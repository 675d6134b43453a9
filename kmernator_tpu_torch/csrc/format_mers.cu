// MeraculousCounter's two text files, written on the card from its device
// table, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package brings the table back to the
// host, drops the keys under depth 2 there (`purge_min_depth`) and formats
// the text with a native host routine (native/io_native.cpp
// `format_mer_lines`, k <= 32) or NumPy (`_emit_lines`). Each key's text
// depends on its own row alone, so the card writes it where the table
// already is, and only the text comes back.
//
// The table: L int64 key lanes in key order (ops/kmer.py encode_lanes: a
// lane holds 32 bases, base 0 in its top bits, XOR the sign bit), int32
// counts and int32 [M, 12] extension counters. A key is kept when its count
// is at least min_count. For each kept key, in key order:
//   - mercount: "KMER\tCOUNT\n", then the reverse complement's line with
//     the same count;
//   - mergraph: "KMER\t" and the 12 counters, each followed by a space, then
//     "0\n"; the reverse complement's line takes the counters in the order
//     9 8 7 6 10 11 3 2 1 0 4 5.
// Numbers are decimal with no leading zeros, a negative counter as 0, as
// `write_u64` writes them.
//
// Two launches make the text:
//   - select: a block of THREADS keys, one a thread, sums its kept keys'
//     bytes in each file and its kept keys; the last block to finish (a
//     counter in device memory) scans the blocks' sums in place, so that
//     offs[b] holds the bytes and keys of the blocks before b, and offs[nb]
//     the totals. The host reads offs back and cuts the blocks into slabs.
//   - write, once a slab of blocks [b0, b1): a block scans its keys'
//     lengths, and each thread writes its key's four lines into a stage in
//     shared memory laid out as the output is, 16-byte aligned; the block
//     then stores the stage as 16-byte words (the edge words, which other
//     blocks share, byte by byte). A block whose text passes the stage
//     (very wide keys) writes device memory directly. The slab's buffer
//     holds the mercount text from 0 and the mergraph text from g_at.
//
// What bounds it: bytes. Select reads 4 B a key and 48 B a kept key;
// write reads 4 B a key and 48 + 8 L B a kept key, and writes the text
// (some 150 B a kept key at k = 21). Digits come from a multiply-shift
// division by 10, and a key's bases from its lanes in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;    // keys a block, one a thread
constexpr int STAGE = 65536;    // staged text bytes a block
constexpr int WARPS = THREADS / 32;

struct Table {
  const long long* const* lanes;  // [L] device pointers to [M] lanes
  const int* counts;              // [M]
  const int4* ext;                // [M] rows of 12 int32, as 3 int4
  long long M;
  int L, k, min_count;
};

__device__ __forceinline__ long long round16(long long x) {
  return (x + 15) & ~15LL;
}

__device__ __forceinline__ int ndigits(unsigned v) {
  return 1 + (v >= 10u) + (v >= 100u) + (v >= 1000u) + (v >= 10000u) +
         (v >= 100000u) + (v >= 1000000u) + (v >= 10000000u) +
         (v >= 100000000u) + (v >= 1000000000u);
}

// v's nd digits at p; v / 10 as a multiply and a shift, exact for 32 bits
__device__ __forceinline__ char* put_u32(char* p, unsigned v, int nd) {
  for (int i = nd - 1; i > 0; --i) {
    const unsigned q =
        (unsigned)(((unsigned long long)v * 0xCCCCCCCDull) >> 35);
    p[i] = (char)('0' + (v - q * 10u));
    v = q;
  }
  p[0] = (char)('0' + v);
  return p + nd;
}

// One key's row: its count, its 12 counters (negative as 0) and their
// digits, and its line lengths in each file (0 when it is dropped).
struct Row {
  unsigned count;
  unsigned ext[12];
  int nd[12];
  int cnd;        // digits of the count
  int c_line;     // bytes of one mercount line
  int g_line;     // bytes of one mergraph line
};

__device__ __forceinline__ void read_row(const Table& T, long long i,
                                         Row& r) {
  r.c_line = r.g_line = 0;
  if (i >= T.M) return;
  const int c = T.counts[i];
  if (c < T.min_count) return;
  r.count = (unsigned)c;
  r.cnd = ndigits(r.count);
  int sum = 0;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const int4 v = T.ext[3 * i + w];
    const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned u = e[j] < 0 ? 0u : (unsigned)e[j];
      r.ext[4 * w + j] = u;
      r.nd[4 * w + j] = ndigits(u);
      sum += r.nd[4 * w + j];
    }
  }
  r.c_line = T.k + 2 + r.cnd;        // KMER \t COUNT \n
  r.g_line = T.k + 1 + sum + 14;     // KMER \t 12 x (N ' ') 0 \n
}

// Exclusive prefix of v over the block, and the block's total. Every
// thread calls it; it uses `sh` (WARPS + 1 values) and syncs.
__device__ __forceinline__ long long block_scan(long long v, long long* sh,
                                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const long long t = sh[w];
      sh[w] = run;
      run += t;
    }
    sh[WARPS] = run;
  }
  __syncthreads();
  const long long out = sh[warp] + x - v;
  *total = sh[WARPS];
  __syncthreads();   // sh is free again
  return out;
}

__global__ void __launch_bounds__(THREADS)
    select_kernel(Table T, long long* offs, unsigned* done, unsigned nb) {
  __shared__ long long sh[WARPS + 1];
  __shared__ bool last;
  const long long b = blockIdx.x;
  Row r;
  read_row(T, b * THREADS + threadIdx.x, r);
  long long tot[3];
  block_scan(2LL * r.c_line, sh, &tot[0]);
  block_scan(2LL * r.g_line, sh, &tot[1]);
  block_scan(r.c_line > 0, sh, &tot[2]);
  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) offs[3 * (b + 1) + q] = tot[q];
    __threadfence();
    last = atomicAdd(done, 1u) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: offs[1..nb] in place to their inclusive prefixes
  const long long per = (nb + THREADS - 1) / THREADS;
  const long long s = threadIdx.x * per;
  const long long e = s + per < (long long)nb ? s + per : (long long)nb;
  long long run[3];
  for (int q = 0; q < 3; ++q) {
    long long a = 0;
    for (long long j = s; j < e; ++j) a += __ldcg(&offs[3 * (j + 1) + q]);
    long long unused;
    run[q] = block_scan(a, sh, &unused);
  }
  for (long long j = s; j < e; ++j)
    for (int q = 0; q < 3; ++q) {
      run[q] += __ldcg(&offs[3 * (j + 1) + q]);
      offs[3 * (j + 1) + q] = run[q];
    }
  if (threadIdx.x < 3) offs[threadIdx.x] = 0;
}

// The key's four lines: mercount's two at c, mergraph's two at g.
__device__ __forceinline__ void write_lines(const Table& T, long long i,
                                            const Row& r, char* c,
                                            char* g) {
  const int k = T.k;
  char* cr = c + r.c_line;
  char* gr = g + r.g_line;
  int q = 0;
  for (int l = 0; l < T.L; ++l) {
    const unsigned long long u =
        (unsigned long long)T.lanes[l][i] ^ 0x8000000000000000ull;
    const int n = k - q < 32 ? k - q : 32;
    for (int j = 0; j < n; ++j, ++q) {
      const unsigned code = (unsigned)(u >> (62 - 2 * j)) & 3u;
      const char f = (char)(0x54474341u >> (8 * code));    // A C G T
      const char rc = (char)(0x41434754u >> (8 * code));   // T G C A
      c[q] = f;
      g[q] = f;
      cr[k - 1 - q] = rc;
      gr[k - 1 - q] = rc;
    }
  }
  c[k] = cr[k] = g[k] = gr[k] = '\t';
  put_u32(c + k + 1, r.count, r.cnd);
  put_u32(cr + k + 1, r.count, r.cnd);
  c[r.c_line - 1] = cr[r.c_line - 1] = '\n';
  constexpr int PERM[12] = {9, 8, 7, 6, 10, 11, 3, 2, 1, 0, 4, 5};
  char* pf = g + k + 1;
  char* pr = gr + k + 1;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    pf = put_u32(pf, r.ext[j], r.nd[j]);
    *pf++ = ' ';
    pr = put_u32(pr, r.ext[PERM[j]], r.nd[PERM[j]]);
    *pr++ = ' ';
  }
  pf[0] = pr[0] = '0';
  pf[1] = pr[1] = '\n';
}

// Bytes [lo, hi) of the stage `src` to `dst` (both 16-byte aligned, byte j
// of src to byte j of dst): whole words as 16-byte stores, the words
// shared with the neighbouring blocks' text byte by byte.
__device__ __forceinline__ void store_text(char* dst, const char* src,
                                           long long lo, long long hi) {
  if (hi <= lo) return;
  const long long w0 = lo >> 4, w1 = (hi + 15) >> 4;
  for (long long w = w0 + threadIdx.x; w < w1; w += THREADS) {
    const long long a = w << 4;
    if (a >= lo && a + 16 <= hi) {
      reinterpret_cast<uint4*>(dst)[w] =
          reinterpret_cast<const uint4*>(src)[w];
    } else {
      for (long long j = a < lo ? lo : a; j < a + 16 && j < hi; ++j)
        dst[j] = src[j];
    }
  }
}

struct Slab {
  const long long* offs;   // select's block prefixes
  long long b0;            // the slab's first block
  long long c0, g0;        // its first byte in each file: offs[b0]
  long long g_at;          // where its mergraph text starts in out
  char* out;               // 16-byte aligned
};

__global__ void __launch_bounds__(THREADS) write_kernel(Table T, Slab S) {
  extern __shared__ __align__(16) char stage[];
  __shared__ long long sh[WARPS + 1];
  const long long b = S.b0 + blockIdx.x;
  const long long i = b * THREADS + threadIdx.x;
  Row r;
  read_row(T, i, r);
  long long c_tot, g_tot;
  const long long c_off = block_scan(2LL * r.c_line, sh, &c_tot);
  const long long g_off = block_scan(2LL * r.g_line, sh, &g_tot);
  if (c_tot == 0) return;               // the block keeps no key
  const long long c_dst = S.offs[3 * b] - S.c0;
  const long long g_dst = S.g_at + S.offs[3 * b + 1] - S.g0;
  // the stage mirrors the output from the 16-byte word each text starts in
  const long long c_head = c_dst & 15, g_head = g_dst & 15;
  const long long c_span = round16(c_head + c_tot);
  const bool staged = c_span + round16(g_head + g_tot) <= STAGE;
  if (r.c_line > 0) {
    if (staged)
      write_lines(T, i, r, stage + c_head + c_off,
                  stage + c_span + g_head + g_off);
    else
      write_lines(T, i, r, S.out + c_dst + c_off, S.out + g_dst + g_off);
  }
  if (!staged) return;
  __syncthreads();
  store_text(S.out + (c_dst - c_head), stage, c_head, c_head + c_tot);
  store_text(S.out + (g_dst - g_head), stage + c_span, g_head,
             g_head + g_tot);
}

Table make_table(const void* lanes, int L, const void* counts,
                 const void* ext, long long M, int k, int min_count) {
  Table T;
  T.lanes = static_cast<const long long* const*>(lanes);
  T.counts = static_cast<const int*>(counts);
  T.ext = static_cast<const int4*>(ext);
  T.M = M;
  T.L = L;
  T.k = k;
  T.min_count = min_count;
  return T;
}

}  // namespace

extern "C" {

// Keys a block (the unit of offs and of the slabs).
int kmtpu_format_mers_threads() { return THREADS; }

// lanes: a device array of L pointers to [M] int64 lanes; counts [M]
// int32; ext [M, 12] int32, 16-byte aligned; M > 0. offs: [3 (nb + 1) + 1]
// int64, nb = ceil(M / THREADS): rows of (mercount bytes, mergraph bytes,
// keys kept) of the blocks before each block, and the totals at nb; its
// last element is the blocks' done counter (zeroed here, on the stream).
// Launches on `stream` and returns the first CUDA error (0 = launched).
int kmtpu_format_mers_select(const void* lanes, int L, const void* counts,
                             const void* ext, long long M, int k,
                             int min_count, void* offs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nb = (M + THREADS - 1) / THREADS;
  long long* o = static_cast<long long*>(offs);
  cudaError_t err = cudaMemsetAsync(o + 3 * (nb + 1), 0, sizeof(long long),
                                    st);
  if (err != cudaSuccess) return (int)err;
  select_kernel<<<(unsigned)nb, THREADS, 0, st>>>(
      make_table(lanes, L, counts, ext, M, k, min_count), o,
      reinterpret_cast<unsigned*>(o + 3 * (nb + 1)), (unsigned)nb);
  return (int)cudaGetLastError();
}

// The text of blocks [b0, b1) into out (16-byte aligned): mercount's from
// 0, mergraph's from g_at; c0 and g0 are offs[b0]'s bytes. The table's
// arguments as for select, and offs as select left it.
int kmtpu_format_mers_write(const void* lanes, int L, const void* counts,
                            const void* ext, long long M, int k,
                            int min_count, const void* offs, long long b0,
                            long long b1, long long c0, long long g0,
                            long long g_at, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b1 <= b0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE);
  if (err != cudaSuccess) return (int)err;
  Slab S;
  S.offs = static_cast<const long long*>(offs);
  S.b0 = b0;
  S.c0 = c0;
  S.g0 = g0;
  S.g_at = g_at;
  S.out = static_cast<char*>(out);
  write_kernel<<<(unsigned)(b1 - b0), THREADS, STAGE, st>>>(
      make_table(lanes, L, counts, ext, M, k, min_count), S);
  return (int)cudaGetLastError();
}

}  // extern "C"
