// The count path's input, built on the card from the reads' raw bytes, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package builds these arrays on the host
// (ops/weights.py `window_weights`, `good_kmer_mask`, and the padding of
// parallel/device_spectrum.py `pack_readset` and `ragged_to_padded`),
// because its goodness rests on a float64 running product that a TPU has
// no fast way to compute. An H100 runs IEEE float64 natively, so this
// kernel replays the same product in the same order and writes, for a
// block of reads held as ragged bytes (seq, qual, offsets):
//   - codes [rows, L] u8: BASE_CODE of each base, markup bases (code 4) as
//     0, and 0 past the read;
//   - good [rows, NW] bool, NW = L - k + 1: (float)w > (float)min_kq for
//     each window of weight w, false for a discarded read and past the
//     read's windows;
//   - lengths [rows] i32;
//   - optionally weights [rows, NW] f32: (float)w, 0 past the read;
//   - optionally ext_ok [rows, L] bool: the base's raw quality byte is at
//     or above ext_min, or the read has no qualities; false past the read;
//   - totals [2] u64: the windows of the reads, and the good ones.
// Rows from n to `rows` are written as empty reads (the shards' padding).
//
// The weight is bit-equal to `window_weights`: a read's window 0, every
// window at a multiple of 1024 and every window after a bad one starts
// from 1.0 and multiplies the k base probabilities in order; another
// window multiplies the previous weight by p[i+k-1] / p[i-1]. A window is
// bad when it holds a base of probability 0 or a markup base, and its
// weight is then 0.0. The product and the quotient are __dmul_rn and
// __ddiv_rn, so no contraction into a fused multiply-add reaches a weight;
// the float32 casts are __double2float_rn, as NumPy's astype rounds.
// Badness is a rolling count of such bases (a markup base counts as a
// probability of 0: it is only ever inside bad windows, so its own
// probability is never multiplied).
//
// What bounds it: bytes. Some 2 B a base in (sequence and quality) and
// L + NW (+ L for ext_ok, + 4 NW for weights) B a read out; the float64
// chain is short (one multiply on the dependent path a window) and runs
// one thread a read.
//
// Design: a block takes THREADS consecutive reads, one a thread. Their
// bytes are one contiguous span of seq and of qual, which the block stages
// into shared memory with 16-byte loads when it fits the stage (a span
// that does not, from long reads, is read from device memory directly).
// Codes and ext_ok are written from the stage as whole 16-byte words over
// the block's contiguous output rows. Each thread then runs its read's
// chain on the stage and writes its good (and weight) row into a shared
// output stage, which the block stores as 16-byte words once every chain
// is done (rows too wide for that stage are written directly). The block's
// output rows start at a multiple of 16 bytes, since THREADS is.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // reads a block, one a thread
constexpr int RESYNC = 1024;          // the reference's recompute period
constexpr int64_t IN_MAX = 32768;     // staged bytes of seq (and of qual)
constexpr int64_t OUT_MAX = 65536;    // staged bytes of good (and weights)
constexpr int TABLES = 256 * 8 + 256; // probability and code tables

struct Params {
  const uint8_t* seq;       // ragged bases, padded to a multiple of 16
  const uint8_t* qual;      // ragged raw quality bytes, the same
  const int64_t* offsets;   // [n + 1], offsets[0] == 0
  const uint8_t* flags;     // [n]: bit 0 has qualities, bit 1 discarded
  const double* ptab;       // [256] probability by raw quality byte
  const uint8_t* ctab;      // [256] code by base byte (4: markup)
  int64_t n, rows;
  int k, L, NW;
  float min_kq;
  int ext_min;
  int64_t in_cap;           // staged bytes a block and array (0: none)
  int out_stage;            // good (and weights) rows staged
  uint8_t* codes;
  uint8_t* good;
  int32_t* lengths;
  float* weights;           // or null
  uint8_t* ext_ok;          // or null
  unsigned long long* totals;
};

__host__ __device__ __forceinline__ int64_t round16(int64_t x) {
  return (x + 15) & ~(int64_t)15;
}

// Store nbytes from shared `src` to device `dst` (both 16-byte aligned) as
// 16-byte words, the tail byte by byte.
__device__ __forceinline__ void store_rows(uint8_t* dst, const uint8_t* src,
                                           int64_t nbytes) {
  const int64_t words = nbytes >> 4;
  for (int64_t j = threadIdx.x; j < words; j += THREADS)
    reinterpret_cast<uint4*>(dst)[j] =
        reinterpret_cast<const uint4*>(src)[j];
  for (int64_t j = (words << 4) + threadIdx.x; j < nbytes; j += THREADS)
    dst[j] = src[j];
}

__global__ void __launch_bounds__(THREADS) prepare_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ptab = reinterpret_cast<double*>(smem);
  uint8_t* ctab = smem + 256 * 8;
  uint8_t* seq_s = smem + TABLES;
  uint8_t* qual_s = seq_s + P.in_cap;
  uint8_t* good_s = qual_s + P.in_cap;
  float* w_s = reinterpret_cast<float*>(
      good_s + round16((int64_t)THREADS * P.NW));
  __shared__ int64_t row_off[THREADS];   // into the stage or the arrays
  __shared__ int row_len[THREADS];
  __shared__ uint8_t row_flags[THREADS];
  __shared__ unsigned long long tot[2];

  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * THREADS;
  const int nrows = (int)(P.rows - r0 < THREADS ? P.rows - r0 : THREADS);
  const int64_t rend = r0 + THREADS < P.n ? r0 + THREADS : P.n;  // reads end
  for (int i = tid; i < 256; i += THREADS) {
    ptab[i] = P.ptab[i];
    ctab[i] = P.ctab[i];
  }
  if (tid < 2) tot[tid] = 0;
  int64_t lo = 0, hi = 0;
  if (r0 < P.n) {
    lo = P.offsets[r0] & ~(int64_t)15;
    hi = round16(P.offsets[rend]);
  }
  const bool staged = P.in_cap > 0 && hi - lo <= P.in_cap;
  const uint8_t* seq = staged ? seq_s : P.seq + lo;
  const uint8_t* qual = staged ? qual_s : P.qual + lo;
  if (staged) {
    const uint4* s4 = reinterpret_cast<const uint4*>(P.seq + lo);
    const uint4* q4 = reinterpret_cast<const uint4*>(P.qual + lo);
    for (int64_t j = tid; j < (hi - lo) >> 4; j += THREADS) {
      reinterpret_cast<uint4*>(seq_s)[j] = s4[j];
      reinterpret_cast<uint4*>(qual_s)[j] = q4[j];
    }
  }
  const int64_t r = r0 + tid;
  int len = 0;
  uint8_t fl = 0;
  if (r < P.n) {
    const int64_t o = P.offsets[r];
    len = (int)(P.offsets[r + 1] - o);
    fl = P.flags[r];
    row_off[tid] = o - lo;
  } else {
    row_off[tid] = 0;
  }
  row_len[tid] = len;
  row_flags[tid] = fl;
  __syncthreads();

  // codes and ext_ok: 16 output bytes a thread and step over the block's
  // contiguous rows
  {
    const int64_t total = (int64_t)nrows * P.L;
    uint8_t* crow = P.codes + r0 * P.L;
    uint8_t* erow = P.ext_ok ? P.ext_ok + r0 * P.L : nullptr;
    for (int64_t o = (int64_t)tid * 16; o < total; o += THREADS * 16) {
      int rr = (int)(o / P.L);
      int j = (int)(o - (int64_t)rr * P.L);
      uint8_t c[16], e[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        uint8_t cv = 0, ev = 0;
        if (rr < nrows && j < row_len[rr]) {
          const int64_t at = row_off[rr] + j;
          const uint8_t code = ctab[seq[at]];
          cv = code == 4 ? 0 : code;
          ev = !(row_flags[rr] & 1) || (int)qual[at] >= P.ext_min;
        }
        c[b] = cv;
        e[b] = ev;
        if (++j == P.L) {
          j = 0;
          ++rr;
        }
      }
      if (o + 16 <= total) {
        uint4 cw, ew;
        cw.x = c[0] | c[1] << 8 | c[2] << 16 | (uint32_t)c[3] << 24;
        cw.y = c[4] | c[5] << 8 | c[6] << 16 | (uint32_t)c[7] << 24;
        cw.z = c[8] | c[9] << 8 | c[10] << 16 | (uint32_t)c[11] << 24;
        cw.w = c[12] | c[13] << 8 | c[14] << 16 | (uint32_t)c[15] << 24;
        reinterpret_cast<uint4*>(crow + o)[0] = cw;
        if (erow) {
          ew.x = e[0] | e[1] << 8 | e[2] << 16 | (uint32_t)e[3] << 24;
          ew.y = e[4] | e[5] << 8 | e[6] << 16 | (uint32_t)e[7] << 24;
          ew.z = e[8] | e[9] << 8 | e[10] << 16 | (uint32_t)e[11] << 24;
          ew.w = e[12] | e[13] << 8 | e[14] << 16 | (uint32_t)e[15] << 24;
          reinterpret_cast<uint4*>(erow + o)[0] = ew;
        }
      } else {
        for (int b = 0; b < 16 && o + b < total; ++b) {
          crow[o + b] = c[b];
          if (erow) erow[o + b] = e[b];
        }
      }
    }
  }

  // the window chain, one thread a read
  unsigned long long n_raw = 0, n_good = 0;
  if (tid < nrows) {
    P.lengths[r] = len;
    const int NW = P.NW, k = P.k;
    uint8_t* grow = P.out_stage ? good_s + (int64_t)tid * NW
                                : P.good + r * NW;
    float* wrow = P.weights == nullptr ? nullptr
                  : P.out_stage ? w_s + (int64_t)tid * NW
                                : P.weights + r * NW;
    const int nw = len >= k ? len - k + 1 : 0;
    if (nw > 0) {
      const uint8_t* s = seq + row_off[tid];
      const uint8_t* q = qual + row_off[tid];
      const bool hq = fl & 1, dis = fl & 2;
      // the base's probability, 0 for a markup base
      auto prob = [&](int j) -> double {
        if (ctab[s[j]] == 4) return 0.0;
        return hq ? ptab[q[j]] : 1.0;
      };
      int nbad = 0;
      for (int j = 0; j < k - 1; ++j) nbad += prob(j) == 0.0;
      double w = 0.0, p_out = 0.0;
      bool prev_bad = false;
      for (int i = 0; i < nw; ++i) {
        const double p_in = prob(i + k - 1);
        nbad += p_in == 0.0;
        if (i > 0) {
          p_out = prob(i - 1);
          nbad -= p_out == 0.0;
        }
        const bool bad = nbad > 0;
        double wo = 0.0;
        if (!bad) {
          if (prev_bad || i % RESYNC == 0) {
            w = 1.0;
            for (int j = 0; j < k; ++j) w = __dmul_rn(w, prob(i + j));
          } else {
            w = __dmul_rn(w, __ddiv_rn(p_in, p_out));
          }
          wo = w;
        }
        prev_bad = bad;
        const float f = __double2float_rn(wo);
        const bool g = !dis && f > P.min_kq;
        grow[i] = g;
        if (wrow) wrow[i] = f;
        n_good += g;
      }
      n_raw = nw;
    }
    for (int i = nw; i < NW; ++i) {
      grow[i] = 0;
      if (wrow) wrow[i] = 0.0f;
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    n_raw += __shfl_down_sync(0xffffffffu, n_raw, d);
    n_good += __shfl_down_sync(0xffffffffu, n_good, d);
  }
  if ((tid & 31) == 0 && (n_raw | n_good)) {
    atomicAdd(&tot[0], n_raw);
    atomicAdd(&tot[1], n_good);
  }
  __syncthreads();
  if (tid == 0 && (tot[0] | tot[1])) {
    atomicAdd(&P.totals[0], tot[0]);
    atomicAdd(&P.totals[1], tot[1]);
  }
  if (P.out_stage) {
    const int64_t nbytes = (int64_t)nrows * P.NW;
    store_rows(P.good + r0 * P.NW, good_s, nbytes);
    if (P.weights)
      store_rows(reinterpret_cast<uint8_t*>(P.weights + r0 * P.NW),
                 reinterpret_cast<const uint8_t*>(w_s), nbytes * 4);
  }
}

}  // namespace

extern "C" {

// Reads a block.
int kmtpu_prepare_reads_threads() { return THREADS; }

// seq and qual: the ragged bytes of n reads on the card, each allocated to
// a multiple of 16 bytes and 16-byte aligned; offsets [n + 1] int64 from
// 0; flags [n] u8 (bit 0: the read has qualities, bit 1: discarded); ptab
// [256] float64 and ctab [256] u8 on the card; max_span: the largest
// offsets[min(r + THREADS, n)] - offsets[r] over blocks. Outputs, all of
// `rows` >= n rows, contiguous and 16-byte aligned: codes [rows, L] u8,
// good [rows, L - k + 1] bool, lengths [rows] i32, weights [rows, L - k +
// 1] f32 or null, ext_ok [rows, L] bool or null, totals [2] u64 (zeroed
// here, on the stream). Needs 1 <= k <= L and every read at most L bases.
// Launches on `stream` and returns the first CUDA error (0 = launched).
int kmtpu_prepare_reads(const void* seq, const void* qual,
                        const void* offsets, const void* flags,
                        const void* ptab, const void* ctab, int64_t n,
                        int64_t rows, int k, int L, float min_kq,
                        int ext_min, int64_t max_span, void* codes,
                        void* good, void* lengths, void* weights,
                        void* ext_ok, void* totals, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(totals, 0, 2 * sizeof(uint64_t), st);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  Params P;
  P.seq = static_cast<const uint8_t*>(seq);
  P.qual = static_cast<const uint8_t*>(qual);
  P.offsets = static_cast<const int64_t*>(offsets);
  P.flags = static_cast<const uint8_t*>(flags);
  P.ptab = static_cast<const double*>(ptab);
  P.ctab = static_cast<const uint8_t*>(ctab);
  P.n = n;
  P.rows = rows;
  P.k = k;
  P.L = L;
  P.NW = L - k + 1;
  P.min_kq = min_kq;
  P.ext_min = ext_min;
  // a span is at most 30 bytes wider once rounded out to 16-byte words
  P.in_cap = round16(max_span + 32);
  if (P.in_cap > IN_MAX) P.in_cap = IN_MAX;
  const int64_t out_bytes =
      round16((int64_t)THREADS * P.NW) +
      (weights ? (int64_t)THREADS * P.NW * 4 : 0);
  P.out_stage = out_bytes <= OUT_MAX;
  P.codes = static_cast<uint8_t*>(codes);
  P.good = static_cast<uint8_t*>(good);
  P.lengths = static_cast<int32_t*>(lengths);
  P.weights = static_cast<float*>(weights);
  P.ext_ok = static_cast<uint8_t*>(ext_ok);
  P.totals = static_cast<unsigned long long*>(totals);
  const size_t smem = TABLES + 2 * P.in_cap + (P.out_stage ? out_bytes : 0);
  err = cudaFuncSetAttribute(prepare_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (rows + THREADS - 1) / THREADS;
  prepare_kernel<<<(unsigned)blocks, THREADS, smem, st>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
