// Merge-path sort of int64 key lanes, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of kmernator_tpu/parallel/pallas_sort.py:
//   - `local_sort_blocks` (pallas_sort.py:360, kernel body :370, network
//     `_bitonic_sort_rows` :327): sort each aligned power-of-two block
//     ascending;
//   - `merge_level` (pallas_sort.py:203, kernel body :245, merge-path splits
//     `_merge_path_splits_desc` :53): merge adjacent sorted runs pairwise,
//     an odd tail run copying through.
// Keys are the port's int64 lanes ((hi << 32 | lo) ^ 1 << 63, sentinel
// INT64_MAX), so one signed compare stands for the TPU's two-word `_le`.
//
// What bounds it: bytes. Every pass over global memory reads and writes each
// row once, at least 16 B a row, against a few integer compares a row. The
// design's pass count is what it costs.
//
// Design. The TPU sorts a whole 2^17-row block in VMEM with a bitonic
// network because Mosaic cannot index VMEM dynamically. A Hopper CTA has at
// most 227 KB of shared memory, an eighth of such a block, but indexes it
// freely, so both phases merge:
//   1. local sort. `tile_sort` sorts a tile of t = min(TILE, block) keys
//      in one CTA (TILE 16384 keys, 128 KB of opted-in dynamic shared
//      memory): coalesced loads into shared memory, ITEMS = 16 keys a thread
//      sorted in registers by a fully unrolled network, then
//      log2(t / ITEMS) merge-path rounds in shared memory, each thread
//      binary-searching its split within its run pair and merging ITEMS
//      outputs one after another. A block larger than the tile is finished
//      by log2(block / t) merge levels confined to the block (`merge_tile`
//      over uniform run pairs, no pair table), ping-ponging
//      between `out` and a scratch. At block 2^17 that is 4 passes over
//      global memory (1 tile pass, 3 levels), where a bitonic network over
//      8192-key tiles needs 15; none is a bare compare-exchange pass. (A
//      tile of 8192 keys, 8 a thread in 64 KB, measured 1-3% slower at
//      both of the main path's shapes: PERF.md.) The tile pass runs far
//      above its device-memory bound (PERF.md): its time goes to the
//      shared-memory rounds, each a split search and a sequential merge.
//   2. merge level: merge path. Each CTA writes one output tile of T =
//      256 threads x 8 rows (2,048; 16 rows a thread measured slower on
//      the card, PERF.md). Tiles are counted pair by pair, so a tile never
//      straddles two pairs; a pair's length is a multiple of `chunk` >=
//      1024 but not always of T, and its last tile is then shorter: its
//      rows (a multiple of 1024) bound the merge and the stores. The
//      tile's first and last splits (how many rows of run A precede them,
//      ties A-first, as `_merge_path_splits_desc`) are searched inside
//      `merge_tile` by two warps, each probing 32 candidates a step (a
//      separate split launch before the merge measured slower where the
//      merge sort runs, PERF.md). `merge_tile` stages the A and B windows
//      in shared memory with 16-byte loads (a window starts at a split, so
//      only 8-byte aligned: one scalar head and tail load), each thread
//      merges its outputs in registers after a sub-split search in shared
//      memory, and the tile goes back through shared memory as coalesced
//      16-byte stores. An odd tail run's pair has blen = 0: every split search
//      returns at once and the tile is a copy. The pair table of a level
//      across blocks reaches the card by an asynchronous copy from pinned
//      host memory (parallel/merge_sort.py), so the host never waits for
//      the previous level.
// Shared-memory tiles are padded by one key every 16 (`sidx`), so that the
// blocked accesses of 8 or 16 consecutive keys a thread hit 16 distinct
// 8-byte banks a half-warp.
// The kernels allocate nothing: the caller passes the output and the
// scratch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITEMS = 16;                  // keys a thread sorts in registers
constexpr int SORT_THREADS = 1024;
constexpr int TILE = SORT_THREADS * ITEMS;  // 16384 keys a CTA sorts in smem
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_ITEMS = 8;             // outputs a thread merges
constexpr int MERGE_TILE = MERGE_THREADS * MERGE_ITEMS;  // rows a CTA writes
constexpr int64_t KEY_MAX = INT64_MAX;

// Shared-memory slot of tile key i: one pad slot after every 16 keys.
__device__ __forceinline__ int sidx(int i) { return i + (i >> 4); }

// Ascending sort of N register keys: a bitonic network unrolled at compile
// time, so every index is a constant and the keys stay in registers.
template <int N>
__device__ __forceinline__ void register_sort(int64_t (&v)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const int64_t a = v[i], b = v[l];
          const int64_t lo = a < b ? a : b, hi = a < b ? b : a;
          const bool asc = (i & k) == 0;
          v[i] = asc ? lo : hi;
          v[l] = asc ? hi : lo;
        }
      }
    }
  }
}

// Sort each tile of t keys (t a power of two): in -> out. One CTA a tile,
// max(t / ITEMS, 1) threads; tiles smaller than ITEMS are padded with
// KEY_MAX, which sorts last, and only their t keys are stored.
__global__ void __launch_bounds__(SORT_THREADS)
tile_sort(const int64_t* __restrict__ in, int64_t* __restrict__ out, int t) {
  extern __shared__ int64_t s[];
  const int64_t base = (int64_t)blockIdx.x * t;
  const int span = blockDim.x * ITEMS;      // t, or ITEMS when t < ITEMS
  for (int i = threadIdx.x; i < span; i += blockDim.x)
    s[sidx(i)] = i < t ? in[base + i] : KEY_MAX;
  __syncthreads();
  const int o = threadIdx.x * ITEMS;        // this thread's first key
  int64_t v[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) v[q] = s[sidx(o + q)];
  register_sort(v);
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) s[sidx(o + q)] = v[q];
  // round: merge run pairs of L keys; this thread writes outputs
  // [o, o + ITEMS) of its pair, which starts at p0
  for (int L = ITEMS; L < span; L <<= 1) {
    __syncthreads();
    const int p0 = o & ~(2 * L - 1);
    const int d = o - p0;
    int lo = d > L ? d - L : 0;
    int hi = d < L ? d : L;
    while (lo < hi) {                       // rows of A before output d
      const int m = (lo + hi) >> 1;
      if (s[sidx(p0 + m)] <= s[sidx(p0 + L + d - m - 1)]) {
        lo = m + 1;
      } else {
        hi = m;
      }
    }
    int ai = p0 + lo, bi = p0 + L + d - lo;
    const int ae = p0 + L, be = p0 + 2 * L;
    int64_t av = ai < ae ? s[sidx(ai)] : 0;
    int64_t bv = bi < be ? s[sidx(bi)] : 0;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (ai < ae && (bi >= be || av <= bv)) {   // ties A-first
        v[q] = av;
        ++ai;
        av = ai < ae ? s[sidx(ai)] : 0;
      } else {
        v[q] = bv;
        ++bi;
        bv = bi < be ? s[sidx(bi)] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) s[sidx(o + q)] = v[q];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t; i += blockDim.x) out[base + i] = s[sidx(i)];
}

// Rows of A among the first d rows of merge(A, B), ties A-first: the least
// a with A[a] > B[d - a - 1] over a in [max(0, d - nb), min(d, na)], found
// by a whole warp: each step probes 32 evenly spaced candidates at once and
// keeps the gap where the predicate turns true, so a search over 2^22 rows
// takes 5 dependent loads instead of 22. Every lane returns the split.
__device__ __forceinline__ int64_t warp_merge_path(const int64_t* A,
                                                   int64_t na,
                                                   const int64_t* B,
                                                   int64_t nb, int64_t d) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int64_t lo = d - nb > 0 ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t m = lo + lane * step;
    const bool p = m >= hi || A[m] > B[d - m - 1];
    const unsigned b = __ballot_sync(full, p);
    if (b == 0) {
      lo += 31 * step + 1;
    } else {
      const int j = __ffs(b) - 1;
      const int64_t mj = lo + j * step;
      hi = mj < hi ? mj : hi;
      lo = j ? lo + (j - 1) * step + 1 : lo;
    }
  }
  return lo;
}

// The same split inside a shared-memory window: A at slots [0, na), B at
// [na, na + nb), laid out by `sidx`.
__device__ __forceinline__ int smem_merge_path(const int64_t* s, int na,
                                               int nb, int d) {
  int lo = d - nb > 0 ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (s[sidx(m)] <= s[sidx(na + d - m - 1)]) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  return lo;
}

// The merge-level tile of output tile t: its pair's start a0 and run
// lengths alen, blen, and the tile's first row dl within the pair, for
// tiles of T rows; a pair's last tile may be shorter than T.
// From a table of pairs in order covering [0, n), rows (a0, alen, blen,
// tile0), tile0 the pair's first tile:
struct TablePairs {
  const int64_t* pairs;
  int64_t npairs;
  __device__ __forceinline__ void operator()(int64_t t, int T, int64_t& a0,
                                             int64_t& alen, int64_t& blen,
                                             int64_t& dl) const {
    int64_t lo = 0, hi = npairs - 1;
    while (lo < hi) {
      const int64_t m = (lo + hi + 1) >> 1;
      if (pairs[4 * m + 3] <= t) {
        lo = m;
      } else {
        hi = m - 1;
      }
    }
    a0 = pairs[4 * lo];
    alen = pairs[4 * lo + 1];
    blen = pairs[4 * lo + 2];
    dl = (t - pairs[4 * lo + 3]) * T;
  }
};

// Runs of one length `run` (a power of two, a multiple of T / 2) end to end
// over [0, n), n a multiple of 2 * run: tile t's pair starts at t * T
// rounded down to 2 * run.
struct UniformPairs {
  int64_t run;
  __device__ __forceinline__ void operator()(int64_t t, int T, int64_t& a0,
                                             int64_t& alen, int64_t& blen,
                                             int64_t& dl) const {
    const int64_t d0 = t * T;
    a0 = d0 & ~(2 * run - 1);
    alen = run;
    blen = run;
    dl = d0 - a0;
  }
};

// Copy cnt keys from src (8-byte aligned) to window slots [dst0, dst0 +
// cnt): one scalar head load up to a 16-byte boundary, 16-byte loads, one
// scalar tail load.
__device__ __forceinline__ void load_window(const int64_t* __restrict__ src,
                                            int cnt, int64_t* s, int dst0) {
  if (cnt <= 0) return;
  const int head = ((uintptr_t)src & 15) ? 1 : 0;
  if (head && threadIdx.x == 0) s[sidx(dst0)] = src[0];
  const int body = (cnt - head) >> 1;
  const longlong2* v = reinterpret_cast<const longlong2*>(src + head);
  // LOADS loads in flight a thread before any is stored
  constexpr int LOADS = 4;
  for (int i0 = threadIdx.x; i0 < body; i0 += LOADS * blockDim.x) {
    longlong2 x[LOADS];
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < body) x[b] = v[i];
    }
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < body) {
        s[sidx(dst0 + head + 2 * i)] = x[b].x;
        s[sidx(dst0 + head + 2 * i + 1)] = x[b].y;
      }
    }
  }
  if (((cnt - head) & 1) && threadIdx.x == blockDim.x - 1)
    s[sidx(dst0 + cnt - 1)] = src[cnt - 1];
}

// One output tile of T = MERGE_TILE rows a CTA: warps 0 and 1 search the
// tile's first and last split, the tile's A and B windows are staged in
// padded shared memory, each thread merges MERGE_ITEMS outputs in
// registers, and the tile goes back through shared memory as 16-byte
// stores. A pair's last tile holds fewer rows (a multiple of 1024, as every
// pair length is): threads past them merge nothing and the stores stop at
// them.
template <class Pairs>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_tile(const int64_t* __restrict__ keys, int64_t* __restrict__ out,
           Pairs pairs) {
  constexpr int T = MERGE_TILE;
  __shared__ int64_t win[T + T / 16];
  __shared__ int64_t s_split[2];
  const int64_t t = blockIdx.x;
  int64_t a0, alen, blen, dl;
  pairs(t, T, a0, alen, blen, dl);
  const int64_t plen = alen + blen;
  const int rows = plen - dl < T ? (int)(plen - dl) : T;
  const int64_t* A = keys + a0;
  const int64_t* B = A + alen;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t d = dl + warp * rows;
    const int64_t s = d == plen ? alen : warp_merge_path(A, alen, B, blen, d);
    if ((threadIdx.x & 31) == 0) s_split[warp] = s;
  }
  __syncthreads();
  const int64_t a_lo = s_split[0];
  const int64_t a_hi = s_split[1];
  const int na = (int)(a_hi - a_lo);
  const int nb = rows - na;
  load_window(A + a_lo, na, win, 0);
  load_window(B + (dl - a_lo), nb, win, na);
  __syncthreads();
  const int d = threadIdx.x * MERGE_ITEMS;
  int64_t v[MERGE_ITEMS];
  if (d < rows) {
    int ai = smem_merge_path(win, na, nb, d);
    int bi = d - ai;
    int64_t av = ai < na ? win[sidx(ai)] : 0;
    int64_t bv = bi < nb ? win[sidx(na + bi)] : 0;
#pragma unroll
    for (int q = 0; q < MERGE_ITEMS; ++q) {
      if (ai < na && (bi >= nb || av <= bv)) {   // ties A-first
        v[q] = av;
        ++ai;
        av = ai < na ? win[sidx(ai)] : 0;
      } else {
        v[q] = bv;
        ++bi;
        bv = bi < nb ? win[sidx(na + bi)] : 0;
      }
    }
  }
  __syncthreads();
  if (d < rows) {
#pragma unroll
    for (int q = 0; q < MERGE_ITEMS; ++q) win[sidx(d + q)] = v[q];
  }
  __syncthreads();
  longlong2* o = reinterpret_cast<longlong2*>(out + a0 + dl);
  for (int i = threadIdx.x; i < rows / 2; i += MERGE_THREADS)
    o[i] = make_longlong2(win[sidx(2 * i)], win[sidx(2 * i + 1)]);
}

// One merge level over ntiles output tiles.
template <class Pairs>
cudaError_t level(const int64_t* in, int64_t* out, int64_t ntiles,
                  Pairs pairs, cudaStream_t st) {
  merge_tile<<<(unsigned)ntiles, MERGE_THREADS, 0, st>>>(in, out, pairs);
  return cudaGetLastError();
}

// The tile pass: tiles of t <= TILE keys, ITEMS a thread.
cudaError_t launch_tiles(const int64_t* in, int64_t* out, int64_t n, int t,
                         cudaStream_t st) {
  const int threads = t / ITEMS > 0 ? t / ITEMS : 1;
  const int span = threads * ITEMS;
  const size_t smem = (size_t)(span + (span >> 4) + 1) * sizeof(int64_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tile_sort<<<(unsigned)(n / t), threads, smem, st>>>(in, out, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kmtpu_sort_tile() { return TILE; }

// Rows of a merge level's output tile.
int kmtpu_merge_tile() { return MERGE_TILE; }

// in, out [n] int64; n % block == 0, block a power of two. Sorts each block
// of `in` ascending into `out`. When block > TILE, scratch [n] int64 is the
// in-block merge levels' scratch (else unused, may be null). tiles_done, a
// cudaEvent_t or null, is
// recorded on `stream` between the tile pass and the first in-block level.
// Launches on `stream` and returns the first CUDA error (0 = launched).
int kmtpu_local_sort_blocks(const void* in, void* out, int64_t n,
                            int64_t block, void* scratch, void* tiles_done,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  const int t = (int)(block < TILE ? block : TILE);
  int levels = 0;
  for (int64_t r = t; r < block; r <<= 1) ++levels;
  if (levels > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // the tile pass writes where an even number of levels later lands in out
  int64_t* dst = static_cast<int64_t*>(out);
  int64_t* other = static_cast<int64_t*>(scratch);
  if (levels & 1) {
    int64_t* x = dst;
    dst = other;
    other = x;
  }
  cudaError_t err =
      launch_tiles(static_cast<const int64_t*>(in), dst, n, t, st);
  if (err == cudaSuccess && tiles_done != nullptr)
    err = cudaEventRecord(static_cast<cudaEvent_t>(tiles_done), st);
  if (err != cudaSuccess) return (int)err;
  for (int64_t run = t; run < block; run <<= 1) {
    err = level(dst, other, n / MERGE_TILE, UniformPairs{run}, st);
    if (err != cudaSuccess) return (int)err;
    int64_t* x = dst;
    dst = other;
    other = x;
  }
  return (int)cudaSuccess;
}

// Merge levels one after another in one call, so that the host queues them
// all at once. in [n] int64, each level's runs sorted; out [n] int64 gets
// the last level; scratch [n] int64 (null for one level) takes every other
// level, so that the last lands in out. tables: the levels' pair tables end
// to end on the card, rows (a0, alen, blen, tile0) in order covering [0, n),
// alen + blen a multiple of 1024, tile0 the pair's first output tile of
// kmtpu_merge_tile() rows. levels [nlevels, 3] int64 on the host: each
// level's first table row, pair count and tile count. events: nlevels
// cudaEvent_t, each recorded on `stream` after its level, or null. Returns
// the first CUDA error (0 = launched).
int kmtpu_merge_levels(const void* in, void* out, void* scratch, int64_t n,
                       const void* tables, const int64_t* levels,
                       int64_t nlevels, void* const* events, void* stream) {
  if (n <= 0 || nlevels <= 0) return (int)cudaGetLastError();
  if (nlevels > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* src = static_cast<const int64_t*>(in);
  int64_t* dst = static_cast<int64_t*>((nlevels & 1) ? out : scratch);
  int64_t* other = static_cast<int64_t*>((nlevels & 1) ? scratch : out);
  const int64_t* table = static_cast<const int64_t*>(tables);
  for (int64_t l = 0; l < nlevels; ++l) {
    cudaError_t err = level(
        src, dst, levels[3 * l + 2],
        TablePairs{table + 4 * levels[3 * l], levels[3 * l + 1]}, st);
    if (err == cudaSuccess && events != nullptr)
      err = cudaEventRecord(static_cast<cudaEvent_t>(events[l]), st);
    if (err != cudaSuccess) return (int)err;
    src = dst;
    dst = other;
    other = const_cast<int64_t*>(src);
  }
  return (int)cudaSuccess;
}

}  // extern "C"
