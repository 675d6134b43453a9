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
//      by log2(block / t) merge levels confined to the block (`merge_splits`
//      and `merge_tile` over uniform run pairs, no pair table), ping-ponging
//      between `out` and a scratch. At block 2^17 that is 4 passes over
//      global memory (1 tile pass, 3 levels), where a bitonic network over
//      8192-key tiles needs 15; none is a bare compare-exchange pass. (A
//      tile of 8192 keys, 8 a thread in 64 KB, measured 1-3% slower at
//      both of the main path's shapes: PERF.md.) The tile pass runs far
//      above its device-memory bound (PERF.md): its time goes to the
//      shared-memory rounds, each a split search and a sequential merge.
//   2. merge level: merge path. `merge_splits` finds, for the start of every
//      MERGE_TILE-row output tile, how many rows of the pair's run A precede
//      it (binary search, ties A-first, as `_merge_path_splits_desc`).
//      `merge_tile` stages the tile's A and B windows (MERGE_TILE rows in
//      all) in shared memory; each thread binary-searches its own sub-split
//      there, merges its MERGE_ITEMS outputs sequentially into shared memory,
//      and the tile is stored coalesced. MERGE_TILE (1024) divides every run
//      pair because run lengths are multiples of `chunk` >= 1024: `chunk`
//      stays the unit of the run contract, not of the CTA.
// Shared-memory tiles are padded by one key every 16 (`sidx`), so that the
// blocked accesses of 16 consecutive keys a thread hit 16 distinct 8-byte
// banks a half-warp.
// The kernels allocate nothing: the caller passes the output and the
// scratches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITEMS = 16;                  // keys a thread sorts in registers
constexpr int SORT_THREADS = 1024;
constexpr int TILE = SORT_THREADS * ITEMS;  // 16384 keys a CTA sorts in smem
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_ITEMS = 4;
constexpr int MERGE_TILE = MERGE_THREADS * MERGE_ITEMS;   // 1024 rows
constexpr int SPLIT_THREADS = 256;
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
// a with A[a] > B[d - a - 1] over a in [max(0, d - nb), min(d, na)].
template <typename Ptr>
__device__ __forceinline__ int64_t merge_path(Ptr A, int64_t na, Ptr B,
                                              int64_t nb, int64_t d) {
  int64_t lo = d - nb > 0 ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t a = (lo + hi) >> 1;
    if (A[a] <= B[d - a - 1]) {
      lo = a + 1;
    } else {
      hi = a;
    }
  }
  return lo;
}

// The run pair (a0, alen, blen) whose output [a0, a0 + alen + blen) holds
// row d, from a table of pairs in order covering [0, n).
struct TablePairs {
  const int64_t* pairs;
  int64_t npairs;
  __device__ __forceinline__ void operator()(int64_t d, int64_t& a0,
                                             int64_t& alen,
                                             int64_t& blen) const {
    int64_t lo = 0, hi = npairs - 1;
    while (lo < hi) {
      const int64_t m = (lo + hi + 1) >> 1;
      if (pairs[3 * m] <= d) {
        lo = m;
      } else {
        hi = m - 1;
      }
    }
    a0 = pairs[3 * lo];
    alen = pairs[3 * lo + 1];
    blen = pairs[3 * lo + 2];
  }
};

// Runs of one length `run` (a power of two) end to end over [0, n), n a
// multiple of 2 * run: row d's pair starts at d rounded down to 2 * run.
struct UniformPairs {
  int64_t run;
  __device__ __forceinline__ void operator()(int64_t d, int64_t& a0,
                                             int64_t& alen,
                                             int64_t& blen) const {
    a0 = d & ~(2 * run - 1);
    alen = run;
    blen = run;
  }
};

// splits[t] = rows of A before output tile t's first row, within its pair.
template <class Pairs>
__global__ void __launch_bounds__(SPLIT_THREADS)
merge_splits(const int64_t* __restrict__ keys, Pairs pairs, int64_t ntiles,
             int64_t* __restrict__ splits) {
  const int64_t t = (int64_t)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (t >= ntiles) return;
  const int64_t d = t * MERGE_TILE;
  int64_t a0, alen, blen;
  pairs(d, a0, alen, blen);
  splits[t] = merge_path(keys + a0, alen, keys + a0 + alen, blen, d - a0);
}

template <class Pairs>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_tile(const int64_t* __restrict__ keys, int64_t* __restrict__ out,
           Pairs pairs, const int64_t* __restrict__ splits) {
  __shared__ int64_t win[MERGE_TILE];   // A window, then B window
  __shared__ int64_t res[MERGE_TILE];
  const int64_t t = blockIdx.x;
  const int64_t d0 = t * MERGE_TILE;
  int64_t a0, alen, blen;
  pairs(d0, a0, alen, blen);
  const int64_t dl = d0 - a0;   // the tile's first row within its pair
  const int64_t a_lo = splits[t];
  const int64_t a_hi =
      dl + MERGE_TILE == alen + blen ? alen : splits[t + 1];
  const int na = (int)(a_hi - a_lo);
  const int64_t b_lo = dl - a_lo;
  const int64_t* A = keys + a0 + a_lo;
  const int64_t* B = keys + a0 + alen + b_lo;
  for (int i = threadIdx.x; i < MERGE_TILE; i += MERGE_THREADS)
    win[i] = i < na ? A[i] : B[i - na];
  __syncthreads();
  const int nb = MERGE_TILE - na;
  const int d = threadIdx.x * MERGE_ITEMS;
  int ai = (int)merge_path(win, na, win + na, nb, d);
  int bi = d - ai;
#pragma unroll
  for (int q = 0; q < MERGE_ITEMS; ++q) {
    const bool take_a = ai < na && (bi >= nb || win[ai] <= win[na + bi]);
    res[d + q] = take_a ? win[ai++] : win[na + bi++];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MERGE_TILE; i += MERGE_THREADS)
    out[d0 + i] = res[i];
}

// One merge level: the split search, then the merge. n % MERGE_TILE == 0.
template <class Pairs>
cudaError_t launch_level(const int64_t* in, int64_t* out, int64_t n,
                         Pairs pairs, int64_t* splits, cudaStream_t st) {
  const int64_t ntiles = n / MERGE_TILE;
  merge_splits<<<(unsigned)((ntiles + SPLIT_THREADS - 1) / SPLIT_THREADS),
                 SPLIT_THREADS, 0, st>>>(in, pairs, ntiles, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_tile<<<(unsigned)ntiles, MERGE_THREADS, 0, st>>>(in, out, pairs,
                                                         splits);
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

int kmtpu_merge_tile() { return MERGE_TILE; }

// in, out [n] int64; n % block == 0, block a power of two. Sorts each block
// of `in` ascending into `out`. When block > TILE, scratch [n] int64 and
// splits [n / MERGE_TILE + 1] int64 are the in-block merge levels' scratch
// (else unused, may be null). tiles_done, a cudaEvent_t or null, is
// recorded on `stream` between the tile pass and the first in-block level.
// Launches on `stream` and returns the first CUDA error (0 = launched).
int kmtpu_local_sort_blocks(const void* in, void* out, int64_t n,
                            int64_t block, void* scratch, void* splits,
                            void* tiles_done, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  const int t = (int)(block < TILE ? block : TILE);
  int levels = 0;
  for (int64_t r = t; r < block; r <<= 1) ++levels;
  if (levels > 0 && (scratch == nullptr || splits == nullptr))
    return (int)cudaErrorInvalidValue;
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
    err = launch_level(dst, other, n, UniformPairs{run},
                       static_cast<int64_t*>(splits), st);
    if (err != cudaSuccess) return (int)err;
    int64_t* x = dst;
    dst = other;
    other = x;
  }
  return (int)cudaSuccess;
}

// in, out [n] int64, n % MERGE_TILE == 0; pairs [npairs, 3] int64 rows
// (a0, alen, blen), in order, covering [0, n), each run sorted and
// alen + blen a multiple of MERGE_TILE; splits [n / MERGE_TILE + 1] int64
// scratch. Writes merge(A, B) of each pair to out[a0 : a0 + alen + blen].
int kmtpu_merge_level(const void* in, void* out, int64_t n, const void* pairs,
                      int64_t npairs, void* splits, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return (int)launch_level(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n,
      TablePairs{static_cast<const int64_t*>(pairs), npairs},
      static_cast<int64_t*>(splits), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
