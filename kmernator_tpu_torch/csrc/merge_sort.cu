// Merge-path sort of int64 key lanes, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of kmernator_tpu/parallel/pallas_sort.py:
//   - `local_sort_blocks` (pallas_sort.py:360, kernel body :370): sort each
//     aligned power-of-two block ascending;
//   - `merge_level` (pallas_sort.py:203, kernel body :245, merge-path splits
//     `_merge_path_splits_desc` :53): merge adjacent sorted runs pairwise,
//     an odd tail run copying through.
// Keys are the port's int64 lanes ((hi << 32 | lo) ^ 1 << 63, sentinel
// INT64_MAX), so one signed compare stands for the TPU's two-word `_le`.
//
// What bounds it: bytes. Every pass over global memory reads and writes each
// row once, at least 16 B a row, against a few integer compares a row. The
// design's pass count is what it costs. At N = 100,663,296 rows and block =
// 2^17 (768 blocks), with TILE = 8192: the local sort makes 1 tile-sort pass,
// then for each bitonic size k = 2^14 .. 2^17 (4 sizes) one global
// compare-exchange pass per stride 2^13 .. k/2 (1 + 2 + 3 + 4 = 10 passes) and
// one shared-memory pass for the strides below TILE (4 passes): 15 passes.
// The merge makes ceil(log2 768) = 10 levels of one pass each (plus a split
// search that reads 2 log2(run) keys per 1024-row tile). 25 passes in all,
// 16 B a row each: 25 x 1.61 GB at that shape.
//
// Design. The TPU sorts a whole 2^17-row block in VMEM and merges with a
// bitonic network because Mosaic cannot index VMEM dynamically. Hopper has
// 227 KB of shared memory a block and indexes it freely:
//   1. local sort: a bitonic sort. `tile_sort` sorts tiles of
//      t = min(TILE, block) keys (64 KB of dynamic shared memory, above the
//      48 KB default, so the kernel opts in with cudaFuncSetAttribute). Each
//      later bitonic size k runs `global_step` once for each stride >= t,
//      compare-exchanging pairs in global memory, then one `tile_merge` for
//      all strides < t. The direction of a compare-exchange comes from the
//      row's index within its block, so blocks smaller than TILE are sorted
//      whole in one CTA and larger ones across CTAs.
//   2. merge level: merge path. `merge_splits` finds, for the start of every
//      MERGE_TILE-row output tile, how many rows of the pair's run A precede
//      it (binary search, ties A-first, as `_merge_path_splits_desc`).
//      `merge_tile` stages the tile's A and B windows (MERGE_TILE rows in
//      all) in shared memory; each thread binary-searches its own sub-split
//      there, merges its MERGE_ITEMS outputs sequentially into shared memory,
//      and the tile is stored coalesced. MERGE_TILE (1024) divides every run
//      pair because run lengths are multiples of `chunk` >= 1024: `chunk`
//      stays the unit of the run contract, not of the CTA.
// The kernels allocate nothing: the caller passes the output and, for the
// merge, the pair table and a scratch of N / MERGE_TILE + 1 int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SORT_THREADS = 1024;
constexpr int TILE = 8192;                 // keys a CTA sorts in shared memory
constexpr int STEP_THREADS = 256;
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_ITEMS = 4;
constexpr int MERGE_TILE = MERGE_THREADS * MERGE_ITEMS;   // 1024 rows
constexpr int SPLIT_THREADS = 256;

// Row i (within its block) sorts ascending in bitonic size k iff bit k of i
// is clear; at k == block every row is ascending.
__device__ __forceinline__ bool ascending(int64_t g, int64_t block,
                                          int64_t k) {
  return ((g & (block - 1)) & k) == 0;
}

__device__ __forceinline__ void cmp_swap(int64_t& a, int64_t& b, bool asc) {
  if ((a > b) == asc) {
    int64_t t = a;
    a = b;
    b = t;
  }
}

// The compare-exchange steps of strides j_hi .. 1 on a tile of t keys in
// shared memory, for bitonic sizes k_lo .. k_hi (k_lo == k_hi: one size).
__device__ void tile_network(int64_t* s, int t, int64_t base, int64_t block,
                             int64_t k_lo, int64_t k_hi) {
  for (int64_t k = k_lo; k <= k_hi; k <<= 1) {
    for (int64_t j = (k >> 1) < t ? (k >> 1) : (t >> 1); j > 0; j >>= 1) {
      __syncthreads();
      for (int p = threadIdx.x; p < (t >> 1); p += blockDim.x) {
        const int i = (int)((p / j) * 2 * j + (p % j));
        const int l = i + (int)j;
        int64_t a = s[i], b = s[l];
        cmp_swap(a, b, ascending(base + i, block, k));
        s[i] = a;
        s[l] = b;
      }
    }
  }
  __syncthreads();
}

// Sort each tile of t keys: bitonic sizes 2 .. t. in -> out.
__global__ void __launch_bounds__(SORT_THREADS)
tile_sort(const int64_t* __restrict__ in, int64_t* __restrict__ out, int t,
          int64_t block) {
  extern __shared__ int64_t s[];
  const int64_t base = (int64_t)blockIdx.x * t;
  for (int i = threadIdx.x; i < t; i += blockDim.x) s[i] = in[base + i];
  tile_network(s, t, base, block, 2, t);
  for (int i = threadIdx.x; i < t; i += blockDim.x) out[base + i] = s[i];
}

// Strides t/2 .. 1 of bitonic size k, in place, one tile a CTA.
__global__ void __launch_bounds__(SORT_THREADS)
tile_merge(int64_t* __restrict__ keys, int t, int64_t block, int64_t k) {
  extern __shared__ int64_t s[];
  const int64_t base = (int64_t)blockIdx.x * t;
  for (int i = threadIdx.x; i < t; i += blockDim.x) s[i] = keys[base + i];
  tile_network(s, t, base, block, k, k);
  for (int i = threadIdx.x; i < t; i += blockDim.x) keys[base + i] = s[i];
}

// One stride j >= t of bitonic size k, in place in global memory: thread p
// compare-exchanges rows i and i + j, i the p-th row with bit j clear.
__global__ void __launch_bounds__(STEP_THREADS)
global_step(int64_t* __restrict__ keys, int64_t n, int64_t block, int64_t k,
            int64_t j) {
  const int64_t p = (int64_t)blockIdx.x * STEP_THREADS + threadIdx.x;
  if (p >= (n >> 1)) return;
  const int64_t i = (p / j) * 2 * j + (p % j);
  int64_t a = keys[i], b = keys[i + j];
  cmp_swap(a, b, ascending(i, block, k));
  keys[i] = a;
  keys[i + j] = b;
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

// The pair (a0, alen, blen) whose output [a0, a0 + alen + blen) holds row d:
// pairs are in order and cover [0, n).
__device__ __forceinline__ int64_t find_pair(const int64_t* __restrict__ pairs,
                                             int64_t npairs, int64_t d) {
  int64_t lo = 0, hi = npairs - 1;
  while (lo < hi) {
    const int64_t m = (lo + hi + 1) >> 1;
    if (pairs[3 * m] <= d) {
      lo = m;
    } else {
      hi = m - 1;
    }
  }
  return lo;
}

// splits[t] = rows of A before output tile t's first row, within its pair.
__global__ void __launch_bounds__(SPLIT_THREADS)
merge_splits(const int64_t* __restrict__ keys, const int64_t* __restrict__ pairs,
             int64_t npairs, int64_t ntiles, int64_t* __restrict__ splits) {
  const int64_t t = (int64_t)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (t >= ntiles) return;
  const int64_t d = t * MERGE_TILE;
  const int64_t p = find_pair(pairs, npairs, d);
  const int64_t a0 = pairs[3 * p], alen = pairs[3 * p + 1],
                blen = pairs[3 * p + 2];
  splits[t] = merge_path(keys + a0, alen, keys + a0 + alen, blen, d - a0);
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_tile(const int64_t* __restrict__ keys, int64_t* __restrict__ out,
           const int64_t* __restrict__ pairs, int64_t npairs,
           const int64_t* __restrict__ splits) {
  __shared__ int64_t win[MERGE_TILE];   // A window, then B window
  __shared__ int64_t res[MERGE_TILE];
  const int64_t t = blockIdx.x;
  const int64_t d0 = t * MERGE_TILE;
  const int64_t p = find_pair(pairs, npairs, d0);
  const int64_t a0 = pairs[3 * p], alen = pairs[3 * p + 1],
                blen = pairs[3 * p + 2];
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

}  // namespace

extern "C" {

int kmtpu_sort_tile() { return TILE; }

int kmtpu_merge_tile() { return MERGE_TILE; }

// in, out [n] int64; n % block == 0, block a power of two. Sorts each block
// of `in` ascending into `out`. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int kmtpu_local_sort_blocks(const void* in, void* out, int64_t n,
                            int64_t block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  const int t = (int)(block < TILE ? block : TILE);
  const size_t smem = (size_t)t * sizeof(int64_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      tile_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int64_t* keys = static_cast<int64_t*>(out);
  const unsigned tiles = (unsigned)(n / t);
  const int threads = t / 2 < SORT_THREADS ? (t / 2 > 0 ? t / 2 : 1)
                                           : SORT_THREADS;
  tile_sort<<<tiles, threads, smem, st>>>(static_cast<const int64_t*>(in),
                                          keys, t, block);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const unsigned step_blocks =
      (unsigned)(((n >> 1) + STEP_THREADS - 1) / STEP_THREADS);
  for (int64_t k = 2 * (int64_t)t; k <= block; k <<= 1) {
    for (int64_t j = k >> 1; j >= t; j >>= 1) {
      global_step<<<step_blocks, STEP_THREADS, 0, st>>>(keys, n, block, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    tile_merge<<<tiles, threads, smem, st>>>(keys, t, block, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// in, out [n] int64, n % MERGE_TILE == 0; pairs [npairs, 3] int64 rows
// (a0, alen, blen), in order, covering [0, n), each run sorted and
// alen + blen a multiple of MERGE_TILE; splits [n / MERGE_TILE + 1] int64
// scratch. Writes merge(A, B) of each pair to out[a0 : a0 + alen + blen].
int kmtpu_merge_level(const void* in, void* out, int64_t n, const void* pairs,
                      int64_t npairs, void* splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t ntiles = n / MERGE_TILE;
  const int64_t* keys = static_cast<const int64_t*>(in);
  const int64_t* pr = static_cast<const int64_t*>(pairs);
  int64_t* sp = static_cast<int64_t*>(splits);
  merge_splits<<<(unsigned)((ntiles + SPLIT_THREADS - 1) / SPLIT_THREADS),
                 SPLIT_THREADS, 0, st>>>(keys, pr, npairs, ntiles, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_tile<<<(unsigned)ntiles, MERGE_THREADS, 0, st>>>(
      keys, static_cast<int64_t*>(out), pr, npairs, sp);
  return (int)cudaGetLastError();
}

}  // extern "C"
