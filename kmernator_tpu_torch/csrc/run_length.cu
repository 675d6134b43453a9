// Run-length sums over sorted int64 key lanes, for Hopper (sm_90a).
//
// Replaces the TPU kernel kmernator_tpu/parallel/pallas_count.py
// (`run_length_counts`, kernel body `_kernel`): for keys sorted so that equal
// keys are adjacent, out[i] = sum(vals[run]) when i is the last index of its
// run of equal keys, and 0 elsewhere. Any n >= 0 is accepted; there is no
// block-multiple rule.
//
// What bounds it: bytes. Each row is read once (8 B key + 4 B value) and
// written once (4 B), 16 B a row, against a handful of integer operations,
// so the kernel sits far below the card's compute roofline and its floor is
// 16 B * n / (device memory bandwidth).
//
// Design. The TPU kernel walks its grid in order and carries the open run's
// partial count from one block to the next in SMEM. Hopper blocks run in no
// order, so the carry becomes a second pass:
//   1. tile_scan: each block loads one tile of TILE rows with coalesced
//      loads into shared memory, runs a segmented inclusive scan over it
//      (segments restart where the key changes), writes each run end's
//      in-tile partial sum (0 elsewhere), and records the tile aggregate
//      (did a run start in the tile, sum since the last start) and the
//      offset of the first run end if that run began before the tile.
//   2. carry_fix: one block scans the tile aggregates in order, chunk by
//      chunk, and adds the carried partial sum of the run that enters each
//      tile to that run's end. At most one row per tile is fixed up.
// No thread ever loops over a run, so one run spanning millions of rows (a
// drain's trailing sentinel run) costs the same as many short ones. The
// kernels allocate nothing: the caller passes out and a scratch buffer of
// 3 * ceil(n / TILE) int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int FIX_THREADS = 1024;

// A segmented-scan element: `flag` says a run starts within the span,
// `sum` is the sum of values since the last start (or over the whole span).
struct Seg {
  int flag;
  int sum;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  Seg r;
  r.flag = a.flag | b.flag;
  r.sum = b.flag ? b.sum : a.sum + b.sum;
  return r;
}

// Block-wide exclusive scan of one Seg per thread. `wsum` holds 33 Segs of
// shared memory; the block aggregate is returned through `total`.
template <int NT>
__device__ Seg block_exclusive_scan(Seg v, Seg* wsum, Seg* total) {
  constexpr int NWARPS = NT / 32;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Seg inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Seg o;
    o.flag = __shfl_up_sync(full, inc.flag, d);
    o.sum = __shfl_up_sync(full, inc.sum, d);
    if (lane >= d) inc = combine(o, inc);
  }
  Seg excl;
  excl.flag = __shfl_up_sync(full, inc.flag, 1);
  excl.sum = __shfl_up_sync(full, inc.sum, 1);
  if (lane == 0) excl = Seg{0, 0};
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg w = lane < NWARPS ? wsum[lane] : Seg{0, 0};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      Seg o;
      o.flag = __shfl_up_sync(full, w.flag, d);
      o.sum = __shfl_up_sync(full, w.sum, d);
      if (lane >= d) w = combine(o, w);
    }
    Seg we;
    we.flag = __shfl_up_sync(full, w.flag, 1);
    we.sum = __shfl_up_sync(full, w.sum, 1);
    if (lane == 0) we = Seg{0, 0};
    if (lane < NWARPS) wsum[lane] = we;
    if (lane == NWARPS - 1) wsum[32] = w;
  }
  __syncthreads();
  Seg res = combine(wsum[warp], excl);
  *total = wsum[32];
  __syncthreads();  // wsum may be reused by the caller's next scan
  return res;
}

__global__ void __launch_bounds__(THREADS)
tile_scan(const int64_t* __restrict__ keys, const int32_t* __restrict__ vals,
          int32_t* __restrict__ out, int64_t n, int32_t* __restrict__ agg_flag,
          int32_t* __restrict__ agg_sum, int32_t* __restrict__ fix) {
  // skey[0] = key before the tile, skey[1 + j] = tile row j,
  // skey[TILE + 1] = key after the tile
  __shared__ int64_t skey[TILE + 2];
  __shared__ int32_t sval[TILE];
  __shared__ Seg wsum[33];
  __shared__ int first_end;

  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int64_t rows = n - base < TILE ? n - base : TILE;
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    skey[1 + j] = j < rows ? keys[base + j] : 0;
    sval[j] = j < rows ? vals[base + j] : 0;
  }
  if (threadIdx.x == 0) {
    skey[0] = base > 0 ? keys[base - 1] : 0;
    skey[TILE + 1] = base + TILE < n ? keys[base + TILE] : 0;
    first_end = TILE;
  }
  __syncthreads();

  // this thread's ITEMS consecutive rows: starts, ends, values
  const int j0 = threadIdx.x * ITEMS;
  int start[ITEMS], end[ITEMS], v[ITEMS];
  Seg agg = Seg{0, 0};
#pragma unroll
  for (int t = 0; t < ITEMS; ++t) {
    const int j = j0 + t;
    const int64_t i = base + j;
    const bool in = j < rows;
    start[t] = in && (i == 0 || skey[j + 1] != skey[j]);
    end[t] = in && (i == n - 1 || skey[j + 1] != skey[j + 2]);
    v[t] = sval[j];
    if (in) agg = combine(agg, Seg{start[t], v[t]});
  }
  Seg total;
  Seg run = block_exclusive_scan<THREADS>(agg, wsum, &total);

  // in-tile partial sums at run ends, staged in sval for a coalesced store
#pragma unroll
  for (int t = 0; t < ITEMS; ++t) {
    const int j = j0 + t;
    run = combine(run, Seg{start[t], v[t]});
    sval[j] = end[t] ? run.sum : 0;
    if (end[t]) atomicMin(&first_end, j);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows; j += THREADS) out[base + j] = sval[j];

  if (threadIdx.x == 0) {
    const bool lead_open = base > 0 && skey[1] == skey[0];
    agg_flag[blockIdx.x] = total.flag;
    agg_sum[blockIdx.x] = total.sum;
    fix[blockIdx.x] = (lead_open && first_end < TILE) ? first_end : -1;
  }
}

__global__ void __launch_bounds__(FIX_THREADS)
carry_fix(const int32_t* __restrict__ agg_flag,
          const int32_t* __restrict__ agg_sum, const int32_t* __restrict__ fix,
          int32_t* __restrict__ out, int64_t ntiles) {
  __shared__ Seg wsum[33];
  Seg carry = Seg{0, 0};
  for (int64_t c0 = 0; c0 < ntiles; c0 += FIX_THREADS) {
    const int64_t t = c0 + threadIdx.x;
    Seg a = t < ntiles ? Seg{agg_flag[t], agg_sum[t]} : Seg{0, 0};
    Seg total;
    Seg excl = combine(carry, block_exclusive_scan<FIX_THREADS>(a, wsum, &total));
    if (t < ntiles && fix[t] >= 0) out[t * TILE + fix[t]] += excl.sum;
    carry = combine(carry, total);
  }
}

}  // namespace

extern "C" {

int kmtpu_run_length_tile() { return TILE; }

// keys [n] int64 sorted so equal keys are adjacent, vals [n] int32,
// out [n] int32, scratch [3 * ceil(n / TILE)] int32. Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
int kmtpu_run_length_sums(const void* keys, const void* vals, void* out,
                          void* scratch, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t ntiles = (n + TILE - 1) / TILE;
  int32_t* s = static_cast<int32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_scan<<<(unsigned)ntiles, THREADS, 0, st>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(vals),
      static_cast<int32_t*>(out), n, s, s + ntiles, s + 2 * ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_fix<<<1, FIX_THREADS, 0, st>>>(s, s + ntiles, s + 2 * ntiles,
                                       static_cast<int32_t*>(out), ntiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
