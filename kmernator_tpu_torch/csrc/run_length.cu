// Run-length sums over sorted int64 key lanes, for Hopper (sm_90a).
//
// Replaces the TPU kernel kmernator_tpu/parallel/pallas_count.py
// (`run_length_counts`, kernel body `_kernel`): for keys sorted so that equal
// keys are adjacent, out[i] = sum(vals[run]) when i is the last index of its
// run of equal keys, and 0 elsewhere. Any n >= 0 is accepted; there is no
// block-multiple rule. A key is L int64 lanes of any count (ceil(k / 32):
// ops/kmer.py encode_lanes), one array a lane; two rows are one key when
// every lane is equal. The kernel is a template on L: L = 1, 2 and 3 (k <=
// 96) are instances with their lane pointers in the kernel's parameters and
// the lane loop unrolled; one more instance, L = 0, takes any L >= 1 from a
// device array of L lane pointers and loops over them at run time with the
// same per-lane pass, so no k the JAX package runs is past it.
//
// What bounds it: bytes. Each row is read once (8 B a lane + 4 B value) and
// written once (4 B), 8L + 8 B a row, against a handful of integer
// operations, so the kernel sits far below the card's compute roofline and
// its floor is (8L + 8) B * n / (device memory bandwidth).
//
// Design: one launch, a single-pass segmented scan with decoupled look-back
// (Merrill and Garland) over the `Seg` monoid. The TPU kernel walks its grid
// in order and carries the open run's partial sum from block to block;
// Hopper blocks run in no order, so each tile publishes its carry instead:
//   - Tile order. Each CTA takes its tile id from an atomic counter, so every
//     tile it waits on belongs to a CTA that has already started: the wait
//     cannot deadlock, whatever the grid size.
//   - Loads. Keys arrive by coalesced 16-byte vector loads (two a load) into
//     shared memory padded one slot every 16 keys, and each thread then
//     takes its ITEMS consecutive keys into registers without bank
//     conflicts; each key's neighbours are in shared memory, and the one on
//     each side of the tile is one extra load. Lanes pass through the same
//     shared buffer one after another (a barrier between them), each
//     thread folding "differs from the row before / after" into two bit
//     masks, so shared memory does not grow with L; at L = 1 the loop is
//     the single pass of the one-lane kernel. A thread's ITEMS values are
//     contiguous and 16-byte aligned, so it loads them as its own 16-byte
//     words straight into registers: a warp's loads cover whole sectors,
//     and no shared memory or barrier is spent on them.
//   - Scan. Each thread folds its rows into one Seg, a block scan gives each
//     thread its in-tile prefix and the tile aggregate.
//   - Look-back. The tile publishes its aggregate, then, once its exclusive
//     prefix is known, its inclusive prefix, each as one 64-bit word (status,
//     run-start flag, 32-bit sum) stored and loaded whole, so status and
//     value are never seen apart. Warp 0 waits for the nearest predecessor
//     with one lane, then reads 32 predecessors a step, and stops at the
//     first that holds a prefix or a run start (the sum before a start
//     cannot reach this tile). Only the rows of the run that
//     enters the tile need the carry: threads past the tile's first run
//     start write their outputs before the look-back, the others after it.
//   - Output. Run ends get the run's sum, other rows 0, written from
//     registers by 16-byte vector stores.
// The look-back is what holds the kernel above its bound: without it (and
// wrong) the same kernel runs at the speed of a device-to-device copy of
// the same bytes (`design_probe.py`, PERF.md).
// No thread loops over a run, so one run spanning millions of rows (a drain's
// trailing sentinel run) costs the same as many short ones, and no shared
// atomic is taken per run end. A tail tile, or a view not 16-byte aligned,
// takes scalar loads and stores. The kernel allocates nothing: the caller
// passes out and a scratch of 1 + ceil(n / TILE) 64-bit words, which the
// entry point zeroes on the stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;            // rows a thread, chosen on the card
                                    // (`design_probe.py`, PERF.md)
constexpr int TILE = THREADS * ITEMS;

// A segmented-scan element: `flag` says a run starts within the span,
// `sum` is the sum of values since the last start (or over the whole span).
struct Seg {
  int flag;
  int sum;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  Seg r;
  r.flag = a.flag | b.flag;
  r.sum = b.flag ? b.sum : (int)((unsigned)a.sum + (unsigned)b.sum);
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
  return res;
}

// A published tile descriptor: bits 63-62 status, bit 32 flag, bits 31-0 sum.
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long PREFIX = 2ull << 62;

__device__ __forceinline__ unsigned long long pack(unsigned long long status,
                                                   Seg s) {
  return status | ((unsigned long long)(s.flag & 1) << 32) | (unsigned)s.sum;
}

__device__ __forceinline__ Seg unpack(unsigned long long d) {
  return Seg{(int)((d >> 32) & 1), (int)(unsigned)d};
}

// A descriptor is one naturally aligned 64-bit word, so a reader sees its
// status and value together or not at all; it publishes nothing else (no
// other write of the tile is read through it), so relaxed device-scope
// accesses suffice, and they cost less on the look-back's critical path
// than a release store and acquire loads (`design_probe.py`, PERF.md).
__device__ __forceinline__ void store_desc(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_desc(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Shared-memory slot of tile key j: one pad every 16 keys, after a leading
// slot for the key before the tile.
__host__ __device__ constexpr int kslot(int j) { return 1 + j + (j >> 4); }

// Exclusive prefix of tile `tile` from its predecessors' descriptors, by
// warp 0: lane 0 alone waits for the nearest predecessor, which most often
// holds a run start or its prefix and ends the look-back; past it, the warp
// reads 32 predecessors a step. (Every lane polling its own predecessor
// from the start floods the L2 with loads while the nearest one is not
// ready, and costs more than it saves: `design_probe.py`, PERF.md.)
// Returns the prefix in every lane.
__device__ Seg look_back(const unsigned long long* desc, long long tile) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  unsigned long long d = 0;
  if (lane == 0) {
    do {
      d = load_desc(desc + tile - 1);
    } while ((d >> 62) == 0);
  }
  d = __shfl_sync(full, d, 0);
  Seg run = unpack(d);   // combined descriptors of the tiles already read
  if ((d >> 62) == 2 || ((d >> 32) & 1)) return run;
  for (long long hi = tile - 2;; hi -= 32) {
    const long long p = hi - lane;    // lane 0 reads the nearest tile
    d = PREFIX;                       // before tile 0: the empty prefix
    if (p >= 0) {
      do {
        d = load_desc(desc + p);
      } while ((d >> 62) == 0);
    }
    const bool stop = (d >> 62) == 2 || ((d >> 32) & 1);
    const unsigned stops = __ballot_sync(full, stop);
    const int last = stops ? __ffs(stops) - 1 : 31;
    // fold the window from its oldest read descriptor to its newest
    Seg acc = Seg{0, 0};
    for (int l = last; l >= 0; --l) {
      const unsigned long long dl = __shfl_sync(full, d, l);
      acc = combine(acc, unpack(dl));
    }
    run = combine(acc, run);
    if (stops) return run;
  }
}

// The L key lanes of a row (ops/kmer.py encode_lanes): two rows are one key
// when every lane is equal. L = 1, 2, 3: the pointers by value, their count
// known at compile time.
template <int L>
struct Lanes {
  const int64_t* p[L];
  __device__ static constexpr int size() { return L; }
};

// Any number of lanes: a device array of n lane pointers (written by the
// caller on the launch's stream before the launch), their count read at run
// time.
template <>
struct Lanes<0> {
  const int64_t* const* p;
  int n;
  __device__ int size() const { return n; }
};

template <int L>
__global__ void __launch_bounds__(THREADS)
run_length_scan(Lanes<L> keys, const int32_t* __restrict__ vals,
                int32_t* __restrict__ out, int64_t n,
                unsigned long long* __restrict__ scratch, int vec) {
  __shared__ int64_t skey[kslot(TILE) + 1];
  __shared__ Seg wsum[33];
  __shared__ long long s_tile;
  __shared__ Seg s_prefix;
  unsigned long long* desc = scratch + 1;

  if (threadIdx.x == 0)
    s_tile = (long long)atomicAdd(scratch, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const int64_t base = tile * TILE;
  const int rows = n - base < TILE ? (int)(n - base) : TILE;
  const bool full = vec && rows == TILE;
  const int j0 = threadIdx.x * ITEMS;    // this thread's first row

  // one lane at a time through shared memory: bit t of `dprev` (`dnext`)
  // says row j0 + t differs from the row before (after) it in some lane;
  // each thread's ITEMS values, 16-byte aligned and contiguous, go straight
  // into registers with the first lane (the loop is unrolled for L = 1-3,
  // and runs as a loop for L = 0, where the count is known at run time only)
  int v[ITEMS];
  unsigned dprev = 0, dnext = 0;
#pragma unroll
  for (int l = 0; l < keys.size(); ++l) {
    const int64_t* __restrict__ lane = keys.p[l];
    if (l > 0) __syncthreads();        // every read of the last lane is done
    if (full) {
      const longlong2* k2 = reinterpret_cast<const longlong2*>(lane + base);
#pragma unroll
      for (int c = 0; c < ITEMS / 2; ++c) {
        const int i = threadIdx.x + c * THREADS;
        const longlong2 x = k2[i];
        skey[kslot(2 * i)] = x.x;
        skey[kslot(2 * i + 1)] = x.y;
      }
      if (l == 0) {
        const int4* v4 = reinterpret_cast<const int4*>(vals + base + j0);
#pragma unroll
        for (int c = 0; c < ITEMS / 4; ++c) {
          const int4 x = v4[c];
          v[4 * c] = x.x;
          v[4 * c + 1] = x.y;
          v[4 * c + 2] = x.z;
          v[4 * c + 3] = x.w;
        }
      }
    } else {
      for (int j = threadIdx.x; j < TILE; j += THREADS)
        skey[kslot(j)] = j < rows ? lane[base + j] : 0;
      if (l == 0) {
#pragma unroll
        for (int t = 0; t < ITEMS; ++t)
          v[t] = j0 + t < rows ? vals[base + j0 + t] : 0;
      }
    }
    // the key before the tile; the key after it (a short tile is the
    // last, and the loop above left 0 after its rows)
    if (threadIdx.x == 0) skey[0] = base > 0 ? lane[base - 1] : 0;
    if (threadIdx.x == 1 && rows == TILE)
      skey[kslot(TILE)] = base + TILE < n ? lane[base + TILE] : 0;
    __syncthreads();

    // this thread's ITEMS consecutive rows of the lane
    int64_t k[ITEMS];
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) k[t] = skey[kslot(j0 + t)];
    const int64_t before = skey[j0 == 0 ? 0 : kslot(j0 - 1)];
    const int64_t after = skey[kslot(j0 + ITEMS)];
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int64_t prev = t == 0 ? before : k[t - 1];
      const int64_t next = t == ITEMS - 1 ? after : k[t + 1];
      dprev |= (unsigned)(k[t] != prev) << t;
      dnext |= (unsigned)(k[t] != next) << t;
    }
  }

  // run starts and ends as bit masks
  unsigned starts = 0, ends = 0;
  Seg agg = Seg{0, 0};
#pragma unroll
  for (int t = 0; t < ITEMS; ++t) {
    const int j = j0 + t;
    if (j < rows) {
      const bool s = (base + j == 0) || ((dprev >> t) & 1);
      const bool e = (base + j == n - 1) || ((dnext >> t) & 1);
      starts |= (unsigned)s << t;
      ends |= (unsigned)e << t;
      agg = combine(agg, Seg{s, v[t]});
    }
  }
  Seg total;
  Seg run = block_exclusive_scan<THREADS>(agg, wsum, &total);

  // run ends get the run's sum, other rows 0: each thread's ITEMS outputs
  // as 16-byte stores
  auto emit = [&](Seg r) {
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      r = combine(r, Seg{(int)((starts >> t) & 1), v[t]});
      v[t] = (ends >> t) & 1 ? r.sum : 0;
    }
    if (full) {
      int4* o4 = reinterpret_cast<int4*>(out + base + j0);
#pragma unroll
      for (int c = 0; c < ITEMS / 4; ++c)
        o4[c] = make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < ITEMS; ++t)
        if (j0 + t < rows) out[base + j0 + t] = v[t];
    }
  };
  // a run starts in this tile before this thread's rows: they need no carry
  // and are written before the look-back
  const bool carried = run.flag == 0;
  if (!carried) emit(run);

  // publish the aggregate, learn the prefix from the predecessors, publish
  // the inclusive prefix
  if (threadIdx.x < 32) {
    Seg prefix = Seg{0, 0};
    if (tile == 0) {
      if (threadIdx.x == 0) store_desc(desc, pack(PREFIX, total));
    } else {
      if (threadIdx.x == 0) store_desc(desc + tile, pack(AGGREGATE, total));
      prefix = look_back(desc, tile);
      if (threadIdx.x == 0)
        store_desc(desc + tile, pack(PREFIX, combine(prefix, total)));
    }
    if (threadIdx.x == 0) s_prefix = prefix;
  }
  __syncthreads();
  if (carried) emit(combine(s_prefix, run));
}

// keys_aligned: every lane pointer is 16-byte aligned.
template <int L>
int launch(Lanes<L> keys, int keys_aligned, const void* vals, void* out,
           void* scratch, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t ntiles = (n + TILE - 1) / TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(ntiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const int vec = keys_aligned && ((uintptr_t)vals % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  run_length_scan<L><<<(unsigned)ntiles, THREADS, 0, st>>>(
      keys, static_cast<const int32_t*>(vals), static_cast<int32_t*>(out), n,
      static_cast<unsigned long long*>(scratch), vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows a CTA scans.
int kmtpu_run_length_tile() { return TILE; }

// Keys of L = 1, 2 or 3 int64 lanes k0..k[L-1], each [n], sorted
// lexicographically so equal keys are adjacent (unused lane pointers are
// ignored); vals [n] int32, out [n] int32, scratch [1 + ceil(n /
// kmtpu_run_length_tile())] 64-bit words (zeroed here, on the stream).
// Launches on `stream` and returns the first CUDA error (0 = launched), or
// -1 for another L (kmtpu_run_length_sums_lanes takes any L).
int kmtpu_run_length_sums(int L, const void* k0, const void* k1,
                          const void* k2, const void* vals, void* out,
                          void* scratch, int64_t n, void* stream) {
  const int64_t* a = static_cast<const int64_t*>(k0);
  const int64_t* b = static_cast<const int64_t*>(k1);
  const int64_t* c = static_cast<const int64_t*>(k2);
  const int al = (uintptr_t)a % 16 == 0;
  switch (L) {
    case 1:
      return launch<1>(Lanes<1>{{a}}, al, vals, out, scratch, n, stream);
    case 2:
      return launch<2>(Lanes<2>{{a, b}}, al && (uintptr_t)b % 16 == 0, vals,
                       out, scratch, n, stream);
    case 3:
      return launch<3>(Lanes<3>{{a, b, c}},
                       al && (uintptr_t)b % 16 == 0 && (uintptr_t)c % 16 == 0,
                       vals, out, scratch, n, stream);
    default: return -1;
  }
}

// Keys of any L >= 1 int64 lanes: lane_ptrs is a DEVICE array of L lane
// pointers (each lane [n], as above), written on `stream` before this call;
// lanes_aligned says every lane pointer is 16-byte aligned. The other
// arguments and the result are those of kmtpu_run_length_sums; -1 for
// L < 1.
int kmtpu_run_length_sums_lanes(int L, const void* lane_ptrs,
                                int lanes_aligned, const void* vals,
                                void* out, void* scratch, int64_t n,
                                void* stream) {
  if (L < 1) return -1;
  return launch<0>(
      Lanes<0>{static_cast<const int64_t* const*>(lane_ptrs), L},
      lanes_aligned, vals, out, scratch, n, stream);
}

}  // extern "C"
