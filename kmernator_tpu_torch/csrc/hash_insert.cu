// Open-addressing hash-table insert of 32-bit keys, for Hopper (sm_90a).
//
// Replaces the TPU kernel kmernator_tpu/parallel/pallas_hash.py:87
// (`hash_insert`, kernel body `_insert_kernel` :51): clear a fresh table of
// `cap` slots (cap a power of two), insert every key by linear probing from
// h0 = (key * 2654435761 mod 2^32) & (cap - 1), stepping h = (h + 1) &
// (cap - 1); a new key gets count 1, a key already present one more; return
// the slot keys (0xFFFFFFFF = empty), the slot counts and the number of new
// keys. The outputs are the port's int64 words: the table is two int64
// arrays written in place, so no widening pass follows the insert.
//
// Keys equal to the empty sentinel 0xFFFFFFFF are counted as new on every
// occurrence and write nothing: the TPU kernel counts them the same way and
// what it writes for them (count 1 in a slot that still reads as empty) is
// never read back by a probe. A key outside [0, 2^32) sets status[1]; a
// probe chain that meets `cap` slots holding other keys (more distinct keys
// than slots) stops and sets status[0]. The wrapper reads both and raises.
//
// What bounds it: bytes, and of those the random ones. The keys stream in
// once (8 B each) and the table is written once by the clear (16 B a slot),
// but every insert is one 64-bit atomicCAS on the key array and one 64-bit
// atomicAdd on the count array at a data-dependent slot: each touches at
// least one 32-byte sector of each array, and a table larger than the 50 MB
// L2 turns each of those into a device-memory read-modify-write. The
// operation count (a multiply, a mask and a compare a probe) is negligible.
//
// Design. The TPU probes one key after another on its scalar core: that
// serial order is why it needs no atomics. Here every key is its own thread
// (grid-stride), and the compare-and-swap takes the place of the serial
// order: a thread CASes EMPTY -> key at its probe slot; if the slot held
// EMPTY the key is new, if it held the key the key is already there, and in
// both cases the thread adds one to the slot's count; otherwise it steps on.
// Slots only ever go from EMPTY to a key, so two threads with one key follow
// the same chain and meet at one slot, and the set of occupied slots is the
// one any serial order gives (linear probing without deletions). Which key
// sits in which slot of a cluster depends on the order, so the result is
// held to the serial version through order-free invariants, not bit by bit.
// New keys are counted with one atomic a warp (__ballot_sync, __popc). The
// clear is a kernel on the same stream. Nothing here caches the table in
// L2 or probes a warp at a time: right and simple first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 16;
constexpr unsigned long long EMPTY = 0xFFFFFFFFull;
constexpr uint32_t GOLDEN = 2654435761u;

__global__ void __launch_bounds__(THREADS)
clear_table(unsigned long long* __restrict__ tk,
            unsigned long long* __restrict__ tc, int64_t cap,
            unsigned long long* __restrict__ n_unique,
            int32_t* __restrict__ status) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < cap;
       i += stride) {
    tk[i] = EMPTY;
    tc[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    n_unique[0] = 0;
    status[0] = 0;
    status[1] = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
insert_keys(const int64_t* __restrict__ keys, int64_t n,
            unsigned long long* __restrict__ tk,
            unsigned long long* __restrict__ tc, int64_t cap,
            unsigned long long* __restrict__ n_unique,
            int32_t* __restrict__ status) {
  const uint32_t mask = (uint32_t)(cap - 1);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  // the loop bound is the same for every thread of a block, so every lane
  // of a warp reaches the ballot
  for (int64_t base = (int64_t)blockIdx.x * THREADS; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    bool is_new = false;
    if (i < n) {
      const int64_t key = keys[i];
      if (key < 0 || key > (int64_t)EMPTY) {
        atomicOr(&status[1], 1);
      } else if (key == (int64_t)EMPTY) {
        is_new = true;
      } else {
        const unsigned long long k = (unsigned long long)key;
        uint32_t h = ((uint32_t)key * GOLDEN) & mask;
        for (int64_t probes = 1;; ++probes) {
          const unsigned long long old = atomicCAS(&tk[h], EMPTY, k);
          if (old == EMPTY || old == k) {
            atomicAdd(&tc[h], 1ull);
            is_new = old == EMPTY;
            break;
          }
          if (probes == cap) {
            atomicOr(&status[0], 1);
            break;
          }
          h = (h + 1) & mask;
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, is_new);
    if ((threadIdx.x & 31) == 0 && ballot != 0)
      atomicAdd(n_unique, (unsigned long long)__popc(ballot));
  }
}

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < MAX_BLOCKS ? (blocks > 0 ? blocks : 1)
                                        : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// keys [n] int64; tk, tc [cap] int64 (written whole); n_unique [1] int64;
// status [2] int32 (overflow, key out of range). cap is a power of two in
// [1, 2^32]. Launches the clear and the insert on `stream` and returns
// cudaGetLastError() (0 = launched).
int kmtpu_hash_insert(const void* keys, int64_t n, void* tk, void* tc,
                      int64_t cap, void* n_unique, void* status,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<unsigned long long*>(tk);
  auto* c = static_cast<unsigned long long*>(tc);
  auto* nu = static_cast<unsigned long long*>(n_unique);
  auto* s = static_cast<int32_t*>(status);
  clear_table<<<grid_for(cap), THREADS, 0, st>>>(k, c, cap, nu, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return (int)err;
  insert_keys<<<grid_for(n), THREADS, 0, st>>>(
      static_cast<const int64_t*>(keys), n, k, c, cap, nu, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
