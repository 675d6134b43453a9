// Open-addressing hash-table insert of 32-bit keys, for Hopper (sm_90a).
//
// Replaces the TPU kernel kmernator_tpu/parallel/pallas_hash.py:87
// (`hash_insert`, kernel body `_insert_kernel` :51): clear a fresh table of
// `cap` slots (cap a power of two), insert every key by linear probing from
// h0 = (key * 2654435761 mod 2^32) & (cap - 1), stepping h = (h + 1) &
// (cap - 1); a new key gets count 1, a key already present one more; return
// the slot keys (0xFFFFFFFF = empty), the slot counts and the number of new
// keys, as the port's int64 words.
//
// Keys equal to the empty sentinel 0xFFFFFFFF are counted as new on every
// occurrence and write nothing: the TPU kernel counts them the same way and
// what it writes for them (count 1 in a slot that still reads as empty) is
// never read back by a probe. A key outside [0, 2^32) sets status[1]; a
// probe chain that meets `cap` slots holding other keys (more distinct keys
// than slots) stops and sets status[0]. The wrapper reads both and raises.
//
// What bounds it: the table's random traffic. The keys stream in once (8 B
// each) and the outputs are written once (16 B a slot), but every insert
// touches the slot of a data-dependent place with an atomic: at least one
// 32-byte sector a key, which a table larger than the 50 MB L2 turns into a
// device-memory read-modify-write. The operation count (a multiply, a mask
// and a compare a probe) is negligible.
//
// Design. The TPU probes one key after another on its scalar core: that
// serial order is why it needs no atomics. Here every key is its own thread
// (grid-stride), and atomics take the place of the serial order. A slot is
// one 64-bit word, the key in the low half and its count in the high half;
// empty is key 0xFFFFFFFF with count 0. So an insert touches one sector of
// one array, and the table is half the bytes of separate key and count
// arrays (2^22 slots: 32 MiB, inside the L2). A thread walks its chain with
// a plain load first (through L2: atomics live there):
//   - another key: step on, no atomic (slots only ever go from empty to a
//     key, so a key once seen in a slot stays);
//   - this key: one atomicAdd of 1 << 32, the count half;
//   - empty: one atomicCAS empty -> (key, 1); if it fails, the key it
//     returns decides: this key takes one atomicAdd, another steps on.
// A key whose first load finds its key or an empty slot that it wins makes
// one atomic. Two threads with one key follow the same chain and meet at
// one slot, and the set of occupied slots is the one any serial order gives
// (linear probing without deletions). Which key sits in which slot of a
// cluster depends on the order, so the result is held to the serial
// version through order-free invariants, not bit by bit. New keys are
// counted with one atomic a warp (__ballot_sync, __popc). A count holds at
// most 2^32 - 1, so the wrapper refuses 2^32 keys or more.
//
// Three launches on one stream, from one host call: the clear (8 B a slot)
// writes the packed table into `tk`; the insert; the unpack splits each
// slot in place into the int64 `tk` and `tc` that the contract returns.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 16;
constexpr uint32_t EMPTY_KEY = 0xFFFFFFFFu;
constexpr unsigned long long EMPTY_SLOT = EMPTY_KEY;   // count 0
constexpr unsigned long long ONE = 1ull << 32;         // count 1
constexpr uint32_t GOLDEN = 2654435761u;

__global__ void __launch_bounds__(THREADS)
clear_slots(unsigned long long* __restrict__ slots, int64_t cap,
            unsigned long long* __restrict__ n_unique,
            int32_t* __restrict__ status) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < cap;
       i += stride)
    slots[i] = EMPTY_SLOT;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    n_unique[0] = 0;
    status[0] = 0;
    status[1] = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
insert_keys(const int64_t* __restrict__ keys, int64_t n,
            unsigned long long* slots, int64_t cap,
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
      if (key < 0 || key > (int64_t)EMPTY_KEY) {
        atomicOr(&status[1], 1);
      } else if (key == (int64_t)EMPTY_KEY) {
        is_new = true;
      } else {
        const uint32_t k = (uint32_t)key;
        uint32_t h = (k * GOLDEN) & mask;
        for (int64_t probes = 1;; ++probes) {
          uint32_t held = (uint32_t)__ldcg(&slots[h]);
          if (held == EMPTY_KEY) {
            const unsigned long long old =
                atomicCAS(&slots[h], EMPTY_SLOT, ONE | k);
            if (old == EMPTY_SLOT) {
              is_new = true;
              break;
            }
            held = (uint32_t)old;
          }
          if (held == k) {
            atomicAdd(&slots[h], ONE);
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

// slots (in tk) -> tk = key, tc = count, in place.
__global__ void __launch_bounds__(THREADS)
unpack_slots(unsigned long long* __restrict__ tk,
             unsigned long long* __restrict__ tc, int64_t cap) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < cap;
       i += stride) {
    const unsigned long long s = tk[i];
    tk[i] = s & 0xFFFFFFFFull;
    tc[i] = s >> 32;
  }
}

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < MAX_BLOCKS ? (blocks > 0 ? blocks : 1)
                                        : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// keys [n] int64, n < 2^32; tk, tc [cap] int64 (written whole); n_unique
// [1] int64; status [2] int32 (overflow, key out of range); cap a power of
// two in [1, 2^32]. Launches the clear, the insert and the unpack on
// `stream`; `cleared` and `inserted`, cudaEvent_t or null, are recorded
// after the first two. Returns the first CUDA error (0 = launched).
int kmtpu_hash_insert(const void* keys, int64_t n, void* tk, void* tc,
                      int64_t cap, void* n_unique, void* status,
                      void* cleared, void* inserted, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* slots = static_cast<unsigned long long*>(tk);
  auto* nu = static_cast<unsigned long long*>(n_unique);
  auto* flags = static_cast<int32_t*>(status);
  clear_slots<<<grid_for(cap), THREADS, 0, st>>>(slots, cap, nu, flags);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && cleared != nullptr)
    err = cudaEventRecord(static_cast<cudaEvent_t>(cleared), st);
  if (err == cudaSuccess && n > 0) {
    insert_keys<<<grid_for(n), THREADS, 0, st>>>(
        static_cast<const int64_t*>(keys), n, slots, cap, nu, flags);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && inserted != nullptr)
    err = cudaEventRecord(static_cast<cudaEvent_t>(inserted), st);
  if (err != cudaSuccess) return (int)err;
  unpack_slots<<<grid_for(cap), THREADS, 0, st>>>(
      slots, static_cast<unsigned long long*>(tc), cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
