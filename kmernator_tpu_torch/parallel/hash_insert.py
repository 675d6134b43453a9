"""Open-addressing hash-table insert: the port of pallas_hash.py.

`hash_insert(keys, cap)` keeps the contract of
kmernator_tpu/parallel/pallas_hash.py `hash_insert`: insert every key into a
fresh table of `cap` slots (a power of two) by linear probing from
h0 = (key * 2654435761 mod 2^32) & (cap - 1), a new key with count 1 and a
key already present one more, and return (table_keys [cap], table_counts
[cap], n_unique [1]); an empty slot holds 0xFFFFFFFF. Keys are the port's
words: a 1-D contiguous int64 tensor with values in [0, 2^32). The outputs
are int64.

This is the experiment behind the repo's choice of a sort-shaped k-mer
counter (`device_spectrum.count_batch`) over a hash-shaped one; it is not
on FilterReads' path. Run its bench, the counterpart of the JAX module's:

    KMTPU_HASH_BENCH=1 python -m kmernator_tpu_torch.parallel.hash_insert \
        [--device cuda|cpu]

On a CUDA tensor the wrapper makes one call into csrc/hash_insert.cu,
which launches three hand-written kernels on the current stream: a clear
of the table, the insert (one thread a key; a slot is one 64-bit word, the
key in the low half and the count in the high half, as `pack_slots` lays
it out; a plain load, then one atomic where the load finds the key or an
empty slot) and an unpack of the slots into the int64 outputs
(`unpack_slots`). On a CPU
tensor it takes `hash_insert_plain`, a serial transcription of the JAX
kernel, bit-equal to it in all three outputs. Nothing else chooses between
them, and a failed build or launch raises.

Where the two differ from each other or from the JAX function:

- **Layout.** The kernel inserts in parallel, so which key of a cluster
  sits in which slot depends on timing. It is held to the serial version
  through `check_invariants`, which does not depend on the order:
  `n_unique`, the set of occupied slots, each distinct key in exactly one
  slot with its exact count, and every slot from a key's home to its slot
  occupied.
- **The empty sentinel as a key.** A key of 0xFFFFFFFF is new on every
  occurrence in the JAX kernel: `n_unique` grows by one each time, and it
  writes count 1 into the first empty slot of its chain, which still reads
  as empty and which a later key may take. The plain version does the same,
  bit for bit. The kernel counts each occurrence as new and writes nothing:
  no probe reads an empty slot's count, so every output but the counts of
  empty slots agrees. When no empty slot is left the JAX loop never ends;
  both versions here count the key and write nothing.
- **Overflow.** More distinct keys (other than the sentinel) than `cap`:
  the JAX loop never ends. Here every probe chain stops after `cap` slots
  and both versions raise ValueError naming the number of keys and `cap`.
- **Arguments.** A `cap` that is not a power of two in [1, 2^32], keys
  outside [0, 2^32), and input that is not 1-D, int64 and contiguous raise
  ValueError or TypeError (the JAX function asserts on `cap`).
- **At most 2^32 - 1 keys.** A packed slot's count has 32 bits, so both
  versions raise ValueError for 2^32 keys or more. The JAX kernel's counts
  are u32 too, and wrap there.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch

EMPTY = 0xFFFFFFFF
GOLDEN = 2654435761
MAX_CAP = 1 << 32
MAX_KEYS = 1 << 32    # a packed slot's count holds at most 2^32 - 1
EMPTY_SLOT = EMPTY    # the packed empty slot: key 0xFFFFFFFF, count 0

launches = 0          # kernel launches made by hash_insert on CUDA tensors

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from kmernator_tpu_torch.kernels.build import load
        lib = load("hash_insert")
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.kmtpu_hash_insert.argtypes = [P, I64, P, P, I64, P, P, P, P, P]
        lib.kmtpu_hash_insert.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_args(keys: torch.Tensor, cap: int) -> None:
    if not (isinstance(cap, (int, np.integer)) and 1 <= cap <= MAX_CAP
            and cap & (cap - 1) == 0):
        raise ValueError("cap must be a power of two in [1, 2^32], got %r"
                         % (cap,))
    if keys.dtype != torch.int64:
        raise TypeError("hash_insert takes int64 keys, got %s" % keys.dtype)
    if keys.dim() != 1:
        raise ValueError("hash_insert takes a 1-D key tensor, got shape %s"
                         % (tuple(keys.shape),))
    if not keys.is_contiguous():
        raise ValueError("hash_insert takes a contiguous key tensor")
    if keys.numel() >= MAX_KEYS:
        raise ValueError("hash_insert takes fewer than 2^32 keys (a slot's "
                         "count is 32 bits), got %d" % keys.numel())


def _overflow(n: int, cap: int) -> ValueError:
    return ValueError("hash_insert: %d keys hold more distinct keys than "
                      "the cap = %d slots of the table" % (n, cap))


def _out_of_range() -> ValueError:
    return ValueError("hash_insert takes keys in [0, 2^32)")


def hash_insert_plain(keys: torch.Tensor, cap: int):
    """Plain version: the JAX kernel's serial insert, one key after another,
    on Python integers. Bit-equal to the JAX function in all three outputs;
    raises where the JAX loop would never end (see the module docstring)."""
    _check_args(keys, cap)
    ks = keys.tolist()
    if ks and (min(ks) < 0 or max(ks) > EMPTY):
        raise _out_of_range()
    mask = cap - 1
    tk = [EMPTY] * cap
    tc = [0] * cap
    n_new = 0
    for key in ks:
        h = (key * GOLDEN) & mask
        for _ in range(cap):
            slot = tk[h]
            if slot == key or slot == EMPTY:
                break
            h = (h + 1) & mask
        else:                       # cap slots, none free, none the key
            if key != EMPTY:
                raise _overflow(len(ks), cap)
            n_new += 1              # the sentinel is new; nowhere to write
            continue
        is_new = tk[h] == EMPTY
        tk[h] = key
        tc[h] = 1 if is_new else tc[h] + 1
        n_new += is_new
    dev = keys.device
    return (torch.tensor(tk, dtype=torch.int64, device=dev),
            torch.tensor(tc, dtype=torch.int64, device=dev),
            torch.tensor([n_new], dtype=torch.int64, device=dev))


def hash_insert_launch(keys: torch.Tensor, cap: int, events=None):
    """The kernels alone, on a CUDA tensor: (tk, tc, n_unique, status),
    with nothing waited for. status [2] int32 is (overflow, a key out of
    range); `raise_on_status` reads it. `hash_insert` is this plus that
    check; the bench chains launches and checks once at the end. `events`,
    four CUDA events or None, are recorded before the clear, after it,
    after the insert and after the unpack, to time the three apart; the
    kernels' call records the middle two."""
    global launches
    _check_args(keys, cap)
    if keys.device.type != "cuda":
        raise ValueError("hash_insert_launch takes a CUDA tensor, got %s"
                         % keys.device)
    lib = _kernel_lib()
    dev = keys.device
    tk = torch.empty(cap, dtype=torch.int64, device=dev)
    tc = torch.empty(cap, dtype=torch.int64, device=dev)
    n = torch.empty(1, dtype=torch.int64, device=dev)
    status = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if events is not None:
            # recording creates each event; the first is recorded last, so
            # that no host work of the others lies inside the clear's time
            for ev in events[::-1]:
                ev.record(stream)
        err = lib.kmtpu_hash_insert(
            keys.data_ptr(), keys.numel(), tk.data_ptr(), tc.data_ptr(), cap,
            n.data_ptr(), status.data_ptr(),
            None if events is None else events[1].cuda_event,
            None if events is None else events[2].cuda_event,
            stream.cuda_stream)
        if err == 0 and events is not None:
            events[3].record(stream)
    if err != 0:
        raise RuntimeError("hash_insert kernel launch failed: CUDA error %d"
                           % err)
    launches += 1
    return tk, tc, n, status


def raise_on_status(status: torch.Tensor, n_keys: int, cap: int) -> None:
    """Raise what the kernel flagged in `status` (waits for the card)."""
    overflow, out_of_range = (int(x) for x in status.tolist())
    if out_of_range:
        raise _out_of_range()
    if overflow:
        raise _overflow(n_keys, cap)


def hash_insert(keys: torch.Tensor, cap: int):
    """keys [N] int64 in [0, 2^32), cap a power of two -> (table_keys [cap],
    table_counts [cap], n_unique [1]), all int64. Raises ValueError when the
    keys hold more than cap distinct keys."""
    _check_args(keys, cap)
    if keys.device.type == "cpu":
        return hash_insert_plain(keys, cap)
    if keys.device.type == "cuda":
        tk, tc, n, status = hash_insert_launch(keys, cap)
        raise_on_status(status, keys.numel(), cap)
        return tk, tc, n
    raise ValueError("hash_insert has no kernel for device %s" % keys.device)


def pack_slots(tk: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
    """The kernel's slot layout in plain PyTorch: int64 slot keys and
    counts (counts < 2^31 here) -> one int64 word a slot, count << 32 |
    key. An empty slot with count 0 is EMPTY_SLOT."""
    return (tc << 32) | tk


def unpack_slots(slots: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed slots -> (slot keys, slot counts), int64: what the kernel's
    last launch does in place."""
    return slots & EMPTY, (slots >> 32) & EMPTY


def home_slots(keys: np.ndarray, cap: int) -> np.ndarray:
    """h0 of each key (numpy, keys in [0, 2^32)) as int64. The product is
    taken mod 2^64, which keeps its low 32 bits exact."""
    k = np.asarray(keys).astype(np.uint64)
    return ((k * np.uint64(GOLDEN)) & np.uint64(cap - 1)).astype(np.int64)


def occupied_slots(distinct: np.ndarray, cap: int) -> np.ndarray:
    """[cap] bool: the slots that linear probing fills with these distinct
    keys (no sentinel, at most cap of them) in any insertion order. Computed
    in rounds: every waiting key tries its slot, one key takes each free
    slot tried, and the rest step on."""
    if distinct.size > cap:
        raise ValueError("%d distinct keys do not fit in %d slots"
                         % (distinct.size, cap))
    occ = np.zeros(cap, bool)
    h = home_slots(distinct, cap)
    while h.size:
        free = ~occ[h]
        taken, first = np.unique(h[free], return_index=True)
        occ[taken] = True
        stay = np.ones(h.size, bool)
        stay[np.flatnonzero(free)[first]] = False
        h = (h[stay] + 1) & (cap - 1)
    return occ


def check_invariants(keys, cap: int, tk, tc, n) -> int:
    """Hold one insert's outputs to np.unique through four checks that do
    not depend on the insertion order, and raise AssertionError on the
    first that fails:

    1. n_unique is the number of distinct keys other than the sentinel
       plus the number of sentinel occurrences;
    2. the occupied slots (key != 0xFFFFFFFF) are the ones linear probing
       fills in any order (`occupied_slots`);
    3. every distinct key other than the sentinel occupies exactly one
       slot, whose count is the key's count;
    4. every slot from a key's home slot to its slot, cyclically, is
       occupied.

    Takes tensors or numpy arrays; returns the largest absolute difference
    between a slot's count and its key's count (0 when all four hold).
    """
    def as_np(x):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.asarray(x).astype(np.int64)

    keys, tk, tc = as_np(keys).reshape(-1), as_np(tk), as_np(tc)
    n = int(as_np(n).reshape(-1)[0])
    if tk.shape != (cap,) or tc.shape != (cap,):
        raise AssertionError("table shapes %s, %s, expected (%d,)"
                             % (tk.shape, tc.shape, cap))
    real = keys[keys != EMPTY]
    want_k, want_c = np.unique(real, return_counts=True)
    if want_k.size > cap:
        raise AssertionError("%d distinct keys cannot fit in %d slots"
                             % (want_k.size, cap))
    want_n = want_k.size + (keys.size - real.size)
    if n != want_n:
        raise AssertionError("1: n_unique %d, expected %d" % (n, want_n))
    occ = tk != EMPTY
    if not np.array_equal(occ, occupied_slots(want_k, cap)):
        raise AssertionError("2: the occupied slots differ from linear "
                             "probing's (%d occupied, %d expected)"
                             % (occ.sum(), want_k.size))
    slots = np.flatnonzero(occ)
    order = np.argsort(tk[slots], kind="stable")
    got_k, got_c = tk[slots][order], tc[slots][order]
    if not np.array_equal(got_k, want_k):
        raise AssertionError("3: the table's keys are not the distinct keys "
                             "once each")
    err = int(np.abs(got_c - want_c).max()) if got_c.size else 0
    if err:
        raise AssertionError("3: counts differ from np.unique's by up to %d"
                             % err)
    d = (slots - home_slots(tk[slots], cap)) & (cap - 1)
    run = np.concatenate([[0], np.cumsum(np.concatenate([occ, occ]))])
    h0 = slots - d
    h0[h0 < 0] += cap
    if not np.array_equal(run[h0 + d + 1] - run[h0], d + 1):
        raise AssertionError("4: a key sits past an empty slot of its chain")
    return err


def edge_cases() -> Dict[str, Tuple[np.ndarray, int]]:
    """name -> (int64 keys, cap): the cases the CPU tests, the card tests
    and chip_smoke.py hold each version to."""
    rng = np.random.default_rng(3)
    home_last = [k for k in range(1 << 16) if (k * GOLDEN) & 63 == 63][:5]
    full = rng.permutation(np.repeat(rng.choice(1 << 20, 64, replace=False),
                                     3))
    mixed = rng.integers(0, 50, 300)
    mixed[rng.random(300) < 0.2] = EMPTY
    mixed[:3] = [0, EMPTY, 0]
    n16, n_distinct = 1 << 16, int(0.9 * (1 << 16))
    distinct = rng.choice(EMPTY, n_distinct, replace=False)
    load = rng.permutation(np.concatenate(
        [distinct, distinct[rng.integers(0, n_distinct, n16 - n_distinct)]]))
    cases = {
        "jax_test": (np.random.default_rng(1).integers(0, 500, 4096), 2048),
        "n0": (np.zeros(0), 8),
        "n1": (np.array([123456789]), 8),
        "all_equal": (np.full(1000, 77), 64),
        "full_table": (full, 64),
        "wraparound": (rng.permutation(np.repeat(home_last, 4)), 64),
        "sentinel_quirk": (np.array([5, EMPTY, 5, EMPTY, 0, 7]), 8),
        "sentinel_mixed": (mixed, 128),
        "cap_1": (np.full(5, 9), 1),
        "load_0.9": (load, n16),
    }
    return {k: (np.asarray(v, dtype=np.int64), c)
            for k, (v, c) in cases.items()}


def large_cases() -> Dict[str, Tuple[np.ndarray, int]]:
    """name -> (int64 keys, cap): the cases only the card runs, held to
    np.unique through `check_invariants` (the plain version's Python loop
    is too slow for them): one key 2^20 times, every thread on one slot's
    count; and 2^23 keys filling 2^22 slots to load 0.9."""
    rng = np.random.default_rng(4)
    cap = 1 << 22
    n_distinct = int(0.9 * cap)
    distinct = np.unique(rng.integers(0, EMPTY, n_distinct + n_distinct // 8))
    distinct = rng.permutation(distinct)[:n_distinct]
    n = 1 << 23
    load = rng.permutation(np.concatenate(
        [distinct, distinct[rng.integers(0, n_distinct, n - n_distinct)]]))
    return {"hot_key": (np.full(1 << 20, 2024, dtype=np.int64), 1 << 10),
            "load_0.9_2^22": (load.astype(np.int64), cap)}


def _card_label() -> str:
    """`name, power.limit` of the card as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0) + ", power limit unread"


def bench(n: int = 1 << 10, cap: int = 1 << 12, steps: int = 50,
          device: str = "cuda") -> dict:
    """The JAX module's bench: n keys drawn by default_rng(0) from
    [0, 2^16), then `steps` insert passes over keys ^ (i & 1) (the low bit
    flips every other pass; the number of distinct keys stays), run once to
    warm and once timed; the two totals of n_unique must agree.

    Timed region: the `steps` passes, each the allocation of its outputs
    and one insert (clear, insert and unpack kernels on the card), plus
    adding n_unique to a running total. On the card the passes are launched back to back
    between two CUDA events, with one synchronise after them; the overflow
    flags are checked after the timing. On the CPU, the host clock.
    """
    from kmernator_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    keys = np.random.default_rng(0).integers(0, 1 << 16, n)
    x = torch.from_numpy(keys.astype(np.int64)).to(dev)
    xs = (x, x ^ 1)
    n0 = int(hash_insert(x, cap)[2][0])

    def run():
        if dev.type == "cpu":
            return sum(int(hash_insert(xs[i & 1], cap)[2][0])
                       for i in range(steps)), []
        total = torch.zeros(1, dtype=torch.int64, device=dev)
        statuses = []
        for i in range(steps):
            _, _, nu, st = hash_insert_launch(xs[i & 1], cap)
            total += nu
            statuses.append(st)
        return total, statuses

    def check(total, statuses):
        for st in statuses:
            raise_on_status(st, n, cap)
        return int(total)

    total0 = check(*run())
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        total, statuses = run()
        stop.record()
        torch.cuda.synchronize()
        seconds = start.elapsed_time(stop) / 1e3
        total = check(total, statuses)
        where = _card_label()
    else:
        t0 = time.perf_counter()
        total = check(*run())
        seconds = time.perf_counter() - t0
        where = "cpu, plain version"
    if total != total0 or total != steps * n0:
        raise RuntimeError("hash bench: totals %d and %d, expected %d"
                           % (total0, total, steps * n0))
    return {"device": where, "n": n, "cap": cap, "steps": steps,
            "unique0": n0, "seconds": seconds,
            "mkeys_per_s": n * steps / seconds / 1e6}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kmernator_tpu_torch.parallel.hash_insert",
        description="Bench of the hash-table insert at the JAX bench's "
                    "shape (needs KMTPU_HASH_BENCH=1 when run as a module).")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    r = bench(device=ap.parse_args(argv).device)
    print("hash_insert on %s: %.3f Mkeys/s (N=%d, cap=%d, unique0=%d, "
          "%d passes in %.6f s)" % (r["device"], r["mkeys_per_s"], r["n"],
                                    r["cap"], r["unique0"], r["steps"],
                                    r["seconds"]), flush=True)
    return r


if __name__ == "__main__":
    if not os.environ.get("KMTPU_HASH_BENCH"):
        sys.exit("set KMTPU_HASH_BENCH=1 to run the hash-insert bench")
    main()
