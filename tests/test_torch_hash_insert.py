"""Hash-table insert of kmernator_tpu_torch against the Pallas kernel.

The port's plain version (what a CPU tensor takes) must be bit-equal to the
JAX `hash_insert` run in interpret mode in all three outputs (slot keys,
slot counts, n_unique). The CUDA kernel inserts in parallel, so its layout
differs; it is held to the plain version through the order-free invariants
of `check_invariants` by tests/test_torch_cuda.py and chip_smoke.py, and
this file checks that the invariants hold for any insertion order and fail
on broken tables. Tolerance: none, integers.

Each test runs under the suite's one time limit (the repository's root
conftest.py); the bench's subprocess has a timeout of its own.
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.parallel.pallas_hash import hash_insert as jax_hash_insert
from kmernator_tpu_torch.parallel import hash_insert as hi

from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = hi.edge_cases()
JAX_CASES = ["jax_test", "n1", "all_equal", "full_table", "wraparound",
             "sentinel_quirk", "sentinel_mixed", "cap_1"]


def _plain(keys, cap):
    return hi.hash_insert_plain(torch.from_numpy(keys), cap)


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_bit_equal_to_jax(name):
    keys, cap = CASES[name]
    want = jax_hash_insert(jnp.asarray(keys.astype(np.uint32)), cap,
                           interpret=True)
    got = _plain(keys, cap)
    for w, g in zip(want, got):
        assert g.dtype == torch.int64
        assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy())
    assert hi.check_invariants(keys, cap, *got) == 0


def test_sentinel_quirk_and_full_table_values():
    """What the JAX kernel gives on the cases named in its contract."""
    keys, cap = CASES["sentinel_quirk"]
    tk, tc, n = _plain(keys, cap)
    assert int(n[0]) == 5
    # each sentinel is new and writes count 1 into a slot that stays empty
    keys = np.array([hi.EMPTY, hi.EMPTY])
    want = jax_hash_insert(jnp.asarray(keys.astype(np.uint32)), 4,
                           interpret=True)
    tk, tc, n = _plain(keys, 4)
    assert tk.tolist() == [hi.EMPTY] * 4 and sorted(tc.tolist()) == [0, 0,
                                                                     0, 1]
    assert n.tolist() == [2]
    for w, g in zip(want, (tk, tc, n)):
        assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy())
    keys, cap = CASES["full_table"]
    assert int(_plain(keys, cap)[2][0]) == cap
    keys, cap = CASES["wraparound"]
    homes = hi.home_slots(keys, cap)
    assert (homes == cap - 1).all()
    tk = _plain(keys, cap)[0].numpy()
    assert set(np.flatnonzero(tk != hi.EMPTY)) == {63, 0, 1, 2, 3}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_wrapper_is_plain_and_invariants_hold(name):
    keys, cap = CASES[name]
    before = hi.launches
    got = hi.hash_insert(torch.from_numpy(keys), cap)
    assert hi.launches == before     # the CPU path launches no kernel
    for a, b in zip(got, _plain(keys, cap)):
        assert torch.equal(a, b)
    assert hi.check_invariants(keys, cap, *got) == 0


@pytest.mark.parametrize("name", ["jax_test", "full_table", "wraparound",
                                  "sentinel_mixed", "load_0.9"])
def test_invariants_hold_for_any_insertion_order(name):
    """Another order gives another layout but passes the same checks."""
    keys, cap = CASES[name]
    order = np.random.default_rng(9).permutation(keys.size)
    tk, tc, n = _plain(keys[order], cap)
    assert hi.check_invariants(keys, cap, tk, tc, n) == 0
    assert np.array_equal(tk.numpy() != hi.EMPTY,
                          _plain(keys, cap)[0].numpy() != hi.EMPTY)


def test_invariants_fail_on_broken_tables():
    keys, cap = CASES["jax_test"]
    tk, tc, n = (x.numpy() for x in _plain(keys, cap))
    occ = np.flatnonzero(tk != hi.EMPTY)

    def fails(check, tk2=tk, tc2=tc, n2=n):
        with pytest.raises(AssertionError, match="^%s:" % check):
            hi.check_invariants(keys, cap, tk2, tc2, n2)

    fails("1", n2=n + 1)
    c2 = tc.copy()
    c2[occ[0]] += 1
    fails("3", tc2=c2)
    k2 = tk.copy()
    k2[occ[1]] = k2[occ[0]]               # one key twice, another missing
    fails("3", tk2=k2)
    k2[occ[1]] = 1234567                  # a key not in the input
    fails("3", tk2=k2)
    # move the last key of a cluster one empty slot further on
    e = next(int(s) for s in np.flatnonzero(tk == hi.EMPTY)
             if tk[(s + 1) % cap] == hi.EMPTY and tk[s - 1] != hi.EMPTY)
    k3, c3 = tk.copy(), tc.copy()
    k3[(e + 1) % cap], c3[(e + 1) % cap] = tk[e - 1], tc[e - 1]
    k3[e - 1], c3[e - 1] = hi.EMPTY, 0
    fails("2", k3, c3)


def test_invariant_4_alone():
    """A table whose occupied set is right but whose keys sit before their
    home slot fails check 4 and no other."""
    keys = np.array([[k for k in range(1 << 16)
                      if (k * hi.GOLDEN) & 7 == h][0] for h in (2, 5)])
    cap = 8
    tk, tc, n = (x.numpy() for x in _plain(keys, cap))
    assert set(np.flatnonzero(tk != hi.EMPTY)) == {2, 5}
    k2 = tk.copy()
    k2[2], k2[5] = tk[5], tk[2]
    with pytest.raises(AssertionError, match="^4:"):
        hi.check_invariants(keys, cap, k2, tc[[0, 1, 5, 3, 4, 2, 6, 7]], n)


def test_argument_checks_and_overflow():
    keys = torch.arange(10, dtype=torch.int64)
    for cap in (0, 3, 12, 1 << 33, 2.0):
        with pytest.raises(ValueError, match="power of two"):
            hi.hash_insert(keys, cap)
    for bad in ([-1, 2], [0, 1 << 32]):
        with pytest.raises(ValueError, match=r"\[0, 2\^32\)"):
            hi.hash_insert(torch.tensor(bad, dtype=torch.int64), 8)
    with pytest.raises(TypeError):
        hi.hash_insert(keys.to(torch.int32), 16)
    with pytest.raises(ValueError, match="1-D"):
        hi.hash_insert(keys.view(2, 5), 16)
    with pytest.raises(ValueError, match="contiguous"):
        hi.hash_insert(torch.arange(20, dtype=torch.int64)[::2], 16)
    # more distinct keys than slots: JAX would never end; both versions raise
    with pytest.raises(ValueError, match=r"10 keys .* cap = 8"):
        hi.hash_insert(keys, 8)
    with pytest.raises(ValueError, match=r"10 keys .* cap = 8"):
        hi.hash_insert_plain(keys, 8)
    # the sentinel after a full table: counted, written nowhere, no raise
    tk, tc, n = hi.hash_insert(torch.tensor([3, hi.EMPTY]), 1)
    assert tk.tolist() == [3] and tc.tolist() == [1] and n.tolist() == [2]


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_slots_hold_the_plain_tables(name):
    """The kernel's slot layout, in plain PyTorch, round-trips the plain
    version's outputs; an empty slot packs to EMPTY_SLOT where the JAX
    sentinel quirk left no count in it."""
    keys, cap = CASES[name]
    tk, tc, _ = _plain(keys, cap)
    slots = hi.pack_slots(tk, tc)
    assert slots.dtype == torch.int64
    back = hi.unpack_slots(slots)
    assert torch.equal(back[0], tk) and torch.equal(back[1], tc)
    assert torch.equal(slots & hi.EMPTY, tk)
    empty = tk == hi.EMPTY
    if not (keys == hi.EMPTY).any():
        assert bool((slots[empty] == hi.EMPTY_SLOT).all())
    assert torch.equal(slots[~empty] >> 32, tc[~empty])


def test_key_limit_without_building_the_keys():
    """2^32 keys or more raise before any work: a meta tensor has the
    shape and no storage."""
    many = torch.empty(hi.MAX_KEYS, dtype=torch.int64, device="meta")
    for call in (hi.hash_insert, hi.hash_insert_plain, hi.hash_insert_launch):
        with pytest.raises(ValueError, match=r"fewer than 2\^32 keys"):
            call(many, 8)
    # one key fewer passes the limit and stops at the device instead
    with pytest.raises(ValueError, match="no kernel for device meta"):
        hi.hash_insert(many[1:], 8)


BENCH = r"""
import runpy, sys
sys.argv = ["hash_insert", "--device", "cpu"]
runpy.run_module("kmernator_tpu_torch.parallel.hash_insert",
                 run_name="__main__", alter_sys=True)
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "kmernator_tpu")))
"""


def test_bench_entry_point_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, KMTPU_HASH_BENCH="1", **ONE_THREAD)
    proc = subprocess.run([sys.executable, "-c", BENCH], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "hash_insert on cpu, plain version:" in proc.stdout
    assert "Mkeys/s (N=1024, cap=4096, unique0=" in proc.stdout
    assert "LOADED []" in proc.stdout
    # without the switch it refuses, as the JAX module does nothing
    env.pop("KMTPU_HASH_BENCH")
    proc = subprocess.run([sys.executable, "-m",
                           "kmernator_tpu_torch.parallel.hash_insert",
                           "--device", "cpu"], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "KMTPU_HASH_BENCH=1" in proc.stderr


def test_bench_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hi.bench(device="cuda")
