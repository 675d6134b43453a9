"""Run-length counter of kmernator_tpu_torch against the Pallas kernel.

The port's plain version (what a CPU tensor takes) must be bit-equal to the
JAX `run_length_counts` run in interpret mode, over the cases of
tests/test_pallas_count.py. The CUDA kernel is held to the plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py. The kernel's
schedule (tiles scanned on their own, the carry found by looking back over
earlier tiles' aggregates) is held to the JAX kernel by
`run_length_schedule_plain` at tiles of a few hundred rows. Tolerance:
none, integers.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.parallel.pallas_count import (run_length_counts as
                                                 jax_run_length_counts,
                                                 run_length_counts_reference)
from kmernator_tpu_torch.ops.kmer import encode_lane
from kmernator_tpu_torch.parallel import run_length as rl

import torch_threads  # noqa: F401


def _torch_counts(hi, lo, good):
    return rl.run_length_counts(torch.from_numpy(hi.astype(np.int64)),
                                torch.from_numpy(lo.astype(np.int64)),
                                torch.from_numpy(good)).numpy()


def _case(hi, lo, good, block_rows=8):
    want = np.asarray(jax_run_length_counts(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(good),
        block_rows=block_rows, interpret=True))
    got = _torch_counts(hi, lo, good)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def _random_runs(rng, N):
    vals = np.sort(rng.integers(0, 300, N))
    hi = (vals // 7).astype(np.uint32)
    lo = (vals % 7).astype(np.uint32)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order], rng.random(N) < 0.7


def test_random_runs():
    _case(*_random_runs(np.random.default_rng(0), 4 * 8 * 128))


def test_high_bit_keys_and_cross_block_runs():
    N = 2 * 8 * 128
    hi = np.full(N, 0xDEADBEEF, np.uint32)
    lo = np.full(N, 0xFFFFFFF0, np.uint32)
    good = np.ones(N, bool)
    good[::3] = False
    _case(hi, lo, good)
    hi2 = hi.copy()
    hi2[N // 2:] = 0xDEADBEF0   # run boundary exactly at the block boundary
    _case(hi2, lo, good)


def test_all_unique():
    N = 8 * 128
    hi = np.arange(N, dtype=np.uint32)
    lo = np.zeros(N, np.uint32)
    _case(hi, lo, np.ones(N, bool))
    assert (_torch_counts(hi, lo, np.ones(N, bool)) == 1).all()


@pytest.mark.parametrize("N", [0, 1, 2, 1000, 2049])
def test_any_length(N):
    """No block-multiple rule: against the numpy oracle."""
    rng = np.random.default_rng(N)
    hi, lo, good = _random_runs(rng, N)
    got = _torch_counts(hi, lo, good)
    assert np.array_equal(got, run_length_counts_reference(hi, lo, good))


def test_sums_of_int32_values_and_sentinel_tail():
    rng = np.random.default_rng(5)
    lanes = np.sort(rng.integers(-(1 << 63), (1 << 63) - 1, 3000,
                                 dtype=np.int64) // (1 << 55))
    lanes[-700:] = np.iinfo(np.int64).max   # a drain's sentinel run
    vals = rng.integers(0, 5, 3000).astype(np.int32)
    got = rl.run_length_sums(torch.from_numpy(lanes), torch.from_numpy(vals))
    ends = np.append(lanes[1:] != lanes[:-1], True)
    cum = np.cumsum(vals)
    want = np.zeros(3000, np.int32)
    idx = np.flatnonzero(ends)
    want[idx] = np.diff(np.concatenate([[0], cum[idx]]))
    assert np.array_equal(got.numpy(), want)


def test_wrapper_checks_and_cpu_takes_plain_version():
    lanes = torch.arange(8, dtype=torch.int64)
    vals = torch.ones(8, dtype=torch.int32)
    before = rl.launches
    assert (rl.run_length_sums(lanes, vals) == 1).all()
    assert rl.launches == before    # the CPU path launches no kernel
    with pytest.raises(TypeError):
        rl.run_length_sums(lanes.to(torch.int32), vals)
    with pytest.raises(TypeError):
        rl.run_length_sums(lanes, vals.to(torch.int64))
    with pytest.raises(ValueError):
        rl.run_length_sums(lanes, vals[:4])
    with pytest.raises(ValueError):
        rl.run_length_sums(lanes[::2], vals[::2])
    with pytest.raises(ValueError):
        rl.run_length_sums(lanes.to("meta"), vals.to("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc, no kernel: the build raises instead of falling back."""
    from kmernator_tpu_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    assert build.library_path("run_length").endswith(".so")


def _schedule_case(hi, lo, good, tile, n=None):
    """run_length_schedule_plain at `tile` against the JAX kernel in
    interpret mode on the sentinel-padded input; the first n rows (all by
    default) compared."""
    n = hi.size if n is None else n
    want = np.asarray(jax_run_length_counts(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(good), block_rows=8,
        interpret=True))[:n]
    lanes = encode_lane([torch.from_numpy(hi[:n].astype(np.int64)),
                            torch.from_numpy(lo[:n].astype(np.int64))])
    vals = torch.from_numpy(good[:n].astype(np.int32))
    got = rl.run_length_schedule_plain(lanes, vals, tile)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, rl.run_length_sums_plain(lanes, vals))


def _pad(hi, lo, good, N):
    """Sentinel keys (good = False) appended up to N rows."""
    k = N - hi.size
    full = np.full(k, 0xFFFFFFFF, np.uint32)
    return (np.concatenate([hi, full]), np.concatenate([lo, full]),
            np.concatenate([good, np.zeros(k, bool)]))


@pytest.mark.parametrize("tile", [255, 256, 257])
def test_schedule_runs_ending_on_tile_edges(tile):
    """Runs that end on a tile's first row and on its last row, at N a
    multiple of the tile (256) and one off it (255, 257)."""
    N = 2048
    rng = np.random.default_rng(tile)
    keys = np.sort(rng.integers(0, 400, N)).astype(np.int64)
    for t0 in range(tile, N - 2, tile):
        keys[t0] = keys[t0 - 1] + 1000          # a run ends on the last row
        keys[t0 + 1:] += 2000                   # and one on the first row
    keys = np.sort(keys)
    hi, lo = (keys >> 16).astype(np.uint32), (keys & 0xFFFF).astype(np.uint32)
    _schedule_case(hi, lo, rng.random(N) < 0.8, tile)


@pytest.mark.parametrize("tile", [256, 300])
def test_schedule_one_run_across_every_tile(tile):
    N = 3072
    hi = np.full(N, 0x80000001, np.uint32)
    lo = np.full(N, 7, np.uint32)
    good = np.ones(N, bool)
    good[::5] = False
    _schedule_case(hi, lo, good, tile)


@pytest.mark.parametrize("n", [2047, 2048, 2049])
def test_schedule_length_around_the_tile(n):
    """n one below, at and one above a multiple of the tile: the JAX kernel
    runs on the sentinel-padded input (the last real key is no sentinel)."""
    rng = np.random.default_rng(n)
    hi, lo, good = _random_runs(rng, n)
    _schedule_case(*_pad(hi, lo, good, 3072), tile=256, n=n)


def test_schedule_sentinel_tail():
    """A drain's sentinel run across the last tiles. The JAX kernel takes
    the key after the last row to be the sentinel, so it never ends a
    trailing sentinel run; the port ends it at row n - 1 like any run.
    Every other row bit-equal."""
    rng = np.random.default_rng(9)
    hi, lo, good = _random_runs(rng, 2048)
    hi, lo, good = _pad(hi, lo, good, 4096)
    good[2048::3] = True
    want = np.asarray(jax_run_length_counts(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(good), block_rows=8,
        interpret=True))
    lanes = encode_lane([torch.from_numpy(hi.astype(np.int64)),
                         torch.from_numpy(lo.astype(np.int64))])
    got = rl.run_length_schedule_plain(
        lanes, torch.from_numpy(good.astype(np.int32)), 300).numpy()
    assert np.array_equal(got[:-1], want[:-1]) and want[-1] == 0
    assert got[-1] == good[2048:].sum()
