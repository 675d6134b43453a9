"""Run-length counter of kmernator_tpu_torch against the Pallas kernel.

The port's plain version (what a CPU tensor takes) must be bit-equal to the
JAX `run_length_counts` run in interpret mode, over the cases of
tests/test_pallas_count.py. The CUDA kernel is held to the plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py. Tolerance: none,
integers.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.parallel.pallas_count import (run_length_counts as
                                                 jax_run_length_counts,
                                                 run_length_counts_reference)
from kmernator_tpu_torch.parallel import run_length as rl


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
