"""The shard_map steps of kmernator_tpu_torch.parallel.mesh and the read
matcher builders of parallel/dist_match.py against the JAX package, the
JAX side on 1, 2 and 4 of the conftest's 8 CPU devices and the port on
as many shards of one CPU device: distributed_spectrum_fn,
distributed_count_fn and distributed_extension_fn (counts, shard tables
and overflow bit-equal; tolerance: none), the JAX sentinel case at
capacity_factor 0.5, and build_index_fn + match_fn (the ids bit-equal).

distributed_spectrum_fn takes its good mask from window_good, which the
port computes otherwise than JAX (ROADMAP 3o): its inputs' logp are
multiples of 2^-9, whose window sums are exact in float32 in any order,
so both masks are the same. Where a bucket overflows, the rows it drops
follow the JAX sort's tie order and the port's row order, so that case
holds the overflow counts and what they fix (the routed rows' total and
the windows that got a count), not which windows those are."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmernator_tpu.parallel import dist_match as JD
from kmernator_tpu.parallel import mesh as JM
from kmernator_tpu_torch.parallel import device_spectrum as TS
from kmernator_tpu_torch.parallel import dist_match as TD
from kmernator_tpu_torch.parallel import mesh as TM

import torch_threads  # noqa: F401

K = 31


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _batch(D, B=48, L=72, seed=0):
    """B reads (a multiple of D) of a 600 bp genome, a quarter random,
    some short or empty; logp multiples of 2^-9 (about phred 10-40); a
    random good mask and extension mask."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    starts = rng.integers(0, 600 - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[:B // 4] = rng.integers(0, 4, (B // 4, L))
    lengths = rng.integers(K, L + 1, B).astype(np.int32)
    lengths[[1, 2]] = (0, K - 3)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    logp = (-rng.integers(0, 80, (B, L)) / 512).astype(np.float32)
    good = rng.random((B, L - K + 1)) < 0.85
    ext_ok = rng.random((B, L)) < 0.9
    return codes.astype(np.uint8), logp, lengths, good, ext_ok


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_distributed_spectrum_fn_bit_equal(D):
    codes, logp, lengths, _, _ = _batch(D, seed=D)
    (jc, tc), (jl, tl), (jn, tn) = (_both(a) for a in (codes, logp,
                                                       lengths))
    band = np.abs(TS.window_good(tl, tn, K, np.log2(0.1))[0].numpy()
                  - np.log2(0.1)) <= TS.window_good_bound(tl).numpy()[:, None]
    assert not band.any()
    want = JM.distributed_spectrum_fn(JM.make_mesh(D), K)(jc, jl, jn)
    got = TM.distributed_spectrum_fn(TM.make_mesh(D, "cpu"), K)(tc, tl, tn)
    for a, b in zip(want, got):
        assert a.shape == tuple(b.shape) and np.array_equal(_np(a), _np(b))
    assert _np(got[0]).max() >= 2 and int(_np(got[3]).sum()) == 0


@pytest.mark.parametrize("D", [1, 2, 4])
def test_distributed_count_fn_bit_equal(D):
    codes, _, lengths, good, _ = _batch(D, seed=10 + D)
    args = [_both(a) for a in (codes, good, lengths)]
    want = JM.distributed_count_fn(JM.make_mesh(D), K, min_count=1)(
        *(a[0] for a in args))
    got = TM.distributed_count_fn(TM.make_mesh(D, "cpu"), K, min_count=1)(
        *(a[1] for a in args))
    for a, b in zip(want, got):
        assert a.shape == tuple(b.shape) and np.array_equal(_np(a), _np(b))


@pytest.mark.parametrize("D", [4, 8])
def test_sentinel_windows_not_routed(D):
    """The JAX test's case: 90% of 512 reads shorter than k, capacity
    factor 0.5; no overflow, short reads count 0, full reads >= 1."""
    rng = np.random.default_rng(2)
    B, L = 512, 64
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[rng.random(B) < 0.9] = 10
    good = np.ones((B, L - K + 1), dtype=bool)
    args = [_both(a) for a in (codes, good, lengths)]
    want = JM.distributed_count_fn(JM.make_mesh(D), K, capacity_factor=0.5,
                                   min_count=1)(*(a[0] for a in args))
    counts, overflow = TM.distributed_count_fn(
        TM.make_mesh(D, "cpu"), K, capacity_factor=0.5,
        min_count=1)(*(a[1] for a in args))
    assert np.array_equal(_np(want[0]), counts.numpy())
    assert np.array_equal(_np(want[1]), overflow.numpy())
    assert int(overflow.sum()) == 0
    long_rows = lengths == L
    assert (counts.numpy()[~long_rows] == 0).all()
    assert (counts.numpy()[long_rows] >= 1).all()


def test_overflow_counts_bit_equal():
    """capacity_factor 0.3 at D = 4 with every window good: buckets
    overflow. The overflow of each block, the routed rows (the shard
    counts' total) and the windows that got a count are the JAX ones."""
    codes, logp, lengths, _, _ = _batch(4, B=64, seed=7)
    logp[:] = 0.0
    args = [_both(a) for a in (codes, logp, lengths)]
    want = JM.distributed_spectrum_fn(JM.make_mesh(4), K, 0.3, 1)(
        *(a[0] for a in args))
    got = TM.distributed_spectrum_fn(TM.make_mesh(4, "cpu"), K, 0.3, 1)(
        *(a[1] for a in args))
    assert int(_np(got[3]).sum()) > 0
    assert np.array_equal(_np(want[3]), _np(got[3]))
    assert int(_np(want[2]).sum()) == int(_np(got[2]).sum())
    assert int((_np(want[0]) > 0).sum()) == int((_np(got[0]) > 0).sum())
    for a, b in zip(want[1:3], got[1:3]):
        assert a.shape == tuple(b.shape)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_distributed_extension_fn_bit_equal(D):
    codes, _, lengths, good, ext_ok = _batch(D, seed=20 + D)
    args = [_both(a) for a in (codes, good, ext_ok, lengths)]
    want = JM.distributed_extension_fn(JM.make_mesh(D), K)(
        *(a[0] for a in args))
    got = TM.distributed_extension_fn(TM.make_mesh(D, "cpu"), K)(
        *(a[1] for a in args))
    for a, b in zip(want, got):
        assert a.shape == tuple(b.shape) and np.array_equal(_np(a), _np(b))
    assert _np(got[1]).max() >= 2


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("min_depth", [0, 3])
def test_build_index_and_match_fn_ids_equal(D, min_depth):
    """read_global ids 7 + 3i (global, ascending); queries: windows of the
    reads, random keys, and the first rows of the index."""
    codes, _, lengths, good, _ = _batch(D, seed=30 + D)
    B = codes.shape[0]
    rid = (7 + 3 * np.arange(B)).astype(np.int32)
    args = [_both(a) for a in (codes, good, lengths, rid)]
    jk, jr, jov = JD.build_index_fn(JM.make_mesh(D), K)(
        *(a[0] for a in args))
    mesh = TM.make_mesh(D, "cpu")
    tk, tr, tov = TD.build_index_fn(mesh, K)(*(a[1] for a in args))
    assert int(np.asarray(jov).sum()) == tov == 0 and len(tk) == D
    rng = np.random.default_rng(D)
    canon = TS.extract_canonical(args[0][1], args[2][1], K)[0].reshape(
        -1, 2).numpy()
    queries = np.concatenate([
        canon[rng.integers(0, len(canon), 200)],
        rng.integers(0, 2**32 - 1, (20, 2)), np.asarray(jk)[:4]]).astype(
            np.uint32)
    want = JD.match_fn(JM.make_mesh(D), K, max_ids=8, min_depth=min_depth)(
        jnp.asarray(queries), jk, jr)
    got = TD.match_fn(mesh, K, max_ids=8, min_depth=min_depth)(
        queries, tk, tr)
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() >= 7).any()
