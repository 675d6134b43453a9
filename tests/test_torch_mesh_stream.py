"""kmernator_tpu_torch MeshStreamingSpectrum against the JAX class on
make_mesh(1): the same batches go through both.

Tolerances: keys, counts, purge totals and lookup counts are bit-equal.
Weights agree to 1e-6 x the total weight of the drain's input: both drains
take run weights as differences of a float32 prefix sum over the whole
drain (mesh_stream.py:172-177), but the sums round in another order (XLA's
scan against torch's cumsum, and equal keys sorted in another order), so
each run weight may differ by a few float32 ulps of that total.
"""
import numpy as np
import pytest
import torch

from kmernator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmernator_tpu.parallel.mesh_stream import (
    MeshStreamingSpectrum as JaxSpectrum, pack_bits_host as jax_pack_bits,
    pack_codes_host as jax_pack_codes)
from kmernator_tpu_torch.parallel import mesh_stream as ms
from kmernator_tpu_torch.parallel.mesh import make_mesh

B, L = 32, 64


def _batches(k, n=6, seed=0):
    """Reads from a small genome (solid keys) and random reads (mostly
    singletons); good masks and window weights drawn from the seed."""
    rng = np.random.default_rng(seed + k)
    genome = rng.integers(0, 4, 1500).astype(np.uint8)
    NW = L - k + 1
    out = []
    for _ in range(n):
        starts = rng.integers(0, 1500 - L, B)
        codes = genome[starts[:, None] + np.arange(L)[None, :]]
        codes[B // 2:] = rng.integers(0, 4, (B - B // 2, L))
        lengths = rng.integers(k - 2, L + 1, B).astype(np.int32)
        lengths[-1] = 0
        good = rng.random((B, NW)) < 0.9
        weights = rng.random((B, NW)).astype(np.float32)
        out.append((codes, good, lengths, weights))
    return out


def _jax_tables(jsp):
    return (np.stack([np.asarray(c) for c in jsp.table_cols]),
            np.asarray(jsp.table_counts), np.asarray(jsp.table_weights))


def _assert_tables_equal(jt, tt, w_total):
    assert np.array_equal(jt[0], tt[0])
    assert np.array_equal(jt[1], tt[1])
    np.testing.assert_allclose(tt[2], jt[2], rtol=0, atol=1e-6 * w_total)


def _drive(k, capacity, with_weights, batches):
    """Feed both classes; compare the tables after every drain. Returns
    both spectra."""
    NW = L - k + 1
    jsp = JaxSpectrum(jax_make_mesh(1), k, capacity=capacity,
                      drain_threshold=2 * B * NW)
    tsp = ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), k,
                                   capacity=capacity,
                                   drain_threshold=2 * B * NW)
    w_in = 0.0
    drains = 0
    for codes, good, lengths, weights in batches:
        bw = weights if with_weights else None
        g = good & (np.arange(NW)[None, :] <= lengths[:, None] - k)
        w_in += float(weights[g].sum()) if with_weights else float(g.sum())
        jsp.add_batch(codes, good, lengths, weights2d=bw)
        tsp.add_batch(codes, good, lengths, weights2d=bw)
        assert (len(jsp._staged) == 0) == (len(tsp._staged) == 0)
        if not tsp._staged:
            drains += 1
            jt = _jax_tables(jsp)
            _assert_tables_equal(jt, tsp.to_numpy_tables(), w_in)
            assert jsp.purged_singletons == tsp.purged_singletons
            w_in = float(jt[2].sum())
    assert drains >= 2
    return jsp, tsp


@pytest.mark.parametrize("k", [15, 21, 31, 32])
def test_tables_after_every_drain_and_lookup(k):
    batches = _batches(k)
    jsp, tsp = _drive(k, 4096, True, batches)
    assert tsp.purged_singletons == 0
    for codes, good, lengths, _ in batches[:3]:
        want = np.ones_like(good)
        for mc in (1, 2):
            j = np.asarray(jsp.lookup_batch(codes, want, lengths,
                                            min_count=mc))
            t = tsp.lookup_batch(codes, want, lengths, min_count=mc)
            assert t.dtype == np.int32
            assert np.array_equal(j, t)
            assert (t >= mc).any()
    jk, jc, jw = jsp.finalize(min_depth=1, with_weights=True)
    tk, tc, tw = tsp.finalize(min_depth=1, with_weights=True)
    assert np.array_equal(jk, tk) and np.array_equal(jc, tc)


@pytest.mark.parametrize("capacity", [300, 1500])
def test_capacity_cut_purges_singletons_like_jax(capacity):
    """Past capacity the drain keeps solid keys first, then the lowest
    singletons: 300 rows hold fewer than the solid keys, 1500 hold the
    solid keys and some singletons."""
    k = 31
    jsp, tsp = _drive(k, capacity, False, _batches(k, n=8, seed=5))
    assert tsp.purged_singletons > 0
    assert tsp.purged_singletons == jsp.purged_singletons
    jt, tt = _jax_tables(jsp), tsp.to_numpy_tables()
    assert np.array_equal(jt[1], tt[1])
    assert (tt[1][0] > 0).sum() == capacity


def test_state_carry_round_trip():
    k = 31
    batches = _batches(k, seed=9)
    jsp, _ = _drive(k, 4096, True, batches)
    jsp._drain()
    cols, counts, weights = _jax_tables(jsp)
    tsp = ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), k, capacity=4096)
    tsp.from_numpy_tables(cols, counts, weights)
    back = tsp.to_numpy_tables()
    assert all(np.array_equal(a, b) for a, b in zip((cols, counts, weights),
                                                    back))
    for codes, good, lengths, _ in batches:
        want = np.ones_like(good)
        assert np.array_equal(
            np.asarray(jsp.lookup_batch(codes, want, lengths, min_count=2)),
            tsp.lookup_batch(codes, want, lengths, min_count=2))
    with pytest.raises(ValueError):
        tsp.from_numpy_tables(cols[:, :, ::-1], counts, weights)
    with pytest.raises(ValueError):
        tsp.from_numpy_tables(cols[:, :, :100], counts, weights)


def test_wire_packing_and_unpack():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, (5, 37)).astype(np.uint8)
    mask = rng.random((5, 21)) < 0.5
    pc, pb = ms.pack_codes_host(codes), ms.pack_bits_host(mask)
    assert np.array_equal(pc, jax_pack_codes(codes))
    assert np.array_equal(pb, jax_pack_bits(mask))
    assert np.array_equal(
        ms._unpack_codes_dev(torch.from_numpy(pc), 37).numpy(), codes)
    assert np.array_equal(
        ms._unpack_bits_dev(torch.from_numpy(pb), 21).numpy(), mask)


def test_one_device_only():
    with pytest.raises(NotImplementedError, match="D > 1"):
        make_mesh(2, "cpu")
    with pytest.raises(NotImplementedError):
        ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), 33, capacity=16)
