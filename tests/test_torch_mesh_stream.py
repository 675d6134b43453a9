"""kmernator_tpu_torch MeshStreamingSpectrum against the JAX class on
make_mesh(1): the same batches go through both.

Tolerances: keys, counts, purge totals and lookup counts are bit-equal.
Weights agree to 1e-6 x the total weight of the drain's input: the JAX
drain takes run weights as differences of a float32 prefix sum over the
whole drain (mesh_stream.py:172-177), the port as differences of a float64
one, rounded to float32, so each JAX run weight may be off by a few
float32 ulps of that total. The port's are held to float64 sums past the
float32 prefix's edge, and its counts to int64 sums past the int32 one.
"""
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmernator_tpu.parallel.mesh_stream import (
    MeshStreamingSpectrum as JaxSpectrum, pack_bits_host as jax_pack_bits,
    pack_codes_host as jax_pack_codes)
from kmernator_tpu_torch.parallel import mesh_stream as ms
from kmernator_tpu_torch.parallel.mesh import make_mesh

import torch_threads  # noqa: F401

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
    """Every shard of a mesh lives on its one torch device: make_mesh(n)
    is n shards for any n >= 1, whatever the number of cards. A table
    takes any k: ceil(k / 32) key lanes a shard."""
    assert make_mesh(2, "cpu").size == 2
    sp = ms.MeshStreamingSpectrum(make_mesh(4, "cpu"), 31, capacity=16)
    assert sp.table_counts.shape == (4, 16) and sp.capacity_factor == 2.0
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    for k, L in ((96, 3), (97, 4), (320, 10)):
        sp = ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), k, capacity=16)
        assert sp.L == L and len(sp.table_lanes) == L
        assert sp.table_lanes[0].shape == (1, 16)


def _drain_counts(table_keys, table_counts, staged_keys, cap=8):
    """The port's drain of a table (from_numpy_tables) and staged rows of
    count 1, at k = 32: keys are (0, key) word pairs. Returns {key: count}
    of the table after the drain."""
    sp = ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), 32, capacity=cap)
    cols = np.full((2, 1, cap), 0xFFFFFFFF, np.uint32)
    cols[0, 0, :len(table_keys)] = 0
    cols[1, 0, :len(table_keys)] = table_keys
    counts = np.zeros((1, cap), np.int32)
    counts[0, :len(table_keys)] = table_counts
    sp.from_numpy_tables(cols, counts, np.zeros((1, cap), np.float32))
    lanes = ms.encode_lanes([torch.zeros(len(staged_keys), dtype=torch.int64),
                             torch.tensor(staged_keys, dtype=torch.int64)])
    sp._staged.append((lanes, torch.ones(len(staged_keys))))
    sp._staged_rows += len(staged_keys)
    sp._drain()
    planes, cnt, _ = sp.to_numpy_tables()
    real = cnt[0] != 0
    assert (planes[0, 0, real] == 0).all()
    return dict(zip(planes[1, 0, real].tolist(), cnt[0, real].tolist()))


def test_drain_past_the_int32_prefix_edge():
    """Queue 3g: counts in one drain that sum past 2^31 - 1 (table counts
    2^30, 2^30, 3, 4 for keys 5-8, staged rows 8, 9, 9, 5). The JAX drain's
    int32 prefix scan wraps there and loses key 5; the port's run sums are
    per run, held here to an int64 numpy count, not to the JAX drain."""
    table_keys = np.array([5, 6, 7, 8])
    table_counts = np.array([1 << 30, 1 << 30, 3, 4], np.int64)
    staged = np.array([8, 9, 9, 5])
    want = {}
    for key, c in zip(table_keys.tolist(), table_counts.tolist()):
        want[key] = want.get(key, 0) + c
    for key in staged.tolist():
        want[key] = want.get(key, 0) + 1
    assert sum(want.values()) > (1 << 31) - 1
    assert _drain_counts(table_keys, table_counts, staged) == want
    # the port's own limit: a single key's count past 2^31 - 1 wraps its
    # int32 table count negative, and the drain then drops the key
    got = _drain_counts(np.array([5, 6]), np.array([(1 << 31) - 1, 3]),
                        np.array([5, 6]))
    assert got == {6: 4}


def test_drain_weights_past_the_float32_prefix_edge():
    """Run weights once the drain's total weight passes 2^23, where a
    float32 ulp is 1: a first key of weight 2^24, then 40 keys of 1-3 rows
    of weight 0.3 each. The port's run weights are the float64 sums rounded
    to float32; the JAX drain differences a float32 prefix there, so its
    small runs come out as whole numbers (shown here on its `_drain_fn`)."""
    from kmernator_tpu.parallel.mesh_stream import _drain_fn
    rng = np.random.default_rng(12)
    keys = np.concatenate([[1], np.repeat(np.arange(2, 42),
                                          rng.integers(1, 4, 40))])
    w = np.full(len(keys), 0.3, np.float32)
    w[0] = 2.0 ** 24
    want = {}
    for key, x in zip(keys.tolist(), w.astype(np.float64).tolist()):
        want[key] = want.get(key, 0.0) + x
    cap, R = 64, 64 + len(keys)
    sp = ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), 32, capacity=cap)
    perm = rng.permutation(len(keys))
    lanes = ms.encode_lanes([torch.zeros(len(keys), dtype=torch.int64),
                             torch.from_numpy(keys[perm])])
    sp._staged.append((lanes, torch.from_numpy(w[perm])))
    sp._staged_rows += len(keys)
    sp._drain()
    planes, counts, weights = sp.to_numpy_tables()
    real = counts[0] > 0
    got = dict(zip(planes[1, 0, real].tolist(), weights[0, real].tolist()))
    assert got == {key: float(np.float32(x)) for key, x in want.items()}
    # the JAX drain on the same rows (table of sentinels + staged)
    cols = np.full((2, 1, R), 0xFFFFFFFF, np.uint32)
    cols[0, 0, cap:] = 0
    cols[1, 0, cap:] = keys[perm]
    cnt = np.concatenate([np.zeros(cap, np.int32),
                          np.ones(len(keys), np.int32)])[None, :]
    wts = np.concatenate([np.zeros(cap, np.float32), w[perm]])[None, :]
    out = _drain_fn(jax_make_mesh(1), 2, cap, R)(
        *[jnp.asarray(c) for c in cols], jnp.asarray(cnt), jnp.asarray(wts))
    jw = np.asarray(out[3])[0, :len(want)]
    assert np.array_equal(np.asarray(out[1])[0, :len(want)],
                          np.array(sorted(want)))
    err = np.abs(jw.astype(np.float64)
                 - np.array([want[key] for key in sorted(want)]))
    assert err[1:].max() >= 0.3 and (jw[1:] == np.round(jw[1:])).all()


def _grow_batches(seed, n=10, Bg=256, Lg=64, k=31, good_frac=1.0):
    """The JAX grow test's batches (tests/test_mesh_stream.py:166-218):
    half of each batch from a 3 kb genome, half random, every read full
    length; each window good with probability good_frac."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000, dtype=np.uint8)
    batches = []
    for _ in range(n):
        codes = rng.integers(0, 4, (Bg, Lg), dtype=np.uint8)
        starts = rng.integers(0, 3000 - Lg, Bg // 2)
        codes[:Bg // 2] = genome[starts[:, None] + np.arange(Lg)[None, :]]
        batches.append((codes, rng.random((Bg, Lg - k + 1)) < good_frac))
    return batches


def _numpy_count(batches, k):
    from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
    from kmernator_tpu_torch.parallel.spectrum import pack_keys
    keys = []
    for codes, good in batches:
        Bg, Lg = codes.shape
        canon, _, _, _ = extract_kmers_flat(
            codes.reshape(-1), np.arange(0, (Bg + 1) * Lg, Lg), k)
        keys.append(pack_keys(canon)[good.reshape(-1)])
    uniq, counts = np.unique(np.concatenate(keys), return_counts=True)
    return dict(zip(uniq.tolist(), counts.tolist()))


GREW = re.compile(r"mesh shard table grew to (\d+) rows/device "
                  r"\(driving rows (\d+) x(\d)\)")


def _drive_grow(batches, k, capacity, max_capacity, capfd,
                drain_threshold=0):
    """Feed both classes; after every drain the capacity, the purged
    singletons and the table (keys, counts and weights, which are whole
    numbers here) are equal. Returns both spectra and the growth steps,
    (rows, driving rows, headroom) from each one's debug log, equal."""
    from kmernator_tpu.utils.logging import Log as JaxLog
    from kmernator_tpu_torch.utils.logging import Log
    jsp = JaxSpectrum(jax_make_mesh(1), k, capacity=capacity,
                      max_capacity=max_capacity,
                      drain_threshold=drain_threshold)
    tsp = ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), k,
                                   capacity=capacity,
                                   max_capacity=max_capacity,
                                   drain_threshold=drain_threshold)
    lengths = np.full(batches[0][0].shape[0], batches[0][0].shape[1],
                      np.int32)
    steps = ([], [])
    levels = (JaxLog.debug_level, Log.debug_level)
    JaxLog.debug_level = Log.debug_level = 1
    try:
        for batch in batches + [None]:
            for sp, log in zip((jsp, tsp), steps):
                capfd.readouterr()
                if batch is None:   # the last drain, as finalize does
                    sp._drain()
                else:
                    sp.add_batch(batch[0], batch[1], lengths)
                log += GREW.findall(capfd.readouterr().err)
            assert (len(jsp._staged) == 0) == (len(tsp._staged) == 0)
            assert tsp.cap == jsp.cap and tsp.drain_threshold == \
                jsp.drain_threshold
            if not tsp._staged:
                assert tsp.purged_singletons == jsp.purged_singletons
                jt, tt = _jax_tables(jsp), tsp.to_numpy_tables()
                assert all(np.array_equal(a, b) for a, b in zip(jt, tt))
    finally:
        JaxLog.debug_level, Log.debug_level = levels
    assert steps[0] == steps[1]
    return jsp, tsp, [(int(c), int(r), int(h)) for c, r, h in steps[1]]


def test_grow_on_pressure_follows_jax(capfd):
    """The D = 1 counterpart of the JAX grow test: the table starts at
    1,024 rows, grows 4x whenever a drain could overfill it (headroom 1,
    before the drain) or leaves it over half full (headroom 2, after it),
    purges nothing, and ends as the numpy count. Each batch drains (a
    threshold of one batch's rows), so that both kinds of step occur."""
    k = 31
    batches = _grow_batches(11, good_frac=0.8)
    jsp, tsp, steps = _drive_grow(batches, k, 1024, 1 << 20, capfd,
                                  drain_threshold=256 * (64 - k + 1))
    caps = [1024] + [c for c, _, _ in steps]
    assert caps == [1024 * 4 ** i for i in range(len(caps))]
    assert len(steps) >= 3 and tsp.drains == len(batches)
    assert {h for _, _, h in steps} == {1, 2}
    assert tsp.purged_singletons == jsp.purged_singletons == 0
    keys, counts = tsp.finalize(min_depth=1)
    from kmernator_tpu_torch.parallel.spectrum import pack_keys
    assert dict(zip(pack_keys(keys).tolist(), counts.tolist())) == \
        _numpy_count(batches, k)


def test_grow_stops_at_max_capacity_and_purges_like_jax(capfd):
    """A ceiling of 20,000 rows, under the distinct keys: the last step
    pads only to the ceiling, and from there both drains purge the same
    singletons and keep the same table."""
    k = 31
    jsp, tsp, steps = _drive_grow(_grow_batches(12), k, 1024, 20000, capfd)
    assert [c for c, _, _ in steps] == [4096, 16384, 20000]
    assert tsp.drain_threshold == 10000
    assert tsp.purged_singletons == jsp.purged_singletons > 0
    assert int((tsp.table_counts > 0).sum()) == 20000


def test_pre_drain_grow_at_headroom_one(capfd):
    """A drain threshold set by the caller holds every batch until the last
    drain, which must grow first (headroom 1: every real staged row may be
    a new key) from 1,024 rows past twice the staged rows, so that it
    purges nothing; the caller's threshold is kept."""
    k = 45
    batches = _grow_batches(13, n=3, k=k)
    staged = 3 * 256 * (64 - k + 1)
    jsp, tsp, steps = _drive_grow(batches, k, 1024, 1 << 20, capfd,
                                  drain_threshold=10 ** 9)
    assert steps == [(4096, 2 * staged + 1, 1), (16384, 2 * staged + 1, 1),
                     (65536, 2 * staged + 1, 1)]
    assert tsp.drains == 1 and tsp.drain_threshold == 10 ** 9
    assert tsp.purged_singletons == jsp.purged_singletons == 0
    keys, counts = tsp.finalize(min_depth=1)
    from kmernator_tpu_torch.parallel.spectrum import pack_keys
    assert dict(zip(pack_keys(keys).tolist(), counts.tolist())) == \
        _numpy_count(batches, k)


def test_fixed_capacity_never_grows(capfd):
    """max_capacity == 0 (every --mesh 1 path but the distributed engine):
    the capacity and the threshold stay, and the drain purges instead."""
    k = 31
    jsp, tsp, steps = _drive_grow(_grow_batches(12, n=4), k, 4096, 0, capfd)
    assert steps == [] and tsp.cap == 4096 and tsp.drain_threshold == 2048
    assert tsp.purged_singletons == jsp.purged_singletons > 0
