"""The port's shard exchange (parallel/mesh.py) and MeshStreamingSpectrum
at D = 2 and 4 shards, against the JAX functions and the JAX class on 2
and 4 of the test process's 8 CPU devices: the same inputs go through
both.

Tolerances: the owner hash, bucket loads, overflow counts, keys, counts,
drain counts, overflow retries, purged singletons, lookups and purge marks
are bit-equal. Weights agree to 1e-6 x the total weight of the drain's
input (ROADMAP fault 3e: the JAX drain differences a float32 prefix, the
port a float64 one). The JAX bucket sort is unstable, so a bucket is
compared as a multiset, and an overflowing bucket (whose kept rows the
unstable sort picks) as C rows of its owner's rows.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.parallel import mesh as jax_mesh
from kmernator_tpu.parallel.mesh_stream import MeshStreamingSpectrum as \
    JaxSpectrum
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
from kmernator_tpu_torch.parallel import mesh as tm
from kmernator_tpu_torch.parallel import mesh_stream as ms
from kmernator_tpu_torch.parallel.spectrum import pack_keys

import torch_threads  # noqa: F401

B, L = 32, 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 6])
def test_owner_hash_bit_equal(W):
    """owner_hash_cols over W words: seeded words, and edge words (0, all
    ones, words whose products pass 2^63 in int64)."""
    rng = np.random.default_rng(W)
    words = rng.integers(0, 1 << 32, (W, 4096), dtype=np.uint64)
    edge = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xC2B2AE35,
                     0x85EBCA6B, 0x9E3779B9, 1], np.uint64)
    words[:, :len(edge)] = edge[None, :]
    words[:, len(edge):2 * len(edge)] = edge[::-1][None, :]
    words = words.astype(np.uint32)
    want = np.asarray(jax_mesh.owner_hash_cols(
        [jnp.asarray(w) for w in words])).astype(np.int64)
    got = tm.owner_hash_cols([_t(w) for w in words]).numpy()
    assert np.array_equal(got, want)
    got2 = tm.owner_hash(_t(words.T)).numpy()
    assert np.array_equal(got2, np.asarray(jax_mesh.owner_hash(
        jnp.asarray(words.T))).astype(np.int64))
    assert (got >> 32).max() == 0 and got.min() >= 0


@pytest.mark.parametrize("D", [2, 4])
def test_bucket_scatter_against_jax(D):
    """A C that one bucket overflows: the overflow count, every bucket that
    does not overflow as a multiset of (key words, good), the overflowing
    one as C of its owner's rows, and win_slot pointing at each routed
    row; sentinel rows are neither routed nor counted."""
    rng = np.random.default_rng(D)
    N, W = 600, 2
    words = rng.integers(0, 1 << 32, (W, N), dtype=np.uint64).astype(
        np.uint32)
    sent = rng.random(N) < 0.2
    words[:, sent] = 0xFFFFFFFF
    owner = rng.integers(0, D, N).astype(np.int32)
    owner[:250] = 1
    good = rng.random(N) < 0.7
    C = 120
    jc, jg, jslot, jov = jax_mesh._bucket_scatter_cols(
        [jnp.asarray(w) for w in words], jnp.asarray(good),
        jnp.asarray(owner), D, C)
    pc, pg, pslot, pov = tm.bucket_scatter_cols(
        [_t(w)[None] for w in words], torch.from_numpy(good)[None],
        _t(owner)[None], D, C)
    real = ~sent
    loads = np.bincount(owner[real], minlength=D)
    assert int(pov[0]) == int(jov) == int(np.maximum(loads - C, 0).sum()) > 0
    assert np.array_equal(tm.bucket_loads(_t(owner)[None],
                                          torch.from_numpy(real)[None],
                                          D)[0].numpy(), loads)
    jslot, pslot = np.asarray(jslot), pslot[0].numpy()
    assert ((pslot >= 0) == (jslot >= 0)).sum() >= N - 2 * int(pov[0])
    assert (pslot[sent] == -1).all() and (jslot[sent] == -1).all()
    rows = {d: sorted(zip(words[0, real & (owner == d)].tolist(),
                          words[1, real & (owner == d)].tolist(),
                          good[real & (owner == d)].tolist()))
            for d in range(D)}
    for d in range(D):
        jb = sorted(r for r in zip(*[np.asarray(c)[d].tolist() for c in jc],
                                   np.asarray(jg)[d].astype(bool).tolist())
                    if r[0] != 0xFFFFFFFF or r[1] != 0xFFFFFFFF)
        pb = sorted(r for r in zip(*[c[0, d].tolist() for c in pc],
                                   pg[0, d].bool().tolist())
                    if r[0] != 0xFFFFFFFF or r[1] != 0xFFFFFFFF)
        if loads[d] <= C:
            assert jb == pb == rows[d]
        else:
            assert len(jb) == len(pb) == C
            assert not (set(pb) - set(rows[d])) and not (set(jb)
                                                         - set(rows[d]))
    # win_slot points at the row in the port's planes
    for i in np.flatnonzero(pslot >= 0):
        d, c = divmod(int(pslot[i]), C)
        assert int(pc[0][0, d, c]) == words[0, i]
        assert int(pc[1][0, d, c]) == words[1, i]


def test_exchange_is_the_all_to_all():
    """exchange maps [D_src, D_dst, C, ...] to [D_dst, D_src * C, ...]; the
    reply comes back to each source at its own slots."""
    D, C = 3, 4
    send = torch.arange(D * D * C * 2).reshape(D, D, C, 2)
    recv = tm.exchange(send)
    assert recv.shape == (D, D * C, 2)
    for dst in range(D):
        for src in range(D):
            assert torch.equal(recv[dst, src * C:(src + 1) * C],
                               send[src, dst])
    back = tm.exchange(recv.reshape(D, D, C, 2))
    assert torch.equal(back.reshape(D, D, C, 2), send)


def _batches(k, n, seed, Bn=B):
    """Reads from a small genome (solid keys) and random reads (mostly
    singletons); good masks and window weights drawn from the seed."""
    rng = np.random.default_rng(seed + k)
    genome = rng.integers(0, 4, 1500).astype(np.uint8)
    NW = L - k + 1
    out = []
    for _ in range(n):
        starts = rng.integers(0, 1500 - L, Bn)
        codes = genome[starts[:, None] + np.arange(L)[None, :]]
        codes[Bn // 2:] = rng.integers(0, 4, (Bn - Bn // 2, L))
        lengths = rng.integers(k - 2, L + 1, Bn).astype(np.int32)
        lengths[-1] = 0
        good = rng.random((Bn, NW)) < 0.9
        weights = rng.random((Bn, NW)).astype(np.float32)
        out.append((codes, good, lengths, weights))
    return out


def _jax_tables(jsp):
    return (np.stack([np.asarray(c) for c in jsp.table_cols]),
            np.asarray(jsp.table_counts), np.asarray(jsp.table_weights))


def _pair(D, k, **kw):
    return (JaxSpectrum(jax_mesh.make_mesh(D), k, **kw),
            ms.MeshStreamingSpectrum(tm.make_mesh(D, "cpu"), k, **kw))


def _feed(jsp, tsp, batches, k, with_weights=True):
    """Both classes take the same batches; after every drain the shard
    tables, purged singletons and overflow retries agree. Returns the
    number of drains."""
    NW = L - k + 1
    drains, w_in = 0, 0.0
    for codes, good, lengths, weights in batches:
        bw = weights if with_weights else None
        g = good & (np.arange(NW)[None, :] <= lengths[:, None] - k)
        w_in += float(weights[g].sum()) if with_weights else float(g.sum())
        jsp.add_batch(codes, good, lengths, weights2d=bw)
        tsp.add_batch(codes, good, lengths, weights2d=bw)
        assert tsp._staged_rows == jsp._staged_rows
        assert (len(jsp._staged) == 0) == (len(tsp._staged) == 0)
        assert tsp.overflow_retries == jsp.overflow_retries
        if not tsp._staged:
            drains += 1
            jt, tt = _jax_tables(jsp), tsp.to_numpy_tables()
            assert np.array_equal(jt[0], tt[0])
            assert np.array_equal(jt[1], tt[1])
            np.testing.assert_allclose(tt[2], jt[2], rtol=0,
                                       atol=1e-6 * w_in)
            assert tsp.purged_singletons == jsp.purged_singletons
            w_in = float(jt[2].sum())
    return drains


@pytest.mark.parametrize("D,k,capacity", [(2, 31, 4096), (4, 21, 4096),
                                          (2, 33, 300), (4, 31, 180)])
def test_shards_after_every_drain_and_lookup(D, k, capacity):
    """Per-shard keys and counts bit-equal after every drain, the same
    drains (staged rows D * C a batch, sentinel padding included), and at
    the small capacities the same singleton purge under pressure; then
    lookups at min_count 1 and 2, and finalize."""
    NW = L - k + 1
    jsp, tsp = _pair(D, k, capacity=capacity, drain_threshold=B * NW)
    batches = _batches(k, 8, seed=D)
    assert _feed(jsp, tsp, batches, k) >= 2
    assert (tsp.purged_singletons > 0) == (capacity < 1000)
    for codes, good, lengths, _ in batches[:3]:
        want = np.ones_like(good)
        for mc in (1, 2):
            j = np.asarray(jsp.lookup_batch(codes, want, lengths,
                                            min_count=mc))
            t = tsp.lookup_batch(codes, want, lengths, min_count=mc)
            assert t.dtype == np.int32 and np.array_equal(j[:len(t)], t)
            assert (t >= mc).any()
    assert tsp.overflow_retries == jsp.overflow_retries
    jk, jc, jw = jsp.finalize(min_depth=1, with_weights=True)
    tk, tc, tw = tsp.finalize(min_depth=1, with_weights=True)
    assert np.array_equal(jk, tk) and np.array_equal(jc, tc)
    assert np.array_equal(np.argsort(pack_keys(tk), kind="stable"),
                          np.arange(len(tk)))


@pytest.mark.parametrize("D", [2, 4])
def test_overflow_retry_and_odd_batch(D):
    """A capacity_factor of 0.25 overflows the buckets of the first batch,
    so C doubles as in JAX (the same retries and staged rows), and a batch
    of B + 1 reads is padded to a multiple of D."""
    k = 25
    jsp, tsp = _pair(D, k, capacity=4096, capacity_factor=0.25)
    batches = _batches(k, 3, seed=9, Bn=B + 1)
    _feed(jsp, tsp, batches, k, with_weights=False)
    assert tsp.overflow_retries == jsp.overflow_retries > 0
    jsp._drain()
    tsp._drain()
    jt, tt = _jax_tables(jsp), tsp.to_numpy_tables()
    assert all(np.array_equal(a, b) for a, b in zip(jt, tt))


def _variant_table(rng, k, n_sources=10, n_noise=300):
    """Sources of high count, hamming-1 variants of them (the first of each
    a source in turn, so the purge takes rounds) and noise: (keys [M, W]
    u32, counts [M])."""
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    table = {}

    def add(seq, count):
        canon = extract_kmers_flat(seq, np.array([0, k]), k)[0]
        key = canon[0].tobytes()
        table[key] = (canon[0], table.get(key, (None, 0))[1] + count)

    for s in range(n_sources):
        src = genome[s * 200:s * 200 + k].copy()
        add(src, int(rng.integers(600, 5000)))
        for v in range(5):
            mut = src.copy()
            p = int(rng.integers(0, k))
            mut[p] = (mut[p] + 1 + int(rng.integers(0, 3))) % 4
            add(mut, int(rng.integers(600, 900)) if v == 0
                else int(rng.integers(1, 60)))
    for n in range(n_noise):
        add(rng.integers(0, 4, k).astype(np.uint8), int(rng.integers(1, 200)))
    keys = np.stack([w for w, _ in table.values()])
    counts = np.array([c for _, c in table.values()], np.int64)
    return keys, counts


@pytest.mark.parametrize("D,k,ed", [(2, 21, 2), (4, 33, 1)])
def test_set_table_purge_and_lookup_against_jax(D, k, ed):
    """set_table splits a host table by owner into the same shards;
    purge_min_depth and purge_variants_mesh (candidates searched on their
    owner's shard, float32 thresholds) purge the same rows; lookups on the
    purged tables agree; a shard past its capacity raises."""
    keys, counts = _variant_table(np.random.default_rng(D + k), k)
    weights = (counts * np.random.default_rng(3).uniform(
        0.6, 1.0, len(counts))).astype(np.float32)
    jsp, tsp = _pair(D, k, capacity=1024)
    for sp in (jsp, tsp):
        sp.set_table(keys, counts.astype(np.int32), weights)
    assert all(np.array_equal(a, b) for a, b in zip(_jax_tables(jsp),
                                                    tsp.to_numpy_tables()))
    for sp in (jsp, tsp):
        sp.purge_min_depth(2)
    n = [sp.purge_variants_mesh(2.0, ed, 400.0, min_depth=2)
         for sp in (jsp, tsp)]
    assert n[0] == n[1] > 0
    assert all(np.array_equal(a, b) for a, b in zip(_jax_tables(jsp),
                                                    tsp.to_numpy_tables()))
    for codes, good, lengths, _ in _batches(k, 2, seed=4):
        want = np.ones_like(good)
        assert np.array_equal(
            np.asarray(jsp.lookup_batch(codes, want, lengths))[:B],
            tsp.lookup_batch(codes, want, lengths))
    small = ms.MeshStreamingSpectrum(tm.make_mesh(D, "cpu"), k, capacity=16)
    with pytest.raises(RuntimeError, match="overflows capacity"):
        small.set_table(keys, counts)


def test_grow_on_pressure_at_two_shards():
    """max_capacity at D = 2: the pre-drain bound (2 * staged real) // D
    and the post-drain bound (the fullest shard) grow both tables in the
    JAX steps, and the tables agree after every drain."""
    k = 31
    NW = L - k + 1
    jsp, tsp = _pair(2, k, capacity=256, max_capacity=1 << 16,
                     drain_threshold=2 * B * NW)
    batches = _batches(k, 6, seed=21)
    for codes, good, lengths, _ in batches:
        jsp.add_batch(codes, good, lengths)
        tsp.add_batch(codes, good, lengths)
        assert tsp.cap == jsp.cap
        if not tsp._staged:
            assert all(np.array_equal(a, b) for a, b in zip(
                _jax_tables(jsp), tsp.to_numpy_tables()))
    assert tsp.cap > 256 and tsp.purged_singletons == 0 == \
        jsp.purged_singletons
