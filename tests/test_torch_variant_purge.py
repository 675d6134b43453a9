"""The on-device variant purge of kmernator_tpu_torch at D = 1 against the
JAX package: `_shell_cols`, `set_table` + `purge_variants_mesh` (against the
JAX mesh purge on make_mesh(1) and the host KmerSpectrum.purge_variants),
the float32 threshold at its rounding boundary, and the in-memory
FilterReads `--mesh 1 --variant-sigmas` end to end.

Tolerance: none. Marks, purged counts, keys, counts and weights are
bit-equal; app output is byte-identical with the same "Removed N" count.
"""
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.apps import filter_reads as jax_app
from kmernator_tpu.ops.kmer import (extract_kmers_flat, nwords,
                                    revcomp_words, words_less)
from kmernator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmernator_tpu.parallel.mesh_stream import (
    MeshStreamingSpectrum as JaxSpectrum, _shell_cols as jax_shell_cols)
from kmernator_tpu.parallel.spectrum import (KmerSpectrum, pack_keys,
                                             unpack_keys)
from kmernator_tpu_torch.apps import filter_reads as torch_app
from kmernator_tpu_torch.parallel import mesh_stream as ms
from kmernator_tpu_torch.parallel.mesh import make_mesh

import torch_threads  # noqa: F401


def _canon(words, k):
    rc = revcomp_words(np, words, k)
    return np.where(words_less(np, rc, words)[:, None], rc, words)


def _chain_spectrum(rng, k, n_sources=12, n_variants_per=6, n_noise=500):
    """The chain construction of tests/test_variant_purge.py
    (`_random_spectrum(chain=True)`), copied and widened to any k: big
    sources, hamming-1 variants of them (the first of each a source in
    turn), and noise, from 64 random reads of max(80, k + 40) bases.
    Returns (keys [M, W] u32 sorted, counts [M] i64)."""
    W = nwords(k)
    L = max(80, k + 40)
    codes = rng.integers(0, 4, (64, L), dtype=np.uint8)
    offs = np.arange(0, 65 * L, L)
    canon, _, _, _ = extract_kmers_flat(codes.reshape(-1), offs, k)
    pool = np.unique(canon, axis=0)
    rng.shuffle(pool)
    table = {}

    def add(words, count):
        key = words.tobytes()
        table[key] = table.get(key, 0) + count

    for sw in pool[:n_sources]:
        add(sw, int(rng.integers(600, 5000)))
        for v in range(n_variants_per):
            p = int(rng.integers(0, k))
            w, o = divmod(p, 16)
            shift = np.uint32(30 - 2 * o)
            mut = sw[None, :].copy()
            mut[0, w] = ((mut[0, w] & ~(np.uint32(3) << shift))
                         | (np.uint32(rng.integers(0, 4)) << shift))
            nk = _canon(mut, k)[0]
            add(nk, int(rng.integers(600, 900)) if v == 0
                else int(rng.integers(1, 60)))
    for nk in pool[n_sources:n_sources + n_noise]:
        add(nk, int(rng.integers(1, 200)))
    keys = np.frombuffer(b"".join(table), np.uint32).reshape(-1, W)
    counts = np.array(list(table.values()), np.int64)
    order = np.argsort(pack_keys(keys), kind="stable")
    return keys[order], counts[order]


@pytest.mark.parametrize("k", [21, 31, 33, 127])
def test_shell_cols_matches_jax(k):
    rng = np.random.default_rng(k)
    W = nwords(k)
    L = max(100, k + 60)
    codes = rng.integers(0, 4, (8, L), dtype=np.uint8)
    canon, _, _, _ = extract_kmers_flat(codes.reshape(-1),
                                        np.arange(0, 9 * L, L), k)
    canon = canon[:200]
    want = jax_shell_cols([jnp.asarray(canon[:, w]) for w in range(W)], k)
    got = ms._shell_cols([torch.from_numpy(canon[:, w].astype(np.int64))
                          for w in range(W)], k)
    assert len(got) == W
    for g, w in zip(got, want):
        assert g.shape == (len(canon), 4 * k)
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    # the distance-2 expansion of the same rows
    flat = [jnp.asarray(w).reshape(-1)[:3000] for w in want]
    want2 = jax_shell_cols(flat, k)
    got2 = ms._shell_cols([g.reshape(-1)[:3000] for g in got], k)
    for g, w in zip(got2, want2):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("k,ed,chunk_rows", [
    (21, 1, 0), (21, 2, 0), (21, 2, 5000), (33, 2, 0), (33, 1, 300),
    (127, 1, 0), (127, 1, 2000)])
def test_purge_matches_jax_mesh_and_host(k, ed, chunk_rows):
    """set_table then purge_variants_mesh at D = 1: the same purged count,
    keys, counts and weights as the JAX mesh purge on make_mesh(1) and the
    host KmerSpectrum.purge_variants (which ends with purge_min_depth)."""
    rng = np.random.default_rng(17 + k + ed)
    keys, counts = _chain_spectrum(rng, k)
    W = nwords(k)
    jsp = JaxSpectrum(jax_make_mesh(1), k, capacity=4096)
    jsp.set_table(keys, counts.astype(np.int32))
    tsp = ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), k, capacity=4096)
    tsp.set_table(keys, counts.astype(np.int32))
    n_jax = jsp.purge_variants_mesh(2.0, ed, 512.0, min_depth=2)
    n_port = tsp.purge_variants_mesh(2.0, ed, 512.0, min_depth=2,
                                     chunk_rows=chunk_rows)
    host = KmerSpectrum(k=k)
    host.keys, host.counts = pack_keys(keys), counts.copy()
    n_host = host.purge_variants(2.0, ed, 512.0, use_weighted=False,
                                 min_depth=2)
    assert n_port == n_jax == n_host > 0
    assert tsp.purge_stats["rounds"] >= 2          # the chain takes rounds
    jt = (np.stack([np.asarray(c) for c in jsp.table_cols]),
          np.asarray(jsp.table_counts), np.asarray(jsp.table_weights))
    tt = tsp.to_numpy_tables()
    for a, b in zip(jt, tt):
        assert np.array_equal(a, b)
    got_keys, got_counts, got_w = tsp.finalize(min_depth=2,
                                               with_weights=True)
    assert np.array_equal(pack_keys(got_keys), host.keys)
    assert np.array_equal(got_counts, host.counts)
    assert np.array_equal(got_w, got_counts.astype(np.float64))
    assert np.array_equal(unpack_keys(host.keys, W), got_keys)


def test_purge_min_depth_and_weighted_values():
    """purge_min_depth alone, and the purge on weights that are not the
    counts, against the JAX mesh class."""
    k = 21
    keys, counts = _chain_spectrum(np.random.default_rng(5), k)
    weights = (counts * np.random.default_rng(6).uniform(
        0.6, 1.0, len(counts))).astype(np.float32)
    jsp = JaxSpectrum(jax_make_mesh(1), k, capacity=4096)
    tsp = ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), k, capacity=4096)
    for sp in (jsp, tsp):
        sp.set_table(keys, counts.astype(np.int32), weights)
        sp.purge_min_depth(40)
    jk, jc, jw = jsp.finalize(min_depth=1, with_weights=True)
    tk_, tc, tw = tsp.finalize(min_depth=1, with_weights=True)
    assert np.array_equal(jk, tk_) and np.array_equal(jc, tc)
    assert np.array_equal(jw, tw) and jc.min() >= 40
    for sp in (jsp, tsp):
        sp.set_table(keys, counts.astype(np.int32), weights)
    n = [sp.purge_variants_mesh(2.0, 2, 400.0, min_depth=2)
         for sp in (jsp, tsp)]
    assert n[0] == n[1] > 0
    for a, b in zip(jsp.finalize(2, True), tsp.finalize(2, True)):
        assert np.array_equal(a, b)
    with pytest.raises(RuntimeError, match="overflows capacity"):
        ms.MeshStreamingSpectrum(make_mesh(1, "cpu"), k,
                                 capacity=16).set_table(keys, counts)


def _thresholds(v, sigmas, dist):
    """The distance-`dist` victim limit of source values v, four ways:
    the threshold v - sqrt(v) * sigmas rounded once (a fused multiply-add)
    or with product and difference each rounded, then divided by
    c = 20 ^ (dist - 1) or multiplied by the float32 1 / c."""
    sq = np.sqrt(v)
    s32 = np.float32(sigmas)
    c = np.float32(20 ^ (dist - 1))
    fused = (v.astype(np.float64)
             - sq.astype(np.float64) * np.float64(s32)).astype(np.float32)
    sep = (v - sq * s32).astype(np.float32)
    recip = np.float32(1) / c
    return {"fused_recip": fused * recip, "fused_div": fused / c,
            "sep_recip": sep * recip, "sep_div": sep / c}


@pytest.mark.parametrize("dist", [1, 2])
def test_threshold_rounding_boundary_follows_jax(dist):
    """Queue 3b: the victim test `w < (v - sqrt(v) * s) / (20 ^ (d - 1))`
    at source values v where the four float32 roundings of the limit
    (threshold fused or not, division or reciprocal multiply) do not all
    agree. Each neighbour, at hamming distance `dist` from its source,
    weighs the least of the four, so it is purged under some roundings and
    kept under others. The JAX mesh purge (XLA on the CPU) takes the fused
    threshold times the reciprocal, and no other of the four, and the port
    follows it."""
    k, sigmas = 21, 2.5
    rng = np.random.default_rng(3 + dist)
    v = (rng.random(100_000) * 4000 + 600).astype(np.float32)
    lim = _thresholds(v, sigmas, dist)
    q = np.stack(list(lim.values()))
    pick = np.flatnonzero((q != q[0]).any(axis=0))[:48]
    assert len(pick) == 48
    v, w = v[pick], q[:, pick].min(axis=0)
    purged_if = {name: w < x[pick] for name, x in lim.items()}
    for name in ("fused_div", "sep_recip", "sep_div"):
        assert not np.array_equal(purged_if[name], purged_if["fused_recip"])
    codes = rng.integers(0, 4, (len(v), k), dtype=np.uint8)
    src, _, _, _ = extract_kmers_flat(codes.reshape(-1),
                                      np.arange(0, (len(v) + 1) * k, k), k)
    nb = src.copy()
    nb[:, 0] ^= np.uint32(1 << 30)                 # base 0 changed
    if dist == 2:
        nb[:, 0] ^= np.uint32(1 << 20)             # and base 5
    nb = _canon(nb, k)
    keys = np.concatenate([src, nb])
    weights = np.concatenate([v, w]).astype(np.float32)
    counts = np.full(len(keys), 50, np.int32)
    assert len(np.unique(pack_keys(keys))) == len(keys)
    got = {}
    for name, sp in (("jax", JaxSpectrum(jax_make_mesh(1), k, 4096)),
                     ("port", ms.MeshStreamingSpectrum(make_mesh(1, "cpu"),
                                                       k, 4096))):
        sp.set_table(keys, counts, weights)
        # ed 1 at dist 1; at dist 2 every source passes the shrink limit
        # (20 x (20 ^ 2) = 440 < 600)
        n = sp.purge_variants_mesh(sigmas, dist, 500.0 if dist == 1
                                   else 20.0, min_depth=2)
        kept = set(pack_keys(sp.finalize(min_depth=2)[0]).tolist())
        got[name] = (n, np.array([x not in kept for x in
                                  pack_keys(nb).tolist()]))
    assert np.array_equal(got["jax"][1], purged_if["fused_recip"])
    assert np.array_equal(got["port"][1], got["jax"][1])
    assert got["port"][0] == got["jax"][0] == int(got["jax"][1].sum())


def test_sqrt_is_correctly_rounded():
    """The threshold's float32 square root is XLA's and numpy's, correctly
    rounded (torch.sqrt of a float32 tensor need not be)."""
    rng = np.random.default_rng(4)
    v = (rng.random(1 << 22) * 1e6).astype(np.float32)
    got = ms._sqrt_f32(torch.from_numpy(v)).numpy()
    assert np.array_equal(got, np.sqrt(v))
    assert np.array_equal(got, np.asarray(jax.jit(jnp.sqrt)(v)))


@pytest.mark.parametrize("sign", [1, -1])
def test_fused_rounding_at_ties(sign):
    """_fma_sub_f32 rounds v - a * b once, also where the float64
    difference lands exactly halfway between two float32 values and only
    its rounding error decides the side (1024 + 2^-13 - (1 + 2^-16) *
    2^-14 (1 - 2^-16) = 1024 + 2^-14 + 2^-46, just past the midpoint)."""
    v = np.float32(1024 + 2.0 ** -13)
    a = np.float32(1 + 2.0 ** -16)
    b = np.float32(2.0 ** -14 * (1 - 2.0 ** -16))
    if sign < 0:
        v, b = -v, -b
    got = ms._fma_sub_f32(torch.tensor([v]), torch.tensor([a]),
                          torch.tensor([b]))
    want = np.float32(sign * (1024 + 2.0 ** -13))
    assert got.item() == want
    # the float64 difference alone, rounded again, lands on the even side
    double = np.float32(np.float64(v) - np.float64(a) * np.float64(b))
    assert double != want


@pytest.fixture(scope="module")
def deep_fastq(tmp_path_factory):
    """The deep_fastq input of tests/test_variant_purge_e2e.py: 200x of a
    3 kb genome with a Poisson(1) count of errors a read."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 3000, dtype=np.uint8)
    L, n = 100, 6000
    path = tmp_path_factory.mktemp("deep") / "deep.fastq"
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            s = int(rng.integers(0, 3000 - L))
            read = genome[s:s + L].copy()
            for _ in range(rng.poisson(1.0)):
                read[int(rng.integers(0, L))] = rng.integers(0, 4)
            f.write(b"@r%d\n" % i)
            f.write(bases[read].tobytes() + b"\n+\n")
            f.write(b"I" * L + b"\n")
    return str(path)


PURGE = ["--verbose", "1", "--kmer-scoring-type", "MEDIAN",
         "--mask-simple-repeats", "0", "--min-read-length", "25",
         "--variant-sigmas", "2.0", "--min-variant-kmer-depth", "20"]


def _removed(text):
    found = re.findall(r"Removed (\d+) kmer-variants", text)
    assert len(found) == 1, text[-2000:]
    return int(found[0])


def test_in_memory_mesh_purge_byte_identical(tmp_path, deep_fastq, capfd):
    """The in-memory --mesh 1 --variant-sigmas 2 --min-variant-kmer-depth
    20: the port's output and "Removed N" equal the JAX mesh app's and the
    JAX host engine's, and differ from the run without the purge. The JAX
    mesh app runs at --variant-edit-distance 1: every source here is below
    the distance-2 limit (20 x (20 ^ 2) = 440), so its marks are those of
    distance 2, which it would reach by expanding every source's
    distance-2 shell and masking it, about a minute on the CPU."""
    d = str(tmp_path)
    runs = {}
    for name, app, argv in (
            ("jax_mesh", jax_app, ["--threads", "1", "--mesh", "1",
                                   "--variant-edit-distance", "1"]),
            ("jax_host", jax_app, ["--threads", "1"]),
            ("port", torch_app, ["--device", "cpu", "--mesh", "1"]),
            ("port_ed1", torch_app, ["--device", "cpu", "--mesh", "1",
                                     "--variant-edit-distance", "1"])):
        capfd.readouterr()
        assert app.run(argv + PURGE + ["--out", os.path.join(d, name),
                                       "31", deep_fastq]) == 0
        runs[name] = (_removed(capfd.readouterr().err),
                      open(os.path.join(d, name + "-MinDepth2-deep.fastq"),
                           "rb").read())
    assert runs["port"][0] > 0
    for name in ("jax_mesh", "jax_host", "port_ed1"):
        assert runs[name] == runs["port"], name
    assert torch_app.run(["--device", "cpu", "--mesh", "1"] + PURGE[:-4]
                         + ["--out", os.path.join(d, "plain"), "31",
                            deep_fastq]) == 0
    assert open(os.path.join(d, "plain-MinDepth2-deep.fastq"),
                "rb").read() != runs["port"][1]
