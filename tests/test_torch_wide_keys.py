"""k > 32 in kmernator_tpu_torch: keys of L = ceil(W/2) int64 lanes against
the JAX package's W-word keys.

Inputs are made from numpy seeds here. Tolerance: none for keys, counts,
lookups and app output (bit- or byte-identical); the drain's weights as in
tests/test_torch_mesh_stream.py (1e-6 of the drain's total weight). JAX
oracle runs of the app use --threads 1, in this process.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.apps import filter_reads as jax_app
from kmernator_tpu.parallel.device_spectrum import (
    count_batch as jax_count_batch)
from kmernator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmernator_tpu.parallel.mesh_stream import (
    MeshStreamingSpectrum as JaxSpectrum)
from kmernator_tpu.parallel.pallas_count import run_length_counts_reference
from kmernator_tpu.parallel.spectrum import pack_keys as jax_pack_keys
from kmernator_tpu_torch.apps import filter_reads as torch_app
from kmernator_tpu_torch.ops import kmer as tk
from kmernator_tpu_torch.parallel import run_length as rl
from kmernator_tpu_torch.parallel.device_spectrum import (count_batch,
                                                          extract_canonical_cols,
                                                          sort_lanes)
from kmernator_tpu_torch.parallel.mesh import make_mesh
from kmernator_tpu_torch.parallel.mesh_stream import MeshStreamingSpectrum

import torch_threads  # noqa: F401

BASE = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
        "--artifact-edit-distance", "1", "--min-read-length", "25"]


def _words(rng, n, k):
    """n random W-word keys of k bases (pad bases zero), with sentinel rows,
    sign-bit words and repeats."""
    W = tk.nwords(k)
    words = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(
        np.uint32)
    words[:, W - 1] &= np.uint32(tk.last_word_mask(k))
    words[:5] = 0xFFFFFFFF
    words[5:10, 0] = 0x80000000
    words[10:20] = words[20:30]
    words[30:40, :W - 1] = words[40:50, :W - 1]   # equal but the last word
    return words


def _cols(words):
    return [torch.from_numpy(words[:, w].astype(np.int64))
            for w in range(words.shape[1])]


@pytest.mark.parametrize("k", [17, 33, 48, 63, 64, 95])
def test_lanes_round_trip_and_order(k):
    """encode_lanes/decode_lanes round-trip the words; a lexicographic
    signed sort of the lanes orders the keys as pack_keys does."""
    W = tk.nwords(k)
    words = _words(np.random.default_rng(k), 3000, k)
    lanes = tk.encode_lanes(_cols(words))
    assert len(lanes) == tk.nlanes(W) == (W + 1) // 2
    assert all(int(x[0]) == tk.SENTINEL_LANE for x in lanes)
    back = tk.decode_lanes(lanes, W)
    assert np.array_equal(np.stack([c.numpy() for c in back], -1),
                          words.astype(np.int64))
    s, perm = sort_lanes(lanes)
    order = np.argsort(jax_pack_keys(words), kind="stable")
    assert np.array_equal(words[perm.numpy()], words[order])
    assert np.array_equal(np.stack([c.numpy() for c in tk.decode_lanes(
        s, W)], -1), words[order].astype(np.int64))
    if W <= 2:
        assert torch.equal(lanes[0], tk.encode_lane(_cols(words)))


def _reference_w(words, good):
    """run_length_counts_reference over W-word keys."""
    N = len(words)
    counts = np.zeros(N, np.int32)
    i = 0
    while i < N:
        j = i
        tot = 0
        while j < N and np.array_equal(words[j], words[i]):
            tot += int(good[j])
            j += 1
        counts[j - 1] = tot
        i = j
    return counts


@pytest.mark.parametrize("k", [31, 33, 63, 95])
def test_run_length_lanes_against_reference(k):
    """The L-lane plain version and the kernel's schedule model against the
    JAX numpy reference, generalised to W words (and the JAX reference
    itself at W = 2)."""
    rng = np.random.default_rng(100 + k)
    W = tk.nwords(k)
    base = _words(rng, 300, k)
    words = base[rng.integers(0, len(base), 2500)]
    words = words[np.argsort(jax_pack_keys(words), kind="stable")]
    good = rng.random(len(words)) < 0.7
    want = _reference_w(words, good)
    if W == 2:
        assert np.array_equal(want, run_length_counts_reference(
            words[:, 0], words[:, 1], good))
    lanes = tk.encode_lanes(_cols(words))
    vals = torch.from_numpy(good.astype(np.int32))
    got = rl.run_length_sums(lanes, vals)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(rl.run_length_schedule_plain(lanes, vals, 256)
                          .numpy(), want)


def test_run_length_lanes_refused():
    x = torch.zeros(4, dtype=torch.int64)
    ones = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 3 key lanes"):
        rl.run_length_sums([x] * 4, ones)
    with pytest.raises(ValueError):
        rl.run_length_sums([x, x[:3]], ones)
    assert torch.equal(rl.run_length_sums([x], ones),
                       rl.run_length_sums(x, ones))


def _reads(rng, B, L, genome_len=2000):
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    codes = genome[rng.integers(0, genome_len - L, B)[:, None]
                   + np.arange(L)[None, :]]
    codes[B // 2:] = rng.integers(0, 4, (B - B // 2, L))
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    return codes, lengths


@pytest.mark.parametrize("k", [33, 63])
def test_count_batch_wide_matches_jax(k):
    rng = np.random.default_rng(k)
    codes, lengths = _reads(rng, 96, 120)
    cols, _, valid = extract_canonical_cols(torch.from_numpy(codes),
                                            torch.from_numpy(lengths), k)
    cols = [c.reshape(-1) for c in cols]
    good = valid.reshape(-1) & torch.from_numpy(
        rng.random(valid.numel()) < 0.9)
    words = np.stack([c.numpy() for c in cols], -1).astype(np.uint32)
    for min_count in (1, 2):
        want = jax_count_batch(jnp.asarray(words), jnp.asarray(good.numpy()),
                               min_count=min_count)
        got = count_batch(cols, good, min_count=min_count)
        assert np.array_equal(got[0].numpy().astype(np.uint32),
                              np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[2]) == int(want[2]) > 0


@pytest.mark.parametrize("k", [33, 95])
def test_mesh_drain_and_lookup_match_jax(k):
    """Drain after every batch, lookup and to_numpy_tables of the L-lane
    table against the JAX class on make_mesh(1)."""
    rng = np.random.default_rng(7 * k)
    B, L = 24, k + 40
    NW = L - k + 1
    jsp = JaxSpectrum(jax_make_mesh(1), k, capacity=2048,
                      drain_threshold=2 * B * NW)
    tsp = MeshStreamingSpectrum(make_mesh(1, "cpu"), k, capacity=2048,
                                drain_threshold=2 * B * NW)
    assert tsp.L == tk.nlanes(tk.nwords(k))
    batches = []
    w_in = 0.0
    for _ in range(5):
        codes, lengths = _reads(rng, B, L, 400)
        lengths[-1] = 0
        good = rng.random((B, NW)) < 0.9
        weights = rng.random((B, NW)).astype(np.float32)
        g = good & (np.arange(NW)[None, :] <= lengths[:, None] - k)
        w_in += float(weights[g].sum())
        batches.append((codes, lengths))
        jsp.add_batch(codes, good, lengths, weights2d=weights)
        tsp.add_batch(codes, good, lengths, weights2d=weights)
        if not tsp._staged:
            jt = (np.stack([np.asarray(c) for c in jsp.table_cols]),
                  np.asarray(jsp.table_counts), np.asarray(jsp.table_weights))
            tt = tsp.to_numpy_tables()
            assert np.array_equal(jt[0], tt[0])
            assert np.array_equal(jt[1], tt[1])
            np.testing.assert_allclose(tt[2], jt[2], rtol=0,
                                       atol=1e-6 * w_in)
            w_in = float(jt[2].sum())
    assert tsp.drains >= 2
    for codes, lengths in batches:
        want = np.ones((B, NW), bool)
        for mc in (1, 2):
            j = np.asarray(jsp.lookup_batch(codes, want, lengths,
                                            min_count=mc))
            t = tsp.lookup_batch(codes, want, lengths, min_count=mc)
            assert np.array_equal(j, t)
    assert (t >= 2).any()
    jk, jc = jsp.finalize(min_depth=1)
    tk_, tc = tsp.finalize(min_depth=1)
    assert np.array_equal(jk, tk_) and np.array_equal(jc, tc)
    # the state carry at L lanes
    cols, counts, weights = tsp.to_numpy_tables()
    back = MeshStreamingSpectrum(make_mesh(1, "cpu"), k, capacity=2048)
    back.from_numpy_tables(cols, counts, weights)
    assert all(np.array_equal(a, b) for a, b in
               zip((cols, counts, weights), back.to_numpy_tables()))
    with pytest.raises(ValueError, match="not sorted"):
        back.from_numpy_tables(cols[:, :, ::-1], counts, weights)


def _genome_reads(path, seed, n_reads=400, read_len=90, genome_len=5000):
    """Reads of a random genome with 1% substitutions and varied quals."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    recs = []
    for i in range(n_reads):
        s = int(rng.integers(0, genome_len - read_len))
        read = genome[s:s + read_len].copy()
        err = rng.random(read_len) < 0.01
        read[err] = (read[err] + 1) % 4
        q = bytes(rng.integers(45, 74, read_len).astype(np.uint8))
        recs.append(b"@w%04d\n%s\n+\n%s\n" % (i, acgt[read].tobytes(), q))
    with open(path, "wb") as f:
        f.write(b"".join(recs))


def _outputs(d, prefix):
    return {n[len(prefix):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix)}


@pytest.mark.parametrize("k,extra", [
    (33, ["--mesh", "1", "--mesh-batch", "64"]),
    (63, ["--streaming", "--mesh", "1", "--streaming-chunk-mb", "0.01",
          "--mesh-batch", "64"])], ids=["in-memory-k33", "streaming-k63"])
def test_filter_reads_wide_k_byte_identical(tmp_path, k, extra):
    """FilterReads at k > 32 on both --mesh 1 paths: every output file
    byte-identical to the JAX mesh app's."""
    inp = str(tmp_path / "in.fastq")
    _genome_reads(inp, k)
    d = str(tmp_path)
    assert jax_app.run(["--threads", "1"] + extra
                       + ["--out", os.path.join(d, "jax")] + BASE
                       + [str(k), inp]) == 0
    assert torch_app.run(["--device", "cpu"] + extra
                         + ["--out", os.path.join(d, "torch")] + BASE
                         + [str(k), inp]) == 0
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert want and set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(len(v) > 1000 for v in got.values())
