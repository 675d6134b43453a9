"""The port's read matcher at D = 1 (kmernator_tpu_torch/parallel/
dist_match.py, and `search_lanes` in parallel/device_spectrum.py) against
the JAX `build_index_fn` and `match_fn` at make_mesh(1) on the CPU, and
against the host `KmerReadIndex`.

Inputs are built here: phiX reads sampled with numpy from
kmernator_tpu_torch/data/phix174.fasta on both strands, with N bases,
reads shorter than k and discarded reads, and seeded numpy key tables.
Tolerance: none. Index keys and read ids, insertion points and the
[Q, max_ids] answers are bit-equal, hit sets equal.
"""
import bisect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmernator_tpu.io.reads import load_reads as jax_load_reads
from kmernator_tpu.ops.match import KmerReadIndex as JaxKmerReadIndex
from kmernator_tpu.parallel.dist_match import (MeshReadIndex as
                                               JaxMeshReadIndex,
                                               build_index_fn, match_fn)
from kmernator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmernator_tpu_torch.io.reads import BASE_CODE, load_reads
from kmernator_tpu_torch.ops import kmer as tk
from kmernator_tpu_torch.ops.weights import good_kmer_mask, window_weights
from kmernator_tpu_torch.parallel import dist_match as dm
from kmernator_tpu_torch.parallel.device_spectrum import (
    pack_readset, ragged_to_padded, search_lanes)
from kmernator_tpu_torch.parallel.mesh import make_mesh
from kmernator_tpu_torch.parallel.spectrum import pack_keys

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
MESH = make_mesh(1, "cpu")


def phix_genome() -> bytes:
    with open(os.path.join(REPO, "kmernator_tpu_torch", "data",
                           "phix174.fasta"), "rb") as f:
        return b"".join(l.strip() for l in f if not l.startswith(b">"))


def _revcomp(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]


def _write_reads(path, rng, n_reads=600, planted=b"", n_planted=0):
    """phiX reads of 40-90 bp on both strands (0.3% substitutions, a tenth
    of the bases at phred 2-19), an N in every ninth read, reads of 5-20
    bp in every twentieth, and `planted` copied into the first n_planted
    reads. Returns the discarded mask to set on the loaded read set."""
    g = phix_genome()
    circ = g + g[:200]
    with open(path, "wb") as f:
        for i in range(n_reads):
            n = int(rng.integers(5, 21) if i % 20 == 19
                    else rng.integers(40, 91))
            s = int(rng.integers(0, len(g)))
            seq = bytearray(circ[s:s + n])
            for e in np.nonzero(rng.random(n) < 0.003)[0]:
                seq[e] = ACGT[(b"ACGT".index(seq[e]) + 1) % 4]
            if i < n_planted:
                p = int(rng.integers(0, max(n - len(planted), 0) + 1))
                seq[p:p + len(planted)] = planted[:n - p]
            if i % 9 == 4:
                seq[int(rng.integers(0, n))] = ord("N")
            seq = bytes(seq)
            if i % 2:
                seq = _revcomp(seq)
            phred = rng.integers(20, 41, n)
            low = rng.random(n) < 0.1
            phred[low] = rng.integers(2, 20, int(low.sum()))
            f.write(b"@r%04d\n%s\n+\n%s\n"
                    % (i, seq, bytes((phred + 33).astype(np.uint8))))
    discarded = np.zeros(n_reads, bool)
    discarded[3::17] = True
    return discarded


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """The same FASTQ loaded by both packages, the same reads discarded;
    and a second set with a 40-mer planted in 30 reads."""
    d = tmp_path_factory.mktemp("match")
    out = {}
    for name, planted, n_planted in (("phix", b"", 0),
                                     ("planted", None, 30)):
        rng = np.random.default_rng(21 if planted is None else 20)
        if planted is None:
            planted = ACGT[rng.integers(0, 4, 40)].tobytes()
        path = str(d / (name + ".fastq"))
        discarded = _write_reads(path, rng, planted=planted,
                                 n_planted=n_planted)
        pair = (load_reads([path]), jax_load_reads([path]))
        for rs in pair:
            rs.discarded[:] = discarded
        out[name] = pair
    out["planted_seq"] = planted
    return out


def _device_inputs(rs, k):
    """The host side of MeshReadIndex: padded codes, the exact good mask
    with discarded reads masked out, lengths (numpy)."""
    L = max(rs.max_length(), k)
    codes, _, lengths = pack_readset(rs, L, 3, 33)
    markup = BASE_CODE[rs.seq] == 4
    w = window_weights(rs.base_probabilities(3, 33), rs.offsets, markup, k)
    nw = np.maximum(rs.lengths() - k + 1, 0)
    good2d = ragged_to_padded(good_kmer_mask(w, 0.10), nw, L - k + 1,
                              fill=False)
    good2d &= ~rs.discarded[:, None]
    return codes, good2d, lengths


def _jax_index(codes, good2d, lengths, k):
    """The JAX index at make_mesh(1): its sentinel rows (read id -1, after
    every real key) cut off."""
    ikeys, irid, overflow = build_index_fn(jax_make_mesh(1), k)(
        jnp.asarray(codes), jnp.asarray(good2d), jnp.asarray(lengths),
        jnp.arange(codes.shape[0], dtype=jnp.int32))
    assert int(np.asarray(overflow).sum()) == 0
    irid = np.asarray(irid)
    real = irid >= 0
    assert real[:real.sum()].all()
    return np.asarray(ikeys), irid, int(real.sum())


def _port_index(codes, good2d, lengths, k):
    shards, overflow = dm.build_index(MESH, k, torch.from_numpy(codes),
                                      torch.from_numpy(good2d),
                                      torch.from_numpy(lengths))
    assert overflow == 0 and len(shards) == 1
    return shards[0]


def _query_words(rs, k, rng, n_miss=6):
    """Canonical k-mers of the first and last window of every read long
    enough, then n_miss random keys (all but certainly absent)."""
    codes = np.where(BASE_CODE[rs.seq] == 4, 0, BASE_CODE[rs.seq])
    canon, _, rid, _ = tk.extract_kmers_flat(codes.astype(np.uint8),
                                             rs.offsets, k)
    first = np.concatenate([[True], rid[1:] != rid[:-1]])
    last = np.concatenate([rid[1:] != rid[:-1], [True]])
    q = canon[first | last]
    W = tk.nwords(k)
    miss = rng.integers(0, 1 << 32, (n_miss, W), dtype=np.uint64)
    miss = miss.astype(np.uint32)
    miss[:, W - 1] &= np.uint32(tk.last_word_mask(k))
    return np.concatenate([q, miss])


def _lanes(words):
    return tk.encode_lanes([torch.from_numpy(words[:, w].astype(np.int64))
                            for w in range(words.shape[1])])


@pytest.mark.parametrize("k,min_depth", [(21, 1), (31, 2), (45, 3),
                                         (63, 2)])
def test_index_and_match_equal_jax_and_host(reads, k, min_depth):
    """build_index equals the JAX index row for row (keys and read ids);
    match equals the JAX match_fn at make_mesh(1) on hits and misses; and
    each query's ids equal the host KmerReadIndex's run where the run fits
    max_ids."""
    rs, jrs = reads["phix"]
    codes, good2d, lengths = _device_inputs(rs, k)
    jkeys, jrid, C = _jax_index(codes, good2d, lengths, k)
    lanes, rid = _port_index(codes, good2d, lengths, k)
    assert len(lanes) == tk.nlanes(tk.nwords(k))
    assert rid.dtype == torch.int32 and rid.numel() == C > 1000
    got_keys = torch.stack(tk.decode_lanes(lanes, tk.nwords(k)), -1)
    assert np.array_equal(got_keys.numpy().astype(np.uint32), jkeys[:C])
    assert np.array_equal(rid.numpy(), jrid[:C])

    max_ids = 8
    words = _query_words(rs, k, np.random.default_rng(k))
    want = np.asarray(match_fn(jax_make_mesh(1), k, max_ids=max_ids,
                               min_depth=min_depth)(
        jnp.asarray(words), jnp.asarray(jkeys), jnp.asarray(jrid)))
    got = dm.match(lanes, rid, _lanes(words), max_ids, min_depth)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want[-6:] == -1).all() and (want[:, 0] >= 0).sum() > 50

    host = JaxKmerReadIndex(jrs, k, min_depth=min_depth)
    hkeys = pack_keys(words)
    gated = 0
    for q, key in enumerate(hkeys):
        j = np.searchsorted(host.keys, key)
        found = j < len(host.keys) and host.keys[j] == key
        run = (host.read_ids[host.offsets[j]:host.offsets[j + 1]]
               if found else [])
        if len(run) > max_ids:
            continue
        expect = set(run.tolist()) if found and host._keep[j] else set()
        gated += found and not host._keep[j]
        assert set(got[q][got[q] >= 0].tolist()) == expect, q
    assert gated > 0 or min_depth <= 1


def test_runs_cut_at_max_ids_equal_jax(reads):
    """A 40-mer planted in 30 reads: its runs are longer than max_ids = 4,
    so the cut keeps the 4 smallest read ids, as the JAX sort's read-id
    key makes it, at k = 21 (one lane) and 33 (two lanes)."""
    rs, _ = reads["planted"]
    for k in (21, 33):
        codes, good2d, lengths = _device_inputs(rs, k)
        jkeys, jrid, C = _jax_index(codes, good2d, lengths, k)
        lanes, rid = _port_index(codes, good2d, lengths, k)
        codes = BASE_CODE[np.frombuffer(reads["planted_seq"], np.uint8)]
        planted = tk.extract_kmers_flat(codes, np.array([0, 40]), k)[0]
        words = np.concatenate(
            [planted, _query_words(rs, k, np.random.default_rng(1))[:40]])
        want = np.asarray(match_fn(jax_make_mesh(1), k, max_ids=4)(
            jnp.asarray(words), jnp.asarray(jkeys), jnp.asarray(jrid)))
        got = dm.match(lanes, rid, _lanes(words), 4)
        assert np.array_equal(got.numpy(), want)
        full = dm.match(lanes, rid, _lanes(words), 64)
        long_runs = (full >= 0).sum(1) > 4
        assert long_runs[:len(planted)].sum() >= len(planted) // 2
        cut = got[long_runs]
        assert (cut >= 0).all()
        assert torch.equal(cut, full[long_runs][:, :4])
        assert (cut[:, 1:] >= cut[:, :-1]).all()


@pytest.mark.parametrize("case", ["shorter_than_k", "all_discarded"])
def test_empty_index(reads, case):
    """Every read shorter than k, or every read discarded: the port's
    index has no row, the JAX one only sentinel rows; both answer every
    query with no id, and MeshReadIndex gives empty sets."""
    rs, jrs = reads["phix"]
    k = 95 if case == "shorter_than_k" else 31
    if case == "all_discarded":
        rs.discarded[:] = True
    try:
        codes, good2d, lengths = _device_inputs(rs, k)
        jkeys, jrid, C = _jax_index(codes, good2d, lengths, k)
        lanes, rid = _port_index(codes, good2d, lengths, k)
        assert C == 0 and rid.numel() == 0
        words = _query_words(jrs, 31, np.random.default_rng(2))[:40]
        if k != 31:
            W = tk.nwords(k)
            words = np.random.default_rng(3).integers(
                0, 1 << 32, (40, W), dtype=np.uint64).astype(np.uint32)
            words[:, W - 1] &= np.uint32(tk.last_word_mask(k))
        want = np.asarray(match_fn(jax_make_mesh(1), k, max_ids=8)(
            jnp.asarray(words), jnp.asarray(jkeys), jnp.asarray(jrid)))
        got = dm.match(lanes, rid, _lanes(words), 8)
        assert (want == -1).all() and np.array_equal(got.numpy(), want)
        index = dm.MeshReadIndex(MESH, rs, k, min_depth=1)
        assert [rid.numel() for _, rid in index._shards] == [0]
        assert index.match_queries(words) == [set()] * len(words)
    finally:
        rs.discarded[:] = False
        rs.discarded[3::17] = True


@pytest.mark.parametrize("k", [31, 45])
def test_mesh_read_index_equals_jax(reads, k):
    """MeshReadIndex.match_queries (compacted hits, one copy to the host)
    gives the JAX class's list of sets, in the same insertion order."""
    rs, jrs = reads["planted"]
    words = _query_words(rs, k, np.random.default_rng(4))
    want = JaxMeshReadIndex(jax_make_mesh(1), jrs, k, max_ids=16
                            ).match_queries(words)
    got = dm.MeshReadIndex(MESH, rs, k, max_ids=16).match_queries(words)
    assert got == want
    assert [list(s) for s in got] == [list(s) for s in want]
    assert sum(len(s) for s in got) > 500


def _lex_table(rng, n, L, n_keys):
    """n sorted keys of L int64 lanes from n_keys distinct keys sharing
    leading lanes, and the same keys as Python tuples."""
    pool = rng.integers(-(1 << 62), 1 << 62, (n_keys, L), dtype=np.int64)
    if L > 1:
        pool[1::2, :L - 1] = pool[0::2, :L - 1][:len(pool[1::2])]
    rows = sorted(map(tuple, pool[rng.integers(0, n_keys, n)].tolist()))
    return rows, [torch.tensor([r[j] for r in rows], dtype=torch.int64)
                  for j in range(L)]


@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_search_lanes_both_sides(L, n):
    """search_lanes against bisect over tuples on both sides (and against
    numpy.searchsorted at L = 1): queries in the table, between, below and
    above every key, and keys equal in all but the last lane."""
    rng = np.random.default_rng(10 * L + n)
    rows, table = _lex_table(rng, n, L, max(n // 3, 1))
    extra = rng.integers(-(1 << 62), 1 << 62, (50, L), dtype=np.int64)
    queries = rows[::3] + list(map(tuple, extra.tolist())) + [
        (-(1 << 63),) * L, ((1 << 63) - 1,) * L]
    if rows and L > 1:
        queries.append(rows[0][:L - 1] + (rows[0][-1] + 1,))
    q = [torch.tensor([r[j] for r in queries], dtype=torch.int64)
         for j in range(L)]
    for right, side in ((False, bisect.bisect_left),
                        (True, bisect.bisect_right)):
        got = search_lanes(table, q, right=right)
        assert got.tolist() == [side(rows, r) for r in queries]
        if L == 1:
            want = np.searchsorted(table[0].numpy(), q[0].numpy(),
                                   side="right" if right else "left")
            assert np.array_equal(got.numpy(), want)
