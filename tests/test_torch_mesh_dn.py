"""MeraculousCounter's extension spectrum, the assembler's read matcher and
their CLIs at D = 2 and 4 shards, against the JAX functions and apps on 2
and 4 of the test process's 8 CPU devices; and ROADMAP fault 3n, the JAX
`make_mesh` that builds a smaller mesh than asked on a host with fewer
devices.

Tolerance: none. Keys, counts, extension counters, read ids, overflow
counts and every output file are bit- or byte-identical.
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.apps import meraculous_counter as jax_mer
from kmernator_tpu.apps import nucleating_assembler as jax_asm
from kmernator_tpu.apps.generate_metagenome import run as generate
from kmernator_tpu.io.reads import load_reads as jax_load_reads
from kmernator_tpu.parallel import mesh as jax_mesh
from kmernator_tpu.parallel.dist_match import (MeshReadIndex as JaxIndex,
                                               build_index_fn, match_fn)
from kmernator_tpu_torch.apps import meraculous_counter as torch_mer
from kmernator_tpu_torch.apps import nucleating_assembler as torch_asm
from kmernator_tpu_torch.io.reads import load_reads
from kmernator_tpu_torch.ops.kmer import decode_lanes, nwords
from kmernator_tpu_torch.parallel import dist_match as dm
from kmernator_tpu_torch.parallel import mesh as tm

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reads(k, B=240, L=90, seed=0):
    """Reads from a 3 kb genome with ragged lengths (some shorter than k),
    random good masks and extension flags, as numpy arrays."""
    rng = np.random.default_rng(seed + k)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[B // 3:B // 2] = rng.integers(0, 4, (B // 2 - B // 3, L))
    lengths = rng.integers(k - 5, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    good = rng.random((B, L - k + 1)) < 0.9
    ext_ok = rng.random((B, L)) < 0.95
    return codes, good, ext_ok, lengths


def _words(lanes, W):
    return np.stack([c.numpy() for c in decode_lanes(lanes, W)],
                    axis=1).astype(np.uint32).reshape(-1, W)


@pytest.mark.parametrize("D,k,factor", [(2, 21, 2.0), (4, 45, 2.0),
                                        (4, 21, 0.3)])
def test_extension_spectrum_against_jax(D, k, factor):
    """extension_spectrum_mesh against distributed_extension_fn on D
    devices: the merged table equals the JAX shards' kept rows in key
    order; at a capacity_factor of 0.3 both overflow by the same rows."""
    codes, good, ext_ok, lengths = _reads(k)
    fn = jax_mesh.distributed_extension_fn(jax_mesh.make_mesh(D), k,
                                           capacity_factor=factor,
                                           min_count=1)
    sk, sc, se, ov = (np.asarray(x) for x in fn(
        jnp.asarray(codes), jnp.asarray(good), jnp.asarray(ext_ok),
        jnp.asarray(lengths)))
    lanes, counts, ext, overflow = tm.extension_spectrum_mesh(
        tm.make_mesh(D, "cpu"), k, *(torch.from_numpy(a) for a in
                                     (codes, good, ext_ok, lengths)),
        min_count=1, capacity_factor=factor)
    assert overflow == int(ov.sum())
    if overflow:
        assert lanes is None and factor < 1
        return
    real = (sc > 0) & ~np.all(sk == 0xFFFFFFFF, axis=1)
    order = np.lexsort(sk[real].T[::-1])
    assert np.array_equal(_words(lanes, nwords(k)), sk[real][order])
    assert np.array_equal(counts.numpy(), sc[real][order])
    assert np.array_equal(ext.numpy(), se[real][order])


@pytest.mark.parametrize("D,k", [(2, 31), (4, 45), (4, 21)])
def test_build_index_and_match_against_jax(D, k):
    """build_index against build_index_fn on D devices, shard by shard
    (the JAX shard's rows with a read id, keys and ids row for row), and
    match_shards against match_fn on hits and misses; a capacity_factor
    of 0.3 overflows by the same rows."""
    codes, good, _, lengths = _reads(k, seed=5)
    B = codes.shape[0]
    args = [jnp.asarray(codes), jnp.asarray(good), jnp.asarray(lengths),
            jnp.arange(B, dtype=jnp.int32)]
    jmesh = jax_mesh.make_mesh(D)
    tens = [torch.from_numpy(a) for a in (codes, good, lengths)]
    mesh = tm.make_mesh(D, "cpu")
    _, _, jov = build_index_fn(jmesh, k, 0.3)(*args)
    assert dm.build_index(mesh, k, *tens, capacity_factor=0.3) == \
        (None, int(np.asarray(jov).sum()))
    ikeys, irid, jov = build_index_fn(jmesh, k)(*args)
    assert int(np.asarray(jov).sum()) == 0
    shards, overflow = dm.build_index(mesh, k, *tens)
    assert overflow == 0 and len(shards) == D
    W = nwords(k)
    ikeys, irid = np.asarray(ikeys), np.asarray(irid)
    per = len(irid) // D
    for d, (lanes, rid) in enumerate(shards):
        jk, jr = ikeys[d * per:(d + 1) * per], irid[d * per:(d + 1) * per]
        real = jr >= 0
        assert real[:real.sum()].all() and rid.numel() == real.sum() > 0
        assert np.array_equal(_words(lanes, W), jk[real])
        assert np.array_equal(rid.numpy(), jr[real])
    rng = np.random.default_rng(k)
    queries = np.concatenate([ikeys[irid >= 0][rng.integers(
        0, int((irid >= 0).sum()), 300)], rng.integers(
            0, 1 << 32, (20, W), dtype=np.uint64).astype(np.uint32)])
    for max_ids, min_depth in ((16, 0), (4, 3)):
        want = np.asarray(match_fn(jmesh, k, max_ids=max_ids,
                                   min_depth=min_depth)(
            jnp.asarray(queries), jnp.asarray(ikeys), jnp.asarray(irid)))
        got = dm.match_shards(shards, [torch.from_numpy(
            queries[:, w].astype(np.int64)) for w in range(W)], max_ids,
            min_depth)
        assert np.array_equal(got.numpy(), want) and (want >= 0).any()


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshdn")
    path = str(d / "meta.fastq")
    assert generate(["--genomes", "4", "--total-genome-mb", "0.02",
                     "--coverage", "15", "--read-length", "150",
                     "--seed", "7", "--out", path]) in (0, None)
    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    pick = np.random.default_rng(3).choice(len(seqs) - 1, 4, replace=False)
    seeds = str(d / "seeds.fa")
    with open(seeds, "wb") as f:
        for i, r in enumerate(pick):
            f.write(b">seed%d\n%s\n" % (i, seqs[r][:100]))
    return path, seeds


@pytest.mark.parametrize("D", [2, 4])
def test_read_index_retry_against_jax(meta, monkeypatch, D):
    """MeshReadIndex from a capacity_factor of 0.3: its build overflows
    and retries at twice the factor until the buckets fit, as the JAX
    class does, and the index answers as the JAX one does."""
    k = 31
    builds = []
    plain = dm.build_index

    def counted(*a, **kw):
        out = plain(*a, **kw)
        builds.append(out[1])
        return out

    monkeypatch.setattr(dm, "build_index", counted)
    want_index = JaxIndex(jax_mesh.make_mesh(D), jax_load_reads([meta[0]]),
                          k, max_ids=16, capacity_factor=0.3)
    index = dm.MeshReadIndex(tm.make_mesh(D, "cpu"), load_reads([meta[0]]),
                             k, max_ids=16, capacity_factor=0.3)
    assert len(builds) >= 2 and builds[0] > 0 and builds[-1] == 0
    W = nwords(k)
    rng = np.random.default_rng(D)
    queries = np.concatenate([_words(lanes, W)[:100]
                              for lanes, _ in index._shards]
                             + [rng.integers(0, 1 << 32, (20, W),
                                             dtype=np.uint64)
                                .astype(np.uint32)])
    got = index.match_queries(queries)
    assert got == want_index.match_queries(queries)
    assert sum(len(x) for x in got) > 100


def _outputs(d, prefix):
    return {n[len(prefix):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix)}


@pytest.mark.parametrize("D,k", [(2, 21), (4, 45)])
def test_meraculous_cli(tmp_path, meta, D, k):
    """MeraculousCounter --mesh D: mercount and mergraph byte-identical to
    the JAX app's at the same D."""
    d = str(tmp_path)
    assert jax_mer.run(["--jax-platform", "cpu", "--mesh", str(D),
                        "--kmer-size", str(k), "--out",
                        os.path.join(d, "jax"), meta[0]]) == 0
    assert torch_mer.run(["--device", "cpu", "--mesh", str(D),
                          "--kmer-size", str(k), "--out",
                          os.path.join(d, "torch"), meta[0]]) == 0
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert set(want) == {".mercount.m%d" % k, ".mergraph.m%d.D2" % k}
    assert got == want and all(len(v) > 1000 for v in got.values())


@pytest.mark.parametrize("D,k", [(2, 31), (4, 45)])
def test_assembler_cli(tmp_path, meta, D, k):
    """The nucleating assembler --mesh D: the contigs and every checkpoint
    byte-identical to the JAX app's at the same D."""
    fq, seeds = meta
    common = ["--contig-file", seeds, "--max-iterations", "2",
              "--artifact-edit-distance", "1", "--mesh", str(D)]
    jax_out, torch_out = str(tmp_path / "jax.fa"), str(tmp_path / "torch.fa")
    assert jax_asm.run(common + ["--jax-platform", "cpu", "--out", jax_out,
                                 str(k), fq]) == 0
    assert torch_asm.run(["--device", "cpu"] + common
                         + ["--out", torch_out, str(k), fq]) == 0
    want = _outputs(str(tmp_path), "jax.fa")
    got = _outputs(str(tmp_path), "torch.fa")
    assert "" in want and got == want
    assert b"-l" in got[""] or b"-r" in got[""]     # some contig grew


def test_jax_make_mesh_truncates(tmp_path):
    """ROADMAP fault 3n, kept visible: on a host with one JAX device,
    make_mesh(2) builds a mesh of one device, while FilterReads --mesh 2
    sizes each shard for two (ceil(n_good / 2 * 1.25)), so the one table
    holds about 0.63 of the good windows and purges singletons. The port's
    make_mesh(2) is two shards on its one device, and its --mesh 2 purges
    nothing here."""
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    inp = str(tmp_path / "rand.fastq")
    with open(inp, "wb") as f:
        for i in range(150):
            f.write(b"@r%d\n%s\n+\n%s\n" % (
                i, acgt[rng.integers(0, 4, 100)].tobytes(), b"I" * 100))
    script = """
import sys, jax
jax.config.update("jax_platforms", "cpu")
from kmernator_tpu.parallel import mesh, mesh_stream
from kmernator_tpu.apps import filter_reads
seen = []
class Seen(mesh_stream.MeshStreamingSpectrum):
    def __init__(self, m, k, capacity, **kw):
        super().__init__(m, k, capacity, **kw)
        seen.append(self)
mesh_stream.MeshStreamingSpectrum = Seen
assert filter_reads.run(["--jax-platform", "cpu", "--mesh", "2", "--out",
                         sys.argv[2], "31", sys.argv[1]]) == 0
print(mesh.make_mesh(2).devices.size, seen[0].D, seen[0].cap,
      seen[0].purged_singletons)
"""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "-c", script, inp,
                           str(tmp_path / "jax")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    size, D, cap, purged = map(int, proc.stdout.split()[-4:])
    n_good = 150 * (100 - 31 + 1)
    assert (size, D) == (1, 1)
    assert cap == int(np.ceil(n_good / 2 * 1.25)) and purged > 0
    assert "purged" in proc.stderr
    from kmernator_tpu_torch.apps import filter_reads as torch_fr
    from kmernator_tpu_torch.parallel import mesh_stream as ms
    seen = []

    class Seen(ms.MeshStreamingSpectrum):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)

    plain, torch_fr.MeshStreamingSpectrum = torch_fr.MeshStreamingSpectrum, \
        Seen
    try:
        assert torch_fr.run(["--device", "cpu", "--mesh", "2", "--out",
                             str(tmp_path / "torch"), "31", inp]) == 0
    finally:
        torch_fr.MeshStreamingSpectrum = plain
    assert tm.make_mesh(2, "cpu").size == 2
    assert (seen[0].D, seen[0].cap) == (2, cap)
    assert seen[0].purged_singletons == 0
