"""FilterReads at `--mesh 2` and `--mesh 4` (both --mesh paths: in-memory
and --streaming) against the JAX app at the same mesh size on 2 and 4 of
the test process's 8 CPU devices: every output file byte-identical
(tolerance: none), and the singleton purge under capacity pressure warned
of in both. The JAX app, not the host engine, is the oracle here: under
pressure a shard's drain purges singletons at batches that depend on D."""
import os
import re

import numpy as np
import pytest

from kmernator_tpu.apps import filter_reads as jax_app
from kmernator_tpu_torch.apps import filter_reads as torch_app

import torch_threads  # noqa: F401

BASE = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
        "--artifact-edit-distance", "1", "--min-read-length", "25"]
STREAM = ["--streaming", "--streaming-chunk-mb", "0.05", "--mesh-batch",
          "128"]
PURGED = re.compile(r"mesh (?:build|streaming) purged (\d+) singletons")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """3,000 reads of 100 bp from a 1.5 kb genome (about 150x a 31-mer)
    with a Poisson(0.5) count of errors a read, then 300 random reads:
    solid keys, variants of them seen more than once, and many
    singletons."""
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 1500, dtype=np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    path = str(tmp_path_factory.mktemp("meshfr") / "mixed.fastq")
    with open(path, "wb") as f:
        for i in range(3300):
            if i < 3000:
                s = int(rng.integers(0, 1500 - 100))
                read = genome[s:s + 100].copy()
                for _ in range(rng.poisson(0.5)):
                    read[int(rng.integers(0, 100))] = rng.integers(0, 4)
            else:
                read = rng.integers(0, 4, 100, dtype=np.uint8)
            f.write(b"@m%d\n%s\n+\n%s\n" % (i, acgt[read].tobytes(),
                                            b"I" * 100))
    return path


def _outputs(d, prefix):
    return {n[len(prefix):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix)}


@pytest.mark.parametrize("D,k,extra", [
    (2, 31, ["--mesh-batch", "256"]),
    (4, 31, ["--mesh-batch", "256"]),
    (2, 33, []),
    (2, 31, STREAM),
    (4, 31, STREAM),
    (2, 31, ["--variant-sigmas", "2", "--min-variant-kmer-depth", "20",
             "--variant-edit-distance", "1", "--verbose", "1"]),
    (4, 31, STREAM + ["--streaming-parts", "2000"]),
], ids=["in-memory-2", "in-memory-4", "k33-2", "streaming-2", "streaming-4",
        "variant-sigmas-2", "pressure-4"])
def test_mesh_n_byte_identical(tmp_path, mixed, capfd, D, k, extra):
    """Both apps at --mesh D with `extra`: the same output files, the same
    "Removed N" for --variant-sigmas, and, with --streaming-parts 2000 (a
    shard of 2,000 rows against some 40,000 distinct keys), the same
    count of singletons purged under capacity pressure, warned of by
    both."""
    d = str(tmp_path)
    logs = {}
    for name, app, flag in (("jax", jax_app, ["--jax-platform", "cpu"]),
                            ("torch", torch_app, ["--device", "cpu"])):
        capfd.readouterr()
        assert app.run(flag + ["--mesh", str(D)] + extra
                       + ["--out", os.path.join(d, name)] + BASE
                       + [str(k), mixed]) == 0
        logs[name] = capfd.readouterr().err
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert want and set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(len(v) for v in got.values())
    purged = {name: PURGED.findall(log) for name, log in logs.items()}
    assert purged["jax"] == purged["torch"]
    assert bool(purged["torch"]) == ("--streaming-parts" in extra)
    if "--variant-sigmas" in extra:
        removed = {name: re.findall(r"Removed (\d+) kmer-variants", log)
                   for name, log in logs.items()}
        assert removed["jax"] == removed["torch"]
        assert len(removed["torch"]) == 1 and int(removed["torch"][0]) > 0


@pytest.mark.parametrize("D", [2, 4])
def test_in_memory_mesh_sized_without_discarded_reads(tmp_path, capfd,
                                                      monkeypatch, D):
    """The in-memory --mesh engine sizes its shards by the good windows of
    the reads not discarded (1.25x a shard's share), where the JAX app
    also counts the discarded reads'. On reads of which four in five are
    discarded as artifacts (an adapter then 76 random bases, every window
    good) and the rest mostly distinct keys, the smaller shards, past the
    4,096-row floor, hold every key: no singleton purged, and the output
    files the host engine's."""
    rng = np.random.default_rng(29)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    adapter = b"ACGTACGTTTGACCAGTCAGGACT"
    art = tmp_path / "adapter.fasta"
    art.write_bytes(b">custom\n%s\n" % adapter)
    genome = rng.integers(0, 4, 1000, dtype=np.uint8)
    fq = str(tmp_path / "in.fastq")
    with open(fq, "wb") as f:
        for i in range(2000):
            if i % 5:
                seq = adapter + acgt[rng.integers(0, 4, 76)].tobytes()
            elif i % 10:
                s = int(rng.integers(0, 900))
                seq = acgt[genome[s:s + 100]].tobytes()
            else:
                seq = acgt[rng.integers(0, 4, 100)].tobytes()
            f.write(b"@d%d\n%s\n+\n%s\n" % (i, seq, b"I" * 100))
    tables = []

    class Recorded(torch_app.MeshStreamingSpectrum):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tables.append(self)

    monkeypatch.setattr(torch_app, "MeshStreamingSpectrum", Recorded)
    flags = BASE + ["--artifact-reference-file", str(art), "--verbose", "1"]
    logs = {}
    for name, mesh in (("host", []), ("mesh", ["--mesh", str(D)])):
        capfd.readouterr()
        assert torch_app.run(["--device", "cpu"] + mesh + ["--out",
                             str(tmp_path / name)] + flags
                             + ["31", fq]) == 0
        logs[name] = capfd.readouterr().err
    discarded = re.findall(r"filter affected \(trimmed/removed\) (\d+)",
                           logs["mesh"])
    assert discarded and int(discarded[0]) >= 1600
    (sp,) = tables
    n_good = 400 * 70     # the kept reads' windows, all of them good
    assert sp.D == D and sp.cap == int(np.ceil(n_good / D * 1.25)) > 4096
    assert sp.purged_singletons == 0 and not PURGED.findall(logs["mesh"])
    want, got = (_outputs(str(tmp_path), "host"),
                 _outputs(str(tmp_path), "mesh"))
    assert want and set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(len(v) for v in got.values())
