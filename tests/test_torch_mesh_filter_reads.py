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
