"""FilterReads on the torch engine (`--device cpu`) against the JAX app:
every output file byte-identical (tolerance: none), under the in-memory
`--mesh 1` path and `--streaming --mesh 1`, on the synthetic config of
__graft_entry__.py and on a ~3 MB generate_metagenome input."""
import os

import numpy as np
import pytest
import torch

from kmernator_tpu.apps import filter_reads as jax_app
from kmernator_tpu.apps.generate_metagenome import run as generate
from kmernator_tpu_torch.apps import filter_reads as torch_app

BASE = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
        "--artifact-edit-distance", "1", "--min-read-length", "25"]


def _graft_input(path):
    """__graft_entry__.py's synthetic FilterReads input: 320 reads of 72 bp
    from a 4 kb genome."""
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    recs = []
    for i in range(320):
        s = int(rng.integers(0, len(genome) - 72))
        recs.append(b"@r%03d\n%s\n+\n%s\n"
                    % (i, acgt[genome[s:s + 72]].tobytes(), b"H" * 72))
    with open(path, "wb") as f:
        f.write(b"".join(recs))


def _outputs(d, prefix):
    return {n[len(prefix):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix)}


def _compare(tmp_path, inp, extra):
    d = str(tmp_path)
    assert jax_app.run(extra + ["--out", os.path.join(d, "jax")] + BASE
                       + ["31", inp]) == 0
    assert torch_app.run(["--device", "cpu"] + extra
                         + ["--out", os.path.join(d, "torch")] + BASE
                         + ["31", inp]) == 0
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert want and set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(len(v) for v in got.values())


@pytest.fixture(scope="module")
def metagenome(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("meta") / "meta.fastq")
    assert generate(["--genomes", "20", "--total-genome-mb", "0.07",
                     "--coverage", "20", "--read-length", "150",
                     "--seed", "7", "--out", path]) in (0, None)
    assert 2 << 20 < os.path.getsize(path) < 4 << 20
    return path


@pytest.mark.parametrize("extra", [["--mesh", "1", "--mesh-batch", "64"],
                                   ["--streaming", "--mesh", "1",
                                    "--streaming-chunk-mb", "0.005",
                                    "--mesh-batch", "64"]])
def test_graft_config_byte_identical(tmp_path, extra):
    inp = str(tmp_path / "in.fastq")
    _graft_input(inp)
    _compare(tmp_path, inp, extra)


def test_metagenome_streaming_byte_identical(tmp_path, metagenome):
    # over 2 MB: --mesh 1 takes the streaming engine on its own
    _compare(tmp_path, metagenome, ["--mesh", "1"])


def test_metagenome_in_memory_byte_identical(tmp_path, metagenome,
                                             monkeypatch):
    monkeypatch.setenv("KMTPU_AUTO_STREAM_MB", "64")
    _compare(tmp_path, metagenome, ["--mesh", "1"])


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2"], "D > 1"),
    (["--mesh", "1", "--distributed", "127.0.0.1:1"], "D > 1"),
    (["--mesh", "1", "--nprocs", "2"], "D > 1"),
    (["--mesh", "1", "--gathered-logs", "1"], "D > 1"),
    (["--mesh", "1", "--variant-sigmas", "2"], "later PR"),
])
def test_refused_flags(tmp_path, argv, match):
    inp = str(tmp_path / "in.fastq")
    _graft_input(inp)
    with pytest.raises(NotImplementedError, match=match):
        torch_app.run(["--device", "cpu"] + argv
                      + ["--out", str(tmp_path / "o")] + BASE + ["31", inp])


def test_wide_k_refused(tmp_path):
    inp = str(tmp_path / "in.fastq")
    _graft_input(inp)
    with pytest.raises(NotImplementedError, match="later PR"):
        torch_app.run(["--device", "cpu", "--mesh", "1", "--out",
                       str(tmp_path / "o")] + BASE + ["33", inp])


def test_seams_restored_and_cuda_without_card(tmp_path, monkeypatch):
    seams = (jax_app.window_count_lookup_mesh, jax_app._streaming_mesh_count)
    inp = str(tmp_path / "in.fastq")
    _graft_input(inp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_app.run(["--mesh", "1", "--out", str(tmp_path / "o")]
                      + BASE + ["31", inp])
    with pytest.raises(ValueError):
        torch_app.run(["--device", "tpu", "--out", str(tmp_path / "o")]
                      + BASE + ["31", inp])
    assert (jax_app.window_count_lookup_mesh,
            jax_app._streaming_mesh_count) == seams
