"""The port's FilterReads (`--device cpu`) against the JAX app: every
output file byte-identical (tolerance: none) on the host engine (no
--mesh: in-memory, and streaming over its fork pool), the in-memory
`--mesh 1` path and `--streaming --mesh 1`, on the synthetic config of
__graft_entry__.py and on a ~3 MB generate_metagenome input. The one
tolerance is on the weight columns of the --histogram-file of
`--streaming --mesh 1`, stated at its test."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmernator_tpu.apps import filter_reads as jax_app
from kmernator_tpu.apps.generate_metagenome import run as generate
from kmernator_tpu_torch.apps import filter_reads as torch_app

from torch_ranks import app_ranks
from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _paired_input(path):
    """160 read pairs (names /1 and /2, mate 2 reverse-complemented) from a
    4 kb genome, with repeated fragments for the duplicate filter and N
    bases for the markup trims."""
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    recs = []
    for i in range(160):
        s = int(rng.integers(0, len(genome) - 300)) if i % 10 else 100
        m1 = acgt[genome[s:s + 80]].copy()
        m2 = acgt[3 - genome[s + 200:s + 280][::-1]].copy()
        if i % 7 == 0:
            m1[int(rng.integers(0, 80))] = ord("N")
        q = bytes(rng.integers(35, 74, 80).astype(np.uint8))
        recs.append(b"@p%03d/1\n%s\n+\n%s\n" % (i, m1.tobytes(), q))
        recs.append(b"@p%03d/2\n%s\n+\n%s\n" % (i, m2.tobytes(), q))
    with open(path, "wb") as f:
        f.write(b"".join(recs))


def _outputs(d, prefix):
    return {n[len(prefix):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix)}


def _compare(tmp_path, inp, extra, per_app=None):
    """Run both apps with `extra` (plus per_app[name] for each) and require
    every output file named after --out to be byte-identical."""
    d = str(tmp_path)
    per_app = per_app or {}
    assert jax_app.run(extra + per_app.get("jax", [])
                       + ["--out", os.path.join(d, "jax")] + BASE
                       + ["31", inp]) == 0
    assert torch_app.run(["--device", "cpu"] + extra
                         + per_app.get("torch", [])
                         + ["--out", os.path.join(d, "torch")] + BASE
                         + ["31", inp]) == 0
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert want and set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(len(v) for v in got.values())


def _compare_cli(tmp_path, inp, extra):
    """The port's fork pool (`extra` holds --threads > 1) against the JAX
    app's sequential engine (--threads 1), each run as its own program with
    a time limit, so that the pool forks a fresh interpreter, never this
    test process and its jax and torch threads. The JAX package holds its
    pool byte-identical to its sequential engine
    (tests/test_streaming_host.py:70-84); its pool is not the oracle here
    because its workers keep the cleanup module's SIGTERM handler, which
    can miss the signal of Pool.terminate and hang the run (see the port's
    utils/cleanup.py)."""
    d = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **ONE_THREAD,
               KMTPU_POOL_TIMEOUT_S="60")
    sequential = list(extra)
    sequential[sequential.index("--threads") + 1] = "1"
    for name, app, args in (
            ("jax", "kmernator_tpu", ["--jax-platform", "cpu"] + sequential),
            ("torch", "kmernator_tpu_torch", ["--device", "cpu"] + extra)):
        proc = subprocess.run(
            [sys.executable, "-m", app + ".apps.filter_reads"] + args
            + ["--out", os.path.join(d, name)] + BASE + ["31", inp],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-3000:])
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
                                    "--mesh-batch", "64"],
                                   []])
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


@pytest.mark.parametrize("extra", [
    ["--max-kmer-output-depth", "4"],
    ["--max-kmer-output-depth", "4", "--normalization-method", "OPTIMAL"],
    ["--partition-by-depth", "8", "--remainder-trim", "20"],
    ["--dedup-mode", "1"],
    ["--min-passing-in-pair", "2", "--kmer-scoring-type", "MIN",
     "--phix-output", "1", "--filter-output", "1"],
    ["--format-output", "1", "--min-depth", "3"],
    ["--streaming", "--threads", "1", "--streaming-chunk-mb", "0.005"],
    ["--streaming", "--threads", "2", "--streaming-chunk-mb", "0.005"],
], ids=["normalize-random", "normalize-optimal", "partition-by-depth",
        "dedup", "pairs-min-phix-artifact", "fasta-min-depth-3",
        "streaming-sequential", "streaming-fork-pool"])
def test_host_engine_options_byte_identical(tmp_path, extra):
    """The copied host code on paired reads: each option family of the
    host engine gives the JAX app's bytes. The port's fork pool (--threads
    2) runs in a program of its own, against the JAX sequential engine."""
    inp = str(tmp_path / "pairs.fastq")
    _paired_input(inp)
    if "--threads" in extra and extra[extra.index("--threads") + 1] != "1":
        _compare_cli(tmp_path, inp, extra)
    else:
        _compare(tmp_path, inp, extra)


def test_metagenome_host_engine_byte_identical(tmp_path, metagenome):
    # no --mesh, over 2 MB: the host streaming engine over its fork pool
    _compare_cli(tmp_path, metagenome, ["--threads", "2"])


def _histogram_rows(path):
    """The bucket rows of a --histogram-file, as float rows."""
    rows = []
    for line in open(path).read().split("\n")[5:]:
        fields = [f for f in line.split("\t") if f]
        if fields:
            rows.append([float(f) for f in fields])
    return np.array(rows)


def test_streaming_mesh_weights_reach_output(tmp_path, metagenome):
    """Drain weights reach FilterReads output only through --histogram-file
    and --variant-sigmas on `--streaming --mesh 1`. The reads written are
    byte-identical to the JAX app's, and so is every column of the
    histogram but its weights. Tolerance on the weight columns (Weight,
    QualProb, %Weight and the Weights: total): 5e-3 relative. Both drains
    take run weights as differences of a float32 prefix sum over the whole
    drain, rounded in another order (XLA's scan and sort against torch's);
    at this input's total weight (~7.7e5) a float32 ulp is 0.06. The JAX
    mesh app is held to the same tolerance against its own host engine,
    whose spill counter sums run weights without that prefix, and whose
    reads must be byte-identical too."""
    extra = ["--streaming", "--mesh", "1", "--variant-sigmas", "2"]
    hist = {name: str(tmp_path / ("histogram-" + name))
            for name in ("jax", "torch", "host")}
    _compare(tmp_path, metagenome, extra,
             {name: ["--histogram-file", hist[name]]
              for name in ("jax", "torch")})
    assert jax_app.run(["--streaming", "--threads", "1",
                        "--variant-sigmas", "2", "--histogram-file",
                        hist["host"], "--out", str(tmp_path / "host")]
                       + BASE + ["31", metagenome]) == 0
    host_reads = _outputs(str(tmp_path), "host")
    assert host_reads == _outputs(str(tmp_path), "jax")
    rows = {name: _histogram_rows(h) for name, h in hist.items()}
    weight_cols = [6, 7, 8]
    want = rows["jax"]
    assert want.shape[0] > 20
    exact_cols = [c for c in range(want.shape[1]) if c not in weight_cols]
    lines = {name: open(h).read().split("\n") for name, h in hist.items()}
    totals = {name: [float(f) for f in ls[2].split("\t")[1:] if f]
              for name, ls in lines.items()}
    for other in ("torch", "host"):
        got = rows[other]
        assert got.shape == want.shape
        assert np.array_equal(got[:, exact_cols], want[:, exact_cols])
        np.testing.assert_allclose(got[:, weight_cols], want[:, weight_cols],
                                   rtol=5e-3, atol=1e-3)
        assert lines[other][:2] == lines["jax"][:2]
        np.testing.assert_allclose(totals[other], totals["jax"], rtol=5e-3)


@pytest.mark.parametrize("argv,lifted", [
    (["--streaming", "--distributed", "127.0.0.1:1", "--nprocs", "2"],
     "item 3"),
    (["--mesh", "1", "--nprocs", "2"], "item 3"),
    (["--mesh", "1", "--gathered-logs", "1"], "item 3"),
])
def test_refused_flags(tmp_path, capfd, argv, lifted):
    """The flags once refused (until ROADMAP queue 1 `lifted`) now run: at
    --nprocs 2 as two gloo ranks (tests/torch_ranks.py, each its own
    coordinator port), --gathered-logs 1 in this process, each
    byte-identical to the one-process --mesh 1 run; gathered logs are
    printed all at the end of the run, which is where the flag shows at one
    process (tests/test_torch_nprocs.py holds the lines of two ranks to the
    JAX app's)."""
    inp = str(tmp_path / "in.fastq")
    _graft_input(inp)
    assert torch_app.run(["--device", "cpu", "--mesh", "1", "--out",
                          str(tmp_path / "one")] + BASE + ["31", inp]) == 0
    out = str(tmp_path / "flags")
    if "--nprocs" in argv:
        i = argv.index("--nprocs")
        rest = [a for j, a in enumerate(argv) if j not in (i, i + 1)]
        if "--distributed" in rest:
            i = rest.index("--distributed")
            rest = rest[:i] + rest[i + 2:]
        app_ranks("kmernator_tpu_torch.apps.filter_reads",
                  rest + ["--out", out] + BASE + ["31", inp], 2)
    else:
        capfd.readouterr()
        assert torch_app.run(["--device", "cpu", "--verbose", "1"] + argv
                             + ["--out", out] + BASE + ["31", inp]) == 0
        err = capfd.readouterr().err
        assert "VERBOSE: Reading input files" in err
        assert err.rstrip().endswith("(%d bytes)" % os.path.getsize(
            out + "-MinDepth2-in.fastq"))
    want, got = _outputs(str(tmp_path), "one"), _outputs(str(tmp_path),
                                                         "flags")
    assert want and got == want and any(len(v) for v in got.values())


def test_mesh_2_runs(tmp_path):
    """--mesh 2, refused until the shard exchange was ported, runs two
    shards on the one device: byte-identical to the JAX app at --mesh 2
    (tests/test_torch_mesh_filter_reads.py covers both --mesh paths at 2
    and 4 shards)."""
    inp = str(tmp_path / "in.fastq")
    _graft_input(inp)
    _compare(tmp_path, inp, ["--mesh", "2", "--mesh-batch", "64"])


def test_distributed_one_process_in_memory(tmp_path):
    """--distributed X at one process without --streaming: the in-memory
    --mesh 1 engine, which ignores the coordinator as the JAX app does."""
    inp = str(tmp_path / "in.fastq")
    _graft_input(inp)
    for name, extra in (("plain", []),
                        ("dist", ["--distributed", "127.0.0.1:1"])):
        assert torch_app.run(["--device", "cpu", "--mesh", "1"] + extra
                             + ["--out", str(tmp_path / name)] + BASE
                             + ["31", inp]) == 0
    want, got = _outputs(str(tmp_path), "plain"), _outputs(str(tmp_path),
                                                           "dist")
    assert want and got == want and any(len(v) for v in got.values())


@pytest.mark.parametrize("extra", [["--mesh", "1", "--mesh-batch", "64"],
                                   ["--streaming", "--mesh", "1",
                                    "--streaming-chunk-mb", "0.01",
                                    "--mesh-batch", "64"]],
                         ids=["in-memory", "streaming"])
def test_wide_k_byte_identical(tmp_path, extra):
    """k = 97 (four-lane keys) on both --mesh 1 paths: every output file
    byte-identical to the JAX app's, on 320 reads of 150 bp from a 4 kb
    genome (more k > 96 cases: tests/test_torch_wide_k.py)."""
    rng = np.random.default_rng(97)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    inp = str(tmp_path / "in.fastq")
    with open(inp, "wb") as f:
        for i in range(320):
            s = int(rng.integers(0, len(genome) - 150))
            f.write(b"@r%03d\n%s\n+\n%s\n"
                    % (i, acgt[genome[s:s + 150]].tobytes(), b"H" * 150))
    d = str(tmp_path)
    assert jax_app.run(["--threads", "1"] + extra + ["--out",
                        os.path.join(d, "jax")] + BASE + ["97", inp]) == 0
    assert torch_app.run(["--device", "cpu"] + extra + ["--out",
                          os.path.join(d, "torch")] + BASE
                         + ["97", inp]) == 0
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert want and got == want
    assert any(len(v) > 1000 for v in got.values())


def test_seams_restored_and_cuda_without_card(tmp_path, monkeypatch):
    """A port run binds nothing on the JAX app module: every global of it
    is the same object after runs of all three engines. And --device cuda
    without a card raises, as does an unknown device."""
    before = dict(vars(jax_app))
    inp = str(tmp_path / "in.fastq")
    _graft_input(inp)
    for extra in ([], ["--mesh", "1"], ["--streaming", "--mesh", "1"]):
        assert torch_app.run(["--device", "cpu"] + extra + ["--out",
                             str(tmp_path / "o")] + BASE + ["31", inp]) == 0
    after = dict(vars(jax_app))
    assert set(after) == set(before)
    assert all(after[name] is before[name] for name in before)
    assert sys.modules[torch_app.run.__module__] is torch_app
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_app.run(["--mesh", "1", "--out", str(tmp_path / "o")]
                      + BASE + ["31", inp])
    with pytest.raises(ValueError):
        torch_app.run(["--device", "tpu", "--out", str(tmp_path / "o")]
                      + BASE + ["31", inp])
