"""The port's FilterReads `--streaming --distributed X --nprocs 1` engine
(`run_streaming_distributed`, `--device cpu`) against the JAX app: every
output file byte-identical (tolerance: none) to the JAX host streaming
engine (`--streaming --threads 1`), whose bytes the JAX distributed engine
gives too, on small generate_metagenome inputs cut into 0.05 MB chunks and
64-read batches, so that the table grows on pressure. The one tolerance is
on the weight columns of --histogram-file (5e-3 relative), stated at its
test.

The JAX distributed engine itself runs in a subprocess with one CPU device
(this test process has eight, tests/conftest.py), where its shard table is
the port's D = 1 table: it is the oracle for what only that engine shows,
the table's growth steps (its `--debug 1` log) and the singletons it
purges."""
import gzip
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from kmernator_tpu.apps import filter_reads as jax_app
from kmernator_tpu.apps.generate_metagenome import run as generate
from kmernator_tpu_torch.apps import filter_reads as torch_app

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
        "--artifact-edit-distance", "1", "--min-read-length", "25"]
STREAM = ["--streaming", "--streaming-chunk-mb", "0.05"]
GREW = re.compile(r"mesh shard table grew to (\d+) rows/device "
                  r"\(driving rows (\d+) x(\d)\)")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _distributed():
    return ["--distributed", "127.0.0.1:%d" % _free_port(), "--nprocs", "1",
            "--mesh-batch", "64"]


def _outputs(d, prefix):
    return {n[len(prefix):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix)}


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    """~420 KB of 150 bp reads from 4 genomes at 20x: nine chunks."""
    path = str(tmp_path_factory.mktemp("meta") / "meta.fastq")
    assert generate(["--genomes", "4", "--total-genome-mb", "0.01",
                     "--coverage", "20", "--read-length", "150",
                     "--seed", "7", "--out", path]) in (0, None)
    assert 300 << 10 < os.path.getsize(path) < 600 << 10
    return path


def _pairs(meta, d, aligned: bool):
    """meta's records taken two at a time as mates, /1 into one file and
    /2 into the other: in the same order (aligned), or the second file's
    pairs in reverse order (not aligned)."""
    lines = open(meta, "rb").read().split(b"\n")
    recs = [lines[i:i + 4] for i in range(0, len(lines) - 3, 4)]
    n = len(recs) // 2
    m1 = [[b"@p%d/1" % i] + recs[2 * i][1:] for i in range(n)]
    m2 = [[b"@p%d/2" % i] + recs[2 * i + 1][1:] for i in range(n)]
    if not aligned:
        m2 = m2[::-1]
    paths = []
    for name, mates in (("r1.fastq", m1), ("r2.fastq", m2)):
        paths.append(os.path.join(d, name))
        with open(paths[-1], "wb") as f:
            f.write(b"".join(b"\n".join(r) + b"\n" for r in mates))
    return paths


def _deep(d):
    """150x of a 1 kb genome in 100 bp reads with a Poisson(1) count of
    substitutions a read (the purge tests' deep input, cut down): solid
    k-mers with variants well above a depth of 10."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 1000, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    path = os.path.join(d, "deep.fastq")
    with open(path, "wb") as f:
        for i in range(1500):
            s = int(rng.integers(0, 1000 - 100))
            read = genome[s:s + 100].copy()
            for _ in range(rng.poisson(1.0)):
                read[int(rng.integers(0, 100))] = rng.integers(0, 4)
            f.write(b"@r%d\n%s\n+\n%s\n"
                    % (i, bases[read].tobytes(), b"I" * 100))
    return [path]


def _port(d, name, extra, k, inputs, monkeypatch):
    """The port's engine in this process; returns its tables."""
    tables = []

    class Recorded(torch_app.MeshStreamingSpectrum):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tables.append(self)

    monkeypatch.setattr(torch_app, "MeshStreamingSpectrum", Recorded)
    assert torch_app.run(["--device", "cpu"] + STREAM + _distributed()
                         + extra + ["--out", os.path.join(d, name)] + BASE
                         + [str(k)] + inputs) == 0
    monkeypatch.undo()
    return tables


def _host(d, name, extra, k, inputs):
    assert jax_app.run(["--streaming", "--streaming-chunk-mb", "0.05",
                        "--threads", "1"] + extra
                       + ["--out", os.path.join(d, name)] + BASE
                       + [str(k)] + inputs) == 0


def _same_outputs(d, a="port", b="host"):
    got, want = _outputs(d, a), _outputs(d, b)
    assert want and set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(len(v) for v in got.values())
    return got


def _jax_distributed(d, name, extra, k, inputs):
    """The JAX distributed engine in a subprocess on one CPU device; returns
    its standard error."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run(
        [sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
         "--jax-platform", "cpu"] + STREAM + _distributed() + extra
        + ["--out", os.path.join(d, name)] + BASE + [str(k)] + inputs,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


CASES = {
    "k31": ([], 31, "meta"),
    "k45": ([], 45, "meta"),
    "paired-aligned": ([], 31, "aligned"),
    "paired-merged": (["--separate-outputs", "0"], 31, "aligned"),
    "paired-not-aligned": ([], 31, "not-aligned"),
    "variant-sigmas": (["--variant-sigmas", "2", "--min-variant-kmer-depth",
                        "10", "--verbose", "1"], 31, "deep"),
    "streaming-parts": ([], 31, "meta"),
}
# the port's table at a fixed capacity; the host engine would take the
# flag as its spill part count, which changes no byte
PORT_ONLY = {"streaming-parts": ["--streaming-parts", "60000"]}


@pytest.mark.parametrize("case", list(CASES))
def test_byte_identical_to_the_host_streaming_engine(case, tmp_path, meta,
                                                     monkeypatch, capfd):
    extra, k, source = CASES[case]
    d = str(tmp_path)
    inputs = {"meta": lambda: [meta],
              "aligned": lambda: _pairs(meta, d, True),
              "not-aligned": lambda: _pairs(meta, d, False),
              "deep": lambda: _deep(d)}[source]()
    capfd.readouterr()
    tables = _port(d, "port", extra + PORT_ONLY.get(case, [])
                   + ["--debug", "1"], k, inputs, monkeypatch)
    port_log = capfd.readouterr().err
    _host(d, "host", extra, k, inputs)
    host_log = capfd.readouterr().err
    _same_outputs(d)
    assert len(tables) == 1 and tables[0].drains >= 2
    sp = tables[0]
    assert sp.purged_singletons == 0
    assert all(t.device.type == "cpu" for t in sp.table_lanes)
    grew = GREW.findall(port_log)
    if case == "streaming-parts":
        assert sp.cap == 60000 and sp.max_capacity == 0 and not grew
    else:
        assert grew and int(grew[-1][0]) == sp.cap
    if case.startswith("paired"):
        # one output a file; merged: --out itself, written through the
        # part streams
        names = {"-MinDepth2-r1.fastq", "-MinDepth2-r2.fastq"}
        if case == "paired-merged":
            names = {""}
        assert set(_outputs(d, "port")) == names
    if case == "variant-sigmas":
        removed = [re.findall(r"Removed (\d+) kmer-variants", log)
                   for log in (port_log, host_log)]
        assert removed[0] == removed[1] and int(removed[0][0]) > 0


@pytest.mark.parametrize("k", [31, 45])
def test_growth_steps_follow_the_jax_distributed_engine(k, tmp_path, meta,
                                                        monkeypatch, capfd):
    """The same capacities, driving rows and headrooms, step by step, no
    singleton purged, and the same bytes as the JAX distributed engine at
    D = 1."""
    d = str(tmp_path)
    capfd.readouterr()
    tables = _port(d, "port", ["--debug", "1"], k, [meta], monkeypatch)
    port_log = capfd.readouterr().err
    jax_log = _jax_distributed(d, "jaxd", ["--debug", "1"], k, [meta])
    _same_outputs(d, "port", "jaxd")
    steps = GREW.findall(port_log)
    assert len(steps) >= 2
    assert steps == GREW.findall(jax_log)
    assert tables[0].purged_singletons == 0
    # no purge warning ("... purged N singletons under capacity pressure");
    # the port's --debug 1 run summary names its purged_singletons counter
    purge = re.compile(r"purged \d+ singletons")
    assert not purge.search(port_log) and not purge.search(jax_log)


def _histogram_rows(path):
    """The bucket rows of a --histogram-file, as float rows."""
    rows = []
    for line in open(path).read().split("\n")[5:]:
        fields = [f for f in line.split("\t") if f]
        if fields:
            rows.append([float(f) for f in fields])
    return np.array(rows)


def test_histogram_and_size_history(tmp_path, meta, monkeypatch):
    """--histogram-file and --size-history-file, written from the table
    before its purges: the size history and every histogram column but
    the weights bit-equal to the host engine's. Tolerance on the weight
    columns (Weight, QualProb, %Weight and the Weights: total): 5e-3
    relative, as for `--streaming --mesh 1`
    (tests/test_torch_filter_reads.py): the drain's run weights are
    differences of a prefix sum over the drain, the host engine's spill
    counter sums each run alone (ROADMAP fault 3e)."""
    d = str(tmp_path)
    files = {name: ["--histogram-file", os.path.join(d, "hist-" + name),
                    "--size-history-file", os.path.join(d, "size-" + name)]
             for name in ("port", "host")}
    _port(d, "port", files["port"], 31, [meta], monkeypatch)
    _host(d, "host", files["host"], 31, [meta])
    _same_outputs(d)
    sizes = [open(os.path.join(d, "size-" + n)).read()
             for n in ("port", "host")]
    assert sizes[0] == sizes[1] and len(sizes[0].split("\n")) == 3
    hist = {n: os.path.join(d, "hist-" + n) for n in ("port", "host")}
    rows = {n: _histogram_rows(h) for n, h in hist.items()}
    want, got = rows["host"], rows["port"]
    assert want.shape[0] > 10 and got.shape == want.shape
    weight_cols = [6, 7, 8]
    exact = [c for c in range(want.shape[1]) if c not in weight_cols]
    assert np.array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, weight_cols], want[:, weight_cols],
                               rtol=5e-3, atol=1e-3)
    lines = {n: open(h).read().split("\n") for n, h in hist.items()}
    assert lines["port"][:2] == lines["host"][:2]
    totals = {n: [float(f) for f in ls[2].split("\t")[1:] if f]
              for n, ls in lines.items()}
    np.testing.assert_allclose(totals["port"], totals["host"], rtol=5e-3)


def test_kmer_size_zero(tmp_path, meta, monkeypatch):
    """No spectrum: reads are trimmed at their first markup and scored
    with no table and no collective."""
    d = str(tmp_path)
    assert _port(d, "port", [], 0, [meta], monkeypatch) == []
    _host(d, "host", [], 0, [meta])
    _same_outputs(d)


def test_gz_input_refused_as_jax(tmp_path, meta, capfd):
    """The engine needs random access: a .gz input returns 1 with the JAX
    engine's message (the JAX app runs in this process: the refusal comes
    before its mesh is built)."""
    gz = str(tmp_path / "meta.fastq.gz")
    with open(meta, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    logs = []
    for app, dev in ((torch_app, ["--device", "cpu"]),
                     (jax_app, ["--jax-platform", "cpu"])):
        capfd.readouterr()
        assert app.run(dev + STREAM + _distributed()
                       + ["--out", str(tmp_path / "o")] + BASE
                       + ["31", gz]) == 1
        logs.append(re.findall(r"ERROR: (.*)", capfd.readouterr().err))
    assert logs[0] == logs[1] == ["--streaming --distributed needs "
                                  "random-access input; decompress gz files "
                                  "first"]
    assert not [n for n in os.listdir(tmp_path) if n.startswith("o")]


def test_max_kmer_output_depth_refused_as_jax(tmp_path, meta, capfd):
    logs = []
    for app, dev in ((torch_app, ["--device", "cpu"]),
                     (jax_app, ["--jax-platform", "cpu"])):
        capfd.readouterr()
        assert app.run(dev + STREAM + _distributed()
                       + ["--max-kmer-output-depth", "4",
                          "--out", str(tmp_path / "o")] + BASE
                       + ["31", meta]) == 1
        logs.append(re.findall(r"ERROR: (.*)", capfd.readouterr().err))
    assert len(logs[0]) == 1 and logs[0] == logs[1]
    assert "max-kmer-output-depth" in logs[0][0]
