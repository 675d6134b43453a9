"""The port's in-memory FilterReads across processes (`--distributed HOST:PORT
--nprocs N`, `--device cpu`): N gloo processes, one shard of the table
each, every rank parsing its byte range of the inputs.

Two oracles, every output file byte-identical (tolerance: none): the JAX
host engine in this process (one process, no mesh), and the JAX app at
the same process layout, two `jax.distributed` processes of one CPU
device each, which is where bytes that depend on D would show. The JAX
runs are shared by the cases through a module fixture that starts them
together. --nprocs 4 is held to the host engine only.

Cases: k = 31 with `--phix-output 1` (a gathered diverted-read file) and
`--gathered-logs 1 --verbose 1` (rank 0 prints every rank's lines, in
rank order, as the JAX app's rank 0 does, and rank 1 prints none);
`--variant-sigmas 2` (the same "Removed N" as the JAX app and the host
engine); k = 63 (two key lanes) on a paired two-file input whose byte
partition falls inside pairs (the second file's first reads are short, so
its half-way byte lies past the first file's); --nprocs 4."""
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from kmernator_tpu.apps import filter_reads as jax_app

from torch_ranks import REPO, app_ranks
import torch_threads  # noqa: F401

BASE = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
        "--artifact-edit-distance", "1", "--min-read-length", "25"]
PORT = "kmernator_tpu_torch.apps.filter_reads"
JAX = "kmernator_tpu.apps.filter_reads"
LOGS = ["--gathered-logs", "1", "--verbose", "1", "--phix-output", "1"]
VARIANT = ["--variant-sigmas", "2", "--min-variant-kmer-depth", "20",
           "--variant-edit-distance", "1", "--verbose", "1"]
LOG_LINE = re.compile(r"^\S+ \S+ +[0-9.]+ (\[\d+\] "
                      r"(?:VERBOSE|DEBUG|WARN|ERROR): .*)$", re.M)


def _phix_reads(rng, n):
    seq = b"".join(open(os.path.join(REPO, "kmernator_tpu_torch", "data",
                                     "phix174.fasta"), "rb")
                   .read().split(b"\n")[1:])
    return [seq[s:s + 100] for s in rng.integers(0, len(seq) - 100, n)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """mixed: 3,000 reads of 100 bp from a 1.5 kb genome with a Poisson(0.5)
    count of errors a read, 300 random reads and 60 phiX reads among them.
    r1/r2: 1,500 pairs from another 1.5 kb genome; the first 700 second
    mates are 40-99 bp, so the two files' byte halves fall at other
    pairs."""
    d = tmp_path_factory.mktemp("nprocs")
    rng = np.random.default_rng(13)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, 1500, dtype=np.uint8)
    phix = _phix_reads(rng, 60)
    with open(d / "mixed.fastq", "wb") as f:
        for i in range(3360):
            if i % 56 == 55:
                read = phix[i // 56]
            elif i < 3000:
                s = int(rng.integers(0, 1500 - 100))
                r = genome[s:s + 100].copy()
                for _ in range(rng.poisson(0.5)):
                    r[int(rng.integers(0, 100))] = rng.integers(0, 4)
                read = acgt[r].tobytes()
            else:
                read = acgt[rng.integers(0, 4, 100)].tobytes()
            f.write(b"@m%d\n%s\n+\n%s\n" % (i, read, b"I" * 100))
    genome = rng.integers(0, 4, 1500, dtype=np.uint8)
    with open(d / "r1.fastq", "wb") as f1, open(d / "r2.fastq", "wb") as f2:
        for i in range(1500):
            s = int(rng.integers(0, 1500 - 300))
            n2 = int(rng.integers(40, 100)) if i < 700 else 100
            f1.write(b"@p%d/1\n%s\n+\n%s\n" % (
                i, acgt[genome[s:s + 100]].tobytes(), b"I" * 100))
            f2.write(b"@p%d/2\n%s\n+\n%s\n" % (
                i, acgt[3 - genome[s + 200:s + 200 + n2][::-1]].tobytes(),
                b"I" * n2))
    return {"dir": d, "mixed": [str(d / "mixed.fastq")],
            "paired": [str(d / "r1.fastq"), str(d / "r2.fastq")]}


CASES = {"k31": (31, LOGS, "mixed"), "variant": (31, VARIANT, "mixed"),
         "k63-paired": (63, [], "paired")}


def _outputs(d, prefix):
    return {n[len(prefix) + 1:]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix + "-")}


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX app at --nprocs 2, one job a case, all started together:
    {case: (out prefix, [rank 0's stderr, rank 1's])}."""
    def job(name):
        k, extra, inp = CASES[name]
        out = str(inputs["dir"] / ("jax-" + name))
        outs = app_ranks(JAX, extra + ["--out", out] + BASE
                         + [str(k)] + inputs[inp], 2)
        return name, (out, [e for _, e in outs])
    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(pool.map(job, CASES))


def _host(inputs, tmp_path, name, k, extra, inp):
    """The JAX host engine in this process (one process, no mesh)."""
    out = str(tmp_path / name)
    assert jax_app.run(["--jax-platform", "cpu"] + extra + ["--out", out]
                       + BASE + [str(k)] + inputs[inp]) == 0
    return out


@pytest.fixture(scope="module")
def port_runs(inputs):
    """The port's job of each case at --nprocs 2, run once for the module:
    {case: (out prefix, [rank 0's stderr, rank 1's])}."""
    runs = {}

    def get(case):
        if case not in runs:
            k, extra, inp = CASES[case]
            runs[case] = _port(inputs, inputs["dir"] / ("port-" + case), 2,
                               k, extra, inp)
        return runs[case]
    return get


def _port(inputs, out, n, k, extra, inp):
    out = str(out)
    outs = app_ranks(PORT, extra + ["--out", out] + BASE + [str(k)]
                     + inputs[inp], n)
    return out, [e for _, e in outs]


def _same(a_prefix, b_prefix):
    a = _outputs(*os.path.split(a_prefix))
    b = _outputs(*os.path.split(b_prefix))
    assert a and set(a) == set(b), (sorted(a), sorted(b))
    for name in a:
        assert a[name] == b[name], name
    assert any(len(v) for v in a.values())
    return a


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_byte_identical(inputs, jax_runs, port_runs, tmp_path,
                                      capfd, case):
    k, extra, inp = CASES[case]
    port, port_logs = port_runs(case)
    got = _same(port, jax_runs[case][0])
    capfd.readouterr()
    _same(port, _host(inputs, tmp_path, "host", k, extra, inp))
    host_log = capfd.readouterr().err
    if case == "k31":
        assert len(got["MinDepth2-mixed.fastq"]) > 100000
        assert got["mixed-PhiX.fastq"].count(b"\n@") + 1 == 60
    if case == "variant":
        removed = [re.findall(r"Removed (\d+) kmer-variants", log)
                   for log in port_logs + jax_runs[case][1] + [host_log]]
        assert removed[0] and int(removed[0][0]) > 0
        assert all(r == removed[0] for r in removed), removed


def test_gathered_logs(jax_runs, port_runs):
    """--gathered-logs 1: rank 0 prints every rank's lines, rank 0's
    first, as the JAX app's rank 0 does (stamps stripped; the out prefix
    in the "wrote" lines differs by name), and rank 1 prints none."""
    port, logs = port_runs("k31")
    jax_out, jax_logs = jax_runs["k31"]
    lines = [LOG_LINE.findall(e.replace(port, "OUT")) for e in logs]
    want = [LOG_LINE.findall(e.replace(jax_out, "OUT")) for e in jax_logs]
    assert lines[1] == want[1] == []
    assert lines[0] == want[0]
    ranks = [line[:3] for line in lines[0]]
    assert ranks == sorted(ranks) and ranks[0] == "[0]" and "[1]" in ranks
    assert "[1] VERBOSE: loaded" in "\n".join(lines[0])


def test_four_processes_byte_identical(inputs, tmp_path):
    port, _ = _port(inputs, tmp_path / "port", 4, 31, [], "mixed")
    _same(port, _host(inputs, tmp_path, "host", 31, [], "mixed"))
