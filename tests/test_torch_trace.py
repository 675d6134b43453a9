"""The port's tracer (utils/timers.py) in FilterReads and MeraculousCounter:
off by default and free of effects on the output, the span tree and the
counters of a run, the spans on torch.profiler's timeline, the fork pool's
spans handed back to the parent, and the assembler's per-iteration line
built from spans. All on the CPU at a small size."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from kmernator_tpu_torch.apps import filter_reads, meraculous_counter
from kmernator_tpu_torch.apps import nucleating_assembler
from kmernator_tpu_torch.apps.generate_metagenome import run as generate
from kmernator_tpu_torch.parallel import mesh_stream
from kmernator_tpu_torch.utils import timers
from kmernator_tpu_torch.utils.logging import Log

from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FILTER = ["--device", "cpu", "--streaming", "--streaming-chunk-mb", "0.25",
          "--mesh", "1", "--kmer-scoring-type", "MEDIAN",
          "--mask-simple-repeats", "0", "--artifact-edit-distance", "1",
          "--min-read-length", "25", "--min-depth", "2"]
MERACULOUS = ["--device", "cpu", "--mesh", "1", "--kmer-size", "21"]

# each span of the streaming --mesh engine and of MeraculousCounter --mesh,
# with the names of the spans it runs inside
FILTER_TREE = {
    "run": [],
    "apps.count_pass": ["run"],
    "io.parse": ["apps.count_pass", "apps.output_pass"],
    "ops.artifact": ["apps.count_pass", "apps.output_pass"],
    "apps.prepare": ["apps.count_pass"],
    "table.add": ["apps.count_pass"],
    "exchange": ["table.add"],
    "table.drain": ["table.add"],
    "kernel.run_length": ["table.drain"],
    "table.to_host": ["apps.count_pass"],
    "apps.purge": ["run"],
    "apps.output_pass": ["run"],
    "apps.score": ["apps.output_pass"],
    "io.output": ["apps.output_pass"],
}
MERACULOUS_TREE = {
    "run": [],
    "io.parse": ["run"],
    "apps.count_pass": ["run"],
    "apps.prepare": ["apps.count_pass"],
    "ext.count": ["apps.count_pass"],
    "exchange": ["ext.count"],
    "kernel.run_length": ["ext.count"],
    "table.to_host": ["apps.count_pass"],
    "apps.output_pass": ["run"],
    "apps.purge": ["apps.output_pass"],
    "io.output": ["apps.output_pass"],
}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and no record."""
    timers.disable()
    timers.clear()
    yield
    timers.disable()
    timers.clear()
    Log.debug_level = 0
    Log.verbose_level = 0


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """2,666 reads of 150 bp (0.85 MB) of a two-genome metagenome."""
    path = str(tmp_path_factory.mktemp("trace") / "in.fastq")
    assert generate(["--genomes", "2", "--total-genome-mb", "0.02",
                     "--coverage", "20", "--seed", "11", "--out",
                     path]) == 0
    return path


def _run(app, flags, reads, out_dir, extra=()):
    """The app on the reads into out_dir; its files' bytes by name."""
    os.makedirs(out_dir, exist_ok=True)
    argv = list(flags) + list(extra) + ["--out", os.path.join(out_dir, "o")]
    if app is filter_reads:
        argv.append("31")
    assert app.run(argv + [reads]) == 0
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


APPS = {"filter": (filter_reads, FILTER, FILTER_TREE),
        "meraculous": (meraculous_counter, MERACULOUS, MERACULOUS_TREE)}


@pytest.fixture(scope="module")
def traced(reads, tmp_path_factory):
    """Each app run untraced and traced: (outputs off, outputs on, the
    traced run's record, the filter run's shard tables)."""
    runs = {}
    tables = []

    class Recorded(mesh_stream.MeshStreamingSpectrum):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tables.append(self)

    saved = filter_reads.MeshStreamingSpectrum
    filter_reads.MeshStreamingSpectrum = Recorded
    try:
        for name, (app, flags, _) in APPS.items():
            d = tmp_path_factory.mktemp(name)
            timers.disable()
            timers.clear()
            off = _run(app, flags, reads, str(d / "off"))
            assert timers.records() == []
            timers.enable()
            on = _run(app, flags, reads, str(d / "on"))
            timers.disable()
            (record,) = timers.records()
            timers.clear()
            runs[name] = (off, on, record)
    finally:
        filter_reads.MeshStreamingSpectrum = saved
    return runs, tables


def test_off_by_default(reads, tmp_path, monkeypatch):
    """With the tracer off no span is made, no counter kept and no run
    recorded; span() hands out one shared no-op and count() does nothing."""
    made = []

    class Counting(timers._Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(a)
            super().__init__(*a, **kw)

    monkeypatch.setattr(timers, "_Span", Counting)
    assert not timers.enabled() and not timers.active()
    _run(filter_reads, FILTER, reads, str(tmp_path / "o"))
    assert made == [] and timers.records() == []
    assert not timers.active() and timers._run is None
    assert timers.span("a") is timers.span("b", device=torch.device("cpu"))
    assert timers.count("io.reads", 5) is None and made == []


@pytest.mark.parametrize("app", sorted(APPS))
def test_same_output_traced_or_not(traced, app):
    off, on, _ = traced[0][app]
    assert off and on == off


@pytest.mark.parametrize("app", sorted(APPS))
def test_span_tree(traced, app):
    """The record holds exactly the spans of the app's engine, each inside
    the spans named; self times are >= 0 and sum to the run's total."""
    _, _, record = traced[0][app]
    spans = record["spans"]
    assert {n: e["parents"] for n, e in spans.items()} == APPS[app][2]
    assert spans["run"]["calls"] == 1 and record["rc"] == 0
    assert all(e["self_s"] >= 0 for e in spans.values())
    total = sum(e["self_s"] for e in spans.values())
    assert abs(total - spans["run"]["total_s"]) < 1e-3
    assert abs(record["wall_s"] - spans["run"]["total_s"]) < 1e-9
    # device spans carry device seconds: the host clock's on the CPU
    for name in ("exchange", "kernel.run_length"):
        assert spans[name]["device_s"] == pytest.approx(
            spans[name]["total_s"])


@pytest.mark.parametrize("app", sorted(APPS))
def test_counters(traced, reads, app):
    off, _, record = traced[0][app]
    c = record["counters"]
    with open(reads, "rb") as f:
        lines = f.read().split(b"\n")
    assert c["io.reads"] == sum(1 for ln in lines[0::4] if ln)
    assert c["io.bases"] == sum(len(ln) for ln in lines[1::4])
    assert c["io.bytes_written"] == sum(len(d) for d in off.values())
    assert c["apps.windows_good"] > 0 and c["device.h2d_bytes"] > 0
    assert c["device.d2h_bytes"] > 0 and c["kernel.run_length_bytes"] > 0
    if app == "filter":
        table = traced[1][-1]   # the traced run's
        assert c["table.drains"] == table.drains >= 2
        assert c["table.overflow_retries"] == table.overflow_retries
        assert c["table.purged_singletons"] == table.purged_singletons


def test_spans_on_the_profiler_timeline(reads, tmp_path):
    """Under torch.profiler every span is a kmtpu.* range of the Chrome
    trace, inside a range of each span it ran inside."""
    timers.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(meraculous_counter, MERACULOUS, reads, str(tmp_path / "o"))
    (record,) = timers.records()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("kmtpu.")]
    ranges = {}
    for e in events:
        ranges.setdefault(e["name"][len("kmtpu."):], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    spans = record["spans"]
    assert {n: len(r) for n, r in ranges.items()} == {
        n: e["calls"] for n, e in spans.items()}
    for name, e in spans.items():
        for parent in e["parents"]:
            for a, b in ranges[name]:
                assert any(pa <= a and b <= pb
                           for pa, pb in ranges[parent]), (name, parent)


def test_no_record_function_without_a_profiler(reads, tmp_path,
                                                monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timers.enable()
    _run(meraculous_counter, MERACULOUS, reads, str(tmp_path / "o"))
    assert len(timers.records()) == 1 and opened == []


def test_debug_traces_the_run_and_logs_its_summary(reads, tmp_path, capsys):
    """--debug 1 traces its run with the tracer off, and logs one line a
    span name, then the counters and the kernels' launches."""
    _run(meraculous_counter, MERACULOUS, reads, str(tmp_path / "o"),
         extra=["--debug", "1"])
    (record,) = timers.records()
    err = capsys.readouterr().err
    for name in record["spans"]:
        assert re.search(r"DEBUG: run %d span %s: \d+ calls, [\d.]+ s, self "
                         r"[\d.]+ s" % (record["id"], re.escape(name)), err)
    assert "DEBUG: run %d counters: apps.windows_good" % record["id"] in err


FORK_POOL = """
import json, sys
from kmernator_tpu_torch.apps import filter_reads
from kmernator_tpu_torch.utils import timers
timers.enable()
assert filter_reads.run(sys.argv[1:]) == 0
(record,) = timers.records()
print(json.dumps({"spans": sorted(record["spans"]),
                  "workers": record["workers"]}))
"""


def test_fork_pool_spans_reach_the_parent(reads, tmp_path):
    """The host engine's fork pool (in a program of its own, as the fork
    pool's other tests run it): each task's spans come back to the
    parent's record under "workers", beside the parent's own spans."""
    env = dict(os.environ, PYTHONPATH=REPO, KMTPU_POOL_TIMEOUT_S="60",
               **ONE_THREAD)
    proc = subprocess.run(
        [sys.executable, "-c", FORK_POOL, "--device", "cpu", "--streaming",
         "--streaming-chunk-mb", "0.25", "--threads", "2",
         "--min-read-length", "25", "--out", str(tmp_path / "o"), "31",
         reads], env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().split("\n")[-1])
    workers = got["workers"]
    assert sorted(workers) == ["apps.prepare", "apps.score", "io.output",
                               "io.parse", "ops.artifact", "table.spill"]
    assert workers["io.parse"]["calls"] == 2 * workers["apps.prepare"][
        "calls"] >= 4
    assert {"apps.count_pass", "table.finalize", "apps.purge",
            "apps.output_pass", "table.hash", "io.output"} <= set(
                got["spans"])


def test_assembler_iteration_line(tmp_path, capsys):
    """The assembler's per-iteration line keeps its format, built from the
    asm.match and asm.extend spans."""
    fq, seeds = str(tmp_path / "in.fastq"), str(tmp_path / "seeds.fa")
    assert generate(["--genomes", "1", "--total-genome-mb", "0.005",
                     "--coverage", "30", "--seed", "7", "--out", fq]) == 0
    with open(fq, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    with open(seeds, "wb") as f:
        for i in range(3):
            f.write(b">seed%d\n%s\n" % (i, seqs[7 * i][:100]))
    assert nucleating_assembler.run(
        ["--device", "cpu", "--contig-file", seeds, "--max-iterations", "1",
         "--verbose", "1", "--out", str(tmp_path / "o.fa"), "31", fq]) == 0
    lines = re.findall(r"VERBOSE: (Iteration 1 times: .*)",
                       capsys.readouterr().err)
    assert len(lines) == 1
    m = re.fullmatch(r"Iteration 1 times: match: (\d+\.\d{3})s, "
                     r"extendContigs: (\d+\.\d{3})s, total: (\d+\.\d{3})s",
                     lines[0])
    assert m, lines
    match, extend, total = (float(x) for x in m.groups())
    assert abs(match + extend - total) <= 0.0015


def test_records_keep_a_window_of_short_jobs():
    """The tracer keeps the last KEEP runs' records, and KEEP holds a
    benchmark window of sub-second jobs (over a hundred in 40 s), whose
    readers take one record a job."""
    @timers.traced_run
    def job():
        timers.begin_run()
        with timers.span("io.output"):
            timers.count("io.slabs", 1)
        return 0

    assert timers.KEEP >= 1024
    timers.clear()
    timers.enable()
    try:
        for _ in range(timers.KEEP + 3):
            assert job() == 0
    finally:
        timers.disable()
    records = timers.records()
    timers.clear()
    assert len(records) == timers.KEEP
    assert [r["id"] for r in records] == list(
        range(records[0]["id"], records[0]["id"] + timers.KEEP))
    assert all(r["counters"] == {"io.slabs": 1} for r in records)
