"""One run of one cell: set-up, a window of jobs back to back, the check of
every job's output files against the plain reference, and the result.

Everything a cell is made of is found by name: its entry in
BENCHMARK.json, `kbench/configs/<config>.json` (the app, its argv, the
number of ranks), `kbench/traffic/<traffic>.json` (the generator's
parameters) and `kbench/metrics/<metric>.py` (a reader a per-layer
metric). Adding a cell, a mix or a metric adds files and entries and edits
none.

A job is one whole app invocation on the cell's input: in one process the
port's `run(argv)` (then the temp-file clean-up its `main` makes); with
ranks > 1 one launch of that many rank processes (kbench/ranks.py). The
loop is closed: a job starts only while the window is open, and the window
closes when the last job ends.
"""
from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from kbench import genmeta, nojax
from kbench.probes import ProbeSet

KBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(KBENCH)
GIB = float(1 << 30)


# ---- the manifest and the files a cell is made of ----

def manifest() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> Dict:
    with open(os.path.join(KBENCH, kind, name + ".json")) as f:
        return json.load(f)


def resolve(man: Dict, workload: str) -> Dict:
    """The cell's entry, configuration and traffic."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit("no workload %r in BENCHMARK.json" % workload)
    w = cells[workload]
    return {"workload": w, "config": _json("configs", w["config"]),
            "traffic": _json("traffic", w["traffic"])}


def metrics_of(man: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metric entries a run of the cell reports: with trace the
    per-layer ones that list it (or list no cells), else the end-to-end."""
    ms = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in ms if workload in m.get("workloads", [workload])]


def reader(name: str):
    """kbench/metrics/<name>.py as a module."""
    path = os.path.join(KBENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("kbench_metric_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_set(names: List[str], label: bool, device: str) -> ProbeSet:
    ps = ProbeSet(label=label, device=device)
    for n in names:
        for p in getattr(reader(n), "PROBES", []):
            ps.add(**p)
    return ps


def argv_of(config: Dict, **fill) -> List[str]:
    """The config's argv with its {placeholders} filled."""
    return [a.format(**fill) for a in config["argv"]]


# ---- one job ----

def inproc_job(app, config: Dict, device: str, job_dir: str, input_path: str,
               probes: Optional[ProbeSet], label: bool) -> Dict:
    """The app's run(argv) in this process; its wall, peak and readings."""
    import torch
    from kmernator_tpu_torch.utils import cleanup
    os.makedirs(job_dir, exist_ok=True)
    argv = argv_of(config, device=device, out=os.path.join(job_dir, "out"),
                   input=input_path, rank=0, nprocs=1, port=0)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if probes:
        probes.begin_job(t0)
    ctx = torch.profiler.record_function("kbench.job") if label else None
    if ctx:
        ctx.__enter__()
    try:
        rc = app.run(list(argv))
    except Exception as e:  # a job that raises is a failed job
        print("kbench: job in %s raised %r" % (job_dir, e), file=sys.stderr)
        rc = -1
    finally:
        cleanup._flush()
    if cuda:
        torch.cuda.synchronize()
    if ctx:
        ctx.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    return {"ok": rc == 0, "wall_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
            "probes": probes.end_job() if probes else {}}


# ---- the check ----

def _lines_differing(a: bytes, b: bytes) -> int:
    la, lb = a.split(b"\n"), b.split(b"\n")
    return sum(x != y for x, y in zip(la, lb)) + abs(len(la) - len(lb))


def compare(job_dir: str, want: Dict[str, bytes]) -> Dict[str, int]:
    """A job's output files against the reference's: files missing, extra
    or different, and lines that differ (a missing file's lines all
    count)."""
    have = sorted(os.listdir(job_dir)) if os.path.isdir(job_dir) else []
    files = lines = 0
    for name in set(have) | set(want):
        if name not in want or name not in have:
            files += 1
            data = want.get(name)
            if data is None:
                with open(os.path.join(job_dir, name), "rb") as f:
                    data = f.read()
            lines += data.count(b"\n")
            continue
        with open(os.path.join(job_dir, name), "rb") as f:
            got = f.read()
        if got != want[name]:
            files += 1
            lines += _lines_differing(got, want[name])
    return {"files": files, "lines": lines}


def reference_outputs(config: Dict, input_path: str, control: bool = False
                      ) -> Dict[str, bytes]:
    ref = importlib.import_module("kbench.reference." + config["app"])
    argv = argv_of(config, device="cpu", out="out", input=input_path,
                   rank=0, nprocs=1, port=0)
    return ref.outputs(argv, control=control)


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


# ---- the card ----

def card_info() -> Dict:
    """The card's name and power limit (nvidia-smi), torch and CUDA."""
    import torch
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        info["nvidia_smi"] = out
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = "unavailable: %s" % e
    return info


def peak_bandwidth(kind: str) -> Optional[float]:
    """HBM bytes/s of the card from kbench/peaks.json, by name."""
    with open(os.path.join(KBENCH, "peaks.json")) as f:
        peaks = json.load(f)
    for key, p in peaks["cards"].items():
        if key in kind:
            return p["hbm_bytes_per_s"]
    return None


# ---- one run ----

def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", traffic: Dict = None,
        ranks: int = None, config: str = None) -> Dict:
    """One run of the cell; returns the result (and `info`, for the earlier
    line). `traffic`, `ranks` and `config` (a name under kbench/configs/)
    replace the cell's, for tests at a small size on the CPU."""
    man = manifest()
    cell = resolve(man, workload)
    config = _json("configs", config) if config else cell["config"]
    w = cell["workload"]
    traffic = traffic or cell["traffic"]
    n_ranks = ranks or config.get("ranks", 1)
    cuda = device == "cuda"
    metrics = metrics_of(man, workload, trace)
    layer_names = [m["name"] for m in metrics] if trace else []
    work = tempfile.mkdtemp(prefix="kbench-", dir=tempfile.gettempdir())
    try:
        return _run(config, w, traffic, n_ranks, cuda, device, metrics,
                    layer_names, seed, seconds, trace, t_start, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(config, w, traffic, n_ranks, cuda, device, metrics, layer_names,
         seed, seconds, trace, t_start, work):
    import torch
    from kbench import ranks as rank_launcher
    from kbench import trace as tracing
    input_path = os.path.join(work, "input.fastq")
    warm_path = os.path.join(work, "warm.fastq")
    n_reads, n_bases = genmeta.write(traffic, seed, input_path)
    genmeta.head(input_path, warm_path, traffic["warmup_mb"])
    written = os.path.getsize(input_path) + os.path.getsize(warm_path)
    inproc = n_ranks == 1
    app = probes = None
    if inproc:
        app = importlib.import_module("kmernator_tpu_torch.apps."
                                      + config["app"])
        if trace:
            probes = probe_set(layer_names, True, device)
            probes.install()
    info = card_info() if cuda else {}

    def job(i: int, path: str) -> Dict:
        jd = os.path.join(work, "job%03d" % i)
        if inproc:
            return inproc_job(app, config, device, jd, path, probes, trace)
        return rank_launcher.job(config, n_ranks, device, jd, path,
                                 layer_names, trace)

    # set-up: the warm-up job builds and loads every kernel and library
    warm = job(-1, warm_path)
    if not warm["ok"]:  # the window's jobs will fail too, and count
        print("kbench: the warm-up job failed", file=sys.stderr)
    written += _tree_bytes(os.path.join(work, "job-01"))
    shutil.rmtree(os.path.join(work, "job-01"), ignore_errors=True)
    prof = tracing.profiler() if (trace and inproc and cuda) else None
    setup_s = time.perf_counter() - t_start

    jobs = []
    if prof:
        prof.__enter__()
    win = torch.profiler.record_function("kbench.window") if prof else None
    if win:
        win.__enter__()
    host0 = host_reading()
    t_w0 = time.perf_counter()
    while time.perf_counter() - t_w0 < seconds:
        jobs.append(job(len(jobs), input_path))
    t_w1 = time.perf_counter()
    host = host_window(host0, host_reading())
    if win:
        win.__exit__(None, None, None)
    trace_summary = None
    if prof:
        prof.__exit__(None, None, None)
        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        written += os.path.getsize(path)
        trace_summary = tracing.reduce(path)
        os.remove(path)
    window_s = t_w1 - t_w0

    done = [j for j in jobs if j["ok"]]
    peak = max([j["peak_bytes"] for j in jobs] + [0])
    kind = (torch.cuda.get_device_name(0) if (cuda and inproc)
            else (jobs[0].get("device_kind", "cpu") if jobs else "cpu"))
    if probes:
        probes.uninstall()
    app = None
    gc.collect()
    if cuda and inproc:
        torch.cuda.empty_cache()

    loaded = nojax.found()
    for j in jobs:
        loaded += j.get("jax", [])
    if loaded:
        raise SystemExit("kbench: JAX or the JAX package was loaded: %s"
                         % sorted(set(loaded)))

    # the check: every job's output files against the reference's
    t_check = time.perf_counter()
    want = reference_outputs(config, input_path)
    worst = {"files": 0, "lines": 0}
    for i, j in enumerate(jobs):
        jd = os.path.join(work, "job%03d" % i)
        written += _tree_bytes(jd)
        got = compare(jd, want) if j["ok"] else \
            {"files": len(want), "lines": sum(d.count(b"\n")
                                              for d in want.values())}
        for key in worst:
            worst[key] = max(worst[key], got[key])
    failed = len(jobs) - len(done)
    check_s = time.perf_counter() - t_check
    compared = {"files_differing": {"value": worst["files"], "limit": 0},
                "lines_differing": {"value": worst["lines"], "limit": 0},
                "jobs_failed": {"value": failed, "limit": 0}}
    correct = bool(jobs) and all(c["value"] <= c["limit"]
                                 for c in compared.values())

    out_metrics = {}
    if trace:
        out_metrics = _layer_metrics(metrics, done, kind, trace_summary,
                                     inproc)
    else:
        e2e = {"bases_per_s": (n_bases * len(done) / window_s
                               if done else 0.0),
               "peak_device_gib": peak / GIB,
               "setup_s": setup_s}
        for m in metrics:
            if m["name"] in e2e:
                out_metrics[m["name"]] = {"value": e2e[m["name"]],
                                          "unit": m["unit"]}
    device_out = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": n_ranks, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": out_metrics, "device": device_out}
    if trace:
        busy, traced, breakdown = _busy(trace_summary, done, inproc)
        device_out["busy_s"] = busy
        device_out["window_s"] = traced
        if breakdown:
            result["breakdown"] = breakdown
    result["compared"] = compared
    info.update({"workload": w["name"], "seed": seed, "input_reads": n_reads,
                 "input_bases": n_bases, "jobs_completed": len(done),
                 "job_walls_s": [j["wall_s"] for j in jobs],
                 "warmup_wall_s": warm["wall_s"], "window_s": window_s,
                 "setup_s": setup_s, "check_s": check_s,
                 "bytes_written": written, "host": host,
                 "reference_digests": {n: digest(d) for n, d in want.items()}})
    return {"result": result, "info": info}


def host_reading() -> Dict:
    """The machine's CPU time by state (/proc/stat, in ticks), this
    process's and its children's CPU seconds, the load average and the
    mean clock of the cores (/proc/cpuinfo): read at the window's two
    ends, they say how much of the host's time went elsewhere (another
    machine's, as steal; other processes') while the window ran."""
    out = {"cpu": None, "load1": None, "mhz": None}
    try:
        with open("/proc/stat") as f:
            out["cpu"] = [int(x) for x in f.readline().split()[1:9]]
        with open("/proc/loadavg") as f:
            out["load1"] = float(f.read().split()[0])
        with open("/proc/cpuinfo") as f:
            mhz = [float(ln.split(":")[1]) for ln in f if ln.startswith(
                "cpu MHz")]
        out["mhz"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError, IndexError):
        pass
    ru = resource.getrusage(resource.RUSAGE_SELF)
    rc = resource.getrusage(resource.RUSAGE_CHILDREN)
    out["proc_cpu_s"] = ru.ru_utime + ru.ru_stime + rc.ru_utime + rc.ru_stime
    out["t"] = time.perf_counter()
    return out


def host_window(a: Dict, b: Dict) -> Dict:
    """The host's readings over a window from its two ends: the shares of
    the machine's CPU time that were busy, waiting on I/O and stolen by
    the hypervisor, in %, the run's own CPU seconds a second of the
    window, and the load and clock at each end."""
    out = {"load1": [a["load1"], b["load1"]], "mhz": [a["mhz"], b["mhz"]],
           "proc_cpu_per_s": (b["proc_cpu_s"] - a["proc_cpu_s"])
           / max(b["t"] - a["t"], 1e-9)}
    if a["cpu"] and b["cpu"]:
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
        total = max(sum(d), 1)
        # user nice system idle iowait irq softirq steal
        out["busy_pct"] = 100.0 * (d[0] + d[1] + d[2] + d[5] + d[6]) / total
        out["iowait_pct"] = 100.0 * d[4] / total
        out["steal_pct"] = 100.0 * d[7] / total
    return out


def _tree_bytes(path: str) -> int:
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total


def _rank_readings(jobs: List[Dict]) -> List[List[Dict]]:
    """Per rank, its reading of each job (one rank in one process)."""
    if jobs and "ranks" in jobs[0]:
        n = len(jobs[0]["ranks"])
        return [[j["ranks"][r] for j in jobs] for r in range(n)]
    return [jobs]


def _layer_metrics(metrics, jobs, kind, trace_summary, inproc) -> Dict:
    """Each per-layer reader over the window's jobs; with ranks, the worst
    rank's value."""
    out = {}
    per_rank = _rank_readings(jobs)
    for m in metrics:
        mod = reader(m["name"])
        vals = []
        for rj in per_rank:
            tr = trace_summary if inproc else _sum_traces(
                [j.get("trace") for j in rj])
            ctx = {"trace": tr, "peak_bandwidth": peak_bandwidth(kind)}
            v = mod.value(rj, ctx) if rj else None
            if v is not None:
                vals.append(v)
        if vals:
            worst = max(vals) if m["better"] == "lower" else min(vals)
            out[m["name"]] = {"value": worst, "unit": m["unit"]}
        else:
            gone = sorted({g for rj in per_rank for j in rj
                           for p in j.get("probes", {}).values()
                           for g in p.get("missing", [])})
            print("kbench: %s reports nothing: %s" % (
                m["name"], "; ".join(gone) or "nothing to read"),
                file=sys.stderr)
    return out


def _sum_traces(traces):
    """A rank's traces of its jobs as one: each covers the rank's run of a
    job, so a process's start is in no rank's traced window."""
    traces = [t for t in traces if t]
    if not traces:
        return None
    return {"busy_s": sum(t["busy_s"] for t in traces),
            "window_s": sum(t["window_s"] for t in traces)}


def _busy(trace_summary, jobs, inproc):
    """The device's busy seconds and the traced window's length (means over
    the cards), and the breakdown."""
    if inproc:
        if not trace_summary:
            return 0.0, 0.0, None
        return trace_summary["busy_s"], trace_summary["window_s"], {
            "device_ops": trace_summary["device_ops"],
            "idle_gaps": trace_summary["idle_gaps"]}
    busy, window = [], []
    ops: Dict[str, float] = {}
    gaps = []
    for rj in _rank_readings(jobs):
        ts = [j.get("trace") for j in rj if j.get("trace")]
        summed = _sum_traces(ts) or {"busy_s": 0.0, "window_s": 0.0}
        busy.append(summed["busy_s"])
        window.append(summed["window_s"])
        for t in ts:
            for name, s in t["device_ops"]:
                ops[name] = ops.get(name, 0.0) + s
            gaps += t["idle_gaps"]
    top = sorted(ops.items(), key=lambda x: -x[1])[:10]
    gaps = sorted(gaps, key=lambda x: -x[1])[:10]
    n = max(len(busy), 1)
    return sum(busy) / n, sum(window) / n, {
        "device_ops": [list(x) for x in top], "idle_gaps": gaps}
