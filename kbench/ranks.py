"""The rank launcher: one job of a multi-process configuration is one
launch of its ranks, each a process of its own on its own card.

`job` picks a free port for the job's process group, gives each rank its
own CUDA_VISIBLE_DEVICES (rank r sees the r-th card of those the run was
given), TMPDIR and directory (its
log, its readings), starts every rank in a session of its own under a time
limit, and reads back what each rank measured. A rank that exits with
another code than 0, or passes its limit, fails the job, and every rank of
it is killed. The job's output files go to the job's directory, where the
app's gathered writes put them.

A rank is `python kbench/ranks.py --child SPEC`: it runs the port's app in
its process with the readers' probes (and, traced, torch.profiler) around
it, and writes its wall, peak device memory, readings, trace reduction,
card name and any JAX module it finds to the file SPEC names.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List

KBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(KBENCH)
RANK_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def visible_cards(n: int) -> List[str]:
    """The cards this run was given, one a rank: the launcher's own
    CUDA_VISIBLE_DEVICES list where it has one, else cards 0 to n - 1."""
    given = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = ([c.strip() for c in given.split(",") if c.strip()]
             if given is not None else [str(r) for r in range(n)])
    if len(cards) < n:
        raise SystemExit("kbench: %d ranks, %d cards given (%r)"
                         % (n, len(cards), given))
    return cards[:n]


def job(config: Dict, n: int, device: str, job_dir: str, input_path: str,
        metrics: List[str], trace: bool) -> Dict:
    from kbench.harness import argv_of
    os.makedirs(job_dir, exist_ok=True)
    port = free_port()
    cards = visible_cards(n) if device == "cuda" else []
    procs, specs, logs = [], [], []
    t0 = time.perf_counter()
    for r in range(n):
        rdir = os.path.join(os.path.dirname(job_dir),
                            os.path.basename(job_dir) + ".rank%d" % r)
        tmp = os.path.join(rdir, "tmp")
        os.makedirs(tmp, exist_ok=True)
        spec = {"app": config["app"], "device": device, "metrics": metrics,
                "trace": trace, "readings": os.path.join(rdir,
                                                         "readings.json"),
                "argv": argv_of(config, device=device,
                                out=os.path.join(job_dir, "out"),
                                input=input_path, rank=r, nprocs=n,
                                port=port)}
        path = os.path.join(rdir, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, TMPDIR=tmp)
        if device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = cards[r]
        log = open(os.path.join(rdir, "log.txt"), "wb")
        logs.append(log)
        specs.append(spec)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", path],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    ok = True
    try:
        pending = list(procs)
        while pending:
            for p in list(pending):
                if p.poll() is not None:
                    pending.remove(p)
                    ok = ok and p.returncode == 0
            if not ok or time.monotonic() > deadline:
                ok = False
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    ranks = []
    for r, spec in enumerate(specs):
        try:
            with open(spec["readings"]) as f:
                ranks.append(json.load(f))
        except (OSError, ValueError):
            ok = False
    if not ok:
        for r, spec in enumerate(specs):
            with open(os.path.join(os.path.dirname(spec["readings"]),
                                   "log.txt"), "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            print("kbench: rank %d of %s exited %s:\n%s"
                  % (r, job_dir, procs[r].returncode, tail), file=sys.stderr)
    jax = sorted({m for rk in ranks for m in rk.get("jax", [])})
    return {"ok": ok, "wall_s": wall, "ranks": ranks, "jax": jax,
            "peak_bytes": max([rk.get("peak_bytes", 0) for rk in ranks]
                              + [0]),
            "device_kind": ranks[0].get("device_kind", "") if ranks else ""}


def child(spec_path: str) -> int:
    """One rank: the app on this process's card, measured."""
    sys.path.insert(0, ROOT)
    import importlib
    import torch
    from kbench import nojax
    from kbench import trace as tracing
    from kbench.harness import probe_set
    with open(spec_path) as f:
        spec = json.load(f)
    cuda = spec["device"] == "cuda"
    if cuda and not torch.cuda.is_available():
        print("kbench rank: no CUDA device visible", file=sys.stderr)
        return 2
    app = importlib.import_module("kmernator_tpu_torch.apps." + spec["app"])
    from kmernator_tpu_torch.utils import cleanup
    probes = None
    if spec["trace"]:
        probes = probe_set(spec["metrics"], True, spec["device"])
        probes.install()
    plant = os.environ.get("KBENCH_PLANT")
    if plant:  # the harness's tests break the timed path here
        with open(plant) as f:
            exec(compile(f.read(), plant, "exec"), {})
    prof = tracing.profiler() if (spec["trace"] and cuda) else None
    if prof:  # its start is no part of the job
        prof.__enter__()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if probes:
        probes.begin_job(t0)
    ctx = torch.profiler.record_function("kbench.job") if prof else None
    if ctx:
        ctx.__enter__()
    rc = app.run(list(spec["argv"]))
    cleanup._flush()
    if cuda:
        torch.cuda.synchronize()
    if ctx:
        ctx.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    reduced = None
    if prof:
        prof.__exit__(None, None, None)
        path = os.path.join(os.path.dirname(spec["readings"]), "trace.json")
        prof.export_chrome_trace(path)
        reduced = tracing.reduce(path, window="kbench.job")
        os.remove(path)
    out = {"rc": rc, "wall_s": wall,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
           "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "probes": probes.end_job() if probes else {},
           "trace": reduced, "jax": nojax.found()}
    with open(spec["readings"], "w") as f:
        json.dump(out, f)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    raise SystemExit("usage: ranks.py --child SPEC")
