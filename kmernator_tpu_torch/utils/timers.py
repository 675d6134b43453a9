"""The port's tracer: spans and counters inside the program, off by default.

    from kmernator_tpu_torch.utils import timers
    with timers.span("io.parse"):
        rs = next(chunks)
    timers.count("io.reads", rs.n)

A run is one call of an app's `run(argv)` (decorated with `traced_run`):
one user job. The app opens it with `begin_run` once its options are
parsed, when the tracer is enabled (`enable()`) or its `--debug` is 1 or
more. While a run is open, each span records its name, its start and end
(`time.perf_counter_ns`), the index of its parent span and the run's id,
and `count` adds to the run's counters. The spans stay in memory. At the
run's end they are reduced to the run's record (`records()`, the last
1,024 runs: a benchmark window of sub-second jobs, read whole): for each
span name its calls, its total seconds, its self seconds (the total less
the part its child spans cover) and the names of its parents, the device
seconds of the spans given a device, and the run's counters; at `--debug
1` one line a name is logged, then the counters and the kernels' launches
in the run.

A span given `device=` (the torch device its work runs on) also records a
pair of CUDA events around its work when that device is CUDA; the run's
end reads them after one `torch.cuda.synchronize()`. On another device
its device seconds are the host clock's.

While a `torch.profiler` is recording, every span also opens
`torch.profiler.record_function("kmtpu." + name)`, so that it sits on the
profiler's timeline beside the device's kernels and copies.

With no run open, `span` returns one shared no-op context after one flag
test, and `count` returns after one flag test: no clock read, no event,
no record_function, no synchronize and no allocation. Spans and counts
are recorded from the thread that opened the run only.

`timed(name)` is a span that reads the host clock whether or not a run is
open, for a program's own log line (the assembler's per-iteration times).
A forked pool worker hands the spans of its task to the parent with
`task_mark`/`task_spans`, and the parent adds them to its run's record
under "workers" with `absorb`.
"""
from __future__ import annotations

import collections
import functools
import sys
import threading
import time
from typing import Dict, List, Optional

from kmernator_tpu_torch.utils.logging import Log

KEEP = 1024   # run records kept
# the kernels' launch counters the run summary reads (module, attribute)
LAUNCHES = (("parallel.run_length", "launches"),
            ("parallel.merge_sort", "launches"),
            ("parallel.hash_insert", "launches"),
            ("parallel.prepare_reads", "launches"),
            ("parallel.format_mers", "launches"))

_active = False       # a run is open: the one flag span() and count() test
_enabled = False
_run = None           # the open run
_job_start: Optional[int] = None   # perf_counter_ns at traced_run's entry
_next_id = 0
_records: collections.deque = collections.deque(maxlen=KEEP)

# a span's record: [name, parent index, start ns, end ns, device, run id,
# start event, end event]
NAME, PARENT, T0, T1, DEVICE, RUN, EV0, EV1 = range(8)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP = _Noop()


def enable() -> None:
    """Trace every later run of an app in this process."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Trace no later run (unless its --debug asks); an open run goes on."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def active() -> bool:
    """Whether a run is open and recording."""
    return _active


def records() -> List[Dict]:
    """The records of the last runs, oldest first."""
    return list(_records)


def clear() -> None:
    """Forget the records kept."""
    _records.clear()


class _Run:
    def __init__(self, t0: int):
        global _next_id
        _next_id += 1
        self.id = _next_id
        self.thread = threading.get_ident()
        self.spans: List[list] = [["run", -1, t0, 0, None, self.id, None,
                                   None]]
        self.stack = [0]
        self.counters: Dict[str, int] = {}
        self.workers: Dict[str, Dict] = {}
        self.launches = _launches()
        self.rf = _record_function("run")


def _record_function(name: str):
    """An open record_function("kmtpu." + name) while a torch.profiler is
    recording, else None."""
    import torch
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function("kmtpu." + name)
    rf.__enter__()
    return rf


def span(name: str, device=None):
    """A context that records the span `name` in the open run; with no run
    open, the shared no-op."""
    if not _active:
        return _NOOP
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add n to the open run's counter `name`."""
    if not _active:
        return
    r = _run
    if r.thread == threading.get_ident():
        r.counters[name] = r.counters.get(name, 0) + int(n)


class _Span:
    __slots__ = ("name", "device", "run", "index", "rf")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.run = None

    def __enter__(self):
        r = _run
        if r.thread != threading.get_ident():
            return self
        self.run = r
        self.index = len(r.spans)
        rec = [self.name, r.stack[-1], 0, 0, self.device, r.id, None, None]
        r.spans.append(rec)
        r.stack.append(self.index)
        self.rf = _record_function(self.name)
        if self.device is not None and self.device.type == "cuda":
            import torch
            rec[EV0] = torch.cuda.Event(enable_timing=True)
            rec[EV1] = torch.cuda.Event(enable_timing=True)
            rec[EV0].record()
        rec[T0] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        r = self.run
        if r is None:
            return None
        rec = r.spans[self.index]
        rec[T1] = time.perf_counter_ns()
        if rec[EV1] is not None:
            rec[EV1].record()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        r.stack.pop()
        return None


class timed:
    """A span whose host seconds are read whether or not a run is open:
    `with timed("asm.match") as t: ...`, then `t.seconds`."""

    def __init__(self, name: str):
        self.span = span(name)
        self.seconds = 0.0

    def __enter__(self):
        self.span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self.span.__exit__(*exc)
        return None


# ---- runs ----

def traced_run(fn):
    """Make fn, an app's run(argv), a run of the tracer: the app opens it
    with begin_run, and it ends when fn returns or raises. A run called
    inside an open one is part of it."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        global _job_start
        if _active:
            return fn(*args, **kwargs)
        _job_start = time.perf_counter_ns()
        rc = None
        try:
            rc = fn(*args, **kwargs)
            return rc
        finally:
            _job_start = None
            if _active:
                _end(rc)
    return run


def begin_run(debug: int = 0) -> None:
    """Open the run of the job traced_run started, from the job's start,
    when the tracer is enabled or `debug` (the app's --debug) is 1 or
    more. Called by the app once its options are parsed."""
    global _active, _run
    if _active or _job_start is None or not (_enabled or debug >= 1):
        return
    _run = _Run(_job_start)
    _active = True


def _end(rc) -> None:
    global _active, _run
    r = _run
    _active = False
    _run = None
    now = time.perf_counter_ns()
    for rec in r.spans:   # spans an exception left open end with the run
        if rec[T1] == 0:
            rec[T1] = now
    if r.rf is not None:
        r.rf.__exit__(None, None, None)
    if any(rec[EV0] is not None for rec in r.spans):
        import torch
        torch.cuda.synchronize()
    record = {"id": r.id, "rc": rc,
              "wall_s": (r.spans[0][T1] - r.spans[0][T0]) * 1e-9,
              "spans": _reduce(r.spans), "counters": dict(r.counters)}
    if r.workers:
        record["workers"] = r.workers
    _records.append(record)
    _log(record, _launch_delta(r.launches, _launches()))


def _reduce(spans: List[list]) -> Dict[str, Dict]:
    """Per name: calls, total_s, self_s, parents (names), and device_s
    for the spans given a device."""
    covered = [0] * len(spans)
    for rec in spans:
        if rec[PARENT] >= 0:
            covered[rec[PARENT]] += rec[T1] - rec[T0]
    out: Dict[str, Dict] = {}
    for i, rec in enumerate(spans):
        ns = rec[T1] - rec[T0]
        e = out.setdefault(rec[NAME], {"calls": 0, "total_ns": 0,
                                       "self_ns": 0, "parents": set()})
        e["calls"] += 1
        e["total_ns"] += ns
        e["self_ns"] += ns - covered[i]
        if rec[PARENT] >= 0:
            e["parents"].add(spans[rec[PARENT]][NAME])
        if rec[DEVICE] is not None:
            dev = (rec[EV0].elapsed_time(rec[EV1]) * 1e-3
                   if rec[EV0] is not None else ns * 1e-9)
            e["device_s"] = e.get("device_s", 0.0) + dev
    for e in out.values():
        e["total_s"] = e.pop("total_ns") * 1e-9
        e["self_s"] = e.pop("self_ns") * 1e-9
        e["parents"] = sorted(e["parents"])
    return out


# ---- forked pool workers ----

def task_mark() -> Optional[int]:
    """Where a pool task's spans start in the open run (None: no run)."""
    if not _active:
        return None
    return len(_run.spans)


def task_spans(mark: Optional[int]) -> Optional[Dict[str, Dict]]:
    """The spans a pool task recorded since task_mark, reduced as a run's
    are (self seconds within the task) and taken out of the run, for the
    task to return to the parent's absorb."""
    if mark is None or not _active:
        return None
    r = _run
    task = r.spans[mark:]
    del r.spans[mark:]
    for rec in task:
        rec[PARENT] = rec[PARENT] - mark if rec[PARENT] >= mark else -1
    reduced = _reduce(task)
    for e in reduced.values():
        e.pop("parents")
    return reduced


def absorb(spans: Optional[Dict[str, Dict]]) -> None:
    """Add a pool task's spans (task_spans) to the open run's "workers":
    the workers ran side by side, so their seconds are summed apart from
    the run's own spans."""
    if spans is None or not _active:
        return
    for name, e in spans.items():
        w = _run.workers.setdefault(name, {"calls": 0, "total_s": 0.0,
                                           "self_s": 0.0})
        for key in w:
            w[key] += e[key]


# ---- the summary ----

def _launches() -> Dict[str, int]:
    """The kernels' launch counters of the modules loaded, by name."""
    out = {}
    for mod, attr in LAUNCHES:
        m = sys.modules.get("kmernator_tpu_torch." + mod)
        v = getattr(m, attr, None) if m is not None else None
        name = mod.rsplit(".", 1)[1]
        if isinstance(v, dict):
            out.update(("%s.%s" % (name, k), int(n)) for k, n in v.items())
        elif v is not None:
            out[name] = int(v)
    return out


def _launch_delta(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: n - a.get(k, 0) for k, n in b.items() if n != a.get(k, 0)}


def _log(record: Dict, launches: Dict[str, int]) -> None:
    rid = record["id"]
    for name, e in sorted(record["spans"].items(),
                          key=lambda x: -x[1]["total_s"]):
        dev = (", device %.3f s" % e["device_s"]) if "device_s" in e else ""
        Log.debug(1, "run %d span %s: %d calls, %.3f s, self %.3f s%s"
                  % (rid, name, e["calls"], e["total_s"], e["self_s"], dev))
    for name, e in sorted(record.get("workers", {}).items()):
        Log.debug(1, "run %d worker span %s: %d calls, %.3f s, self %.3f s"
                  % (rid, name, e["calls"], e["total_s"], e["self_s"]))
    if record["counters"]:
        Log.debug(1, "run %d counters: %s" % (rid, ", ".join(
            "%s %d" % kv for kv in sorted(record["counters"].items()))))
    if launches:
        Log.debug(1, "run %d launches: %s" % (rid, ", ".join(
            "%s %d" % kv for kv in sorted(launches.items()))))
