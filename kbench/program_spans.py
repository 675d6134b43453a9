"""The port's own spans, for the readers of the metrics of source
`program_span` that read them (kbench/metrics/<name>.py).

Importing this module turns the port's tracer on
(`kmernator_tpu_torch.utils.timers.enable`). A reader module is executed
only in a `--trace 1` run, before its warm-up job, so a measured run
(`--trace 0`) keeps the tracer off; each reader also calls `enable()` when
it is executed, since a process that runs several cells (the tests)
imports this module once.

The tracer keeps a record of each of the app's runs (one job); a reader
gets the records of the window's jobs: of the runs that returned 0, the
last `len(jobs)` (the warm-up job's comes first). A port without the
tracer, or a run with no record, gives None, and the reader reports
nothing.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

try:
    from kmernator_tpu_torch.utils import timers
except ImportError:  # a checkout without the port's tracer
    timers = None


def enable() -> None:
    if timers is not None and hasattr(timers, "enable"):
        timers.enable()


enable()


def window_runs(jobs: List[Dict]) -> Optional[List[Dict]]:
    """The tracer's records of the window's completed jobs, in order."""
    if timers is None or not hasattr(timers, "records") or not jobs:
        return None
    done = [r for r in timers.records() if r.get("rc") == 0]
    if len(done) < len(jobs):
        return None
    return done[-len(jobs):]


def total_s(record: Dict, *names: str) -> float:
    """The summed total seconds of the spans named (0 for a span the run
    did not record)."""
    return sum(record["spans"].get(n, {}).get("total_s", 0.0)
               for n in names)


def per_job(jobs: List[Dict], of: Callable[[Dict], Optional[float]]
            ) -> Optional[float]:
    """The mean over the window's jobs of of(record), or None."""
    runs = window_runs(jobs)
    if not runs:
        return None
    vals = [of(r) for r in runs]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def span_total(jobs: List[Dict], *names: str) -> Optional[float]:
    """Seconds a job spends in the spans named (their totals summed), the
    mean over the window's jobs; None where no run recorded any of them."""
    return per_job(jobs, lambda r: total_s(r, *names)
                   if any(n in r["spans"] for n in names) else None)
