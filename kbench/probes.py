"""Probes: wrappers put around the port's functions from outside, so that
per-layer readers can read host seconds, CUDA-event spans, calls and
bytes without a line of the program changed.

A probe names its targets as "module:attribute" or "module:Class.method".
A module-level function is replaced under every name bound to it in the
loaded modules of the port (`from x import f` copies it), and a method on
its class. A target that is gone leaves the probe `missing`, with the
reason, and its readers report nothing.

Kinds:
- "host": host seconds between call and return (a generator's items too).
- "cuda": a pair of CUDA events around each call, so its span runs from
  the call's start on the stream to the end of the work it queued: kernel
  time, and the host's launches and waits between; milliseconds are read
  at the job's end, after a synchronize.

A probe's `nbytes` callable of (args, kwargs, result) adds each call's
bytes.
- "mark": the host time at each return, relative to the job's start.

On the CPU (the harness's tests) a "cuda" probe reads the host clock:
nothing runs there asynchronously.

A call made while the same probe is already inside a call is not counted
again. With `label=True` (the traced run) each call also opens a
`torch.profiler.record_function("kbench.<probe>")`, which names the host
step in the trace.
"""
from __future__ import annotations

import importlib
import inspect
import sys
import time
from typing import Callable, Dict, List, Optional

PORT = "kmernator_tpu_torch"


class Probe:
    def __init__(self, name: str, kind: str, targets: List[str],
                 nbytes: Optional[Callable] = None):
        self.name, self.kind, self.targets = name, kind, targets
        self.nbytes_of = nbytes
        self.missing: List[str] = []
        self.depth = 0
        self.reset(0.0)

    def reset(self, t0: float):
        self.t0 = t0
        self.calls = 0
        self.host_s = 0.0
        self.events = []
        self.nbytes = 0
        self.marks: List[float] = []

    def reading(self) -> Dict:
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        if self.kind == "cuda" and not self.events:
            ms = 1e3 * self.host_s
        return {"calls": self.calls, "host_s": self.host_s, "span_ms": ms,
                "bytes": self.nbytes, "marks": list(self.marks),
                "missing": list(self.missing)}


class ProbeSet:
    """The probes of a run's readers, installed into the loaded port."""

    def __init__(self, label: bool = False, device: str = "cuda"):
        self.probes: Dict[str, Probe] = {}
        self.label = label
        self.cuda = device == "cuda"
        self._undo = []

    def add(self, name: str, kind: str, targets: List[str],
            nbytes: Optional[Callable] = None) -> Probe:
        if name not in self.probes:
            self.probes[name] = Probe(name, kind, targets, nbytes)
        return self.probes[name]

    def install(self):
        for p in self.probes.values():
            for target in p.targets:
                why = self._install(p, target)
                if why:
                    p.missing.append(why)

    def uninstall(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []

    def begin_job(self, t0: float):
        for p in self.probes.values():
            p.reset(t0)

    def end_job(self) -> Dict[str, Dict]:
        """Each probe's reading of the job; the caller has synchronized."""
        return {n: p.reading() for n, p in self.probes.items()}

    # ---- wrapping ----
    def _install(self, p: Probe, target: str) -> Optional[str]:
        mod_name, _, attr = target.partition(":")
        try:
            mod = importlib.import_module(mod_name)
        except ImportError as e:
            return "%s: %s" % (target, e)
        owner = mod
        *path, leaf = attr.split(".")
        for part in path:
            owner = getattr(owner, part, None)
            if owner is None:
                return "%s: no %s" % (target, part)
        fn = owner.__dict__.get(leaf) if inspect.isclass(owner) else \
            getattr(owner, leaf, None)
        if fn is None:
            return "%s: no %s" % (target, leaf)
        wrapped = self._wrap(p, fn)
        if inspect.isclass(owner):
            self._set(owner, leaf, fn, wrapped)
            return None
        for m in list(sys.modules.values()):
            name = getattr(m, "__name__", "") or ""
            if name.split(".")[0] != PORT:
                continue
            for a, v in list(vars(m).items()):
                if v is fn:
                    self._set(m, a, fn, wrapped)
        return None

    def _set(self, owner, attr, fn, wrapped):
        self._undo.append((owner, attr, fn))
        setattr(owner, attr, wrapped)

    def _wrap(self, p: Probe, fn):
        label = self.label
        events = p.kind == "cuda" and self.cuda

        def enter():
            p.depth += 1
            if p.depth > 1:
                return None
            ctx = None
            if label:
                import torch
                ctx = torch.profiler.record_function("kbench." + p.name)
                ctx.__enter__()
            if events:
                import torch
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                return ctx, ev, 0.0
            return ctx, None, time.perf_counter()

        def leave(state, args, kwargs, result):
            p.depth -= 1
            if state is None:
                return
            ctx, ev, t = state
            p.calls += 1
            if ev is not None:
                ev[1].record()
                p.events.append(ev)
            else:
                now = time.perf_counter()
                p.host_s += now - t
                if p.kind == "mark":
                    p.marks.append(now - p.t0)
            if p.nbytes_of is not None and result is not None:
                p.nbytes += int(p.nbytes_of(args, kwargs, result))
            if ctx is not None:
                ctx.__exit__(None, None, None)

        if inspect.isgeneratorfunction(fn):
            def items(*args, **kwargs):
                it = fn(*args, **kwargs)
                while True:
                    state = enter()
                    try:
                        x = next(it)
                    except StopIteration:
                        leave(state, args, kwargs, None)
                        return
                    except BaseException:
                        leave(state, args, kwargs, None)
                        raise
                    leave(state, args, kwargs, x)
                    yield x
            return items

        def call(*args, **kwargs):
            state = enter()
            result = None
            try:
                result = fn(*args, **kwargs)
                return result
            finally:
                leave(state, args, kwargs, result)
        return call
