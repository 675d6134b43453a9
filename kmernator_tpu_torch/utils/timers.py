"""Phase timers (ref: Utils.h Timer + MatcherInterface::recordTime/getTimes,
used by the assembler loop to report per-phase wall time).

Copied for kmernator_tpu_torch from kmernator_tpu/utils/timers.py; it is
the source unchanged but for this paragraph.
"""
from __future__ import annotations

import time
from typing import List, Tuple


class PhaseTimer:
    def __init__(self):
        self._marks: List[Tuple[str, float]] = []
        self.reset("start")

    def reset(self, label: str = "start"):
        self._marks = [(label, time.perf_counter())]

    def record(self, label: str):
        self._marks.append((label, time.perf_counter()))

    def report(self) -> str:
        out = []
        for (l0, t0), (l1, t1) in zip(self._marks, self._marks[1:]):
            out.append("%s: %.3fs" % (l1, t1 - t0))
        total = self._marks[-1][1] - self._marks[0][1]
        out.append("total: %.3fs" % total)
        return ", ".join(out)
