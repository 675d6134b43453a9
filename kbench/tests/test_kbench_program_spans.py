"""The readers of the port's own spans (kbench/program_spans.py): a traced
run of each cell reports every one of the cell's metrics read from them,
an untraced run leaves the port's tracer off, and the steps the spans
name account for more than 90% of a job."""
import pytest

from kbench import harness, program_spans
from kbench.tests.common import run_cpu
from kmernator_tpu_torch.utils import timers

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _reads_spans(name):
    return getattr(harness.reader(name), "program_spans", None) \
        is program_spans


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_every_span_metric(cell):
    names = [m["name"] for m in harness.metrics_of(MAN, cell, True)
             if _reads_spans(m["name"])]
    assert len(names) >= 5
    out = run_cpu(cell, trace=True)
    res = out["result"]
    assert res["correct"]
    for n in names:
        v = res["metrics"][n]["value"]
        assert isinstance(v, float) and v >= 0.0, (n, v)
    wall = sum(out["info"]["job_walls_s"]) / len(out["info"]["job_walls_s"])
    assert res["metrics"]["apps.untraced_s"]["value"] < 0.1 * wall


def test_untraced_run_leaves_the_tracer_off():
    timers.disable()
    timers.clear()
    out = run_cpu("meraculous-k21.meta20x", trace=False)
    assert out["result"]["correct"]
    assert not timers.enabled() and timers.records() == []


def test_no_record_reports_nothing():
    timers.clear()
    jobs = [{"ok": True, "wall_s": 1.0, "probes": {}}]
    for n in ("io.parse_s", "apps.untraced_s"):
        assert harness.reader(n).value(jobs, {}) is None
