"""The result line has exactly the contract's keys, and a run without the
cards it asks for prints no result."""
import os
import subprocess
import sys

import pytest

from kbench import harness
from kbench.tests.common import run_cpu

TOP = {"correct", "attempted", "failed", "metrics", "device", "compared"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    res = run_cpu("filter-k31.meta20x", trace=trace)["result"]
    assert set(res) - {"breakdown"} == TOP
    assert list(res)[-1] == "compared"
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        dev |= {"busy_s", "window_s"}
    assert set(res["device"]) == dev
    man = harness.manifest()
    want = {m["name"] for m in harness.metrics_of(man, "filter-k31.meta20x",
                                                   trace)}
    # on the CPU the device's readers have nothing to read
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        assert got == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(tmp_path):
    if _cuda():
        pytest.skip("a CUDA card is visible")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.KBENCH, "run.py"),
         "--workload", "filter-k31.meta20x", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert not any('"correct"' in line for line in proc.stdout.splitlines())


def _cuda() -> bool:
    import torch
    return torch.cuda.is_available()
