"""A whole run of each one-card cell on the card, as the driver makes it
(one job in the window). Marked `cuda`: it skips where no card is
visible. On the card: python -m pytest -m cuda kbench/tests"""
import json
import os
import subprocess
import sys

import pytest

from kbench import harness

ONE_CARD = [w["name"] for w in harness.manifest()["workloads"]
            if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.KBENCH, "run.py"),
         "--workload", cell, "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
