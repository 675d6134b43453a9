"""On a tiny seeded input the plain reference agrees byte for byte with the
port's --device cpu run of each configuration (FilterReads-P at two gloo
ranks), and the control (the reference with the first half's singletons
dropped) does not."""
import os

import pytest

from kbench import genmeta, harness
from kbench.tests.common import SEED, TINY, run_cpu

# FilterReads-P, whose four-card cell is not in BENCHMARK.json yet, runs
# its configuration at two gloo ranks in the filter cell's place
CELLS = [("filter-k31.meta20x", None, None),
         ("meraculous-k21.meta20x", None, None),
         ("filter-k31.meta20x", 2, "filterp-k31-4rank")]


@pytest.mark.parametrize("cell,ranks,config", CELLS)
def test_reference_matches_port(cell, ranks, config):
    out = run_cpu(cell, ranks=ranks, config=config)
    res = out["result"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"], res["compared"]
    assert res["compared"]["lines_differing"]["value"] == 0


@pytest.mark.parametrize("config", ["filter-k31", "meraculous-k21"])
def test_control_is_not_correct(config, tmp_path):
    path = os.path.join(tmp_path, "input.fastq")
    genmeta.write(TINY, SEED, path)
    conf = harness._json("configs", config)
    want = harness.reference_outputs(conf, path)
    jd = os.path.join(tmp_path, "control")
    os.makedirs(jd)
    for name, data in harness.reference_outputs(conf, path,
                                                control=True).items():
        with open(os.path.join(jd, name), "wb") as f:
            f.write(data)
    assert harness.compare(jd, want)["lines"] > 0
