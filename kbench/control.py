"""The control of the check: the plain reference with one guarantee broken
(exact counts: the first half's singletons dropped, kbench/reference/
spectrum.py), put in the program's place at a cell's own size. Its outputs
are compared with the sound reference's as a job's are; it has to come out
as not correct on every seed.

    python3 kbench/control.py --workload <cell> --seeds 11 12 13

Prints one JSON line a seed: the numbers compared, as a run reports them.
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from kbench import genmeta, harness
    cell = harness.resolve(harness.manifest(), args.workload)
    for seed in args.seeds:
        work = tempfile.mkdtemp(prefix="kbench-control-")
        try:
            path = os.path.join(work, "input.fastq")
            genmeta.write(cell["traffic"], seed, path)
            want = harness.reference_outputs(cell["config"], path)
            jd = os.path.join(work, "control")
            os.makedirs(jd)
            got = harness.reference_outputs(cell["config"], path,
                                            control=True)
            for name, data in got.items():
                with open(os.path.join(jd, name), "wb") as f:
                    f.write(data)
            diff = harness.compare(jd, want)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "files_differing": diff["files"],
                              "lines_differing": diff["lines"],
                              "correct": diff["lines"] == 0
                              and diff["files"] == 0}), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
