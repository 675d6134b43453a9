"""apps.output_pass_s: seconds a job spends past its counting pass (apps):
scoring, selection and the writes of FilterReads, or MeraculousCounter's
mercount and mergraph text. The job's wall (in a process of the rank
launcher, the rank's own run) less apps.count_pass_s. Per job."""
import os
import importlib.util

_spec = importlib.util.spec_from_file_location(
    "kbench_metric_count_pass",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "apps.count_pass_s.py"))
_count = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_count)

PROBES = _count.PROBES


def value(jobs, ctx):
    rest = []
    for j in jobs:
        c = _count.job_seconds(j)
        if c is None:
            return None
        rest.append(j["wall_s"] - c)
    return sum(rest) / len(rest) if rest else None
