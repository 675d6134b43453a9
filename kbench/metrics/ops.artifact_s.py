"""ops.artifact_s: seconds a job spends in the artifact screen (ops): the
port's span `ops.artifact`, FilterReads' `apply_artifact_filter` and the
write of its scan cache in pass 1, the cache's load and the filter's
replay in pass 2. Per job: the mean over the window's jobs."""
from kbench import program_spans

program_spans.enable()
PROBES = []


def value(jobs, ctx):
    return program_spans.span_total(jobs, "ops.artifact")
