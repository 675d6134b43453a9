"""apps.untraced_s: seconds of a job that no span of the steps accounts for
(apps): the port's run (span `run`, one job) less the totals of its spans
`io.parse`, `ops.artifact`, `apps.prepare`, `table.add`, `ext.count`,
`table.to_host`, `apps.score`, `io.output` and `apps.purge`. Per job: the
mean over the window's jobs."""
from kbench import program_spans

program_spans.enable()
PROBES = []
STEPS = ("io.parse", "ops.artifact", "apps.prepare", "table.add",
         "ext.count", "table.to_host", "apps.score", "io.output",
         "apps.purge")


def value(jobs, ctx):
    return program_spans.per_job(
        jobs, lambda r: r["wall_s"] - program_spans.total_s(r, *STEPS))
