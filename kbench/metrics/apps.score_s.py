"""apps.score_s: seconds a job spends scoring and selecting reads in
FilterReads' pass 2 (apps): the port's span `apps.score`
(`window_count_lookup`, `score_and_trim`, `select_reads`,
`divert_blobs`). Per job: the mean over the window's jobs."""
from kbench import program_spans

program_spans.enable()
PROBES = []


def value(jobs, ctx):
    return program_spans.span_total(jobs, "apps.score")
