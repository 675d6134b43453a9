"""io.parse_s: seconds a job spends parsing its input (io): the port's
span `io.parse`, each chunk that FilterReads' streaming engine reads (in
both passes) or MeraculousCounter's `load_reads`. Per job: the mean over
the window's jobs."""
from kbench import program_spans

program_spans.enable()
PROBES = []


def value(jobs, ctx):
    return program_spans.span_total(jobs, "io.parse")
