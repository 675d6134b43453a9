"""io.output_s: seconds a job spends writing its output files (io): the
port's span `io.output`, FilterReads' `_append_blob` and `_finalize_parts`
or MeraculousCounter's mercount and mergraph dumps (their formatting
included). Per job: the mean over the window's jobs."""
from kbench import program_spans

program_spans.enable()
PROBES = []


def value(jobs, ctx):
    return program_spans.span_total(jobs, "io.output")
