"""io.pairs_s: seconds a job spends pairing its reads by name (io): the
port's span `io.pairs`, each `ReadSet.identify_pairs` call, inside
`io.parse` in FilterReads' streaming engine (both passes). Per job: the
mean over the window's jobs. A port without the span reports nothing."""
from kbench import program_spans

program_spans.enable()
PROBES = []


def value(jobs, ctx):
    return program_spans.span_total(jobs, "io.pairs")
