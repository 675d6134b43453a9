"""apps.prepare_s: seconds a job spends making the card's input on the host
(apps): the port's span `apps.prepare`, FilterReads' `_chunk_padded`
(codes, base probabilities, window weights, padding) and MeraculousCounter's
arrays before their first copy to the card (those and the extension
masks). Per job: the mean over the window's jobs."""
from kbench import program_spans

program_spans.enable()
PROBES = []


def value(jobs, ctx):
    return program_spans.span_total(jobs, "apps.prepare")
