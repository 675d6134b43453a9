"""apps.device_calls_s: host seconds a job spends inside the calls that feed
the card and bring the table back (apps): the port's spans `table.add`
(each `MeshStreamingSpectrum.add_batch`), `ext.count` (MeraculousCounter's
copies and `extension_spectrum_mesh`) and `table.to_host` (the table to a
host spectrum), summed. Per job: the mean over the window's jobs."""
from kbench import program_spans

program_spans.enable()
PROBES = []


def value(jobs, ctx):
    return program_spans.span_total(jobs, "table.add", "ext.count",
                                    "table.to_host")
