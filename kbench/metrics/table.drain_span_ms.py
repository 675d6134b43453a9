"""table.drain_span_ms: milliseconds a job spends draining staged rows into
the shard tables (parallel/mesh_stream.py): a pair of CUDA events around
each `MeshStreamingSpectrum._drain_shard` (sort, run sums, compaction),
from its start on the stream to the end of the work it queued, the host's
launches and waits included. Per job: the window's sum over its jobs."""
PROBES = [dict(name="drain", kind="cuda", targets=[
    "kmernator_tpu_torch.parallel.mesh_stream:"
    "MeshStreamingSpectrum._drain_shard"])]


def value(jobs, ctx):
    r = [j["probes"].get("drain", {}) for j in jobs]
    if not r or not all(x.get("calls") for x in r):
        return None
    return sum(x["span_ms"] for x in r) / len(r)
