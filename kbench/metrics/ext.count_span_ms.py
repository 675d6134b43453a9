"""ext.count_span_ms: milliseconds a job spends in MeraculousCounter's
extension spectrum (parallel/mesh.py `extension_spectrum_mesh`: route,
exchange and the 13 run sums a shard): a pair of CUDA events around each
call, from its start on the stream to the end of the work it queued, the
host's launches and waits included. Per job."""
PROBES = [dict(name="ext_count", kind="cuda", targets=[
    "kmernator_tpu_torch.parallel.mesh:extension_spectrum_mesh"])]


def value(jobs, ctx):
    r = [j["probes"].get("ext_count", {}) for j in jobs]
    if not r or not all(x.get("calls") for x in r):
        return None
    return sum(x["span_ms"] for x in r) / len(r)
