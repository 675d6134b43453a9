"""exchange.span_ms: milliseconds a job spends in the shard exchange
(parallel/mesh.py `owners`, `bucket_loads`, `bucket_slots`,
`scatter_plane`, `exchange`): a pair of CUDA events around each outermost
call, so a span runs from the call's start on the stream to the end of the
work it queued. On this launch-bound path that is mostly the host's
launches and waits, not kernel time: the device's own time is in the
trace (`breakdown`, `device.idle_share`). Per job: the window's sum over
its jobs."""
PROBES = [dict(name="exchange", kind="cuda", targets=[
    "kmernator_tpu_torch.parallel.mesh:" + n
    for n in ("owners", "bucket_loads", "bucket_slots", "scatter_plane",
              "exchange")])]


def value(jobs, ctx):
    r = [j["probes"].get("exchange", {}) for j in jobs]
    if not r or not all(x.get("calls") for x in r):
        return None
    return sum(x["span_ms"] for x in r) / len(r)
