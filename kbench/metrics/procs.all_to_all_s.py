"""procs.all_to_all_s: host seconds a rank spends in the exchange across
processes (parallel/multihost.py `all_to_all_planes`: the copy to the
host, the gloo all_to_all, the copy back). Per job, the slowest rank's."""
PROBES = [dict(name="all_to_all", kind="host", targets=[
    "kmernator_tpu_torch.parallel.multihost:all_to_all_planes"])]


def value(jobs, ctx):
    r = [j["probes"].get("all_to_all", {}) for j in jobs]
    if not r or not all(x.get("calls") for x in r):
        return None
    return sum(x["host_s"] for x in r) / len(r)
