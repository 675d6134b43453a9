"""device.idle_share: the share of the traced window in which no kernel,
copy or memset ran on the card, in % (torch.profiler's trace; a rank's
busy time over its own traced runs of the jobs, the largest over the
ranks)."""
PROBES = []


def value(jobs, ctx):
    t = ctx.get("trace")
    if not t or t.get("busy_s", 0.0) <= 0.0 or t["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
