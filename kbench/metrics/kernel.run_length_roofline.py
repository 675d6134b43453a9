"""kernel.run_length_roofline: the run-length kernel's share of its
bandwidth bound (csrc/run_length.cu through parallel/run_length.py
`run_length_sums`), in %.

The least time is the bytes at the card's HBM bandwidth (kbench/peaks.json)
over the calls' summed CUDA-event spans; a span holds the launch's host
time as well, so the share is never read above the kernel's own. The bytes are taken at the
function's boundary, from the shapes: each key lane and value read once,
each result written once, (8 L + 4 + 4) bytes a row. The count is of the
work, whatever implements it."""
PROBES = []


def call_bytes(args, kwargs, result):
    lanes = kwargs.get("lanes", args[0] if args else None)
    vals = kwargs.get("vals", args[1] if len(args) > 1 else None)
    lanes = [lanes] if hasattr(lanes, "element_size") else list(lanes)
    n = sum(x.numel() * x.element_size() for x in lanes)
    return (n + vals.numel() * vals.element_size()
            + result.numel() * result.element_size())


PROBES.append(dict(name="run_length", kind="cuda", nbytes=call_bytes,
                   targets=["kmernator_tpu_torch.parallel.run_length:"
                            "run_length_sums"]))


def value(jobs, ctx):
    bw = ctx.get("peak_bandwidth")
    r = [j["probes"].get("run_length", {}) for j in jobs]
    ms = sum(x.get("span_ms", 0.0) for x in r)
    nbytes = sum(x.get("bytes", 0) for x in r)
    if not bw or ms <= 0 or not nbytes:
        return None
    return 100.0 * (nbytes / bw) / (ms * 1e-3)
