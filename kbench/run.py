"""The benchmark of kmernator_tpu_torch: one run of one cell.

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout holding BENCHMARK.json, kbench/ and the port.
Set-up generates the cell's input from the seed, loads the port, and runs
one warm-up job on the input's head; the window then runs whole jobs back
to back for --seconds (the last one ends past it), and every job's output
files are compared with the plain reference's. The last line of standard
output is the result as JSON; the numbers compared, each beside its limit,
close standard error. With --trace 0 the metrics are the cell's
end-to-end ones, with --trace 1 its per-layer ones, read by probes and
torch.profiler. Without as many CUDA cards as the cell asks for, or with
JAX or the JAX package loaded, it exits with another code than 0 and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches at fixed paths inside the checkout (the port builds its own
# CUDA and host libraries into build/); no library may load JAX for us
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build",
                                                       "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from kbench import harness, nojax
    cell = harness.resolve(harness.manifest(), args.workload)
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("kbench: the cell asks for %d CUDA card(s); %d visible"
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    loaded = nojax.found()
    if loaded:
        print("kbench: JAX or the JAX package was loaded: %s" % loaded,
              file=sys.stderr)
        return 3
    print(json.dumps({"info": out["info"]}))
    res = out["result"]
    for name, c in res["compared"].items():
        print("compared %s: %s (limit %s)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
