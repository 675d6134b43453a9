"""Smoke run of kmernator_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from csrc/, holds it against its plain
PyTorch version on the card, then drives FilterReads `--mesh 1` through the
port's CLI entry point (`kmernator_tpu_torch.apps.filter_reads.run`), on
the streaming engine (a ~256 MB FASTQ, whose table fills the 64M-row
clamp) and on the in-memory engine with device lookup (~32 MB), and
requires every output file to be byte-identical to the host engine's
(`python -m kmernator_tpu.apps.filter_reads`, no mesh). Fails (non-zero
exit, no result line) without a CUDA device, outside a checkout, or when
any phase fails. Imports no jax.

Output: one line per phase, the card's `name, power.limit`, a JSON line of
per-kernel results, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
FLAGS = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
         "--artifact-edit-distance", "1", "--min-read-length", "25"]
DRAIN_ROWS = (64 << 20) + (32 << 20)   # drain at cap + cap // 2, cap = 64M
BATCH_ROWS = 2048 * 120                # one count_batch of 2048 x 120


def log(msg: str) -> None:
    print(msg, flush=True)


def env_with_root(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.update(extra)
    return env


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sorted_lanes(n: int, n_keys: int, gen: torch.Generator,
                 sentinel_tail: int = 0) -> torch.Tensor:
    """n sorted int64 lanes drawn from n_keys distinct signed values (both
    signs), with an INT64_MAX sentinel tail of the given length."""
    from kmernator_tpu_torch.ops.kmer import SENTINEL_LANE
    ids = torch.randint(0, max(n_keys, 1), (n,), generator=gen,
                        device="cuda")
    lanes = ids * -0x61C8864680B583EB // 3   # odd multiplier: both signs
    if sentinel_tail:
        lanes[-sentinel_tail:] = SENTINEL_LANE
    return torch.sort(lanes).values


def phase_kernel(rl):
    """Kernel vs plain version on the card: bit-equal at the main path's
    shapes and at the edge cases; device times at the main path's shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    cases = {}
    # drain: cap + cap // 2 rows, table counts and staged ones, sentinels
    n = DRAIN_ROWS
    cases["drain_96M"] = (sorted_lanes(n, 30 << 20, gen, 8 << 20),
                          torch.randint(1, 6, (n,), generator=gen,
                                        device="cuda", dtype=torch.int32))
    cases["count_batch_2048x120"] = (
        sorted_lanes(BATCH_ROWS, 60000, gen, 9000),
        torch.ones(BATCH_ROWS, dtype=torch.int32, device="cuda"))
    ones = lambda m: torch.ones(m, dtype=torch.int32, device="cuda")
    cases["n0"] = (torch.empty(0, dtype=torch.int64, device="cuda"), ones(0))
    cases["n1"] = (torch.full((1,), -5, dtype=torch.int64, device="cuda"),
                   ones(1))
    cases["n_not_tile_multiple"] = (sorted_lanes(2048 * 5 + 3, 900, gen),
                                    ones(2048 * 5 + 3))
    cases["one_giant_run"] = (torch.full((5_000_003,), 42, dtype=torch.int64,
                                         device="cuda"), ones(5_000_003))
    cases["all_unique"] = (torch.arange(-(1 << 20), 1 << 20, device="cuda"),
                           ones(2 << 20))
    cases["sentinel_tail"] = (sorted_lanes(1 << 20, 1000, gen, 700_000),
                              ones(1 << 20))
    cases["sign_bit_keys"] = (torch.sort(torch.randint(
        -(1 << 62), 0, (300_001,), generator=gen, device="cuda") * 2).values,
        ones(300_001))
    max_err = 0
    for name, (lanes, vals) in cases.items():
        got = rl.run_length_sums(lanes, vals)
        want = rl.run_length_sums_plain(lanes, vals)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if lanes.numel() else 0
        if not torch.equal(got, want):
            raise SystemExit("run_length kernel disagrees with its plain "
                             "version on %s (max abs err %d)" % (name, err))
        max_err = max(max_err, err)
        log("kernel %-22s n=%-10d bit-equal" % (name, lanes.numel()))
    times = {}
    for name in ("drain_96M", "count_batch_2048x120"):
        lanes, vals = cases[name]
        reps = 10 if name == "drain_96M" else 200
        # plain, kernel, kernel, plain: each the mean of its two turns
        p1 = cuda_ms(lambda: rl.run_length_sums_plain(lanes, vals), reps)
        k1 = cuda_ms(lambda: rl.run_length_sums(lanes, vals), reps)
        k2 = cuda_ms(lambda: rl.run_length_sums(lanes, vals), reps)
        p2 = cuda_ms(lambda: rl.run_length_sums_plain(lanes, vals), reps)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        gbs = 16 * lanes.numel() / (times[name][0] * 1e-3) / 1e9
        log("kernel %-22s kernel %.4f ms, plain %.4f ms (%.0f GB/s at "
            "16 B/row)" % (name, times[name][0], times[name][1], gbs))
    del cases
    torch.cuda.empty_cache()
    return max_err, times


def generate(path: str, genome_mb: str) -> int:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m",
                    "kmernator_tpu.apps.generate_metagenome", "--genomes",
                    "20", "--total-genome-mb", genome_mb, "--coverage", "20",
                    "--read-length", "150", "--seed", "7", "--out", path],
                   check=True, env=env_with_root())
    with open(path, "rb") as f:
        n_reads = sum(chunk.count(b"\n") for chunk in
                      iter(lambda: f.read(1 << 24), b"")) // 4
    log("generated %s: %d reads, %d bytes in %.1f s"
        % (os.path.basename(path), n_reads, os.path.getsize(path),
           time.perf_counter() - t0))
    return n_reads


def outputs(prefix: str):
    d, base = os.path.split(prefix)
    return {n[len(base):]: os.path.join(d, n)
            for n in sorted(os.listdir(d)) if n.startswith(base)}


def phase_app(name: str, fq: str, n_reads: int, rl, extra_env):
    """Port (in-process, on the card) vs host engine (subprocess): outputs
    byte-identical, the kernel launched, the table on the card."""
    import kmernator_tpu_torch.apps.filter_reads as app
    tables = []

    class Recorded(app.MeshStreamingSpectrum):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tables.append(self)

    port_out = os.path.join(WORK, name + "-port")
    host_out = os.path.join(WORK, name + "-host")
    saved_env = {k: os.environ.get(k) for k in extra_env}
    os.environ.update(extra_env)
    plain_class = app.MeshStreamingSpectrum
    app.MeshStreamingSpectrum = Recorded
    torch.cuda.reset_peak_memory_stats()
    try:
        rl.launches = 0
        t0 = time.perf_counter()
        rc = app.run(["--device", "cuda", "--mesh", "1", "--out", port_out]
                     + FLAGS + ["31", fq])
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
        launches = rl.launches
    finally:
        app.MeshStreamingSpectrum = plain_class
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise SystemExit("%s: port FilterReads exited %d" % (name, rc))
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
                    "--out", host_out] + FLAGS + ["31", fq], check=True,
                   env=env_with_root(**extra_env))
    t_host = time.perf_counter() - t0
    mine, want = outputs(port_out), outputs(host_out)
    if not want or set(mine) != set(want):
        raise SystemExit("%s: output files differ: %s vs %s"
                         % (name, sorted(mine), sorted(want)))
    for suffix in want:
        with open(mine[suffix], "rb") as a, open(want[suffix], "rb") as b:
            if a.read() != b.read():
                raise SystemExit("%s: %s differs from the host engine"
                                 % (name, suffix))
    if launches <= 0:
        raise SystemExit("%s: the run-length kernel was never launched"
                         % name)
    if len(tables) != 1 or tables[0].table_keys.device.type != "cuda" \
            or tables[0].drains < 1:
        raise SystemExit("%s: the shard table did not live on the card"
                         % name)
    sp = tables[0]
    log("%s: byte-identical (%s); run_length launches %d; table %d rows "
        "on %s, %d drains, %d singletons purged; peak device memory %.2f GiB"
        % (name, ", ".join(want), launches, sp.cap, sp.table_keys.device,
           sp.drains, sp.purged_singletons,
           torch.cuda.max_memory_allocated() / 2**30))
    log("%s: port %.2f s = %.0f reads/s; host engine %.2f s = %.0f reads/s"
        % (name, t_port, n_reads / t_port, t_host, n_reads / t_host))
    for path in list(mine.values()) + list(want.values()):
        os.remove(path)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kmernator_tpu_torch.kernels import build
    from kmernator_tpu_torch.parallel import run_length as rl
    os.makedirs(WORK, exist_ok=True)

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log("phase 1 card: %s | torch %s, CUDA %s, %d device(s) [%.1f s]"
        % (smi, torch.__version__, torch.version.cuda,
           torch.cuda.device_count(), time.perf_counter() - t0))

    t0 = time.perf_counter()
    build.load("run_length")
    log("phase 2 build: csrc/run_length.cu with nvcc %s in %.2f s (%s)"
        % (" ".join(build.ARCH_FLAGS), build.build_seconds["run_length"],
           os.path.relpath(build.library_path("run_length"), ROOT)))

    t0 = time.perf_counter()
    max_err, times = phase_kernel(rl)
    log("phase 3 kernel vs plain: bit-equal [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    fq = os.path.join(WORK, "meta256.fastq")
    n = generate(fq, "6")
    launches = phase_app("streaming", fq, n, rl, {})
    os.remove(fq)
    log("phase 4 streaming slice ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    fq = os.path.join(WORK, "meta32.fastq")
    n = generate(fq, "0.75")
    launches += phase_app("in-memory", fq, n, rl,
                          {"KMTPU_AUTO_STREAM_MB": "64"})
    os.remove(fq)
    log("phase 5 in-memory slice ok [%.1f s]" % (time.perf_counter() - t0))

    k_ms, p_ms = times["drain_96M"]
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "run_length_sums", "route": "cuda",
        "source": "kmernator_tpu_torch/csrc/run_length.cu",
        "replaces": "kmernator_tpu/parallel/pallas_count.py:159",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
        "shape": "drain %d rows" % DRAIN_ROWS,
        "batch_ms": times["count_batch_2048x120"][0],
        "batch_plain_ms": times["count_batch_2048x120"][1]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
