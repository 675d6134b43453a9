"""Smoke run of kmernator_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc for each source, all
started together) and drives the port's paths on the card:

  1. the card; 2. the build;
  3. the run-length kernel against its plain PyTorch version, bit-equal,
     timed at the drain's, the count path's and a count batch's shapes,
     beside torch.unique_consecutive (the nearest library scan);
  4. FilterReads `--streaming --mesh 1` through the port's CLI entry point
     (`kmernator_tpu_torch.apps.filter_reads.run`) on a ~256 MB FASTQ,
     whose table fills the 64M-row clamp, and
  5. the in-memory `--mesh 1` engine with device lookup (~32 MB): every
     output file byte-identical to the JAX package's host engine, run as a
     separate program (`python -m kmernator_tpu.apps.filter_reads`, no
     mesh) as the oracle;
  6. the merge-path sort kernels (local_sort_blocks, merge_level) against
     their plain versions, bit-equal, at the edge cases and at the main
     path's shapes, with their times beside torch.sort's, the local sort's
     tile pass and in-block levels timed apart inside one call, the merge
     levels timed apart by events that the library's one call records
     between them (queued back to back, and started on an idle card: the
     difference is the time the card waits on the host), and
     merge_sort_lanes and run_length_sums run under
     torch.cuda.set_sync_debug_mode("error");
  7. count_batch on 131,072 reads of 100 bp at k=31 (9,175,040 windows):
     under KMTPU_MERGE_SORT=1 through the sort kernels and without it
     through torch.sort, bit-equal to each other and to a numpy
     np.unique oracle;
  8. the hash-insert kernel against its plain version through the
     order-free invariants at its edge cases (and against np.unique at a
     hot key and at load 0.9), its bench entry point
     (`kmernator_tpu_torch.parallel.hash_insert.main`) at the JAX bench's
     shape, and the canonical 16-mers of phase 7's reads (11,141,120
     keys) into 2^24 slots and into the smallest table at load <= 0.9,
     against np.unique, beside torch.unique and count_batch at k=16, its
     clear, insert and unpack launches timed apart;
  9. the in-memory `--mesh 1 --variant-sigmas 2 --min-variant-kmer-depth
     20` (the on-device variant purge) on a ~42 MB FASTQ of 4 genomes at
     200x, byte-identical to the host engine with the same "Removed N"
     count, the purge's sources, rounds, candidates and device time (CUDA
     events) printed;
 10. k > 32: phase 5's input at k=33 and k=95 on the in-memory `--mesh 1`
     and at k=63 on `--streaming --mesh 1` (two- and three-lane keys),
     each byte-identical to the host engine at the same k;
 11. MeraculousCounter `--mesh 1` through its CLI entry point
     (`kmernator_tpu_torch.apps.meraculous_counter.run`): phase 4's input at
     k=21 (one-lane keys) and phase 5's at k=51 (two lanes), the mercount
     and mergraph files byte-identical to the JAX package's MeraculousCounter
     host engine (`python -m kmernator_tpu.apps.meraculous_counter`, no
     mesh), 13 run-length launches a run, the device time of
     `extension_spectrum_mesh` (CUDA events) and peak device memory;
 12. the nucleating assembler `--mesh 1` through its CLI entry point
     (`kmernator_tpu_torch.apps.nucleating_assembler.run`), whose read
     index is built and queried on the card (parallel/dist_match.py, no
     kernel of csrc/): phase 4's input at k=31 with 50 seeds and phase 5's
     at k=45 (two-lane keys) with 25, each seed the first 100 bp of a read
     drawn with numpy, 5 iterations; the contigs byte-identical to the JAX
     package's host engine (`python -m
     kmernator_tpu.apps.nucleating_assembler`, its k-mer read index), the
     index's rows, each match's queries and hits, the device time of the
     build and of each match (CUDA events), peak device memory and the
     port's host seconds by step.
Phase 3 also holds the kernel's two- and three-lane instantiations
(k <= 64, k <= 96) bit-equal to their plain versions at the drain's shape
and times them beside the one-lane kernel.

Inputs come from the port's own generator and from seeded numpy. Fails
(non-zero exit, no result line) without a CUDA device, outside a
checkout, or when any phase fails, and at its end if any module of jax or
of the JAX package is loaded in this process.

Output: one line per phase, the card's `name, power.limit`, a JSON line of
per-kernel results, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
FLAGS = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
         "--artifact-edit-distance", "1", "--min-read-length", "25"]
DRAIN_ROWS = (64 << 20) + (32 << 20)   # drain at cap + cap // 2, cap = 64M
BATCH_ROWS = 2048 * 120                # one count_batch of 2048 x 120
COUNT_READS, COUNT_LEN, K = 131072, 100, 31   # the bench's round-1 batch
COUNT_ROWS = COUNT_READS * (COUNT_LEN - K + 1)   # 9,175,040 = 70 blocks
BLOCK, CHUNK = 1 << 17, 1 << 15       # merge_sort_2key's defaults
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
SOURCES = ("run_length", "merge_sort", "hash_insert")
HASH_N, HASH_CAP = 1 << 10, 1 << 12   # the JAX hash bench's shape
ASM_ITERATIONS = 5
K16, K16_CAP = 16, 1 << 24           # one 32-bit word a key; 2^24 slots
# the earlier designs' times, from this script on an NVIDIA H100 80GB HBM3 at
# 700.00 W: the bitonic local sort, the hash with separate key and count
# arrays, the two-launch run-length kernel (tile scan, then one carry-fix
# block), and the merge levels of 1,024-row tiles behind a pair table
# copied from pageable host memory a level, with the local sort's in-block
# levels. Printed on a line of their own, never in the kernels line, which
# holds only this run's measurements
PREV_MS = {"local_sort_blocks": {"count_9.2M": 2.0554, "drain_96M": 20.7070},
           "hash_insert": {"hash_1024": 0.0306, "hash_11.1M": 2.1320,
                           "hash_11.1M_high_load": 1.6747},
           "run_length_sums (two launches)": {"drain_96M": 1.1291,
                                      "count_batch_2048x120": 0.0342},
           "merge_level (1,024-row tiles)": {"count_9.2M_7_levels": 0.8353,
                                  "drain_96M_10_levels": 7.5329,
                                  "count_9.2M_3_inblock_levels": 0.2338,
                                  "drain_96M_inblock_levels": 1.8775}}


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


def bytes_bound_ms(nbytes: float) -> float:
    """Least time to move nbytes at the card's data-sheet memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


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


def phase_kernel(rl, count_sorted):
    """Kernel vs plain version on the card: bit-equal at the main path's
    shapes (count_sorted: the count path's sorted lanes) and at the edge
    cases; device times at the main path's shapes."""
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
    cases["count_9.2M"] = (count_sorted,
                           torch.ones(count_sorted.numel(), dtype=torch.int32,
                                      device="cuda"))
    max_err = 0
    for name, (lanes, vals) in cases.items():
        want = rl.run_length_sums_plain(lanes, vals)
        got = rl.run_length_sums(lanes, vals)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs()
                  .max()) if lanes.numel() else 0
        if not torch.equal(got, want):
            raise SystemExit("run_length kernel disagrees with its plain "
                             "version on %s (max abs err %d)" % (name, err))
        max_err = max(max_err, err)
        log("kernel %-22s n=%-10d bit-equal" % (name, lanes.numel()))
    times = {}
    for name in ("drain_96M", "count_9.2M", "count_batch_2048x120"):
        lanes, vals = cases[name]
        reps = {"drain_96M": 10, "count_9.2M": 50}.get(name, 200)
        # plain, kernel, kernel, plain: each the mean of its two turns
        turn = [("plain", lambda: rl.run_length_sums_plain(lanes, vals)),
                ("kernel", lambda: rl.run_length_sums(lanes, vals))]
        t = {}
        for key, fn in turn + turn[::-1]:
            t.setdefault(key, []).append(cuda_ms(fn, reps))
        times[name] = {k: sum(v) / len(v) for k, v in t.items()}
        tm = times[name]
        log("kernel %-22s kernel %.4f ms (tile %d), plain %.4f ms, bound "
            "%.4f ms (%.0f GB/s at 16 B/row)"
            % (name, tm["kernel"], rl._kernel_lib().kmtpu_run_length_tile(),
               tm["plain"], bytes_bound_ms(16 * lanes.numel()),
               16 * lanes.numel() / (tm["kernel"] * 1e-3) / 1e9))
    max_err = max(max_err, phase_lanes(rl, cases, gen, times))
    lanes = cases["drain_96M"][0]
    times["unique_consecutive"] = sum(
        cuda_ms(lambda: torch.unique_consecutive(lanes, return_counts=True),
                10) for _ in range(2)) / 2
    log("kernel drain_96M torch.unique_consecutive(return_counts=True) "
        "%.4f ms (the nearest library scan: compacted runs, another "
        "function, so no library_ms)" % times["unique_consecutive"])
    del cases, lanes
    torch.cuda.empty_cache()
    return max_err, times


def lane_keys(lanes: torch.Tensor, L: int):
    """L key lanes ordered as the one sorted lane `lanes`: lane j is
    lanes >> 8 (L - 1 - j), so most run ends show in the last lane only,
    and lexicographic order is that of `lanes`."""
    return [lanes >> (8 * (L - 1 - j)) for j in range(L)]


def phase_lanes(rl, cases, gen, times) -> int:
    """The kernel's L = 2 and 3 instantiations against the plain version,
    bit-equal, at the drain's shape and at edge cases (a length off the
    tile, runs that end in the first lane only, an 8-byte-offset view);
    device times at the drain's shape, beside the bound of (8L + 8) B a
    row."""
    max_err = 0
    lanes, vals = cases["drain_96M"]
    n = lanes.numel()
    small = sorted_lanes(1 << 20, 5000, gen, 70_000)
    ones = torch.ones(small.numel() + 1, dtype=torch.int32, device="cuda")
    for L in (2, 3):
        edge = {
            "drain_96M": (lane_keys(lanes, L), vals),
            "n_not_tile_multiple": ([x[:2048 * 5 + 3] for x in
                                     lane_keys(small, L)], ones[:2048 * 5 + 3]),
            "first_lane_only": ([small] + [torch.zeros_like(small)] * (L - 1),
                                ones[1:]),
            "offset_view": ([torch.cat([small[:1], small])[1:]
                             for _ in range(L)], ones[1:])}
        for name, (ks, v) in edge.items():
            want = rl.run_length_sums_plain(ks, v)
            got = rl.run_length_sums(ks, v)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs()
                      .max())
            if not torch.equal(got, want):
                raise SystemExit("run_length kernel (L=%d) disagrees with its "
                                 "plain version on %s (max abs err %d)"
                                 % (L, name, err))
            max_err = max(max_err, err)
            log("kernel L=%d %-20s n=%-10d bit-equal"
                % (L, name, ks[0].numel()))
        ks = edge["drain_96M"][0]
        turn = [("plain", lambda: rl.run_length_sums_plain(ks, vals)),
                ("kernel", lambda: rl.run_length_sums(ks, vals))]
        t = {}
        for key, fn in turn + turn[::-1]:
            t.setdefault(key, []).append(cuda_ms(fn, 10))
        tm = times["drain_96M_L%d" % L] = {
            key: sum(v) / len(v) for key, v in t.items()}
        tm["bound"] = bytes_bound_ms((8 * L + 8) * n)
        log("kernel L=%d drain_96M kernel %.4f ms, plain %.4f ms, bound "
            "%.4f ms (%.0f GB/s at %d B/row); L=1 %.4f ms"
            % (L, tm["kernel"], tm["plain"], tm["bound"],
               (8 * L + 8) * n / (tm["kernel"] * 1e-3) / 1e9, 8 * L + 8,
               times["drain_96M"]["kernel"]))
        del edge, ks
    return max_err


def generate(path: str, genome_mb: str, genomes: str = "20",
             coverage: str = "20") -> int:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m",
                    "kmernator_tpu_torch.apps.generate_metagenome",
                    "--genomes", genomes, "--total-genome-mb", genome_mb,
                    "--coverage", coverage,
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


def host_engine(out: str, fq: str, extra_env, k: int = K,
                args=()) -> str:
    """The oracle: the JAX package's host engine (no mesh), run as a
    separate program. Returns its standard error."""
    proc = subprocess.run([sys.executable, "-m",
                           "kmernator_tpu.apps.filter_reads", "--out", out]
                          + FLAGS + list(args) + [str(k), fq],
                          env=env_with_root(**extra_env),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit("the host engine exited %d:\n%s"
                         % (proc.returncode, proc.stderr[-3000:]))
    return proc.stderr


def build_host_libraries() -> None:
    """Both engines build native/io_native.cpp with g++ at first use: the
    port into build/, the JAX host engine into native/. Build both here, as
    set-up, so that neither build lands in a timed FilterReads run."""
    from kmernator_tpu_torch.io import native
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise SystemExit("the port's native IO library did not build")
    log("phase 2 build: native/io_native.cpp with g++ for the port in "
        "%.2f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    fq = os.path.join(WORK, "tiny.fastq")
    rng = np.random.default_rng(1)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(fq, "wb") as f:
        for i in range(200):
            f.write(b"@w%d\n%s\n+\n%s\n" % (
                i, acgt[rng.integers(0, 4, 80)].tobytes(), b"I" * 80))
    host_engine(os.path.join(WORK, "warm"), fq, {})
    for path in outputs(os.path.join(WORK, "warm")).values():
        os.remove(path)
    os.remove(fq)
    log("phase 2 build: the host engine's first run (its g++ build of "
        "native/io_native.cpp) in %.2f s" % (time.perf_counter() - t0))


def phase_app(name: str, fq: str, n_reads: int, rl, extra_env, k: int = K,
              args=(), port_args=()):
    """Port (in-process, on the card) vs host engine (subprocess), both with
    `args` at k, the port with `port_args` too: outputs byte-identical, the
    kernel launched, the table on the card; with --variant-sigmas, the same
    "Removed N" count, and the purge timed by CUDA events around it."""
    import kmernator_tpu_torch.apps.filter_reads as app
    tables, purges = [], []

    class Recorded(app.MeshStreamingSpectrum):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tables.append(self)

        def purge_variants_mesh(self, *a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            n = super().purge_variants_mesh(*a, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            purges.append({"removed": n, "device_ms": ev[0].elapsed_time(
                ev[1]), "host_s": time.perf_counter() - t0,
                **self.purge_stats})
            return n

    port_out = os.path.join(WORK, name + "-port")
    host_out = os.path.join(WORK, name + "-host")
    saved_env = {k: os.environ.get(k) for k in extra_env}
    os.environ.update(extra_env)
    plain_class = app.MeshStreamingSpectrum
    app.MeshStreamingSpectrum = Recorded
    torch.cuda.reset_peak_memory_stats()
    try:
        rl.launches = 0
        by_lanes = dict(rl.launches_by_lanes)
        t0 = time.perf_counter()
        rc = app.run(["--device", "cuda", "--mesh", "1"] + list(port_args)
                     + ["--out", port_out] + FLAGS + list(args)
                     + [str(k), fq])
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
        launches = rl.launches
        by_lanes = {n: rl.launches_by_lanes[n] - by_lanes[n]
                    for n in by_lanes}
    finally:
        app.MeshStreamingSpectrum = plain_class
        for key, v in saved_env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
    if rc != 0:
        raise SystemExit("%s: port FilterReads exited %d" % (name, rc))
    t0 = time.perf_counter()
    host_log = host_engine(host_out, fq, extra_env, k, args)
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
    if len(tables) != 1 or tables[0].drains < 1 or any(
            x.device.type != "cuda" for x in tables[0].table_lanes):
        raise SystemExit("%s: the shard table did not live on the card"
                         % name)
    sp = tables[0]
    lanes = (k + 31) // 32
    if by_lanes[lanes] != launches or sp.L != lanes:
        raise SystemExit("%s: k=%d keys are %d lanes, but the table has %d "
                         "and the kernel ran %s" % (name, k, lanes, sp.L,
                                                    by_lanes))
    purge = None
    if "--variant-sigmas" in args:
        found = re.findall(r"Removed (\d+) kmer-variants", host_log)
        if len(purges) != 1 or len(found) != 1 or int(found[0]) != \
                purges[0]["removed"] or purges[0]["removed"] <= 0:
            raise SystemExit("%s: the port purged %s, the host engine "
                             "logged %s" % (name, purges, found))
        purge = purges[0]
        log("%s: Removed %d kmer-variants on the card and on the host; "
            "%d sources over %d rounds, %d candidate rows; purge %.1f ms "
            "of device time (CUDA events), %.2f s host wall, %.1f%% of the "
            "port's run" % (name, purge["removed"], purge["sources"],
                            purge["rounds"], purge["candidates"],
                            purge["device_ms"], purge["host_s"],
                            100 * purge["device_ms"] / 1e3 / t_port))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("%s: byte-identical (%s); k=%d (%d-lane keys), run_length launches "
        "%d; table %d rows on %s, %d drains, %d singletons purged; peak "
        "device memory %.2f GiB"
        % (name, ", ".join(want), k, lanes, launches, sp.cap,
           sp.table_lanes[0].device, sp.drains, sp.purged_singletons, peak))
    log("%s: port %.2f s = %.0f reads/s; host engine %.2f s = %.0f reads/s"
        % (name, t_port, n_reads / t_port, t_host, n_reads / t_host))
    for path in list(mine.values()) + list(want.values()):
        os.remove(path)
    return {"name": name, "k": k, "launches": launches,
            "by_lanes": by_lanes, "port_s": t_port,
            "host_s": t_host, "reads": n_reads, "peak_gib": peak,
            "purge": purge}


def phase_meraculous(name: str, fq: str, n_reads: int, rl, k: int):
    """MeraculousCounter --mesh 1, the port in process on the card, against
    the JAX package's host engine (a subprocess): mercount and mergraph
    byte-identical, 13 run-length launches at the keys' lane count, the
    device time of extension_spectrum_mesh from CUDA events around it, and
    the port's host seconds in each of the app's steps."""
    import kmernator_tpu_torch.apps.meraculous_counter as app
    calls = []
    stages = {}
    plain = {n: getattr(app, n) for n in (
        "load_reads", "pack_readset", "window_weights", "ragged_to_padded",
        "extension_spectrum_mesh", "spectrum_from_device", "dump_counts",
        "dump_graphs")}

    def host_timed(step):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return plain[step](*a, **kw)
            finally:
                stages[step] = (stages.get(step, 0.0)
                                + time.perf_counter() - t0)
        return call

    def device_timed(mesh, k_, codes, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = host_timed("extension_spectrum_mesh")(mesh, k_, codes, *a,
                                                    **kw)
        ev[1].record()
        torch.cuda.synchronize()
        calls.append({"device_ms": ev[0].elapsed_time(ev[1]),
                      "windows": codes.shape[0] * (codes.shape[1] - k_ + 1),
                      "kmers": out[1].numel(), "on": str(codes.device)})
        return out

    port_out = os.path.join(WORK, name + "-port")
    host_out = os.path.join(WORK, name + "-host")
    for step in plain:
        setattr(app, step, host_timed(step))
    app.extension_spectrum_mesh = device_timed
    torch.cuda.reset_peak_memory_stats()
    try:
        rl.launches = 0
        before = dict(rl.launches_by_lanes)
        t0 = time.perf_counter()
        rc = app.run(["--device", "cuda", "--mesh", "1", "--kmer-size",
                      str(k), "--out", port_out, fq])
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
        launches = rl.launches
        by_lanes = {n: rl.launches_by_lanes[n] - before[n] for n in before}
    finally:
        for step, fn in plain.items():
            setattr(app, step, fn)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0:
        raise SystemExit("%s: port MeraculousCounter exited %d" % (name, rc))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "kmernator_tpu.apps.meraculous_counter",
                           "--kmer-size", str(k), "--out", host_out, fq],
                          env=env_with_root(), capture_output=True, text=True)
    t_host = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit("%s: the host engine exited %d:\n%s"
                         % (name, proc.returncode, proc.stderr[-3000:]))
    mine, want = outputs(port_out), outputs(host_out)
    suffixes = {".mercount.m%d" % k, ".mergraph.m%d.D2" % k}
    if set(want) != suffixes or set(mine) != suffixes:
        raise SystemExit("%s: output files %s and %s, expected %s"
                         % (name, sorted(mine), sorted(want), suffixes))
    sizes = {}
    for suffix in sorted(suffixes):
        with open(mine[suffix], "rb") as a, open(want[suffix], "rb") as b:
            data = a.read()
            if data != b.read():
                raise SystemExit("%s: %s differs from the host engine"
                                 % (name, suffix))
        sizes[suffix] = (len(data), data.count(b"\n"))
        del data
    lanes = (k + 31) // 32
    if (len(calls) != 1 or calls[0]["on"] != "cuda:0" or launches != 13
            or by_lanes[lanes] != 13):
        raise SystemExit("%s: expected one extension_spectrum_mesh call on "
                         "the card and 13 run-length launches at %d lanes; "
                         "got %s and %s" % (name, lanes, calls, by_lanes))
    call = calls[0]
    log("%s: byte-identical (%s); k=%d (%d-lane keys), run_length launches "
        "%d %s; %d windows, %d distinct k-mers; extension_spectrum_mesh "
        "%.1f ms of device time (CUDA events); peak device memory %.2f GiB"
        % (name, ", ".join("%s %d B, %d lines" % (x, *sizes[x])
                           for x in sorted(sizes)), k, lanes, launches,
           by_lanes, call["windows"], call["kmers"], call["device_ms"], peak))
    log("%s: port %.2f s = %.0f reads/s; host engine %.2f s = %.0f reads/s"
        % (name, t_port, n_reads / t_port, t_host, n_reads / t_host))
    log("%s: the port's host seconds by step: %s; the rest %.2f s"
        % (name, ", ".join("%s %.2f" % x for x in stages.items()),
           t_port - sum(stages.values())))
    for path in list(mine.values()) + list(want.values()):
        os.remove(path)
    return {"name": name, "k": k, "launches": launches,
            "by_lanes": by_lanes, "port_s": t_port, "host_s": t_host,
            "reads": n_reads, "peak_gib": peak, "stages_s": stages, **call}


def draw_seeds(fq: str, n_reads: int, path: str, n_seeds: int,
               length: int = 100) -> None:
    """The assembler's seeds: the first `length` bases of n_seeds reads of
    the FASTQ, drawn with numpy.random.default_rng(3), as FASTA."""
    pick = np.random.default_rng(3).choice(n_reads, n_seeds, replace=False)
    slot = {int(r): i for i, r in enumerate(pick)}
    seqs = {}
    with open(fq, "rb") as f:
        for j, line in enumerate(f):
            if j % 4 == 1 and j // 4 in slot:
                seqs[slot[j // 4]] = line.strip()[:length]
    with open(path, "wb") as f:
        for i in range(n_seeds):
            f.write(b">seed%d\n%s\n" % (i, seqs[i]))


def phase_assembler(name: str, fq: str, n_reads: int, rl, ms, hi, k: int,
                    n_seeds: int, iterations: int):
    """The nucleating assembler --mesh 1, the port in process on the card,
    against the JAX package's host engine (its k-mer read index, no mesh; a
    subprocess): the contig files byte-identical, the read index built once
    on the card, one match a iteration, no kernel launched. Prints the
    index's rows and distinct keys, queries and hits a iteration, the
    device time of the index build and of each match (CUDA events), peak
    device memory, both wall times, and the port's host seconds by step."""
    import kmernator_tpu_torch.apps.nucleating_assembler as app
    from kmernator_tpu_torch.parallel import dist_match as dm
    seeds = os.path.join(WORK, name + "-seeds.fa")
    draw_seeds(fq, n_reads, seeds, n_seeds)
    stages, builds, matches = {}, [], []
    steps = {app: ("load_reads", "ArtifactFilter", "apply_artifact_filter",
                   "screen_pools", "extend_contigs", "write_fasta"),
             dm: ("pack_readset", "window_weights", "good_kmer_mask",
                  "ragged_to_padded", "mesh_match_pools")}
    plain = {(mod, n): getattr(mod, n) for mod, names in steps.items()
             for n in names}
    plain_build, plain_match = dm.build_index, dm.match

    def host_timed(mod, step):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return plain[(mod, step)](*a, **kw)
            finally:
                stages[step] = (stages.get(step, 0.0)
                                + time.perf_counter() - t0)
        return call

    def index_summary(out):
        lanes, rid = out
        distinct = 0
        if rid.numel():
            neq = lanes[0][1:] != lanes[0][:-1]
            for lane in lanes[1:]:
                neq |= lane[1:] != lane[:-1]
            distinct = 1 + int(neq.sum())
        return {"rows": rid.numel(), "distinct": distinct,
                "lanes": len(lanes), "on": str(rid.device)}

    def match_summary(ids):
        return {"queries": ids.shape[0], "hits": int((ids >= 0).sum()),
                "on": str(ids.device)}

    def device_timed(fn, record, summary, step):
        def call(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            stages[step] = stages.get(step, 0.0) + time.perf_counter() - t0
            record.append({"device_ms": ev[0].elapsed_time(ev[1]),
                           **summary(out)})
            return out
        return call

    port_out = os.path.join(WORK, name + "-port.fa")
    host_out = os.path.join(WORK, name + "-host.fa")
    for mod, step in plain:
        setattr(mod, step, host_timed(mod, step))
    dm.build_index = device_timed(plain_build, builds, index_summary,
                                  "build_index")
    dm.match = device_timed(plain_match, matches, match_summary,
                            "match (in mesh_match_pools)")
    torch.cuda.reset_peak_memory_stats()
    counters = (rl.launches, dict(ms.launches), hi.launches)
    try:
        t0 = time.perf_counter()
        rc = app.run(["--device", "cuda", "--mesh", "1", "--contig-file",
                      seeds, "--max-iterations", str(iterations), "--out",
                      port_out, str(k), fq])
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
    finally:
        for (mod, step), fn in plain.items():
            setattr(mod, step, fn)
        dm.build_index, dm.match = plain_build, plain_match
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0:
        raise SystemExit("%s: the port's assembler exited %d" % (name, rc))
    if (rl.launches, dict(ms.launches), hi.launches) != counters:
        raise SystemExit("%s: the assembler's path launched a kernel" % name)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "kmernator_tpu.apps.nucleating_assembler",
                           "--contig-file", seeds, "--max-iterations",
                           str(iterations), "--out", host_out, str(k), fq],
                          env=env_with_root(), capture_output=True, text=True)
    t_host = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit("%s: the host engine exited %d:\n%s"
                         % (name, proc.returncode, proc.stderr[-3000:]))
    mine, want = outputs(port_out), outputs(host_out)
    if "" not in want or set(mine) != set(want):
        raise SystemExit("%s: output files differ: %s vs %s"
                         % (name, sorted(mine), sorted(want)))
    for suffix in want:     # the contigs, and each iteration's checkpoint
        with open(mine[suffix], "rb") as a, open(want[suffix], "rb") as b:
            if a.read() != b.read():
                raise SystemExit("%s: %s differs from the host engine's"
                                 % (name, suffix or "the contig file"))
    with open(mine[""], "rb") as f:
        lines = f.read().split()
    lengths = [len(x) for x in lines[1::2]]
    grew = sum(b"-l" in x for x in lines[0::2])
    if len(lengths) != n_seeds or not grew:
        raise SystemExit("%s: %d contigs, %d grew" % (name, len(lengths),
                                                      grew))
    on = {x["on"] for x in builds + matches}
    if len(builds) != 1 or not matches or on != {"cuda:0"}:
        raise SystemExit("%s: expected one index build and the matches on "
                         "the card; got %s and %s" % (name, builds, matches))
    index = builds[0]
    log("%s: byte-identical (%d files; %d contigs, %d grew, longest %d "
        "bp); k=%d (%d-lane keys); index %d rows, %d distinct keys; build "
        "%.1f ms of device time (CUDA events); no kernel launched; peak "
        "device memory %.2f GiB"
        % (name, len(want), len(lengths), grew, max(lengths), k,
           index["lanes"], index["rows"], index["distinct"],
           index["device_ms"], peak))
    log("%s: matches (queries, hits, device ms): %s"
        % (name, ", ".join("%d: %d, %d, %.2f" % (i + 1, m["queries"],
                                                 m["hits"], m["device_ms"])
                           for i, m in enumerate(matches))))
    log("%s: port %.2f s; host engine %.2f s (%.2fx)"
        % (name, t_port, t_host, t_host / t_port))
    nested = stages["match (in mesh_match_pools)"]
    log("%s: the port's host seconds by step: %s; the rest %.2f s"
        % (name, ", ".join("%s %.2f" % x for x in stages.items()),
           t_port - sum(stages.values()) + nested))
    for path in [seeds] + list(mine.values()) + list(want.values()):
        os.remove(path)
    torch.cuda.empty_cache()
    return {"name": name, "k": k, "seeds": n_seeds, "iterations": iterations,
            "grew": grew, "port_s": t_port, "host_s": t_host,
            "reads": n_reads, "peak_gib": peak, "index": index,
            "matches": matches, "stages_s": stages}


def count_codes(seed: int = 11):
    """COUNT_READS reads of COUNT_LEN bases (codes 0..3) sampled from a 2 Mb
    random genome with 0.5% substitutions, so k-mers repeat: [B, L] u8."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2_000_000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - COUNT_LEN, COUNT_READS)
    codes = genome[starts[:, None] + np.arange(COUNT_LEN)[None, :]]
    err = rng.random(codes.shape) < 0.005
    codes = np.where(err, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    lengths = np.full(COUNT_READS, COUNT_LEN, np.int32)
    return codes, lengths


def count_lanes(codes, lengths):
    """The count path's masked key lanes, as count_batch forms them."""
    from kmernator_tpu_torch.ops.kmer import SENTINEL_LANE, encode_lane
    from kmernator_tpu_torch.parallel.device_spectrum import (
        extract_canonical_cols)
    cols, _, valid = extract_canonical_cols(
        torch.from_numpy(codes).cuda(), torch.from_numpy(lengths).cuda(), K)
    cols = [c.reshape(-1) for c in cols]
    valid = valid.reshape(-1)
    lanes = torch.where(valid, encode_lane(cols),
                        torch.full((), SENTINEL_LANE, dtype=torch.int64,
                                   device="cuda"))
    return cols, valid, lanes


def drain_lanes(gen: torch.Generator) -> torch.Tensor:
    """A drain's DRAIN_ROWS lanes: a sorted 64M-row table (30M distinct
    keys, then an 8M-row sentinel tail) followed by 32M staged rows in
    arrival order."""
    from kmernator_tpu_torch.ops.kmer import SENTINEL_LANE
    table = sorted_lanes(64 << 20, 30 << 20, gen, 8 << 20)
    ids = torch.randint(0, 40 << 20, (32 << 20,), generator=gen,
                        device="cuda")
    staged = ids * -0x61C8864680B583EB // 3
    staged[torch.rand(staged.shape, generator=gen, device="cuda")
           < 0.1] = SENTINEL_LANE
    return torch.cat([table, staged])


def local_split_ms(ms, lanes, block: int, reps: int):
    """Mean device ms of the tile pass and of the in-block merge levels of
    one local_sort_blocks call, from CUDA events recorded between them,
    after one warm-up left running, so that the first timed call does not
    wait on an idle card for the host."""
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
           for _ in range(reps)]
    torch.cuda.synchronize()
    ms.local_sort_blocks(lanes, block)
    for ev in evs:
        ms.local_sort_blocks(lanes, block, events=ev)
    torch.cuda.synchronize()
    return [sum(ev[i].elapsed_time(ev[i + 1]) for ev in evs) / reps
            for i in range(2)]


def level_gaps(ms, blocks, runs, levels: int, reps: int):
    """Mean device ms between CUDA events that the library's call records
    after each merge level: calls queued back to back, the host far ahead
    (each level's own time), and calls each started on an idle card (the
    same plus the time the card waits on the host)."""
    def chain(sync: bool):
        evs = [[torch.cuda.Event(enable_timing=True)
                for _ in range(levels + 1)] for _ in range(reps)]
        torch.cuda.synchronize()
        for ev in evs:
            if sync:
                torch.cuda.synchronize()
            ev[0].record()
            ms._merge_levels_cuda(blocks, runs, levels, ev[1:])
        torch.cuda.synchronize()
        return [sum(ev[i].elapsed_time(ev[i + 1]) for ev in evs) / reps
                for i in range(levels)]
    chain(False)                                  # warm-up
    return chain(False), chain(True)


def phase_sort(ms, count_path_lanes):
    """Sort kernels vs plain versions on the card, bit-equal, at the edge
    cases of tests/test_pallas_sort.py, at those of the tile design and at
    the main path's shapes; device times at the main path's shapes."""
    from kmernator_tpu_torch.ops.kmer import SENTINEL_LANE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def rand_lanes(n, lo=-(1 << 62), hi=1 << 62):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda")

    def dup_sentinels(n):
        x = rand_lanes(n, -30, 30)
        x[torch.rand(n, generator=gen, device="cuda") < 0.05] = SENTINEL_LANE
        return x

    edge = [  # (name, lanes, block, chunk)
        ("below_one_block", rand_lanes(3000), 4096, 1024),
        ("not_block_multiple", dup_sentinels(4096 * 7 - 1000), 4096, 1024),
        ("odd_runs_7_blocks", dup_sentinels(4096 * 7), 4096, 1024),
        ("bench_70_blocks_scaled", dup_sentinels(70 * 2048), 2048, 1024),
        ("all_equal", torch.full((5 * BLOCK + 17,), 42, dtype=torch.int64,
                                 device="cuda"), BLOCK, CHUNK),
        ("5pct_sentinels", dup_sentinels(3 * BLOCK), BLOCK, CHUNK),
        ("sign_bit_keys", rand_lanes(3 * BLOCK + 5, -(1 << 62), 0),
         BLOCK, CHUNK),
        ("random_full_width", torch.randint(
            -(1 << 63), (1 << 63) - 1, (9 * BLOCK + 123,), generator=gen,
            device="cuda"), BLOCK, CHUNK),
        ("one_block", rand_lanes(BLOCK), BLOCK, CHUNK),
        ("three_blocks", rand_lanes(3 * BLOCK), BLOCK, CHUNK),
        ("ragged_sentinel_pad", dup_sentinels(3 * BLOCK - 777), BLOCK,
         CHUNK),
    ]
    tile = ms._kernel_lib().kmtpu_sort_tile()
    edge += [("block_eq_tile", rand_lanes(3 * tile), tile, 1024),
             ("block_2tile", dup_sentinels(5 * 2 * tile - 333), 2 * tile,
              1024)]
    shapes = {"count_9.2M": count_path_lanes, "drain_96M": drain_lanes(gen)}
    max_err = 0.0
    for name, lanes, block, chunk in edge + [(n, x, BLOCK, CHUNK)
                                             for n, x in shapes.items()]:
        got = ms.merge_sort_lanes(lanes, block, chunk)
        want = ms.merge_sort_lanes_plain(lanes, block, chunk)
        torch.cuda.synchronize()
        if lanes.numel():
            max_err = max(max_err, float(
                (got.double() - want.double()).abs().max()))
        if not (torch.equal(got, want)
                and torch.equal(want, torch.sort(lanes).values)):
            raise SystemExit("merge sort kernels disagree with their plain "
                             "versions on %s" % name)
        padded = ms.pad_to_block(lanes, block)
        if not torch.equal(ms.local_sort_blocks(padded, block),
                           ms.local_sort_blocks_plain(padded, block)):
            raise SystemExit("local_sort_blocks disagrees with its plain "
                             "version on %s" % name)
        log("sort %-24s n=%-10d block=%-7d bit-equal"
            % (name, lanes.numel(), block))
    del edge
    times = {}
    for name, lanes in shapes.items():
        N = lanes.numel()
        padded = ms.pad_to_block(lanes, BLOCK)
        Np = padded.numel()
        blocks = ms.local_sort_blocks(padded, BLOCK)
        runs = [(i * BLOCK, BLOCK) for i in range(Np // BLOCK)]

        levels = max(len(runs) - 1, 0).bit_length()

        def all_levels():
            return ms.merge_levels(blocks, runs, CHUNK)[0]

        def all_levels_plain():
            s, r = blocks, runs
            while len(r) > 1:
                s, r = ms.merge_level_plain(s, r), ms._pair_runs(r)[1]
            return s

        if not torch.equal(all_levels(), all_levels_plain()):
            raise SystemExit("merge_levels disagrees with its plain version "
                             "on %s" % name)
        reps = 5 if name == "drain_96M" else 20
        # plain, kernel, kernel, plain: each the mean of its two turns
        t = {}
        turn = [
            ("plain", lambda: ms.merge_sort_lanes_plain(lanes), 1),
            ("kernel", lambda: ms.merge_sort_lanes(lanes), reps),
            ("local", lambda: ms.local_sort_blocks(padded, BLOCK), reps),
            ("levels", all_levels, reps),
            ("torch_sort", lambda: torch.sort(lanes).values, reps),
            ("torch_block_sort", lambda: torch.sort(
                padded.view(-1, BLOCK), dim=1).values, reps),
            ("local_plain", lambda: ms.local_sort_blocks_plain(
                padded, BLOCK), reps),
            ("levels_plain", all_levels_plain, 1)]
        for key, fn, r in turn + turn[::-1]:
            t.setdefault(key, []).append(cuda_ms(fn, r))
        times[name] = {k: sum(v) / len(v) for k, v in t.items()}
        tm = times[name]
        tm["tile_pass"], tm["inblock_levels"] = local_split_ms(
            ms, padded, BLOCK, reps)
        tm["each_level"], tm["each_level_idle_start"] = level_gaps(
            ms, blocks, runs, levels, reps)
        tm.update(n=N, padded=Np, n_levels=levels, max_abs_err=max_err)
        log("sort %-10s N=%d: local %.4f ms (plain %.4f, torch.sort of "
            "blocks %.4f), %d merge levels %.4f ms (plain %.4f), whole "
            "merge sort %.4f ms (plain %.4f), torch.sort %.4f ms; bound "
            "%.4f ms a pass at 16 B/row"
            % (name, N, tm["local"], tm["local_plain"],
               tm["torch_block_sort"], levels, tm["levels"],
               tm["levels_plain"], tm["kernel"], tm["plain"],
               tm["torch_sort"], bytes_bound_ms(16 * Np)))
        busy = sum(tm["each_level"])
        cold = sum(tm["each_level_idle_start"])
        log("sort %-10s between the events after each level, calls queued "
            "back to back %s = %.4f ms; each call started on an idle card "
            "%s = %.4f ms: the card waits %.4f ms on the host in a call"
            % (name, ["%.4f" % x for x in tm["each_level"]], busy,
               ["%.4f" % x for x in tm["each_level_idle_start"]], cold,
               cold - busy))
        log("sort %-10s local sort timed apart: tile pass (tile %d) %.4f "
            "ms, %d in-block levels %.4f ms"
            % (name, tile, tm["tile_pass"], (BLOCK // tile).bit_length() - 1,
               tm["inblock_levels"]))
    del shapes
    torch.cuda.empty_cache()
    return times


def no_host_sync(ms, rl, lanes) -> None:
    """merge_sort_lanes and run_length_sums on the count path's lanes under
    torch.cuda.set_sync_debug_mode("error"): any call that makes the host
    wait for the card raises."""
    ones = torch.ones(lanes.numel(), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = ms.merge_sort_lanes(lanes)
        out = rl.run_length_sums(s, ones)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not (torch.equal(s, torch.sort(lanes).values)
            and torch.equal(out, rl.run_length_sums_plain(s, ones))):
        raise SystemExit("the sync-debug run disagrees with the plain "
                         "versions")
    log("sync check: merge_sort_lanes and run_length_sums on %d lanes ran "
        "under torch.cuda.set_sync_debug_mode('error') without a host sync"
        % lanes.numel())


def phase_count(ms, rl, smi: str):
    """count_batch on the count path, merge-sort route and torch.sort route:
    bit-equal to each other and to a numpy oracle; launches read around
    each route."""
    from kmernator_tpu_torch.parallel.device_spectrum import count_batch
    codes, lengths = count_codes()
    cols, valid, _ = count_lanes(codes, lengths)
    N = valid.numel()
    if N != COUNT_ROWS:
        raise SystemExit("count path has %d windows, expected %d"
                         % (N, COUNT_ROWS))
    saved = os.environ.get("KMTPU_MERGE_SORT")
    out = {}
    try:
        for route, env in (("merge_sort", "1"), ("torch_sort", None)):
            if env is None:
                os.environ.pop("KMTPU_MERGE_SORT", None)
            else:
                os.environ["KMTPU_MERGE_SORT"] = env
            ms.launches.update(local_sort_blocks=0, merge_level=0)
            rl.launches = 0
            res = count_batch(cols, valid, min_count=1)
            torch.cuda.synchronize()
            counts = (dict(ms.launches), rl.launches)
            t = cuda_ms(lambda: count_batch(cols, valid, min_count=1), 10)
            out[route] = (res, counts, t)
    finally:
        if saved is None:
            os.environ.pop("KMTPU_MERGE_SORT", None)
        else:
            os.environ["KMTPU_MERGE_SORT"] = saved
    (mres, (m_ms, m_rl), m_t) = out["merge_sort"]
    (tres, (t_ms, t_rl), t_t) = out["torch_sort"]
    if not all(torch.equal(a, b) for a, b in zip(mres, tres)):
        raise SystemExit("count_batch: the merge-sort route disagrees with "
                         "the torch.sort route")
    # one local sort (its in-block levels inside it), then one merge
    # level a doubling of the run across the 70 blocks
    levels = (-(-N // BLOCK) - 1).bit_length()
    if m_ms != {"local_sort_blocks": 1, "merge_level": levels} or m_rl <= 0:
        raise SystemExit("count_batch under KMTPU_MERGE_SORT=1 launched %s "
                         "and run_length %d, expected 1 local sort, %d "
                         "merge levels and the run-length kernel"
                         % (m_ms, m_rl, levels))
    if max(t_ms.values()) != 0 or t_rl <= 0:
        raise SystemExit("count_batch without KMTPU_MERGE_SORT launched %s, "
                         "run_length %d" % (t_ms, t_rl))
    # numpy oracle on the host
    v = valid.cpu().numpy()
    keys = ((cols[0].cpu().numpy().astype(np.uint64) << np.uint64(32))
            | cols[1].cpu().numpy().astype(np.uint64))[v]
    u, c = np.unique(keys, return_counts=True)
    out_keys, table_counts, n_unique = (x.cpu().numpy() for x in mres)
    kept = table_counts > 0
    got = (out_keys[kept, 0].astype(np.uint64) << np.uint64(32)) \
        | out_keys[kept, 1].astype(np.uint64)
    if not (int(n_unique) == u.size and np.array_equal(got, u)
            and np.array_equal(table_counts[kept], c)):
        raise SystemExit("count_batch disagrees with the numpy oracle")
    log("count %d windows (%d reads x %d bp, k=%d): %d distinct keys, "
        "bit-equal on both routes and to np.unique; launches merge-sort "
        "route %s + run_length %d, torch.sort route %s + run_length %d"
        % (N, COUNT_READS, COUNT_LEN, K, u.size, m_ms, m_rl, t_ms, t_rl))
    log("count merge-sort route %.4f ms = %.4g windows/s; torch.sort route "
        "%.4f ms = %.4g windows/s [%s]"
        % (m_t, N / (m_t * 1e-3), t_t, N / (t_t * 1e-3), smi))
    return {"merge_sort": m_ms, "run_length": m_rl + t_rl,
            "merge_ms": m_t, "torch_ms": t_t}


def hash_bound_ms(n: int, cap: int) -> Tuple[float, float]:
    """(bound, sector bound) of one insert of n int64 keys into cap slots
    returned as int64 keys and counts. The bound counts each input byte
    read once and each output byte written once: 8 B a key, 16 B a slot,
    8 B n_unique. The sector bound adds what any table layout must move
    at a data-dependent place: one 32-byte sector a key, the least an
    insert into a table beyond the 50 MB L2 can touch."""
    nbytes = 8 * n + 16 * cap + 8
    return bytes_bound_ms(nbytes), bytes_bound_ms(nbytes + 32 * n)


def hash_split_ms(hi, keys, cap: int, reps: int):
    """Mean device ms of the clear, insert and unpack launches of one
    hash_insert, from CUDA events recorded between them, after one warm-up
    left running (as in local_split_ms)."""
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
           for _ in range(reps)]
    torch.cuda.synchronize()
    hi.hash_insert_launch(keys, cap)
    for ev in evs:
        hi.hash_insert_launch(keys, cap, events=ev)
    torch.cuda.synchronize()
    return [sum(ev[i].elapsed_time(ev[i + 1]) for ev in evs) / reps
            for i in range(3)]


def phase_hash(hi, smi: str):
    """The hash-insert kernel vs its plain version on the card through the
    order-free invariants; the entry point's run, with the launches read
    around it; the real shape against np.unique; device times."""
    from kmernator_tpu_torch.parallel.device_spectrum import (
        count_batch, extract_canonical_cols)
    max_err = 0
    for name, (keys, cap) in hi.edge_cases().items():
        k = torch.from_numpy(keys)
        want = hi.hash_insert_plain(k, cap)
        got = hi.hash_insert(k.cuda(), cap)
        torch.cuda.synchronize()
        hi.check_invariants(keys, cap, *want)
        max_err = max(max_err, hi.check_invariants(keys, cap, *got))
        if not (torch.equal(got[2].cpu(), want[2]) and torch.equal(
                got[0].cpu() != hi.EMPTY, want[0] != hi.EMPTY)):
            raise SystemExit("hash_insert disagrees with its plain version "
                             "on %s" % name)
        log("hash %-16s n=%-6d cap=%-6d n_unique %d, invariants hold"
            % (name, keys.size, cap, int(got[2][0])))
    for name, (keys, cap) in hi.large_cases().items():
        got = hi.hash_insert(torch.from_numpy(keys).cuda(), cap)
        max_err = max(max_err, hi.check_invariants(keys, cap, *got))
        log("hash %-16s n=%-7d cap=%-7d n_unique %d, invariants hold "
            "against np.unique" % (name, keys.size, cap, int(got[2][0])))
        del got
    try:
        hi.hash_insert(torch.arange(10, device="cuda"), 8)
    except ValueError as e:
        log("hash overflow raises: %s" % e)
    else:
        raise SystemExit("hash_insert did not raise on an overflowing table")

    # the slice's main path: the bench entry point, counts read around it
    hi.launches = 0
    bench = hi.main(["--device", "cuda"])
    launches = hi.launches
    if launches != 1 + 2 * 50:
        raise SystemExit("the hash bench launched the hash kernel %d times, "
                         "expected 101" % launches)

    t = {}
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 16, HASH_N)).cuda()
    max_err = max(max_err, hi.check_invariants(
        x, HASH_CAP, *hi.hash_insert(x, HASH_CAP)))
    # plain, kernel, kernel, plain; the library call around them
    for key, fn, reps in (
            ("plain", lambda: hi.hash_insert_plain(x, HASH_CAP), 3),
            ("library", lambda: torch.unique(x, return_counts=True), 200),
            ("kernel", lambda: hi.hash_insert_launch(x, HASH_CAP), 200),
            ("kernel", lambda: hi.hash_insert_launch(x, HASH_CAP), 200),
            ("library", lambda: torch.unique(x, return_counts=True), 200),
            ("plain", lambda: hi.hash_insert_plain(x, HASH_CAP), 3)):
        t.setdefault(key, []).append(cuda_ms(fn, reps))
    small = {k: sum(v) / len(v) for k, v in t.items()}
    small["split"] = hash_split_ms(hi, x, HASH_CAP, 200)
    log("hash_1024: kernel %.4f ms (clear %.4f, insert %.4f, unpack %.4f "
        "timed apart), plain %.4f ms, torch.unique %.4f ms; bound %.6f ms "
        "[%s]" % ((small["kernel"],) + tuple(small["split"])
                  + (small["plain"], small["library"],
                     hash_bound_ms(HASH_N, HASH_CAP)[0], smi)))

    codes, lengths = count_codes()
    cols, _, valid = extract_canonical_cols(
        torch.from_numpy(codes).cuda(), torch.from_numpy(lengths).cuda(), K16)
    keys = cols[0].reshape(-1).contiguous()
    N = keys.numel()
    if N != COUNT_READS * (COUNT_LEN - K16 + 1) or not bool(valid.all()):
        raise SystemExit("k=16 keys: %d windows, expected every one of %d "
                         "valid" % (N, COUNT_READS * (COUNT_LEN - K16 + 1)))
    if int(keys.max()) >= hi.EMPTY:
        raise SystemExit("a canonical 16-mer equals the empty sentinel")
    keys_np = keys.cpu().numpy()
    got = hi.hash_insert(keys, K16_CAP)
    max_err = max(max_err, hi.check_invariants(keys_np, K16_CAP, *got))
    distinct = int(got[2][0])
    cap_hl = 1 << (-(-distinct * 10 // 9) - 1).bit_length()
    got = hi.hash_insert(keys, cap_hl)
    max_err = max(max_err, hi.check_invariants(keys_np, cap_hl, *got))
    del got
    ones = torch.ones(N, dtype=torch.bool, device="cuda")
    cb = count_batch([keys], ones, min_count=1)
    uq = torch.unique(keys, return_counts=True)
    if int(cb[2]) != distinct or uq[0].numel() != distinct:
        raise SystemExit("count_batch (%d) or torch.unique (%d) disagrees "
                         "with the hash's %d distinct 16-mers"
                         % (int(cb[2]), uq[0].numel(), distinct))
    del cb, uq
    t = {}
    # library, kernel, kernel, library; count_batch and the high load after
    for key, fn, reps in (
            ("library", lambda: torch.unique(keys, return_counts=True), 10),
            ("kernel", lambda: hi.hash_insert_launch(keys, K16_CAP), 10),
            ("kernel", lambda: hi.hash_insert_launch(keys, K16_CAP), 10),
            ("library", lambda: torch.unique(keys, return_counts=True), 10),
            ("count_batch", lambda: count_batch([keys], ones, 1), 10),
            ("high_load", lambda: hi.hash_insert_launch(keys, cap_hl), 10)):
        t.setdefault(key, []).append(cuda_ms(fn, reps))
    real = {k: sum(v) / len(v) for k, v in t.items()}
    real.update(n=N, distinct=distinct, cap_hl=cap_hl,
                split=hash_split_ms(hi, keys, K16_CAP, 10),
                high_load_split=hash_split_ms(hi, keys, cap_hl, 10))
    bound, sector = hash_bound_ms(N, K16_CAP)
    log("hash_11.1M: %d keys, %d distinct, invariants hold at cap 2^24 and "
        "at cap %d (load %.3f); kernel %.4f ms (bound %.4f, sector bound "
        "%.4f), at load %.3f %.4f ms; torch.unique %.4f ms; count_batch "
        "k=16 (torch.sort route) %.4f ms [%s]"
        % (N, distinct, cap_hl, distinct / cap_hl, real["kernel"], bound,
           sector, distinct / cap_hl, real["high_load"], real["library"],
           real["count_batch"], smi))
    for what, cap, split in (("cap 2^24", K16_CAP, real["split"]),
                             ("cap %d" % cap_hl, cap_hl,
                              real["high_load_split"])):
        log("hash_11.1M %s timed apart: clear %.4f ms, insert %.4f ms, "
            "unpack %.4f ms (sector bound %.4f ms)"
            % ((what,) + tuple(split) + (hash_bound_ms(N, cap)[1],)))
    del keys, ones
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, "small": small,
            "real": real, "bench": bench}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kmernator_tpu_torch.kernels import build
    from kmernator_tpu_torch.parallel import hash_insert as hi
    from kmernator_tpu_torch.parallel import merge_sort as ms
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
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.build, SOURCES))   # one nvcc a source, together
    for name in SOURCES:
        build.load(name)
        log("phase 2 build: csrc/%s.cu with nvcc %s in %.2f s (%s)"
            % (name, " ".join(build.ARCH_FLAGS), build.build_seconds[name],
               os.path.relpath(build.library_path(name), ROOT)))
    log("phase 2 build: %.2f s in all" % (time.perf_counter() - t0))
    build_host_libraries()

    t0 = time.perf_counter()
    codes, lengths = count_codes()
    count_path_lanes = count_lanes(codes, lengths)[2]
    del codes, lengths
    max_err, times = phase_kernel(rl, torch.sort(count_path_lanes).values)
    log("phase 3 kernel vs plain: bit-equal [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    fq = os.path.join(WORK, "meta256.fastq")
    n = generate(fq, "6")
    runs = [phase_app("streaming", fq, n, rl, {})]
    fq256, n256 = fq, n
    log("phase 4 streaming slice ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    fq32 = os.path.join(WORK, "meta32.fastq")
    n32 = generate(fq32, "0.75")
    in_memory = {"KMTPU_AUTO_STREAM_MB": "64"}
    runs.append(phase_app("in-memory", fq32, n32, rl, in_memory))
    log("phase 5 in-memory slice ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    sort_times = phase_sort(ms, count_path_lanes)
    no_host_sync(ms, rl, count_path_lanes)
    del count_path_lanes
    log("phase 6 sort kernels vs plain: bit-equal [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    count = phase_count(ms, rl, smi)
    launches = sum(r["launches"] for r in runs) + count["run_length"]
    log("phase 7 count path ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    hs = phase_hash(hi, smi)
    log("phase 8 hash insert: invariants hold, %d launches in the bench "
        "[%.1f s]" % (hs["launches"], time.perf_counter() - t0))

    t0 = time.perf_counter()
    fq = os.path.join(WORK, "purge42.fastq")
    n = generate(fq, "0.1", genomes="4", coverage="200")
    purge_run = phase_app("purge", fq, n, rl, in_memory, args=[
        "--variant-sigmas", "2", "--min-variant-kmer-depth", "20",
        "--verbose", "1"])
    os.remove(fq)
    log("phase 9 on-device variant purge ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    wide = [phase_app("wide-k33", fq32, n32, rl, in_memory, k=33),
            phase_app("wide-k63-streaming", fq32, n32, rl, in_memory, k=63,
                      port_args=["--streaming"]),
            phase_app("wide-k95", fq32, n32, rl, in_memory, k=95)]
    log("phase 10 k > 32 ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    mer = [phase_meraculous("meraculous-k21", fq256, n256, rl, 21),
           phase_meraculous("meraculous-k51", fq32, n32, rl, 51)]
    log("phase 11 MeraculousCounter --mesh 1 ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    asm = [phase_assembler("asm-k31", fq256, n256, rl, ms, hi, 31, 50,
                           ASM_ITERATIONS),
           phase_assembler("asm-k45", fq32, n32, rl, ms, hi, 45, 25,
                           ASM_ITERATIONS)]
    os.remove(fq256)
    os.remove(fq32)
    log("phase 12 nucleating assembler --mesh 1 ok [%.1f s]"
        % (time.perf_counter() - t0))
    runs += [purge_run] + wide + mer
    launches += sum(r["launches"] for r in [purge_run] + wide + mer)
    by_lanes = {L: sum(r["by_lanes"][L] for r in runs) for L in (1, 2, 3)}
    by_lanes[1] += count["run_length"]
    if min(by_lanes.values()) <= 0:
        raise SystemExit("the main path did not launch the run-length "
                         "kernel at every lane count: %s" % by_lanes)

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "kmernator_tpu"))
    if loaded:
        raise SystemExit("jax or the JAX package was imported: %s" % loaded)

    rt = times["drain_96M"]
    c = sort_times["count_9.2M"]
    d = sort_times["drain_96M"]
    r = hs["real"]
    log("earlier designs (recorded, not run here): %s"
        % json.dumps(PREV_MS))
    log("FilterReads and MeraculousCounter runs: %s" % json.dumps({
        r["name"]: {key: v for key, v in r.items() if key != "name"}
        for r in runs}))
    log("assembler runs (no kernel launched): %s" % json.dumps({
        r["name"]: {key: v for key, v in r.items() if key != "name"}
        for r in asm}))
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "run_length_sums", "route": "cuda",
        "source": "kmernator_tpu_torch/csrc/run_length.cu",
        "replaces": "kmernator_tpu/parallel/pallas_count.py:159",
        "launches": launches, "max_abs_err": max_err,
        "ms": rt["kernel"], "plain_ms": rt["plain"],
        "bound_ms": bytes_bound_ms(16 * DRAIN_ROWS), "bound_by": "bytes",
        "library_ms": None,
        "shape": "drain %d rows" % DRAIN_ROWS,
        "tile": rl._kernel_lib().kmtpu_run_length_tile(),
        "unique_consecutive_ms": times["unique_consecutive"],
        "count_ms": times["count_9.2M"]["kernel"],
        "count_plain_ms": times["count_9.2M"]["plain"],
        "count_bound_ms": bytes_bound_ms(16 * COUNT_ROWS),
        "batch_ms": times["count_batch_2048x120"]["kernel"],
        "batch_plain_ms": times["count_batch_2048x120"]["plain"],
        "batch_bound_ms": bytes_bound_ms(16 * BATCH_ROWS),
        "launches_by_lanes": by_lanes,
        "lanes2_ms": times["drain_96M_L2"]["kernel"],
        "lanes2_plain_ms": times["drain_96M_L2"]["plain"],
        "lanes2_bound_ms": times["drain_96M_L2"]["bound"],
        "lanes3_ms": times["drain_96M_L3"]["kernel"],
        "lanes3_plain_ms": times["drain_96M_L3"]["plain"],
        "lanes3_bound_ms": times["drain_96M_L3"]["bound"]}, {
        "name": "local_sort_blocks", "route": "cuda",
        "source": "kmernator_tpu_torch/csrc/merge_sort.cu",
        "replaces": "kmernator_tpu/parallel/pallas_sort.py:360",
        "launches": count["merge_sort"]["local_sort_blocks"],
        "max_abs_err": c["max_abs_err"],
        "ms": c["local"], "plain_ms": c["local_plain"],
        "bound_ms": bytes_bound_ms(16 * c["padded"]), "bound_by": "bytes",
        "library_ms": c["torch_block_sort"],
        "torch_ms": c["torch_block_sort"],
        "shape": "count_9.2M: %d rows, block %d" % (c["padded"], BLOCK),
        "tile": ms._kernel_lib().kmtpu_sort_tile(),
        "tile_pass_ms": c["tile_pass"],
        "inblock_levels_ms": c["inblock_levels"],
        "drain_ms": d["local"], "drain_plain_ms": d["local_plain"],
        "drain_tile_pass_ms": d["tile_pass"],
        "drain_inblock_levels_ms": d["inblock_levels"],
        "drain_bound_ms": bytes_bound_ms(16 * d["padded"]),
        "drain_library_ms": d["torch_block_sort"]}, {
        "name": "merge_level", "route": "cuda",
        "source": "kmernator_tpu_torch/csrc/merge_sort.cu",
        "replaces": "kmernator_tpu/parallel/pallas_sort.py:203",
        "launches": count["merge_sort"]["merge_level"],
        "max_abs_err": c["max_abs_err"],
        "ms": c["levels"], "plain_ms": c["levels_plain"],
        "bound_ms": bytes_bound_ms(16 * c["padded"] * c["n_levels"]),
        "bound_by": "bytes", "library_ms": None,
        "shape": "count_9.2M: all %d levels, chunk %d" % (c["n_levels"],
                                                           CHUNK),
        "merge_sort_ms": c["kernel"], "merge_sort_plain_ms": c["plain"],
        "merge_sort_bound_ms": bytes_bound_ms(16 * c["n"]),
        "torch_sort_ms": c["torch_sort"],
        "tile": ms._kernel_lib().kmtpu_merge_tile(),
        "each_level_ms": c["each_level"],
        "each_level_idle_start_ms": c["each_level_idle_start"],
        "drain_ms": d["levels"], "drain_levels": d["n_levels"],
        "drain_bound_ms": bytes_bound_ms(16 * d["padded"] * d["n_levels"]),
        "drain_each_level_ms": d["each_level"],
        "drain_each_level_idle_start_ms": d["each_level_idle_start"],
        "drain_merge_sort_ms": d["kernel"],
        "drain_torch_sort_ms": d["torch_sort"],
        "count_batch_merge_ms": count["merge_ms"],
        "count_batch_torch_ms": count["torch_ms"]}, {
        "name": "hash_insert", "route": "cuda",
        "source": "kmernator_tpu_torch/csrc/hash_insert.cu",
        "replaces": "kmernator_tpu/parallel/pallas_hash.py:87",
        "launches": hs["launches"], "max_abs_err": hs["max_abs_err"],
        "ms": hs["small"]["kernel"], "plain_ms": hs["small"]["plain"],
        "bound_ms": hash_bound_ms(HASH_N, HASH_CAP)[0], "bound_by": "bytes",
        "library_ms": hs["small"]["library"],
        "library": "torch.unique(keys, return_counts=True): the same "
                   "(key, count) multiset and n_unique, but no table",
        "shape": "hash_1024: %d keys in [0, 2^16), cap %d (the bench)"
                 % (HASH_N, HASH_CAP),
        "clear_ms": hs["small"]["split"][0],
        "insert_ms": hs["small"]["split"][1],
        "unpack_ms": hs["small"]["split"][2],
        "bench_mkeys_per_s": hs["bench"]["mkeys_per_s"],
        "k16_shape": "hash_11.1M: %d canonical 16-mers, %d distinct, cap "
                     "2^24" % (r["n"], r["distinct"]),
        "k16_ms": r["kernel"], "k16_clear_ms": r["split"][0],
        "k16_insert_ms": r["split"][1], "k16_unpack_ms": r["split"][2],
        "k16_bound_ms": hash_bound_ms(r["n"], K16_CAP)[0],
        "k16_sector_bound_ms": hash_bound_ms(r["n"], K16_CAP)[1],
        "k16_library_ms": r["library"],
        "count_batch_k16_ms": r["count_batch"],
        "k16_high_load_cap": r["cap_hl"], "k16_high_load_ms": r["high_load"],
        "k16_high_load_clear_ms": r["high_load_split"][0],
        "k16_high_load_insert_ms": r["high_load_split"][1],
        "k16_high_load_unpack_ms": r["high_load_split"][2],
        "k16_high_load_bound_ms": hash_bound_ms(r["n"], r["cap_hl"])[0],
        "k16_high_load_sector_bound_ms": hash_bound_ms(r["n"],
                                                       r["cap_hl"])[1]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
