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
     (`kmernator_tpu_torch.apps.meraculous_counter.run`): phase 5's input at
     k=21 (one-lane keys) and at k=51 (two lanes), the mercount
     and mergraph files byte-identical to the JAX package's MeraculousCounter
     host engine (`python -m kmernator_tpu.apps.meraculous_counter`, no
     mesh), 13 run-length launches a run, one format_mers select launch
     and one write launch a slab of its plan, the device time of
     `extension_spectrum_mesh` (CUDA events) and peak device memory;
 12. the nucleating assembler `--mesh 1` through its CLI entry point
     (`kmernator_tpu_torch.apps.nucleating_assembler.run`), whose read
     index is built and queried on the card (parallel/dist_match.py; its
     input from one prepare_reads launch, no other kernel of csrc/): phase
     5's input at k=31 with 50 seeds and at k=45
     (two-lane keys) with 25, each seed the first 100 bp of a read
     drawn with numpy, 5 iterations; the contigs byte-identical to the JAX
     package's host engine (`python -m
     kmernator_tpu.apps.nucleating_assembler`, its k-mer read index), the
     index's rows, each match's queries and hits, the device time of the
     build and of each match (CUDA events), peak device memory and the
     port's host seconds by step;
 13. FilterReads `--streaming --distributed 127.0.0.1:<port> --nprocs 1`
     (the one-process distributed engine: a table that starts at the
     estimate / 6 and grows 4x on pressure, pass 2 looked up on the card):
     phase 5's input at k=31 and at k=63 (two-lane keys), each
     byte-identical to that input's host-engine outputs from phase 5 or
     10, the table grown at least once with no singleton purged, one
     run-length launch a drain; the capacities, drains, pass 1 and pass 2
     wall time, the lookups' device time (CUDA events), peak device memory,
     the port's host seconds by step and reads/s beside the host engine
     and the `--mesh 1` run of phase 5 or 10.
 14. TnfDistance through its CLI entry point
     (`kmernator_tpu_torch.apps.tnf_distance.run`) on 4,096 contigs of
     2,000-10,000 bp from 16 seeded genomes of GC 30-70%: at --device cuda
     (its distance matrix a float32 torch.matmul on the card, TF32 off) and
     --device cpu, and the JAX app as a separate program (the oracle kind,
     float32 jnp.matmul or the JAX app's float64 numpy fallback where jax
     does not import, is printed): the vectors table byte-identical, every
     distance within 4.0e-3 of the JAX app's and within 1.0e-4 pairwise
     between the three (a TF32 product of the same vectors must fall past
     1.0e-4), the clusters the JAX ones
     but for pairs within that bound of the threshold; each engine's wall
     time, the matmul's device time (CUDA events) and peak device memory;
 15. BamSort and FilterAndSortSam (`kmernator_tpu_torch.apps.bam_sort.run`,
     `.filter_and_sort_sam.run`) on 1,000,000 seeded records of 150 bp on
     20 references: the host engine byte-identical to the JAX apps run as
     separate programs, with BAM and SAM output, both unmapped outputs
     and --keep-unmapped-paired-read 1 and 0, and `--exclude-flags 4
     --min-mapq 20`; `--distributed 127.0.0.1:<port> --nprocs 2` (two gloo
     processes) with the one-process header and record stream;
 16. the small apps on phase 5's input: fastq2fasta (plain, --split-pairs
     1, --write-qual 1), randomly_sample, split_sequence (--num-files 4,
     every --file-num) and compare_spectrums (against itself and against
     a second input, the generator's at seed 8),
     each byte-identical to the JAX app run as a
     separate program; estimate_size on the port alone (its JAX app
     imports jax). Phases 14-16 launch no kernel of csrc/.
 17. `--mesh N` on one card (every shard on it; parallel/mesh.py's owner
     hash, bucket scatter and exchange): FilterReads in-memory `--mesh 2`
     and `--mesh 4` on phase 5's input and `--mesh 2` at k=63,
     `--streaming --mesh 2` on phase 5's, and the purge cell at `--mesh
     2`, each byte-identical to the host-engine outputs of phases 5, 9
     and 10 (the same "Removed N") with no singleton purged; `--streaming
     --mesh 4 --streaming-parts 50000` on phase 5's input, which purges
     singletons under capacity pressure,
     byte-identical to the JAX app at `--mesh 4 --jax-platform cpu` on
     four forced CPU devices (a separate program) with the same count
     purged; MeraculousCounter `--mesh 2` at k=21 and `--mesh 4` at k=51
     on phase 5's input against phase 11's host outputs (13
     run-length launches a shard); the assembler `--mesh 2` at k=45 with
     phase 12's seeds against its host output. Each run prints its wall
     time, the device time of its shard exchange and of its shards'
     drains or counting (CUDA events), run-length launches, overflow
     retries and peak device memory.
 18. `--nprocs 2` on one card: FilterReads across two processes, both
     ranks on cuda:0, over gloo (the shard exchange's planes cross the
     host: parallel/multihost.py `all_to_all_planes`). Each rank is a
     child of this script (`--rank-child`, with phase 17's CUDA-event
     instruments) under a time limit that, with any rank's failure, ends
     both and fails the script. `--streaming --distributed` and the
     in-memory `--nprocs 2` on phase 5's input (with
     `--gathered-logs 1`: rank 0 prints both ranks' lines, rank 1 none)
     against their host-engine outputs, the purge cell against phase 9's
     (the same "Removed N"), and `--streaming --distributed
     --streaming-parts 50000` on phase 5's input against the JAX app at
     two processes on the CPU (a separate program, `JAX_PLATFORMS=cpu`),
     with the same count of singletons purged. Per rank: wall time, the
     exchange's calls and overflow retries and its time split into device
     work, D2H copy, gloo and H2D copy, drains and run-length launches by
     lane count, peak device memory; both ranks' launches join the
     kernels line.
 19. the device library and the entry points (`phase_library`), each step
     driven on the card with the run-length counts zeroed just before it:
     (a) `kmernator_tpu_torch.entry.entry()`'s step bit-equal to
     `entry(device="cpu")`; (b) `spectrum_step` on phase 7's 131,072
     reads x 100 bp with seeded phred 2-40 log2-probabilities (0.5% of the
     bases at -1e30): its counts against a np.unique oracle under its own
     good mask, that mask against the CPU's outside `window_good_bound` of
     the threshold, `compact_spectrum` of its sorted state against
     np.unique and `lookup_join` of all 9,175,040 windows against an
     np.searchsorted oracle, its device time beside phase 7's count_batch;
     (c) `pipeline.StreamingSpectrum` through `build_streaming` on phase
     4's FASTQ (`FastqBatchStream(pack2=True)`) at 2^26 rows, bit-equal to
     a `MeshStreamingSpectrum(make_mesh(1))` fed the same batches and good
     masks, its drains, launches, device time, wall, windows/s and peak
     memory; and a purge case on phase 5's input at 2^20 rows bit-equal
     to the CPU run of the same stream (the same singletons purged); (d)
     `distributed_spectrum_fn`, `distributed_count_fn` and
     `distributed_extension_fn` at D = 1, 2 and 4 on (b)'s batch: counts
     bit-equal to `spectrum_step`'s and D = 1's, no overflow, equal shard
     totals and extension tables, device times; (e)
     `entry.dryrun_multichip(n)` for n = 1, 2 and 4, with its asserts and
     FilterReads byte checks, and its wall. Its launches join the kernels
     line.
 20. k > 96 (`phase_wide_k`), on phase 5's input: FilterReads in-memory
     `--mesh 1` at k=97 (W = 7 words, L = 4 lanes: an odd last word) and
     k=145 (L = 5), `--streaming --mesh 2` at k=127, `--streaming
     --distributed --nprocs 1` at k=97 (against the k=97 oracle's
     outputs), MeraculousCounter `--mesh 2` at k=101 and the assembler
     `--mesh 1` at k=99 (25 of phase 12's seeds, `--minimum-coverage 2`),
     each byte-identical to the JAX package's host engine at the same k,
     run as a separate program on the CPU beside the port's runs; and
     library-k127: `spectrum_step` and `count_batch` on 32,768 seeded
     reads of 150 bp at k=127 (786,432 windows) bit-equal to a np.unique
     oracle, `distributed_count_fn` at D = 2 bit-equal to D = 1. Each run
     prints its wall time, its run-length launches by lane count, its
     drains, the device time of its drains and lookups (CUDA events) and
     its peak device memory. Its launches join the kernels line.
 21. the prepare_reads kernel (`phase_prepare`) against its plain version,
     the host's NumPy steps, bit for bit (the largest difference over its
     outputs measured), one launch a call, at the benchmark's shapes:
     MeraculousCounter's one call on 200,000 seeded reads of 150 bp at
     k=21 (extension masks, min quality 2) and one of FilterReads'
     streamed chunks, 52,000 reads at k=31 (L = 160, min quality 3),
     reads of phred 2-41 with one base in a thousand N; the
     kernel alone (CUDA events, its inputs on the card) beside its byte
     bound, the whole call (the copies to the card and the kernel, and
     for the chunk the copies back) and the host steps (host clock). Its
     launches on the main path are counted run by run in phases 4-20: each
     FilterReads run launches it once a streamed chunk (once a run on the
     in-memory engine), and each MeraculousCounter and assembler run
     once.
 22. the format_mers kernels (`phase_format_mers`) at the benchmark's
     table: meraculous-k21.meta20x's input (kbench/genmeta.py at a fixed
     seed) counted on the card as MeraculousCounter --mesh 1 counts it,
     its two files written by the kernels in the default slabs,
     byte-identical to the host path's (the table to the host, the purge
     of depth 2, dump_counts and dump_graphs), one select launch and one
     write launch a slab; select and the write launches alone (CUDA
     events) beside their byte bounds, the whole call (the kernels, the
     pinned copies and the file writes) and the host path (host clock).
Phase 3 also holds the kernel's two- and three-lane instances (k <= 64,
k <= 96) and its run-time lane loop at four, five and ten lanes (k <= 128,
160, 320) bit-equal to their plain versions at edge cases, and at the
drain's shape at L = 2-5, where it times them beside the one-lane kernel.

Inputs come from the port's own generator and from seeded numpy. Fails
(non-zero exit, no result line) without a CUDA device, outside a
checkout, or when any phase fails, and at its end if any module of jax or
of the JAX package is loaded in this process.

Output: one line per phase, the card's `name, power.limit`, a JSON line of
per-kernel results, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor
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
SOURCES = ("run_length", "merge_sort", "hash_insert", "prepare_reads",
           "format_mers")
HASH_N, HASH_CAP = 1 << 10, 1 << 12   # the JAX hash bench's shape
ASM_ITERATIONS = 5
# phase 17's capacity-pressure run on phase 5's input: a shard capacity
# far under its distinct keys
PRESSURE_ROWS = 50_000
# phase 18: two ranks of one job on the one card, each a child of this
# script; a job that passes its time limit fails the phase
NPROCS, RANK_TIMEOUT = 2, 600
K16, K16_CAP = 16, 1 << 24           # one 32-bit word a key; 2^24 slots
# phase 3: the lane counts held to the plain version (L = 2, 3: the
# unrolled instances; 4 and up: the run-time lane loop) and those timed at
# the drain's shape
LANE_COUNTS, TIMED_LANES = (2, 3, 4, 5, 10), (2, 3, 4, 5)
# phase 19: StreamingSpectrum's rows on phase 4's input (past its distinct
# keys: no purge) and in the purge case on phase 5's (under them)
STREAM_ROWS, PURGE_ROWS = 1 << 26, 1 << 20
# phase 21: the benchmark's shapes of the prepare_reads kernel, (name,
# reads, read length, k, padded length, min quality, min k-mer quality,
# extension masks)
PREP_SHAPES = (("meraculous_200k", 200_000, 150, 21, 150, 2, 0.0, True),
               ("filter_chunk", 52_000, 150, 31, 160, 3, 0.10, False))
FP32_FLOPS = 67e12                   # H100 SXM data sheet, no tensor cores
TNF_CONTIGS, TNF_GENOMES, TNF_GENOME_BP = 4096, 16, 1_600_000
TNF_BOUND = 4.0e-3      # ~ sqrt(2 * 136 * 2^-24): float32 sums near g = 1
# Sound float32 runs differ by far less than that worst case (0.0 at the
# files' 6 digits between float32 engines, 1.3e-5 against float64 on this
# input); a TF32 product by about 4.6e-3. The gaps are held to this limit,
# and a TF32 product of the same vectors must fall past it.
TNF_SOUND = 1.0e-4
TNF_THRESHOLD = 0.175   # TnfDistance's --cluster-threshold-distance
BAM_RECORDS, BAM_READ_LEN = 1_000_000, 150
# the JAX BamSort's gzip.decompress copies the rest of the stream at each
# BGZF block, so its oracle runs take the first 125,000 records (33 MB)
BAM_ORACLE_RECORDS = 125_000
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


def lanes_since(rl, before) -> dict:
    """The run-length kernel's launches by lane count since `before`, a
    copy of rl.launches_by_lanes taken earlier: {L: launches} for every L
    launched in between."""
    return {L: n - before.get(L, 0)
            for L, n in sorted(rl.launches_by_lanes.items())
            if n > before.get(L, 0)}


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
    """The kernel's L = 2 and 3 instances and its run-time lane loop at L
    = 4, 5 and 10 against the plain version, bit-equal, at the drain's
    shape (L = 2-5) and at edge cases (a length off the tile, runs that end
    in the first lane only, an 8-byte-offset view); device times at the
    drain's shape (L = 2-5), beside the bound of (8L + 8) B a row."""
    max_err = 0
    lanes, vals = cases["drain_96M"]
    n = lanes.numel()
    small = sorted_lanes(1 << 20, 5000, gen, 70_000)
    ones = torch.ones(small.numel() + 1, dtype=torch.int32, device="cuda")
    for L in LANE_COUNTS:
        edge = {
            "n_not_tile_multiple": ([x[:2048 * 5 + 3] for x in
                                     lane_keys(small, L)], ones[:2048 * 5 + 3]),
            "first_lane_only": ([small] + [torch.zeros_like(small)] * (L - 1),
                                ones[1:]),
            "offset_view": ([torch.cat([small[:1], small])[1:]
                             for _ in range(L)], ones[1:])}
        if L in TIMED_LANES:
            edge["drain_96M"] = (lane_keys(lanes, L), vals)
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
        if L not in TIMED_LANES:
            continue
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
             coverage: str = "20", seed: str = "7") -> int:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m",
                    "kmernator_tpu_torch.apps.generate_metagenome",
                    "--genomes", genomes, "--total-genome-mb", genome_mb,
                    "--coverage", coverage,
                    "--read-length", "150", "--seed", seed, "--out", path],
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


def fr_oracle(name: str, fq: str, k: int, extra_env, args=()) -> dict:
    """The JAX package's FilterReads host engine at k on fq (a separate
    program): {"host_out", "host_s", "host_log"}."""
    host_out = os.path.join(WORK, name + "-host")
    t0 = time.perf_counter()
    host_log = host_engine(host_out, fq, extra_env, k, args)
    return {"host_out": host_out, "host_s": time.perf_counter() - t0,
            "host_log": host_log}


def mer_oracle(name: str, fq: str, k: int, extra_env) -> dict:
    """The JAX package's MeraculousCounter host engine at k on fq (a
    separate program): {"host_out", "host_s"}."""
    host_out = os.path.join(WORK, name + "-host")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "kmernator_tpu.apps.meraculous_counter",
                           "--kmer-size", str(k), "--out", host_out, fq],
                          env=env_with_root(**extra_env),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit("%s: the host engine exited %d:\n%s"
                         % (name, proc.returncode, proc.stderr[-3000:]))
    return {"host_out": host_out, "host_s": time.perf_counter() - t0}


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


def timed_steps(steps, stages):
    """Install host-clock timers on the functions `steps` names, (module,
    name) pairs, adding each call's seconds (each item's, for a generator)
    to stages[name]. Returns the originals, for `restore_steps`."""
    import inspect
    plain = {}

    def timed(fn, step):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stages[step] = stages.get(step, 0.0) + (time.perf_counter()
                                                        - t0)

        def items(*a, **kw):
            it = fn(*a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    x = next(it)
                except StopIteration:
                    return
                finally:
                    stages[step] = stages.get(step, 0.0) + (
                        time.perf_counter() - t0)
                yield x
        return items if inspect.isgeneratorfunction(fn) else call

    for mod, step in steps:
        plain[(mod, step)] = getattr(mod, step)
        setattr(mod, step, timed(plain[(mod, step)], step))
    return plain


def restore_steps(plain):
    for (mod, step), fn in plain.items():
        setattr(mod, step, fn)


# the shard exchange: owner hash (`owners`), bucket loads and slots, the
# scatter into send planes, and the exchange itself (parallel/mesh.py)
EXCHANGE = ("owners", "bucket_loads", "bucket_slots",
            "scatter_plane", "exchange")


def event_timed(targets, sink):
    """Wrap each (owner, name) of `targets` so that every call records a
    pair of CUDA events around it into sink[name]. Returns the originals,
    for `restore_steps`."""
    plain = {}
    for owner, name in targets:
        fn = getattr(owner, name)
        plain[(owner, name)] = fn

        def call(*a, _fn=fn, _name=name, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = _fn(*a, **kw)
            ev[1].record()
            sink.setdefault(_name, []).append(ev)
            return out
        setattr(owner, name, call)
    return plain


def events_ms(sink, names) -> float:
    """The device milliseconds between each recorded pair of `names`,
    summed (after a synchronize)."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for n in names for a, b in sink.get(n, ()))


def phase_app(name: str, fq: str, n_reads: int, rl, extra_env, k: int = K,
              args=(), port_args=(), host_from=None, keep_host=False,
              steps=(), mesh: int = 1):
    """Port (in-process, on the card, `--mesh mesh`) vs host engine
    (subprocess), both with `args` at k, the port with `port_args` too:
    outputs byte-identical, the kernel launched, the table on the card; with
    --variant-sigmas, the same "Removed N" count, and the purge timed by
    CUDA events around it. host_from: an earlier run's result whose host
    outputs (kept by keep_host) and log stand for this run's, with the same
    FLAGS, args and k. The table's capacities, the end of pass 1 (the last
    purge's return) and each lookup_batch, timed by CUDA events, are
    recorded, and so are the shard exchange's calls and each shard's drain;
    with steps ((module, name) pairs), the port's host seconds in each and
    in the table's add_batch and lookup_batch."""
    import kmernator_tpu_torch.apps.filter_reads as app
    from kmernator_tpu_torch.parallel import mesh_stream
    from kmernator_tpu_torch.parallel import prepare_reads as pr
    tables, purges, lookup_events = [], [], []
    chunk_calls = []
    shard_events = {}
    pass1_end = []
    stages = {}

    class Recorded(app.MeshStreamingSpectrum):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tables.append(self)
            self.caps = [self.cap]

        def _maybe_grow(self, *a, **kw):
            super()._maybe_grow(*a, **kw)
            if self.cap != self.caps[-1]:
                self.caps.append(self.cap)

        def add_batch(self, *a, **kw):
            t0 = time.perf_counter()
            super().add_batch(*a, **kw)
            stages["add_batch"] = stages.get("add_batch", 0.0) + (
                time.perf_counter() - t0)

        def lookup_batch(self, *a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            out = super().lookup_batch(*a, **kw)
            ev[1].record()
            lookup_events.append(ev)
            stages["lookup_batch"] = stages.get("lookup_batch", 0.0) + (
                time.perf_counter() - t0)
            return out

        def purge_min_depth(self, *a, **kw):
            super().purge_min_depth(*a, **kw)
            pass1_end.append(time.perf_counter())

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
            pass1_end.append(time.perf_counter())
            return n

    plain_chunk = app._chunk_padded

    def chunk_padded(*a, **kw):
        chunk_calls.append(1)
        return plain_chunk(*a, **kw)

    port_out = os.path.join(WORK, name + "-port")
    saved_env = {k: os.environ.get(k) for k in extra_env}
    os.environ.update(extra_env)
    plain_class = app.MeshStreamingSpectrum
    app.MeshStreamingSpectrum = Recorded
    app._chunk_padded = chunk_padded
    plain_steps = timed_steps(steps, stages)
    plain_steps.update(event_timed(
        [(mesh_stream, n) for n in EXCHANGE]
        + [(mesh_stream.MeshStreamingSpectrum, "_drain_shard")],
        shard_events))
    torch.cuda.reset_peak_memory_stats()
    try:
        rl.launches = 0
        pr.launches = 0
        before = dict(rl.launches_by_lanes)
        t0 = time.perf_counter()
        rc = app.run(["--device", "cuda", "--mesh", str(mesh)]
                     + list(port_args) + ["--out", port_out] + FLAGS
                     + list(args) + [str(k), fq])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        t_port = t_end - t0
        launches = rl.launches
        prep_launches = pr.launches
        by_lanes = lanes_since(rl, before)
    finally:
        app.MeshStreamingSpectrum = plain_class
        restore_steps(plain_steps)
        app._chunk_padded = plain_chunk
        for key, v in saved_env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
    if rc != 0:
        raise SystemExit("%s: port FilterReads exited %d" % (name, rc))
    host_from = resolved(host_from)
    oracle = host_from or fr_oracle(name, fq, k, extra_env, args)
    host_out, t_host = oracle["host_out"], oracle["host_s"]
    host_log = oracle["host_log"]
    mine, want = outputs(port_out), outputs(host_out)
    same_files(name, mine, want, "the host engine")
    if launches <= 0:
        raise SystemExit("%s: the run-length kernel was never launched"
                         % name)
    # every --mesh engine builds its padded arrays in _chunk_padded, one
    # prepare_reads launch a call: the streaming engines (--streaming, or an
    # input past the auto-stream size) once a chunk, the in-memory engine
    # once a run
    auto_mb = int(extra_env.get("KMTPU_AUTO_STREAM_MB", "2"))
    streamed = ("--streaming" in port_args
                or os.path.getsize(fq) > (auto_mb << 20))
    if prep_launches != len(chunk_calls) or prep_launches < 1 or (
            not streamed and prep_launches != 1):
        raise SystemExit("%s: %d _chunk_padded calls (streaming engine: "
                         "%s), but %d prepare_reads launches"
                         % (name, len(chunk_calls), streamed, prep_launches))
    if len(tables) != 1 or tables[0].drains < 1 or tables[0].D != mesh \
            or any(x.device.type != "cuda" for x in tables[0].table_lanes):
        raise SystemExit("%s: the %d shard tables did not live on the card"
                         % (name, mesh))
    sp = tables[0]
    lanes = (k + 31) // 32
    if by_lanes.get(lanes, 0) != launches or sp.L != lanes:
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
        "%d, prepare_reads launches %d (one a _chunk_padded call); table "
        "%d rows on %s, "
        "%d drains, %d singletons purged; peak device memory %.2f GiB"
        % (name, ", ".join(want), k, lanes, launches, prep_launches, sp.cap,
           sp.table_lanes[0].device, sp.drains, sp.purged_singletons, peak))
    log("%s: port %.2f s = %.0f reads/s; host engine %.2f s = %.0f reads/s"
        % (name, t_port, n_reads / t_port, t_host, n_reads / t_host))
    for path in list(mine.values()) + ([] if keep_host or host_from
                                       else list(want.values())):
        os.remove(path)
    lookup_ms = sum(a.elapsed_time(b) for a, b in lookup_events)
    return {"name": name, "k": k, "launches": launches,
            "prep_launches": prep_launches, "chunks": len(chunk_calls),
            "by_lanes": by_lanes, "port_s": t_port,
            "host_s": t_host, "reads": n_reads, "peak_gib": peak,
            "purge": purge, "host_out": host_out, "host_log": host_log,
            "caps": sp.caps, "mesh": mesh,
            "exchange_ms": events_ms(shard_events, EXCHANGE),
            "drain_ms": events_ms(shard_events, ["_drain_shard"]),
            "retries": sp.overflow_retries,
            "drains": sp.drains, "purged": sp.purged_singletons,
            "lookups": len(lookup_events), "lookup_device_ms": lookup_ms,
            "pass1_s": pass1_end[-1] - (t_end - t_port) if pass1_end
            else None, "pass2_s": t_end - pass1_end[-1] if pass1_end
            else None, "host_steps_s": stages if steps else None}


def phase_distributed(name: str, fq: str, n_reads: int, rl, k: int,
                      host_from, mesh1_run):
    """FilterReads `--streaming --distributed 127.0.0.1:<port> --nprocs 1`
    on the card against the host engine's outputs of an earlier phase
    (host_from), beside that input's `--mesh 1` run (mesh1_run):
    byte-identical, the table on the card and grown at least once, no
    singleton purged, one run-length launch at the keys' lane count a
    drain, and pass 2's lookups on the card."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    import kmernator_tpu_torch.apps.filter_reads as app
    from kmernator_tpu_torch.io import chunked
    steps = [(chunked, "stream_partition_readsets")] + [
        (app, f) for f in ("ArtifactFilter", "apply_artifact_filter",
                           "_chunk_padded", "padded_to_ragged",
                           "score_and_trim", "select_reads", "divert_blobs")]
    r = phase_app(name, fq, n_reads, rl, {}, k=k, host_from=host_from,
                  port_args=["--streaming", "--distributed",
                             "127.0.0.1:%d" % port, "--nprocs", "1"],
                  steps=steps)
    lanes = (k + 31) // 32
    if len(r["caps"]) < 2:
        raise SystemExit("%s: the table never grew (%s rows)"
                         % (name, r["caps"]))
    if r["purged"] != 0:
        raise SystemExit("%s: %d singletons purged" % (name, r["purged"]))
    if r["launches"] != r["drains"] \
            or r["by_lanes"].get(lanes, 0) != r["drains"]:
        raise SystemExit("%s: %d drains, but the run-length kernel ran %s"
                         % (name, r["drains"], r["by_lanes"]))
    if r["lookups"] < 1 or r["pass2_s"] is None:
        raise SystemExit("%s: pass 2 made no lookup on the card" % name)
    log("%s: table %s rows on the card, %d drains (one run-length launch "
        "each at L=%d), 0 singletons purged"
        % (name, " -> ".join("{:,}".format(c) for c in r["caps"]),
           r["drains"], lanes))
    log("%s: pass 1 %.2f s, pass 2 %.2f s (%d lookup_batch calls, %.1f ms "
        "of device time by CUDA events); peak device memory %.2f GiB"
        % (name, r["pass1_s"], r["pass2_s"], r["lookups"],
           r["lookup_device_ms"], r["peak_gib"]))
    log("%s: the port's host seconds by step: %s; the rest %.2f s"
        % (name, ", ".join("%s %.2f" % x
                           for x in r["host_steps_s"].items()),
           r["port_s"] - sum(r["host_steps_s"].values())))
    log("%s: %.0f reads/s; host engine %.0f reads/s; --mesh 1 "
        "(%s, this run) %.0f reads/s"
        % (name, n_reads / r["port_s"], n_reads / r["host_s"],
           mesh1_run["name"], mesh1_run["reads"] / mesh1_run["port_s"]))
    return r


def phase_meraculous(name: str, fq: str, n_reads: int, rl, k: int,
                     mesh: int = 1, host_from=None, keep_host=False):
    """MeraculousCounter --mesh `mesh`, the port in process on the card,
    against the JAX package's host engine (a subprocess; host_from: an
    earlier run's result whose host outputs, kept by keep_host, stand for
    this run's): mercount and mergraph byte-identical, 13 run-length
    launches a shard at the keys' lane count, the device time of
    extension_spectrum_mesh, of its shard exchange and of its shards'
    counting from CUDA events around them, one format_mers select launch
    and one write launch a slab of the plan its write returns, and the
    port's host seconds in each of the app's steps."""
    import kmernator_tpu_torch.apps.meraculous_counter as app
    from kmernator_tpu_torch.parallel import format_mers as fm
    from kmernator_tpu_torch.parallel import mesh as tmesh
    from kmernator_tpu_torch.parallel import prepare_reads as pr
    calls = []
    stages = {}
    shard_events = {}
    plans = []
    plain = {n: getattr(app, n) for n in (
        "load_reads", "prepare_reads", "extension_spectrum_mesh")}
    plain_fm = {n: getattr(fm, n) for n in ("select", "write")}

    def host_timed(step, fns=plain):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fns[step](*a, **kw)
                if step == "write":
                    plans.append(out)
                return out
            finally:
                if step == "prepare_reads":   # its kernel runs on after
                    torch.cuda.synchronize()  # the launch returns
                stages[step] = (stages.get(step, 0.0)
                                + time.perf_counter() - t0)
        return call

    def device_timed(mesh_, k_, codes, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = host_timed("extension_spectrum_mesh")(mesh_, k_, codes, *a,
                                                    **kw)
        ev[1].record()
        torch.cuda.synchronize()
        calls.append({"device_ms": ev[0].elapsed_time(ev[1]),
                      "windows": codes.shape[0] * (codes.shape[1] - k_ + 1),
                      "kmers": 0 if out[1] is None else out[1].numel(),
                      "overflow": out[3], "on": str(codes.device)})
        return out

    port_out = os.path.join(WORK, name + "-port")
    for step in plain:
        setattr(app, step, host_timed(step))
    for step in plain_fm:
        setattr(fm, step, host_timed(step, plain_fm))
    app.extension_spectrum_mesh = device_timed
    plain_events = event_timed(
        [(tmesh, n) for n in EXCHANGE + ("count_received_ext",)],
        shard_events)
    torch.cuda.reset_peak_memory_stats()
    try:
        rl.launches = 0
        pr.launches = 0
        fm.launches.clear()
        before = dict(rl.launches_by_lanes)
        t0 = time.perf_counter()
        rc = app.run(["--device", "cuda", "--mesh", str(mesh),
                      "--kmer-size", str(k), "--out", port_out, fq])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        t_port = t_end - t0
        launches = rl.launches
        prep_launches = pr.launches
        fm_launches = dict(fm.launches)
        by_lanes = lanes_since(rl, before)
    finally:
        for step, fn in plain.items():
            setattr(app, step, fn)
        for step, fn in plain_fm.items():
            setattr(fm, step, fn)
        restore_steps(plain_events)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0:
        raise SystemExit("%s: port MeraculousCounter exited %d" % (name, rc))
    host_from = resolved(host_from)
    oracle = host_from or mer_oracle(name, fq, k, {})
    host_out, t_host = oracle["host_out"], oracle["host_s"]
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
    want_launches = 13 * mesh
    if (not calls or calls[-1]["overflow"] or
            {c["on"] for c in calls} != {"cuda:0"}
            or launches != want_launches
            or by_lanes.get(lanes, 0) != want_launches
            or prep_launches != 1):
        raise SystemExit("%s: expected extension_spectrum_mesh on the card, "
                         "%d run-length launches at %d lanes and one "
                         "prepare_reads launch; got %s, %s and %d"
                         % (name, want_launches, lanes, calls, by_lanes,
                            prep_launches))
    slabs = [len(p) for p in plans]
    if len(slabs) != 1 or fm_launches != {"select": 1, "write": slabs[0]}:
        raise SystemExit("%s: expected one format_mers select launch and "
                         "one write launch a slab of its plan; got %s for "
                         "plans of %s slabs" % (name, fm_launches, slabs))
    call = calls[-1]
    exchange_ms = events_ms(shard_events, EXCHANGE)
    count_ms = events_ms(shard_events, ["count_received_ext"])
    log("%s: byte-identical (%s); --mesh %d, k=%d (%d-lane keys), "
        "run_length launches %d %s, prepare_reads 1, format_mers %s; %d "
        "windows, %d distinct "
        "k-mers; extension_spectrum_mesh %.1f ms of device time (CUDA "
        "events), of which the shard exchange %.1f ms and the shards' "
        "counting %.1f ms; %d overflow retries; peak device memory %.2f GiB"
        % (name, ", ".join("%s %d B, %d lines" % (x, *sizes[x])
                           for x in sorted(sizes)), mesh, k, lanes,
           launches, by_lanes, fm_launches, call["windows"], call["kmers"],
           call["device_ms"], exchange_ms, count_ms, len(calls) - 1, peak))
    log("%s: port %.2f s = %.0f reads/s; host engine %.2f s = %.0f reads/s"
        % (name, t_port, n_reads / t_port, t_host, n_reads / t_host))
    log("%s: the port's host seconds by step: %s; the rest %.2f s"
        % (name, ", ".join("%s %.2f" % x for x in stages.items()),
           t_port - sum(stages.values())))
    for path in list(mine.values()) + ([] if keep_host or host_from
                                       else list(want.values())):
        os.remove(path)
    return {"name": name, "k": k, "mesh": mesh, "launches": launches,
            "prep_launches": prep_launches, "format_mers": fm_launches,
            "by_lanes": by_lanes, "port_s": t_port, "host_s": t_host,
            "host_out": host_out, "reads": n_reads, "peak_gib": peak,
            "stages_s": stages, "exchange_ms": exchange_ms,
            "count_ms": count_ms, "retries": len(calls) - 1, **call}


def resolved(host_from):
    """An earlier run's result, or an oracle's still running in a thread
    (a Future), once it is done."""
    return host_from.result() if isinstance(host_from, Future) else host_from


def asm_oracle(name: str, fq: str, k: int, seeds: str, iterations: int,
               args, extra_env) -> dict:
    """The JAX package's nucleating assembler (its host engine, a separate
    program) on the seeds: {"host_out", "host_s"}."""
    host_out = os.path.join(WORK, name + "-host.fa")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "kmernator_tpu.apps.nucleating_assembler",
                           "--contig-file", seeds, "--max-iterations",
                           str(iterations)] + list(args)
                          + ["--out", host_out, str(k), fq],
                          env=env_with_root(**extra_env),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit("%s: the host engine exited %d:\n%s"
                         % (name, proc.returncode, proc.stderr[-3000:]))
    return {"host_out": host_out, "host_s": time.perf_counter() - t0}


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
                    n_seeds: int, iterations: int, mesh: int = 1,
                    host_from=None, keep_host=False, seeds=None, args=()):
    """The nucleating assembler --mesh `mesh`, the port in process on the
    card, against the JAX package's host engine (its k-mer read index, no
    mesh; a subprocess; host_from: an earlier run's result whose seeds and
    host outputs, kept by keep_host, stand for this run's): the contig
    files byte-identical, the read index built on the card from one
    prepare_reads launch, one match a iteration, no other kernel launched.
    Prints the index's rows and distinct
    keys, queries and hits a iteration, the device time of the index build,
    of its shard exchange and of each match (CUDA events), peak device
    memory, both wall times, and the port's host seconds by step
    (prepare_reads up to the end of its kernel). seeds: a
    FASTA of n_seeds seeds to take (else drawn here, or an earlier
    host_from's); args: more flags for both engines."""
    import kmernator_tpu_torch.apps.nucleating_assembler as app
    from kmernator_tpu_torch.parallel import dist_match as dm
    from kmernator_tpu_torch.parallel import prepare_reads as pr
    if seeds is None and host_from is None:
        seeds = os.path.join(WORK, name + "-seeds.fa")
        draw_seeds(fq, n_reads, seeds, n_seeds)
    elif seeds is None:
        seeds = host_from["seeds"]
    stages, builds, matches = {}, [], []
    shard_events = {}
    steps = {app: ("load_reads", "ArtifactFilter", "apply_artifact_filter",
                   "screen_pools", "extend_contigs", "write_fasta"),
             dm: ("prepare_reads", "mesh_match_pools")}
    plain = {(mod, n): getattr(mod, n) for mod, names in steps.items()
             for n in names}
    plain_build, plain_match = dm.build_index, dm.match_shards

    def host_timed(mod, step):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return plain[(mod, step)](*a, **kw)
            finally:
                if step == "prepare_reads":   # its kernel runs on after
                    torch.cuda.synchronize()  # the launch returns
                stages[step] = (stages.get(step, 0.0)
                                + time.perf_counter() - t0)
        return call

    def index_summary(out):
        shards, overflow = out
        rows = distinct = 0
        for lanes, rid in shards or ():
            rows += rid.numel()
            if rid.numel():
                neq = lanes[0][1:] != lanes[0][:-1]
                for lane in lanes[1:]:
                    neq |= lane[1:] != lane[:-1]
                distinct += 1 + int(neq.sum())
        return {"rows": rows, "distinct": distinct, "overflow": overflow,
                "shards": len(shards or ()), "lanes": (k + 31) // 32,
                "on": "cuda:0" if shards is None
                else str(shards[0][1].device)}

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
    for mod, step in plain:
        setattr(mod, step, host_timed(mod, step))
    dm.build_index = device_timed(plain_build, builds, index_summary,
                                  "build_index")
    dm.match_shards = device_timed(plain_match, matches, match_summary,
                                   "match (in mesh_match_pools)")
    plain_events = event_timed([(dm, n) for n in EXCHANGE], shard_events)
    torch.cuda.reset_peak_memory_stats()
    counters = (rl.launches, dict(ms.launches), hi.launches)
    try:
        pr.launches = 0
        t0 = time.perf_counter()
        rc = app.run(["--device", "cuda", "--mesh", str(mesh),
                      "--contig-file", seeds, "--max-iterations",
                      str(iterations)] + list(args)
                     + ["--out", port_out, str(k), fq])
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
        prep_launches = pr.launches
    finally:
        for (mod, step), fn in plain.items():
            setattr(mod, step, fn)
        dm.build_index, dm.match_shards = plain_build, plain_match
        restore_steps(plain_events)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0:
        raise SystemExit("%s: the port's assembler exited %d" % (name, rc))
    if (rl.launches, dict(ms.launches), hi.launches) != counters:
        raise SystemExit("%s: the assembler's path launched a kernel other "
                         "than prepare_reads" % name)
    if prep_launches != 1:
        raise SystemExit("%s: %d prepare_reads launches, where the read "
                         "index takes one" % (name, prep_launches))
    oracle = resolved(host_from) or asm_oracle(name, fq, k, seeds,
                                               iterations, args, {})
    host_out, t_host = oracle["host_out"], oracle["host_s"]
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
    if (not builds or builds[-1]["overflow"] or not matches
            or builds[-1]["shards"] != mesh or on != {"cuda:0"}):
        raise SystemExit("%s: expected the index of %d shards built and "
                         "the matches on the card; got %s and %s"
                         % (name, mesh, builds, matches))
    index = builds[-1]
    exchange_ms = events_ms(shard_events, EXCHANGE)
    log("%s: byte-identical (%d files; %d contigs, %d grew, longest %d "
        "bp); --mesh %d, k=%d (%d-lane keys); index %d rows, %d distinct "
        "keys; build %.1f ms of device time (CUDA events); the shard "
        "exchange (the build's routing, the queries' owner hash) %.1f ms; "
        "%d overflow retries; prepare_reads launches 1; "
        "peak device memory %.2f GiB"
        % (name, len(want), len(lengths), grew, max(lengths), mesh, k,
           index["lanes"], index["rows"], index["distinct"],
           index["device_ms"], exchange_ms, len(builds) - 1, peak))
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
    for path in list(mine.values()) + ([] if keep_host or host_from
                                       else [seeds] + list(want.values())):
        os.remove(path)
    torch.cuda.empty_cache()
    return {"name": name, "k": k, "mesh": mesh, "seeds": seeds,
            "n_seeds": n_seeds, "iterations": iterations, "grew": grew,
            "port_s": t_port, "host_s": t_host, "host_out": host_out,
            "reads": n_reads, "peak_gib": peak, "index": index,
            "exchange_ms": exchange_ms, "retries": len(builds) - 1,
            "prep_launches": prep_launches, "matches": matches,
            "stages_s": stages}


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


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_app(module: str, args, port: bool, **env) -> float:
    """One app run: the port's `run` in this process, on the card, or the
    JAX app as a separate program (with `env` added to its environment).
    Returns its wall seconds; a non-zero exit fails the phase."""
    t0 = time.perf_counter()
    if port:
        import importlib
        app = importlib.import_module("kmernator_tpu_torch.apps." + module)
        rc = app.run(["--device", "cuda"] + list(args))
        torch.cuda.synchronize()
        if rc != 0:
            raise SystemExit("port %s %s exited %d" % (module, args, rc))
    else:
        proc = subprocess.run([sys.executable, "-m",
                               "kmernator_tpu.apps." + module] + list(args),
                              env=env_with_root(**env), capture_output=True)
        if proc.returncode != 0:
            raise SystemExit("JAX %s %s exited %d:\n%s"
                             % (module, args, proc.returncode,
                                proc.stderr.decode()[-3000:]))
    return time.perf_counter() - t0


def read_output(path: str) -> bytes:
    """A file's bytes; a .gz after decompression (gzip stamps its header
    with the time of writing)."""
    from kmernator_tpu_torch.io.bam import bgzf_decompress
    with open(path, "rb") as f:
        data = f.read()
    return bgzf_decompress(data) if path.endswith(".gz") else data


def same_outputs(name: str, port_prefix: str, jax_prefix: str) -> list:
    """Every file named after the port's prefix byte-identical to the JAX
    app's of the same suffix, and the same set of files. Deletes both."""
    mine, want = outputs(port_prefix), outputs(jax_prefix)
    if not want or set(mine) != set(want):
        raise SystemExit("%s: output files differ: %s vs %s"
                         % (name, sorted(mine), sorted(want)))
    for suffix in want:
        a, b = read_output(mine[suffix]), read_output(want[suffix])
        if a != b or not a:
            raise SystemExit("%s: %s differs from the JAX app's (%d and %d "
                             "bytes)" % (name, suffix, len(a), len(b)))
    for path in list(mine.values()) + list(want.values()):
        os.remove(path)
    return sorted(want)


def tnf_input(path: str, seed: int = 14) -> int:
    """TNF_CONTIGS contigs of 2,000-10,000 bp, each a piece of one of
    TNF_GENOMES seeded genomes of GC content 30% to 70%. Returns the
    bases written."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = [acgt[rng.choice(4, TNF_GENOME_BP, p=[(1 - gc) / 2, gc / 2,
                                                    gc / 2, (1 - gc) / 2])]
               for gc in np.linspace(0.30, 0.70, TNF_GENOMES)]
    total = 0
    with open(path, "wb") as f:
        for i in range(TNF_CONTIGS):
            g = int(rng.integers(TNF_GENOMES))
            L = int(rng.integers(2000, 10001))
            s = int(rng.integers(0, TNF_GENOME_BP - L))
            f.write(b">contig%04d genome=%02d\n%s\n"
                    % (i, g, genomes[g][s:s + L].tobytes()))
            total += L
    return total


def inter_distances(path: str):
    """The names and the [n, n] float64 distances (lower triangle
    mirrored, zero diagonal) of a TnfDistance --inter-distance-file."""
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    d = np.zeros((len(lines), len(lines)))
    names = []
    for i, line in enumerate(lines):
        parts = line.split(b"\t")
        names.append(parts[0])
        if i:
            d[i, :i] = np.array(parts[1:], dtype=np.float64)
    return names, d + d.T


def check_clusters(name: str, path: str, names, dj: np.ndarray,
                   thr: float) -> int:
    """The port's clusters lie between the single-link clusters of the JAX
    distances at thr - TNF_BOUND and at thr + TNF_BOUND: a pair within the
    bound of the threshold may link either way, no other pair. Returns the
    number of pairs within the bound."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    index = {nm: i for i, nm in enumerate(names)}
    label = np.full(len(names), -1)
    with open(path, "rb") as f:
        for line in f.read().splitlines():
            g, nm = line.split(b"\t")
            label[index[nm]] = int(g)
    if (label < 0).any():
        raise SystemExit("%s: a contig is in no cluster" % name)

    def components(limit: float) -> np.ndarray:
        adj = csr_matrix(np.triu(dj <= limit, 1))
        return connected_components(adj, directed=False)[1]

    def refines(fine, coarse) -> bool:
        return len(np.unique(np.stack([fine, coarse], 1), axis=0)) == len(
            np.unique(fine))

    sure, maybe = components(thr - TNF_BOUND), components(thr + TNF_BOUND)
    if not (refines(sure, label) and refines(label, maybe)):
        raise SystemExit("%s: the clusters disagree with the JAX distances "
                         "past the bound" % name)
    iu = np.triu_indices(len(dj), 1)
    return int((np.abs(dj[iu] - thr) <= TNF_BOUND).sum())


def tf32_control_gap(a: torch.Tensor) -> float:
    """The largest off-diagonal gap between the distances sqrt(max(0, 2 -
    2 g)) of g = a a^T in float32 and with TF32 on."""
    def d() -> torch.Tensor:
        g = torch.matmul(a, a.T)
        return torch.sqrt(torch.clamp(2.0 - 2.0 * g, min=0.0))
    exact = d()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gap = (d() - exact).abs_()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    gap.fill_diagonal_(0.0)
    return float(gap.max())


def phase_tnf(smi: str):
    """TnfDistance on TNF_CONTIGS contigs through its CLI entry point: the
    port at --device cuda and at --device cpu in this process, the JAX app
    as a separate program on the CPU (JAX_PLATFORMS=cpu, as the CPU tests
    run it), each writing the vectors table, the inter-distance file and
    the clusters at the default threshold; the run's Gram matmul timed
    alone on the card by CUDA events. Where jax finds a GPU, the JAX app
    also runs there, at XLA's default matmul precision, and its distances'
    gap to the port's is printed, not held to the bound: XLA takes float32
    matmuls on an H100 through TF32 by default."""
    from kmernator_tpu_torch.apps import tnf_distance as tnf
    from kmernator_tpu_torch.io.reads import load_reads
    fa = os.path.join(WORK, "tnf%d.fa" % TNF_CONTIGS)
    t0 = time.perf_counter()
    bases = tnf_input(fa)
    log("tnf: %d contigs, %d bp, from %d genomes of GC 30-70%% in %.1f s"
        % (TNF_CONTIGS, bases, TNF_GENOMES, time.perf_counter() - t0))
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.__version__, "
         "jax.default_backend())"], capture_output=True, text=True)
    jax_backend = probe.stdout.split() if probe.returncode == 0 else None
    oracle = ("float32 jnp.matmul on the CPU (jax %s)" % jax_backend[0]
              if jax_backend else "float64 numpy a @ a.T (the JAX app's "
              "fallback: jax does not import on this host)")
    engines = ["cuda", "cpu", "jax"]
    if jax_backend and jax_backend[1] == "gpu":
        engines.append("jax-gpu")
    walls, files, peak = {}, {}, 0.0
    for engine in engines:
        p = os.path.join(WORK, "tnf-" + engine)
        files[engine] = [p + ".vec", p + ".inter", p + ".cl"]
        args = ["--inter-distance-file", files[engine][1], "--cluster-file",
                files[engine][2], "--out", files[engine][0], fa]
        if engine.startswith("jax"):
            walls[engine] = run_app("tnf_distance", args, False, **(
                {"JAX_PLATFORMS": "cpu"} if engine == "jax" else {}))
            continue
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if tnf.run(["--device", engine] + args) != 0:
            raise SystemExit("tnf: the port at --device %s exited non-zero"
                             % engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        if engine == "cuda":
            peak = torch.cuda.max_memory_allocated() / 2**20
    vec = {e: read_output(files[e][0]) for e in walls}
    if not vec["jax"] or any(v != vec["jax"] for v in vec.values()):
        raise SystemExit("tnf: the vectors tables differ")
    mats = {e: inter_distances(files[e][1]) for e in walls}
    names = mats["jax"][0]
    if len(names) != TNF_CONTIGS or any(mats[e][0] != names for e in walls):
        raise SystemExit("tnf: the inter-distance files name other contigs")
    gaps = {a + "-" + b: float(np.abs(mats[a][1] - mats[b][1]).max())
            for a, b in (("cuda", "jax"), ("cpu", "jax"), ("cuda", "cpu"))}
    tf32 = None
    if "jax-gpu" in mats:   # printed, not held to the bound
        gap = np.abs(mats["cuda"][1] - mats["jax-gpu"][1])
        tf32 = {"max_gap": float(gap.max()), "past_bound": int(
            (np.triu(gap, 1) > TNF_BOUND).sum())}
    for limit in (TNF_BOUND, TNF_SOUND):
        if max(gaps.values()) > limit:
            i, j = np.unravel_index(np.abs(mats["cuda"][1] - mats["jax"][1])
                                    .argmax(), (TNF_CONTIGS, TNF_CONTIGS))
            raise SystemExit(
                "tnf: distances differ by %s, past %.1e; the widest at %s, "
                "%s: %s" % (gaps, limit, names[i].decode(), names[j].decode(),
                            {e: mats[e][1][i, j] for e in walls}))
    dj = mats["jax"][1]
    near = {e: check_clusters("tnf-" + e, files[e][2], names, dj,
                              TNF_THRESHOLD) for e in ("cuda", "cpu")}
    cl = {e: read_output(files[e][2]) for e in walls}
    n_clusters = len(set(line.split(b"\t")[0]
                         for line in cl["cuda"].splitlines()))
    # the run's Gram matmul alone, on its own inputs
    tnfs, _ = tnf.tnf_vectors(load_reads([fa]), 4)
    norms = np.sqrt((tnfs * tnfs).sum(axis=1))
    a = torch.from_numpy(tnfs / np.where(norms == 0, 1.0, norms)[:, None]
                         ).to("cuda", torch.float32)
    ms = cuda_ms(lambda: torch.matmul(a, a.T), 50)
    control = tf32_control_gap(a)
    if control <= TNF_SOUND:
        raise SystemExit("tnf: a TF32 product's distances lie within %.1e "
                         "of the float32 ones (%.3g): the limit cannot see "
                         "TF32" % (TNF_SOUND, control))
    n, m = a.shape
    flops = 2.0 * n * n * m
    bound = max(flops / FP32_FLOPS, 4.0 * (n * m + n * n)
                / HBM_BYTES_PER_S) * 1e3
    log("tnf: wall time, port --device cuda %.2f s (peak device memory "
        "%.1f MiB), port --device cpu %.2f s, JAX app on the CPU %.2f s%s "
        "[%s]" % (walls["cuda"], peak, walls["cpu"], walls["jax"],
                  ", on the GPU %.2f s" % walls["jax-gpu"] if tf32 else "",
                  smi))
    if tf32:
        log("tnf: the JAX app on the GPU (XLA's default precision, TF32): "
            "largest distance gap to the port's %.6g, %d of %d distances "
            "past %.1e" % (tf32["max_gap"], tf32["past_bound"],
                           TNF_CONTIGS * (TNF_CONTIGS - 1) // 2, TNF_BOUND))
    log("tnf: TF32 control (the same vectors' product with TF32 on, in "
        "memory): largest distance gap to float32 %.6g, past the limit "
        "%.1e" % (control, TNF_SOUND))
    log("tnf: vectors tables byte-identical on every engine (%d "
        "bytes); largest distance gaps %s, held to %.1e (worst-case bound "
        "%.1e); JAX oracle: %s; %d "
        "clusters at %.3f, byte-identical to the JAX app's: cuda %s, cpu "
        "%s; pairs within the bound of the threshold %s"
        % (len(vec["jax"]), json.dumps(gaps), TNF_SOUND, TNF_BOUND, oracle,
           n_clusters,
           TNF_THRESHOLD, cl["cuda"] == cl["jax"], cl["cpu"] == cl["jax"],
           json.dumps(near)))
    log("tnf: the [%d, %d] float32 Gram matmul on the card %.4f ms (CUDA "
        "events, 50 calls) = %.1f TFLOP/s; bound %.4f ms (float32 at %.0f "
        "TFLOP/s, no TF32) [%s]" % (n, m, ms, flops / ms / 1e9, bound,
                                    FP32_FLOPS / 1e12, smi))
    for paths in files.values():
        for path in paths:
            os.remove(path)
    os.remove(fa)
    return {"contigs": TNF_CONTIGS, "bases": bases, "oracle": oracle,
            "gaps": gaps, "clusters": n_clusters,
            "near_threshold_pairs": near,
            "clusters_identical": {e: cl[e] == cl["jax"]
                                   for e in ("cuda", "cpu")},
            "matmul_ms": ms, "matmul_bound_ms": bound, "jax_gpu_tf32": tf32,
            "tf32_control_gap": control,
            "cuda_peak_mib": peak, **{e + "_s": walls[e] for e in walls}}


def bam_input(n: int, seed: int = 15):
    """n seeded records of BAM_READ_LEN bp on 20 references sized as
    generate_metagenome sizes the streaming input's 20 genomes: both
    strands, read1 and read2, MAPQ 0-60, 2% unmapped, half of those
    placed at their mate. Encoded as io/bam.py parse_sam encodes SAM text,
    and held to it on the first 2,000 records' SAM lines. Returns the
    port's BamData."""
    import struct
    from kmernator_tpu_torch.io import bam
    raw = np.exp(np.random.default_rng(7).uniform(0, 2.5, 20))
    lens = (raw / raw.sum() * 6e6).astype(np.int64)
    rng = np.random.default_rng(seed)
    L = BAM_READ_LEN
    ref = rng.choice(20, n, p=lens / lens.sum())
    pos0 = rng.integers(0, lens[ref] - L)
    flag = (0x1 | np.where(rng.random(n) < 0.5, 0x40, 0x80)
            | np.where(rng.random(n) < 0.5, 0x10, 0))
    mapq = rng.integers(0, 61, n)
    unmapped = rng.random(n) < 0.02
    placed = rng.random(n) < 0.5
    flag = np.where(unmapped, flag | 0x4, flag)
    mapq = np.where(unmapped, 0, mapq)
    ref = np.where(unmapped & ~placed, -1, ref)
    pos0 = np.where(unmapped & ~placed, -1, pos0)
    tlen = np.where(rng.random(n) < 0.5, 1, -1) * rng.integers(200, 600, n)
    tlen = np.where(ref < 0, 0, tlen)
    codes = rng.integers(0, 4, (n, L))
    nibble = np.array([1, 2, 4, 8], np.uint8)[codes]   # "=ACMGRSVTWYHKDBN"
    packed = (nibble[:, 0::2] << 4) | nibble[:, 1::2]
    quals = rng.integers(2, 41, (n, L)).astype(np.uint8)
    cigar = struct.pack("<I", L << 4)
    bd = bam.BamData(header_text=b"@HD\tVN:1.6\tSO:unsorted\n" + b"".join(
        b"@SQ\tSN:genome%02d\tLN:%d\n" % (i, x) for i, x in enumerate(lens)),
        ref_names=[b"genome%02d" % i for i in range(20)],
        ref_lens=[int(x) for x in lens])
    for i in range(n):
        name = b"read%07d" % (i // 2)
        mapped = not unmapped[i]
        end = int(pos0[i]) + (L if mapped else 1)
        bd.records.append(struct.pack(
            "<iiBBHHHiiii", int(ref[i]), int(pos0[i]), len(name) + 1,
            int(mapq[i]), bam._reg2bin(max(int(pos0[i]), 0), max(end, 1)),
            1 if mapped else 0, int(flag[i]), L, int(ref[i]), int(pos0[i]),
            int(tlen[i])) + name + b"\x00" + (cigar if mapped else b"")
            + packed[i].tobytes() + quals[i].tobytes())
    bd.ref_id, bd.pos, bd.flag = (ref.astype(np.int32),
                                  pos0.astype(np.int32),
                                  flag.astype(np.int32))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    sam = [bd.header_text]
    for i in range(min(n, 2000)):
        rname = b"*" if ref[i] < 0 else bd.ref_names[ref[i]]
        sam.append(b"\t".join([
            b"read%07d" % (i // 2), b"%d" % flag[i], rname,
            b"%d" % (pos0[i] + 1), b"%d" % mapq[i],
            b"*" if unmapped[i] else b"%dM" % L,
            b"*" if ref[i] < 0 else b"=", b"%d" % (pos0[i] + 1),
            b"%d" % tlen[i], acgt[codes[i]].tobytes(),
            (quals[i] + 33).tobytes()]) + b"\n")
    if bam.parse_sam(b"".join(sam)).records != bd.records[:2000]:
        raise SystemExit("bam: the records are not parse_sam's encoding")
    return bd


def streams(prefix: str) -> list:
    """A BamSort run's decompressed BAM and unmapped outputs."""
    from kmernator_tpu_torch.io.bam import bgzf_decompress
    return [bgzf_decompress(read_output(prefix + ".bam"))] + [
        read_output(prefix + s) for s in (".unmapped.fastq.gz",
                                          ".pairs.fastq.gz")]


def bgzf_blocks(path: str) -> list:
    """The decompressed size of each BGZF block of a file."""
    import struct
    with open(path, "rb") as f:
        data = f.read()
    sizes, off = [], 0
    while off < len(data):
        size = struct.unpack_from("<H", data, off + 16)[0] + 1
        sizes.append(struct.unpack_from("<I", data, off + size - 4)[0])
        off += size
    return sizes


def phase_bam(smi: str):
    """BamSort and FilterAndSortSam through their CLI entry points. On
    BAM_ORACLE_RECORDS records, the port in this process (the host
    engine) against the JAX apps run as separate programs, byte-identical:
    BamSort with BAM and SAM output, both unmapped outputs and
    --keep-unmapped-paired-read 1 and 0, FilterAndSortSam --exclude-flags
    4 --min-mapq 20. On BAM_RECORDS records, the port in one process and
    at --distributed --nprocs 2 (two gloo processes): the same header and
    record stream."""
    from kmernator_tpu_torch.io import bam
    t0 = time.perf_counter()
    bd = bam_input(BAM_RECORDS)
    inp = os.path.join(WORK, "aln.bam")
    with open(inp, "wb") as f:
        f.write(bam.write_bam(bd))
    header = bam.header_bytes(bd)
    cut = os.path.join(WORK, "aln-oracle.bam")
    bd.records = bd.records[:BAM_ORACLE_RECORDS]
    for col in ("ref_id", "pos", "flag"):
        setattr(bd, col, getattr(bd, col)[:BAM_ORACLE_RECORDS])
    with open(cut, "wb") as f:
        f.write(bam.write_bam(bd))
    del bd
    log("bam: %d records of %d bp on 20 references, %d bytes of BAM, and "
        "its first %d records, %d bytes, in %.1f s"
        % (BAM_RECORDS, BAM_READ_LEN, os.path.getsize(inp),
           BAM_ORACLE_RECORDS, os.path.getsize(cut),
           time.perf_counter() - t0))
    walls = {}
    unmapped_args = lambda p, keep: [
        "--unmapped-reads", p + ".unmapped.fastq.gz",
        "--unmapped-read-pairs", p + ".pairs.fastq.gz",
        "--keep-unmapped-paired-read", keep]
    for out_ext, keep in (("bam", "1"), ("sam", "0")):
        name = "sort-%s-keep%s" % (out_ext, keep)
        for engine in ("port", "jax"):
            p = os.path.join(WORK, "%s-%s" % (engine, name))
            walls["%s-%s-%d" % (name, engine, BAM_ORACLE_RECORDS)] = run_app(
                "bam_sort", unmapped_args(p, keep) + [p + "." + out_ext, cut],
                engine == "port")
        same_outputs("bam " + name, os.path.join(WORK, "port-" + name),
                     os.path.join(WORK, "jax-" + name))
    name = "filter-exclude4-mapq20"
    for engine in ("port", "jax"):
        walls["%s-%s-%d" % (name, engine, BAM_ORACLE_RECORDS)] = run_app(
            "filter_and_sort_sam", [
                "--exclude-flags", "4", "--min-mapq", "20",
                os.path.join(WORK, "%s-%s.bam" % (engine, name)), cut],
            engine == "port")
    with open(os.path.join(WORK, "port-%s.bam" % name), "rb") as f:
        kept = bam.parse_bam(f.read()).n
    same_outputs("bam " + name, os.path.join(WORK, "port-" + name),
                 os.path.join(WORK, "jax-" + name))
    os.remove(cut)
    # all the records: one process, then two gloo processes
    one = os.path.join(WORK, "one")
    walls["sort-bam-keep1-port-%d" % BAM_RECORDS] = run_app(
        "bam_sort", unmapped_args(one, "1") + [one + ".bam", inp], True)
    two = os.path.join(WORK, "two")
    coord = "127.0.0.1:%d" % free_port()
    _, walls["sort-bam-keep1-port-nprocs2-%d" % BAM_RECORDS] = run_job(
        "bam-nprocs2", [
            [sys.executable, "-m", "kmernator_tpu_torch.apps.bam_sort",
             "--device", "cuda", "--distributed", coord, "--nprocs", "2",
             "--procid", str(r)] + unmapped_args(two, "1")
            + [two + ".bam", inp] for r in range(2)], env_with_root())
    if streams(two) != streams(one):
        raise SystemExit("bam: --nprocs 2 gives another header or record "
                         "stream than one process")
    blocks = [bgzf_blocks(x + ".bam") for x in (one, two)]
    if blocks[1][0] != len(header) or blocks[1][-1] != 0:
        raise SystemExit("bam: --nprocs 2 wrote no header block or no EOF "
                         "block of its own")
    for path in list(outputs(one).values()) + list(outputs(two).values()):
        os.remove(path)
    os.remove(inp)
    log("bam: %d records: byte-identical to the JAX apps, BamSort with BAM "
        "output and --keep-unmapped-paired-read 1, with SAM output and 0 "
        "(both with --unmapped-reads and --unmapped-read-pairs, compared "
        "after gzip decompression), FilterAndSortSam --exclude-flags 4 "
        "--min-mapq 20 (%d records kept)" % (BAM_ORACLE_RECORDS, kept))
    log("bam: %d records: --nprocs 2 (gloo) gives the one-process header "
        "and record stream, in %d BGZF blocks (the header its own block of "
        "%d bytes) against one process's %d" % (
            BAM_RECORDS, len(blocks[1]), len(header), len(blocks[0])))
    log("bam: wall time %s [%s]" % (", ".join(
        "%s %.2f s" % kv for kv in walls.items()), smi))
    return {"records": BAM_RECORDS, "oracle_records": BAM_ORACLE_RECORDS,
            "kept_by_filter": kept, "blocks": [len(b) for b in blocks],
            "wall_s": walls}


def phase_small_apps(fq: str, fq_other: str, smi: str):
    """fastq2fasta (plain, --split-pairs 1, --write-qual 1),
    randomly_sample, split_sequence (--num-files 4, every --file-num) and
    compare_spectrums (the input against itself and against fq_other)
    through their CLI entry points, each byte-identical to
    the JAX app run as a separate program; estimate_size, whose JAX app
    imports jax, on the port alone."""
    runs = [("fastq2fasta", "plain", [], ""),
            ("fastq2fasta", "split-pairs", ["--split-pairs", "1"], ""),
            ("fastq2fasta", "write-qual", ["--write-qual", "1"], ""),
            ("randomly_sample", "10000", ["--num-samples", "10000"],
             ".fastq")]
    runs += [("split_sequence", "file%d" % i, ["--num-files", "4",
                                               "--file-num", str(i)],
              ".fastq") for i in range(4)]
    walls, parts, files = {}, [], {}
    for module, tag, args, suffix in runs:
        name = "%s-%s" % (module, tag)
        for engine in ("port", "jax"):
            p = os.path.join(WORK, "%s-%s" % (engine, name))
            walls[name + "-" + engine] = run_app(
                module, args + ["--out", p + suffix, fq], engine == "port")
        if module == "split_sequence":
            parts.append(read_output(os.path.join(WORK, "port-%s.fastq"
                                                  % name)))
        files[name] = same_outputs(name, os.path.join(WORK, "port-" + name),
                                   os.path.join(WORK, "jax-" + name))
    if b"".join(parts) != read_output(fq):
        raise SystemExit("split_sequence: the four parts are not the input")
    spectra = {}
    for tag, ref in (("self", fq), ("other", fq_other)):
        name = "compare_spectrums-" + tag
        for engine in ("port", "jax"):
            p = os.path.join(WORK, "%s-%s" % (engine, name))
            walls[name + "-" + engine] = run_app(
                "compare_spectrums", ["--out", p, "21", ref, fq],
                engine == "port")
        spectra[tag] = read_output(os.path.join(WORK, "port-" + name)
                                   ).decode().splitlines()[-1]
        same_outputs(name, os.path.join(WORK, "port-" + name),
                     os.path.join(WORK, "jax-" + name))
    p = os.path.join(WORK, "port-estimate_size")
    walls["estimate_size-port"] = run_app("estimate_size", [
        "--out", p, "21", fq], True)
    estimate = dict(line.split("\t") for line in read_output(p).decode()
                    .splitlines())
    os.remove(p)
    log("small apps: byte-identical to the JAX apps: %s; compare_spectrums "
        "k=21 against itself: %s; against a second input: %s"
        % (json.dumps(files), spectra["self"], spectra["other"]))
    log("small apps: estimate_size (port only; its JAX app imports jax) "
        "k=21: %s" % json.dumps(estimate))
    log("small apps: wall time %s [%s]" % (", ".join(
        "%s %.2f s" % kv for kv in walls.items()), smi))
    return {"wall_s": walls, "estimate": estimate, "outputs": files}


def phase_pressure(rl, fq32: str, n_reads: int):
    """FilterReads `--streaming --mesh 4 --streaming-parts PRESSURE_ROWS` on
    phase 5's input, so that the shards' drains purge singletons under
    capacity pressure, against the JAX app at `--mesh 4 --jax-platform cpu`
    on four forced CPU devices (a separate program): every output file
    byte-identical, and the same count of singletons purged, warned of by
    both. The input is not cut: the JAX app takes tens of seconds on it."""
    parts = ["--streaming", "--streaming-parts", str(PRESSURE_ROWS)]
    jax_out = os.path.join(WORK, "mesh4-pressure-jax")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
         "--jax-platform", "cpu", "--mesh", "4"] + parts
        + ["--out", jax_out] + FLAGS + [str(K), fq32],
        env=env_with_root(JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=4")),
        capture_output=True, text=True, timeout=600)
    t_jax = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit("mesh4-pressure: the JAX app exited %d:\n%s"
                         % (proc.returncode, proc.stderr[-3000:]))
    r = phase_app("mesh4-pressure", fq32, n_reads, rl, {}, mesh=4,
                  port_args=parts,
                  host_from={"host_out": jax_out, "host_s": t_jax,
                             "host_log": proc.stderr})
    found = re.findall(r"mesh streaming purged (\d+) singletons",
                       proc.stderr)
    if r["purged"] <= 0 or found != [str(r["purged"])]:
        raise SystemExit("mesh4-pressure: the port purged %d singletons, "
                         "the JAX app logged %s" % (r["purged"], found))
    for path in outputs(jax_out).values():
        os.remove(path)
    log("mesh4-pressure: %d singletons purged under capacity pressure by "
        "both, %d reads, %d rows a shard; JAX app at --mesh 4 on 4 CPU "
        "devices %.2f s" % (r["purged"], n_reads, PRESSURE_ROWS, t_jax))
    return r


def phase_mesh_n(rl, ms, hi, fq32, n32, fq_purge, n_purge,
                 purge_args, in_memory, runs, wide, purge_run, mer, asm):
    """Phase 17: --mesh N on one card, every shard on it. FilterReads
    in-memory at --mesh 2 and 4 and at k=63, --streaming --mesh 2 (all on
    phase 5's input) and the purge cell at --mesh 2, each byte-identical to the
    host-engine outputs of phases 5, 9 and 10 with no singleton
    purged; the capacity-pressure run against the JAX app at --mesh 4;
    MeraculousCounter at --mesh 2 (k=21) and --mesh 4 (k=51) against
    phase 11's host outputs, both on phase 5's input; the assembler at
    --mesh 2 (k=45) against phase 12's. Prints each run's wall time, the
    device time of its shard exchange and of its shards' drains (CUDA
    events), run-length launches, overflow retries and peak memory."""
    fr = [phase_app("mesh2-in-memory", fq32, n32, rl, in_memory, mesh=2,
                    host_from=runs[1]),
          phase_app("mesh4-in-memory", fq32, n32, rl, in_memory, mesh=4,
                    host_from=runs[1]),
          phase_app("mesh2-k63", fq32, n32, rl, in_memory, k=63, mesh=2,
                    host_from=wide[1]),
          phase_app("mesh2-streaming", fq32, n32, rl, in_memory, mesh=2,
                    port_args=["--streaming"], host_from=runs[1]),
          phase_app("mesh2-purge", fq_purge, n_purge, rl, in_memory,
                    mesh=2, args=purge_args, host_from=purge_run)]
    for r in fr:
        if r["purged"]:
            raise SystemExit("%s: %d singletons purged" % (r["name"],
                                                          r["purged"]))
    fr.append(phase_pressure(rl, fq32, n32))
    mr = [phase_meraculous("mesh2-meraculous-k21", fq32, n32, rl, 21,
                           mesh=2, host_from=mer[0]),
          phase_meraculous("mesh4-meraculous-k51", fq32, n32, rl, 51,
                           mesh=4, host_from=mer[1])]
    ar = phase_assembler("mesh2-asm-k45", fq32, n32, rl, ms, hi, 45,
                         asm[1]["n_seeds"], asm[1]["iterations"], mesh=2,
                         host_from=asm[1])
    for r in fr + mr:
        log("%s: --mesh %d, %.2f s wall; shard exchange %.1f ms, shards' "
            "%s %.1f ms of device time (CUDA events); run_length launches "
            "%d; %d overflow retries; %s singletons purged; peak device "
            "memory %.2f GiB"
            % (r["name"], r["mesh"], r["port_s"], r["exchange_ms"],
               "drains" if "drain_ms" in r else "counting",
               r.get("drain_ms", r.get("count_ms")), r["launches"],
               r["retries"], r.get("purged", 0), r["peak_gib"]))
    log("%s: --mesh %d, %.2f s wall; shard exchange %.1f ms; index build "
        "%.1f ms of device time (CUDA events); run_length launches 0; %d "
        "overflow retries; peak device memory %.2f GiB"
        % (ar["name"], ar["mesh"], ar["port_s"], ar["exchange_ms"],
           ar["index"]["device_ms"], ar["retries"], ar["peak_gib"]))
    return {"runs": fr + mr, "asm": ar}


# the cross-process shard exchange of phase 18: the device work before the
# transport, and its two copies (parallel/multihost.py all_to_all_planes)
EXCHANGE_DEVICE = ("owners", "bucket_loads", "bucket_slots", "scatter_plane")
COPIES = ("_planes_to_host", "_planes_to_device")


def rank_child(figures: str, argv) -> int:
    """Phase 18's child mode (`python chip_smoke.py --rank-child FIGURES --
    ARGS`): one rank of a --nprocs job, `filter_reads.run(["--device",
    "cuda"] + ARGS)` on the card, with phase 17's instruments: CUDA events
    around the exchange's device work (EXCHANGE_DEVICE), its two copies
    and each shard's drain, the host clock around its gloo collective
    (`all_to_all_rows`), the run-length launches counted from 0 just before
    the run. Writes the rank's figures as JSON to FIGURES; fails if jax or
    the JAX package was loaded."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import kmernator_tpu_torch.apps.filter_reads as app
    from kmernator_tpu_torch.parallel import mesh_stream
    from kmernator_tpu_torch.parallel import multihost
    from kmernator_tpu_torch.parallel import run_length as rl
    tables, events, gloo = [], {}, {"calls": 0, "s": 0.0}

    class Recorded(app.MeshStreamingSpectrum):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tables.append(self)
            self.caps = [self.cap]

        def _maybe_grow(self, *a, **kw):
            super()._maybe_grow(*a, **kw)
            if self.cap != self.caps[-1]:
                self.caps.append(self.cap)

    plain_rows = multihost.all_to_all_rows

    def rows_timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return plain_rows(*a, **kw)
        finally:
            gloo["calls"] += 1
            gloo["s"] += time.perf_counter() - t0

    app.MeshStreamingSpectrum = Recorded
    multihost.all_to_all_rows = rows_timed
    event_timed([(mesh_stream, n) for n in EXCHANGE_DEVICE]
                + [(multihost, n) for n in COPIES]
                + [(mesh_stream.MeshStreamingSpectrum, "_drain_shard")],
                events)
    torch.cuda.reset_peak_memory_stats()
    rl.launches = 0
    before = dict(rl.launches_by_lanes)
    t0 = time.perf_counter()
    rc = app.run(["--device", "cuda"] + list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rl.launches
    by_lanes = lanes_since(rl, before)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "kmernator_tpu"))
    if rc != 0 or loaded or len(tables) != 1:
        print("rank child: rc %d, %d tables, jax modules %s"
              % (rc, len(tables), loaded), file=sys.stderr)
        return 1
    sp = tables[0]
    with open(figures, "w") as f:
        json.dump({
            "rank": multihost.process_index(), "wall_s": wall,
            "device": torch.cuda.get_device_name(sp.device),
            "table_on": str(sp.table_lanes[0].device), "shards": sp.S,
            "mesh": sp.D, "caps": sp.caps, "drains": sp.drains,
            "purged": sp.purged_singletons, "retries": sp.overflow_retries,
            "launches": launches, "by_lanes": by_lanes,
            "exchange_device_ms": events_ms(events, EXCHANGE_DEVICE),
            "d2h_ms": events_ms(events, COPIES[:1]),
            "h2d_ms": events_ms(events, COPIES[1:]),
            "gloo_s": gloo["s"], "exchange_calls": gloo["calls"],
            "drain_ms": events_ms(events, ["_drain_shard"]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}, f)
    return 0


def run_job(name: str, commands, env):
    """Runs `commands`, one a rank of one job, each in a session of its own
    with its output in WORK/<name>.rank<r>.log. A rank that fails, or a
    job past RANK_TIMEOUT, ends every rank and fails the phase. Returns
    each rank's output and the job's wall seconds."""
    logs = [os.path.join(WORK, "%s.rank%d.log" % (name, r))
            for r in range(len(commands))]
    procs = []
    t0 = time.perf_counter()
    try:
        for cmd, path in zip(commands, logs):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=out, stderr=subprocess.STDOUT,
                    start_new_session=True))
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.perf_counter() - t0 > RANK_TIMEOUT:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, 9)
            except ProcessLookupError:
                pass
            p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for path in logs:
        with open(path, errors="replace") as f:
            texts.append(f.read())
        os.remove(path)
    if len(procs) < len(commands) or any(p.returncode != 0 for p in procs):
        raise SystemExit("%s: ranks exited %s after %.1f s (limit %d s):\n%s"
                         % (name, [p.returncode for p in procs], wall,
                            RANK_TIMEOUT, "\n".join(t[-3000:]
                                                    for t in texts)))
    return texts, wall


def nprocs_job(name: str, args):
    """The port's FilterReads with `args` as the NPROCS ranks of one job on
    the card, each rank a child of this script (`rank_child`). Returns each
    rank's figures, with its output under "log", and the job's wall
    seconds."""
    coord = "127.0.0.1:%d" % free_port()
    figs = [os.path.join(WORK, "%s.rank%d.json" % (name, r))
            for r in range(NPROCS)]
    texts, wall = run_job(name, [
        [sys.executable, os.path.abspath(__file__), "--rank-child", figs[r],
         "--"] + list(args) + ["--distributed", coord, "--nprocs",
                               str(NPROCS), "--procid", str(r)]
        for r in range(NPROCS)], env_with_root())
    out = []
    for f, text in zip(figs, texts):
        with open(f) as fh:
            out.append(json.load(fh))
        out[-1]["log"] = text
        os.remove(f)
    return out, wall


def same_files(name: str, mine: dict, want: dict, oracle: str) -> None:
    """The same output files (suffix: path), each byte-identical."""
    if not want or set(mine) != set(want):
        raise SystemExit("%s: output files differ: %s vs %s"
                         % (name, sorted(mine), sorted(want)))
    for suffix in want:
        with open(mine[suffix], "rb") as a, open(want[suffix], "rb") as b:
            if a.read() != b.read():
                raise SystemExit("%s: %s differs from %s"
                                 % (name, suffix, oracle))


def phase_nprocs(cells, smi: str):
    """Phase 18: FilterReads at --nprocs 2 with both ranks on the one card,
    over gloo. cells: (name, input, reads, k, args, oracle) with oracle
    an earlier run's result (its host-engine outputs and log) or None for
    the JAX app at two processes (JAX_PLATFORMS=cpu: the card host's jax
    sees the GPU, and two processes there would each take most of its
    memory). Every output file byte-identical; each rank's table on the
    card and one run-length launch a drain; "Removed N" as the oracle's;
    the singletons purged as the JAX app's (none against the host engine);
    under --gathered-logs, every line printed by rank 0."""
    results = []
    for name, fq, n_reads, k, args, oracle in cells:
        port_out = os.path.join(WORK, name + "-port")
        t_jax = None
        if oracle is None:
            jax_out = os.path.join(WORK, name + "-jax")
            coord = "127.0.0.1:%d" % free_port()
            env = env_with_root(JAX_PLATFORMS="cpu")
            env.pop("XLA_FLAGS", None)
            errs, t_jax = run_job(name + "-jax", [
                [sys.executable, "-m", "kmernator_tpu.apps.filter_reads",
                 "--jax-platform", "cpu"] + args + ["--out", jax_out]
                + FLAGS + [str(k), fq, "--distributed", coord, "--nprocs",
                           str(NPROCS), "--procid", str(r)]
                for r in range(NPROCS)], env)
            oracle = {"host_out": jax_out, "host_log": "\n".join(errs)}
        ranks, wall = nprocs_job(name, args + ["--out", port_out] + FLAGS
                                 + [str(k), fq])
        same_files(name, outputs(port_out), outputs(oracle["host_out"]),
                   "the host engine" if t_jax is None else
                   "the JAX app at --nprocs 2")
        for path in outputs(port_out).values():
            os.remove(path)
        lanes = (k + 31) // 32
        for r in ranks:
            if r["table_on"] != "cuda:0" or r["shards"] != 1 \
                    or r["mesh"] != NPROCS or r["drains"] < 1 \
                    or r["launches"] != r["drains"] \
                    or r["by_lanes"].get(str(lanes), 0) != r["launches"]:
                raise SystemExit("%s: rank %d: table on %s, %d of %d "
                                 "shards, %d drains, run-length launches "
                                 "%s" % (name, r["rank"], r["table_on"],
                                         r["shards"], r["mesh"],
                                         r["drains"], r["by_lanes"]))
        purged = [r["purged"] for r in ranks]
        want = re.findall(r"mesh streaming purged (\d+) singletons",
                          oracle["host_log"])
        if t_jax is not None and (len(set(purged)) != 1 or purged[0] <= 0
                                  or want != [str(purged[0])] * NPROCS):
            raise SystemExit("%s: the ranks purged %s singletons, the JAX "
                             "app logged %s" % (name, purged, want))
        if t_jax is None and any(purged):
            raise SystemExit("%s: %s singletons purged" % (name, purged))
        if "--variant-sigmas" in args:
            found = [re.findall(r"Removed (\d+) kmer-variants", r["log"])
                     for r in ranks]
            host = re.findall(r"Removed (\d+) kmer-variants",
                              oracle["host_log"])
            if len(host) != 1 or found != [host] * NPROCS:
                raise SystemExit("%s: the ranks removed %s, the host "
                                 "engine %s" % (name, found, host))
            log("%s: Removed %s kmer-variants on both ranks and on the "
                "host" % (name, host[0]))
        if "--gathered-logs" in args:
            lines = [re.findall(r"^\S+ \S+ +[0-9.]+ \[(\d+)\] VERBOSE",
                                r["log"], re.M) for r in ranks]
            if lines[1] or sorted(set(lines[0])) != ["0", "1"] \
                    or lines[0] != sorted(lines[0]):
                raise SystemExit("%s: gathered log lines by rank %s"
                                 % (name, lines))
            log("%s: --gathered-logs: rank 0 printed %d lines of ranks "
                "0 and 1 in rank order, rank 1 none"
                % (name, len(lines[0])))
        for r in ranks:
            log("%s: rank %d on %s: %.2f s wall; exchange %d calls, %d "
                "overflow retries: device %.1f ms, D2H %.1f ms, gloo %.2f "
                "s, H2D %.1f ms; %d drains (%.1f ms), run_length launches "
                "by L %s; table %s rows; peak device memory %.2f GiB"
                % (name, r["rank"], r["device"], r["wall_s"],
                   r["exchange_calls"], r["retries"],
                   r["exchange_device_ms"], r["d2h_ms"], r["gloo_s"],
                   r["h2d_ms"], r["drains"], r["drain_ms"], r["by_lanes"],
                   " -> ".join("{:,}".format(c) for c in r["caps"]),
                   r["peak_gib"]))
        log("%s: byte-identical to %s; job %.2f s = %.0f reads/s%s; %s "
            "singletons purged (%s)"
            % (name, "the JAX app at --nprocs 2" if t_jax else
               "the host engine", wall, n_reads / wall,
               "; JAX app at --nprocs 2 on the CPU %.2f s" % t_jax
               if t_jax else "", purged[0], smi))
        if t_jax is not None:
            for path in outputs(oracle["host_out"]).values():
                os.remove(path)
        results.append({"name": name, "k": k, "wall_s": wall,
                        "reads": n_reads, "jax_s": t_jax,
                        "launches": sum(r["launches"] for r in ranks),
                        "by_lanes": {int(L): sum(r["by_lanes"].get(L, 0)
                                                 for r in ranks)
                                     for L in set().union(*(
                                         r["by_lanes"] for r in ranks))},
                        "ranks": [{key: v for key, v in r.items()
                                   if key != "log"} for r in ranks]})
    return results


def drive(rl, fn):
    """fn() with the run-length counts set to 0 just before it: (its
    result, its launches by lane count, read after a synchronize)."""
    rl.launches = 0
    rl.launches_by_lanes.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(rl.launches_by_lanes)


def keys_u64(words: np.ndarray) -> np.ndarray:
    """[N, 2] words (k 17-32) -> [N] uint64 keys in the same order."""
    w = words.astype(np.uint64)
    return (w[:, 0] << np.uint64(32)) | w[:, 1]


def phase_library(rl, smi: str, fq256: str, n256: int, fq32: str,
                  count_ms: float, dev: str = "cuda"):
    """Phase 19: the device library and the entry points on the card, each
    step its own drive (run-length counts zeroed just before it):
    a. entry()'s step bit-equal to entry(device="cpu");
    b. spectrum_step on phase 7's 131,072 reads x 100 bp with seeded phred
       2-40 log2-probabilities (0.5% of bases at -1e30): counts against a
       np.unique oracle under the port's own good mask, that mask against
       the CPU's outside window_good's stated bound of the threshold,
       compact_spectrum of the sorted state against np.unique, lookup_join
       of every window against an np.searchsorted oracle;
    c. StreamingSpectrum through build_streaming on phase 4's FASTQ
       (FastqBatchStream(pack2=True)) at 2^26 rows, against a
       MeshStreamingSpectrum(make_mesh(1)) fed the same batches and good
       masks; then a purge case on phase 5's input at 2^20 rows against
       the CPU run of the same stream;
    d. distributed_spectrum_fn, distributed_count_fn and
       distributed_extension_fn at D = 1, 2 and 4 on (b)'s batch;
    e. dryrun_multichip(n) for n = 1, 2 and 4.
    Every step runs on `dev`, the card (the CPU only to rehearse the phase
    at a small size). Returns the launches by lane count and the
    figures."""
    from kmernator_tpu_torch import entry as E
    from kmernator_tpu_torch.io.stream import FastqBatchStream
    from kmernator_tpu_torch.ops.kmer import encode_lane
    from kmernator_tpu_torch.parallel import device_spectrum as ds
    from kmernator_tpu_torch.parallel import pipeline as pl
    from kmernator_tpu_torch.parallel.mesh import (
        distributed_count_fn, distributed_extension_fn,
        distributed_spectrum_fn, make_mesh)
    from kmernator_tpu_torch.parallel.mesh_stream import (
        MeshStreamingSpectrum)
    lmw = float(np.log2(0.10))
    by_lanes = collections.Counter()
    fig = {}

    def tally(lanes):
        by_lanes.update(lanes)
        return sum(lanes.values())

    # a. the entry point
    fn, args = E.entry(dev)
    got, lanes = drive(rl, lambda: fn(*args))
    fn_c, args_c = E.entry("cpu")
    if not torch.equal(got.cpu(), fn_c(*args_c)):
        raise SystemExit("entry(): the card's counts differ from the CPU's")
    fig["entry_launches"] = tally(lanes)
    log("phase 19a entry(): spectrum_step counts %s on the card, bit-equal "
        "to device='cpu'; run_length launches %d"
        % (tuple(got.shape), fig["entry_launches"]))

    # b. spectrum_step and the library at the count path's full size
    codes, lengths = count_codes()
    rng = np.random.default_rng(19)
    q = rng.integers(2, 41, codes.shape)
    logp = np.log2(1.0 - 10.0 ** (-q / 10.0)).astype(np.float32)
    logp[rng.random(codes.shape) < 0.005] = np.float32(-1e30)
    host = [torch.from_numpy(a) for a in (codes, logp, lengths)]
    dc, dl, dn = (a.to(dev) for a in host)

    def library():
        counts, canon, good = ds.spectrum_step(dc, dl, dn, K)
        state = ds.count_and_score(canon, good, K, 2)[1]
        table = ds.compact_spectrum(*state)
        del state
        looked = ds.lookup_join(table[0], table[1], canon.reshape(-1, 2))
        return counts, canon, good, table, looked

    (counts, canon, good, table, looked), lanes = drive(rl, library)
    fig["library_launches"] = tally(lanes)
    step_ms = cuda_ms(lambda: ds.spectrum_step(dc, dl, dn, K), 3)
    parts_ms = {
        "extract_canonical": cuda_ms(lambda: ds.extract_canonical(dc, dn, K),
                                     3),
        "window_good": cuda_ms(lambda: ds.window_good(dl, dn, K, lmw), 3),
        "count_and_score": cuda_ms(
            lambda: ds.count_and_score(canon, good, K, 2), 3)}
    words = canon.reshape(-1, 2).cpu().numpy()
    if not np.array_equal(words, ds.extract_canonical(
            host[0], host[2], K)[0].reshape(-1, 2).numpy()):
        raise SystemExit("spectrum_step: canonical keys differ from the "
                         "CPU's")
    keys = keys_u64(words)
    g = good.reshape(-1).cpu().numpy()
    u, c = np.unique(keys[g], return_counts=True)
    at = np.minimum(np.searchsorted(u, keys), len(u) - 1)
    seen = np.where(u[at] == keys, c[at], 0).astype(np.int32)
    if not np.array_equal(counts.reshape(-1).cpu().numpy(),
                          np.where(seen >= 2, seen, 0)):
        raise SystemExit("spectrum_step: counts disagree with np.unique")
    w_cpu, g_cpu = ds.window_good(host[1], host[2], K, lmw)
    band = ((w_cpu.double() - lmw).abs()
            <= ds.window_good_bound(host[1])[:, None]).reshape(-1).numpy()
    differ = g != g_cpu.reshape(-1).numpy()
    if (differ & ~band).any():
        raise SystemExit("window_good: the card's good mask differs from "
                         "the CPU's outside the stated bound")
    tk, tc, tn = (x.cpu().numpy() for x in table)
    n = int(tn)
    if not (n == len(u) and np.array_equal(keys_u64(tk[:n]), u)
            and np.array_equal(tc[:n], c) and (tc[n:] == 0).all()):
        raise SystemExit("compact_spectrum disagrees with np.unique")
    if not np.array_equal(looked.cpu().numpy(), seen):
        raise SystemExit("lookup_join disagrees with np.searchsorted")
    fig.update(windows=int(keys.size), good=int(g.sum()), distinct=n,
               band=int(band.sum()), mask_differs=int(differ.sum()),
               step_ms=step_ms, step_parts_ms=parts_ms)
    log("phase 19b spectrum_step: %d windows (%d good, %d in the %s band of "
        "the threshold, %d differ from the CPU's mask, all in it), %d "
        "distinct good keys: counts, compact_spectrum and lookup_join of "
        "every window bit-equal to np.unique / np.searchsorted; "
        "spectrum_step %.4f ms device time (CUDA events; its parts alone: "
        "%s) beside phase 7's count_batch %.4f ms; run_length launches %d "
        "[%s]" % (keys.size, g.sum(), band.sum(), "window_good_bound",
                  differ.sum(), n, step_ms, ", ".join(
                      "%s %.4f ms" % kv for kv in parts_ms.items()),
                  count_ms, fig["library_launches"], smi))
    del table, looked, words, keys, seen, w_cpu, g_cpu

    # c. the streaming build on phase 4's input, then a purge case
    sink, stash = {}, {"codes": [], "good": []}
    plain = event_timed([(pl, "count_batch"), (pl, "merge_tables")], sink)
    plain[(pl, "extract_canonical_cols")] = pl.extract_canonical_cols
    plain[(pl, "window_good")] = pl.window_good

    def keep_codes(codes, lengths, k):
        stash["codes"].append((codes, lengths))
        return plain[(pl, "extract_canonical_cols")](codes, lengths, k)

    def keep_good(*a):
        out = plain[(pl, "window_good")](*a)
        stash["good"].append(out[1])
        return out

    pl.extract_canonical_cols, pl.window_good = keep_codes, keep_good
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        (sk, sc), lanes = drive(rl, lambda: pl.build_streaming(
            FastqBatchStream([fq256], pack2=True), K, STREAM_ROWS,
            min_depth=2, device=dev))
    finally:
        restore_steps(plain)
    wall = time.perf_counter() - t0
    fig["stream_launches"] = tally(lanes)
    n_batches, n_drains = len(sink["count_batch"]), len(sink["merge_tables"])
    if fig["stream_launches"] != n_batches + n_drains:
        raise SystemExit("StreamingSpectrum launched the run-length kernel "
                         "%d times for %d batches and %d drains"
                         % (fig["stream_launches"], n_batches, n_drains))
    dev_ms = events_ms(sink, ("count_batch", "merge_tables"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    windows = sum(int(cd.shape[0]) * (cd.shape[1] - K + 1)
                  for cd, _ in stash["codes"])
    oracle = MeshStreamingSpectrum(make_mesh(1, dev), K,
                                   capacity=STREAM_ROWS)
    for (cd, ln), gd in zip(stash["codes"], stash["good"]):
        oracle.add_batch(cd.cpu().numpy(), gd.cpu().numpy(),
                         ln.cpu().numpy())
    del stash
    ok, oc = oracle.finalize(2)
    if oracle.purged_singletons or not (np.array_equal(sk, ok)
                                        and np.array_equal(sc, oc)):
        raise SystemExit("StreamingSpectrum disagrees with "
                         "MeshStreamingSpectrum(make_mesh(1))")
    del oracle, ok, oc
    fig.update(stream_reads=n256, stream_keys=int(len(sk)),
               stream_batches=n_batches, stream_drains=n_drains,
               stream_device_ms=dev_ms, stream_wall_s=wall,
               stream_windows=windows, stream_peak_gib=peak)
    log("phase 19c StreamingSpectrum: %d reads, %d windows in %d batches, "
        "%d drains, %d keys at count >= 2, bit-equal to "
        "MeshStreamingSpectrum(make_mesh(1)); run_length launches %d "
        "(count_batch %d, merge_tables %d); device %.1f ms (CUDA events), "
        "wall %.2f s, %.4g windows/s; peak device memory %.2f GiB"
        % (n256, windows, n_batches, n_drains, len(sk),
           fig["stream_launches"], n_batches, n_drains, dev_ms, wall,
           windows / wall, peak))
    del sk, sc

    def purge_run(device):
        sp = pl.StreamingSpectrum(K, PURGE_ROWS, device=device)
        stream = FastqBatchStream([fq32], pack2=True)
        for cd, qual, ln in stream:
            sp.add_batch(cd, qual, ln, qual_table=stream.device_table)
        return sp.finalize(2), sp.purged_singletons, sp.drains

    ((pk, pc), purged, drains), lanes = drive(rl, lambda: purge_run(dev))
    fig["purge_launches"] = tally(lanes)
    (ck, cc), c_purged, _ = purge_run("cpu")
    if not (purged == c_purged > 0 and np.array_equal(pk, ck)
            and np.array_equal(pc, cc)):
        raise SystemExit("StreamingSpectrum purge case: the card (%d "
                         "purged) disagrees with the CPU (%d purged)"
                         % (purged, c_purged))
    fig.update(purged=purged, purge_drains=drains, purge_keys=int(len(pk)))
    log("phase 19c purge case (phase 5's input, 2^20 rows): %d singletons "
        "purged in %d drains, %d keys, bit-equal to the CPU run; "
        "run_length launches %d" % (purged, drains, len(pk),
                                    fig["purge_launches"]))

    # d. the shard_map steps at D = 1, 2 and 4 on (b)'s batch
    ext_ok = torch.from_numpy(q >= 20).to(dev)
    ref = None
    for D in (1, 2, 4):
        mesh = make_mesh(D, dev)

        def steps():
            sp = distributed_spectrum_fn(mesh, K)(dc, dl, dn)
            cn = distributed_count_fn(mesh, K)(dc, good, dn)
            ex = distributed_extension_fn(mesh, K)(dc, good, ext_ok, dn)
            return sp, cn, ex

        (sp, cn, ex), lanes = drive(rl, steps)
        fig["dist_launches_D%d" % D] = tally(lanes)
        ms_ = [cuda_ms(lambda: distributed_spectrum_fn(mesh, K)(dc, dl, dn),
                       1),
               cuda_ms(lambda: distributed_count_fn(mesh, K)(dc, good, dn),
                       1),
               cuda_ms(lambda: distributed_extension_fn(mesh, K)(
                   dc, good, ext_ok, dn), 1)]
        # the extension rows of every shard, in key order
        keep = ex[1] > 0
        ext_keys = encode_lane([ex[0][keep, 0], ex[0][keep, 1]])
        order = torch.argsort(ext_keys)
        tab = (ext_keys[order].cpu(), ex[1][keep][order].cpu(),
               ex[2][keep][order].cpu())
        over = int(sp[3].sum()) + int(cn[1].sum()) + int(ex[3].sum())
        total = int(sp[2].sum())
        mine = (sp[0].cpu(), cn[0].cpu(), total, tab)
        if over or not (torch.equal(mine[0], counts.cpu())
                        and torch.equal(mine[1], counts.cpu())):
            raise SystemExit("distributed_*_fn at D = %d: overflow %d or "
                             "counts differ from spectrum_step's" % (D, over))
        if ref is not None and not (total == ref[2] and all(
                torch.equal(a, b) for a, b in zip(tab, ref[3]))):
            raise SystemExit("distributed_*_fn at D = %d differ from D = 1"
                             % D)
        ref = ref or mine
        fig["dist_ms_D%d" % D] = ms_
        log("phase 19d D = %d: distributed_spectrum_fn %.2f ms, "
            "distributed_count_fn %.2f ms, distributed_extension_fn %.2f ms "
            "of device time (CUDA events); counts bit-equal to "
            "spectrum_step's and D = 1's, shard total %d, %d extension "
            "rows equal, overflow 0; run_length launches %d"
            % (D, ms_[0], ms_[1], ms_[2], total, len(tab[0]),
               fig["dist_launches_D%d" % D]))
        del sp, cn, ex, mine
    del dc, dl, dn, good, ext_ok, counts, canon

    # e. the dryrun at 1, 2 and 4 shards
    for n in (1, 2, 4):
        t0 = time.perf_counter()
        _, lanes = drive(rl, lambda: E.dryrun_multichip(n, dev))
        fig["dryrun_s_%d" % n] = time.perf_counter() - t0
        fig["dryrun_launches_%d" % n] = tally(lanes)
        log("phase 19e dryrun_multichip(%d): every assert and byte check "
            "passed in %.2f s wall; run_length launches %d"
            % (n, fig["dryrun_s_%d" % n], fig["dryrun_launches_%d" % n]))
    fig["launches"] = sum(by_lanes.values())
    return dict(by_lanes), fig


# phase 20: k > 96 on phase 5's input. The assembler cell takes the first
# WIDE_ASM_SEEDS of phase 12's asm-k45 seeds with --minimum-coverage 2 on
# both engines: at k = 99 a 150 bp read overlaps a seed's end by at most
# 51 bases, and few seeds reach the default 4.8 reads there. The library
# cell: WIDE_LIB_READS seeded reads of WIDE_LIB_LEN bp at k = WIDE_LIB_K
# (786,432 windows, four-lane keys).
WIDE_ASM_SEEDS, WIDE_ASM_ARGS = 25, ["--minimum-coverage", "2"]
WIDE_LIB_READS, WIDE_LIB_LEN, WIDE_LIB_K = 32768, 150, 127


def first_seeds(path: str, n: int, out: str) -> str:
    """The first n seeds of a draw_seeds FASTA, written to out."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    with open(out, "wb") as f:
        f.write(b"\n".join(lines[:2 * n]) + b"\n")
    return out


def library_wide(rl, smi: str, dev: str = "cuda"):
    """library-k127: spectrum_step and count_batch at k = WIDE_LIB_K on
    WIDE_LIB_READS seeded reads of WIDE_LIB_LEN bp from a 200 kb genome
    (some 25x; 0.2% substitutions,
    phred 30-40 with 0.2% of the bases at phred 2), each a drive of its
    own: the canonical keys the CPU's, spectrum_step's counts and
    count_batch's table bit-equal to a np.unique oracle;
    distributed_count_fn at D = 2 bit-equal to D = 1 and to spectrum_step's
    counts, no overflow. Returns the launches by lane count and the
    figures (device times by CUDA events, peak device memory)."""
    from kmernator_tpu_torch.parallel import device_spectrum as ds
    from kmernator_tpu_torch.parallel.mesh import (distributed_count_fn,
                                                   make_mesh)
    k, B, n_len = WIDE_LIB_K, WIDE_LIB_READS, WIDE_LIB_LEN
    W = (k + 15) // 16
    rng = np.random.default_rng(20)
    genome = rng.integers(0, 4, 200_000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - n_len, B)
    codes = genome[starts[:, None] + np.arange(n_len)[None, :]]
    err = rng.random(codes.shape) < 0.002
    codes = np.where(err, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    q = rng.integers(30, 41, codes.shape)
    q[rng.random(codes.shape) < 0.002] = 2
    logp = np.log2(1.0 - 10.0 ** (-q / 10.0)).astype(np.float32)
    host = [torch.from_numpy(a) for a in
            (codes, logp, np.full(B, n_len, np.int32))]
    dc, dl, dn = (a.to(dev) for a in host)
    by_lanes = collections.Counter()
    fig = {"windows": B * (n_len - k + 1)}
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    (counts, canon, good), lanes = drive(
        rl, lambda: ds.spectrum_step(dc, dl, dn, k))
    fig["step_wall_s"] = time.perf_counter() - t0
    by_lanes.update(lanes)
    fig["step_launches"] = dict(lanes)
    cols = [c.reshape(-1) for c in canon.unbind(-1)]
    gflat = good.reshape(-1)
    table, lanes = drive(rl, lambda: ds.count_batch(cols, gflat, 1))
    by_lanes.update(lanes)
    fig["count_launches"] = dict(lanes)
    fig["step_ms"] = cuda_ms(lambda: ds.spectrum_step(dc, dl, dn, k), 3)
    fig["count_ms"] = cuda_ms(lambda: ds.count_batch(cols, gflat, 1), 3)

    words = canon.reshape(-1, W).cpu().numpy()
    if not np.array_equal(words, ds.extract_canonical(
            host[0], host[2], k)[0].reshape(-1, W).numpy()):
        raise SystemExit("library-k127: canonical keys differ from the "
                         "CPU's")
    g = gflat.cpu().numpy()
    keys = np.ascontiguousarray(words.astype(">u4")).view(
        np.dtype((np.void, 4 * W))).ravel()
    uk, inv = np.unique(keys, return_inverse=True)
    cnt = np.bincount(inv.ravel()[g], minlength=len(uk))
    seen = cnt[inv.ravel()]
    if not np.array_equal(counts.reshape(-1).cpu().numpy(),
                          np.where(seen >= 2, seen, 0)):
        raise SystemExit("library-k127: spectrum_step's counts disagree "
                         "with np.unique")
    tk, tc, tn = (x.cpu().numpy() for x in table)
    kept, present = tc > 0, cnt > 0
    want_keys = np.frombuffer(uk[present].tobytes(), ">u4").reshape(-1, W)
    if not (int(tn) == int(present.sum())
            and np.array_equal(tk[kept], want_keys.astype(np.int64))
            and np.array_equal(tc[kept], cnt[present])
            and (tk[~kept] == 0xFFFFFFFF).all()):
        raise SystemExit("library-k127: count_batch's table disagrees with "
                         "np.unique")
    ref = None
    for D in (1, 2):
        mesh = make_mesh(D, dev)
        (cn, over), lanes = drive(
            rl, lambda: distributed_count_fn(mesh, k)(dc, good, dn))
        by_lanes.update(lanes)
        fig["dist_launches_D%d" % D] = dict(lanes)
        fig["dist_ms_D%d" % D] = cuda_ms(
            lambda: distributed_count_fn(mesh, k)(dc, good, dn), 1)
        if int(over.sum()) or not torch.equal(cn, counts) or (
                ref is not None and not torch.equal(cn, ref)):
            raise SystemExit("library-k127: distributed_count_fn at D = %d "
                             "overflowed (%d) or differs from "
                             "spectrum_step's or D = 1's counts"
                             % (D, int(over.sum())))
        ref = cn
    fig.update(good=int(g.sum()), distinct=int(tn),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("library-k127: %d windows at k=%d (%d-lane keys), %d good, %d "
        "distinct: spectrum_step's counts and count_batch's table "
        "bit-equal to np.unique, distributed_count_fn at D = 1 and 2 to "
        "spectrum_step; spectrum_step %.4f ms, count_batch %.4f ms, "
        "distributed_count_fn %.2f / %.2f ms of device time (CUDA "
        "events); run_length launches by L: step %s, count_batch %s, D = "
        "1 %s, D = 2 %s; peak device memory %.2f GiB [%s]"
        % (fig["windows"], k, (k + 31) // 32, fig["good"], fig["distinct"],
           fig["step_ms"], fig["count_ms"], fig["dist_ms_D1"],
           fig["dist_ms_D2"], fig["step_launches"], fig["count_launches"],
           fig["dist_launches_D1"], fig["dist_launches_D2"],
           fig["peak_gib"], smi))
    fig["launches"] = sum(by_lanes.values())
    return dict(by_lanes), fig


def phase_wide_k(rl, ms, hi, fq32: str, n32: int, in_memory, asm_seeds: str,
                 smi: str):
    """Phase 20: k > 96 on the card, on phase 5's input. FilterReads
    in-memory --mesh 1 at k=97 (W = 7, L = 4: an odd last word) and k=145
    (L = 5), --streaming --mesh 2 at k=127, --streaming --distributed
    --nprocs 1 at k=97 (against the k=97 oracle's outputs),
    MeraculousCounter --mesh 2 at k=101 and the assembler --mesh 1 at k=99
    on WIDE_ASM_SEEDS of phase 12's seeds, each byte-identical to the JAX
    package's host engine at the same k; then library-k127. The host
    engines run as separate programs on the CPU (JAX_PLATFORMS=cpu), all
    started at the phase's start, beside the port's runs on the card.
    Returns (the FilterReads and MeraculousCounter runs, the assembler run,
    the library's launches by lane count, its figures)."""
    cpu = {"JAX_PLATFORMS": "cpu"}
    seeds = first_seeds(asm_seeds, WIDE_ASM_SEEDS,
                        os.path.join(WORK, "asm-k99-seeds.fa"))
    pool = ThreadPoolExecutor(5)
    oracles = {
        name: pool.submit(fr_oracle, name, fq32, k, dict(in_memory, **cpu))
        for name, k in (("wide-k97", 97), ("wide-k127-streaming-mesh2", 127),
                        ("wide-k145", 145))}
    oracles["meraculous-k101-mesh2"] = pool.submit(
        mer_oracle, "meraculous-k101-mesh2", fq32, 101, cpu)
    oracles["asm-k99"] = pool.submit(
        asm_oracle, "asm-k99", fq32, 99, seeds, ASM_ITERATIONS,
        WIDE_ASM_ARGS, cpu)
    try:
        fr = [phase_app("wide-k97", fq32, n32, rl, in_memory, k=97,
                        host_from=oracles["wide-k97"]),
              phase_app("wide-k127-streaming-mesh2", fq32, n32, rl,
                        in_memory, k=127, mesh=2, port_args=["--streaming"],
                        host_from=oracles["wide-k127-streaming-mesh2"]),
              phase_app("wide-k145", fq32, n32, rl, in_memory, k=145,
                        host_from=oracles["wide-k145"])]
        fr.append(phase_distributed("dist-k97", fq32, n32, rl, 97, fr[0],
                                    fr[0]))
        for r in fr:
            log("%s: k=%d, --mesh %d, %.2f s wall; run_length launches by "
                "L %s; %d drains, %.1f ms of device time; %d lookups, %.1f "
                "ms (CUDA events); peak device memory %.2f GiB"
                % (r["name"], r["k"], r["mesh"], r["port_s"], r["by_lanes"],
                   r["drains"], r["drain_ms"], r["lookups"],
                   r["lookup_device_ms"], r["peak_gib"]))
        mer = phase_meraculous("meraculous-k101-mesh2", fq32, n32, rl, 101,
                               mesh=2, host_from=oracles[
                                   "meraculous-k101-mesh2"])
        asm = phase_assembler("asm-k99", fq32, n32, rl, ms, hi, 99,
                              WIDE_ASM_SEEDS, ASM_ITERATIONS, seeds=seeds,
                              args=WIDE_ASM_ARGS,
                              host_from=oracles["asm-k99"])
        lib_lanes, lib = library_wide(rl, smi)
    finally:
        pool.shutdown(wait=True)
        for f in oracles.values():
            if f.exception() is None:
                for path in outputs(f.result()["host_out"]).values():
                    os.remove(path)
        os.remove(seeds)
    return fr + [mer], asm, lib_lanes, lib


def prep_readset(n: int, length: int, seed: int):
    """n seeded reads of `length` bases: ACGT with one N in a thousand,
    phred 2-41 at input base 33."""
    from kmernator_tpu_torch.io.reads import ReadSet
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n * length)]
    seq[rng.random(seq.size) < 1e-3] = ord("N")
    rs = ReadSet()
    rs.seq = seq
    rs.qual = (rng.integers(2, 42, n * length) + 33).astype(np.uint8)
    rs.offsets = np.arange(n + 1, dtype=np.int64) * length
    rs.discarded = np.zeros(n, dtype=bool)
    rs.has_quals = np.ones(n, dtype=bool)
    rs.names = [b""] * n
    rs.comments = [b""] * n
    rs.file_idx = np.zeros(n, dtype=np.int32)
    return rs


def phase_prepare(smi: str) -> dict:
    """The prepare_reads kernel at the benchmark's shapes: bit-equal to
    the host steps (the largest difference over every output measured),
    one launch a call, timed alone, with its copies, and beside the
    host."""
    from kmernator_tpu_torch.parallel import prepare_reads as pr
    pr.launches = 0
    dev = torch.device("cuda")
    out = {"max_abs_err": 0.0}
    for i, (name, n, length, k, L, minq, minkq, ext) in enumerate(
            PREP_SHAPES):
        rs = prep_readset(n, length, 21 + i)
        t0 = time.perf_counter()
        want = pr.prepare_reads_plain(rs, k, L, minq, 33, minkq,
                                      ext_ok=ext)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        before = pr.launches
        t0 = time.perf_counter()
        got = pr.prepare_reads(rs, k, L, minq, 33, minkq, device=dev,
                               ext_ok=ext)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        if pr.launches != before + 1:
            raise SystemExit("prepare_reads %s: %d launches in one call"
                             % (name, pr.launches - before))
        back = 0.0
        if not ext:       # FilterReads copies the chunk's arrays back
            t0 = time.perf_counter()
            [t.cpu() for t in got[:3]]
            back = time.perf_counter() - t0
        err = 0.0
        for a, b in zip(got, want):
            if b is None:
                continue
            a = a.cpu()
            if a.numel():
                err = max(err, (a.double() - b.double()).abs().max().item())
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise SystemExit("prepare_reads %s: the kernel differs from "
                                 "the host steps (largest difference %g)"
                                 % (name, err))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        reads = pr.reads_on_device(rs, dev)
        tabs = pr.device_tables(dev, 33, minq, 33)
        ms_ = cuda_ms(lambda: pr.launch(reads, tabs, n, k, L, minkq,
                                        33 + pr.EXT_MIN_QUALITY, got), 20)
        NW = L - k + 1
        nbytes = 2 * n * length + 9 * n + 8 + n * (L + NW + 4 + (
            L if ext else 0))
        out[name] = {"reads": n, "k": k, "L": L, "kernel_ms": ms_,
                     "max_abs_err": err,
                     "bound_ms": bytes_bound_ms(nbytes), "bytes": nbytes,
                     "call_with_copies_ms": call_s * 1e3,
                     "copy_back_ms": back * 1e3, "host_ms": host_s * 1e3,
                     "windows": int(want.totals[0]),
                     "good": int(want.totals[1])}
        log("phase 21 prepare_reads %s: bit-equal (largest difference %g); "
            "kernel %.4f ms (bound %.4f), call with copies %.1f ms, copy "
            "back %.1f ms, host steps %.1f ms"
            % (name, err, ms_, bytes_bound_ms(nbytes), call_s * 1e3,
               back * 1e3, host_s * 1e3))
        del reads, got, want
    out["launches"] = pr.launches
    out["card"] = smi
    return out


def phase_format_mers(smi: str) -> dict:
    """The format_mers kernels at the benchmark's meraculous table (see
    phase 22 in the module's note)."""
    from kbench import genmeta
    import kmernator_tpu_torch.apps.meraculous_counter as app
    from kmernator_tpu_torch.io.reads import load_reads
    from kmernator_tpu_torch.parallel import format_mers as fm
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "kbench", "traffic", "meta20x.json")) as f:
        traffic = json.load(f)
    fq = os.path.join(WORK, "meta20x.fastq")
    genmeta.write(traffic, 2147483701, fq)
    k, thr = 21, app.dump_threshold(2)
    table = app.build_extension_spectrum_mesh(load_reads([fq]), k, 2, 33,
                                              0.0, 1, device=dev)
    os.remove(fq)
    torch.cuda.synchronize()
    paths = [os.path.join(WORK, "format_mers." + x)
             for x in ("card.mercount", "card.mergraph", "host.mercount",
                       "host.mergraph")]
    fm.launches.clear()
    t0 = time.perf_counter()
    sel = fm.select(table, k, thr)
    plan = fm.write(sel, paths[0], paths[1])
    call_s = time.perf_counter() - t0
    if dict(fm.launches) != {"select": 1, "write": len(plan)}:
        raise SystemExit("format_mers: %s launches for %d slabs"
                         % (dict(fm.launches), len(plan)))
    t0 = time.perf_counter()
    sp = app.spectrum_from_device(k, *table)
    sp.purge_min_depth(app.PURGE_DEPTH)
    app.dump_counts(sp, paths[2], 2)
    app.dump_graphs(sp, paths[3], 2)
    host_s = time.perf_counter() - t0
    for a, b in ((paths[0], paths[2]), (paths[1], paths[3])):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise SystemExit("format_mers: %s differs from the host "
                                 "path's" % os.path.basename(a))
    for path in paths:
        os.remove(path)
    offs = torch.empty_like(sel.offs)
    select_ms = cuda_ms(lambda: fm.launch_select(sel.table, k, thr,
                                                 sel.ptrs, offs), 20)
    buf = torch.empty(max(x.size for x in plan), dtype=torch.uint8,
                      device=dev)
    write_ms = cuda_ms(lambda: [fm.launch_write(sel, x, buf) for x in plan],
                       10)
    M = table.counts.numel()
    nb = len(sel.ends) - 1
    kept, text = int(sel.ends[-1, 2]), int(sel.ends[-1, :2].sum())
    # each byte the work needs once: select reads the counts, the kept
    # keys' counters and writes the blocks' sums; write reads the counts,
    # the kept keys' counters and lanes and writes the text
    select_bytes = 4 * M + 48 * kept + 24 * (nb + 1)
    write_bytes = 4 * M + kept * (48 + 8 * len(table.lanes)) + text
    out = {"keys": M, "kept": kept, "text_bytes": text, "slabs": len(plan),
           "select_ms": select_ms, "select_bound_ms":
           bytes_bound_ms(select_bytes), "write_ms": write_ms,
           "write_bound_ms": bytes_bound_ms(write_bytes),
           "call_ms": call_s * 1e3, "host_ms": host_s * 1e3, "card": smi}
    log("phase 22 format_mers meta20x k=21: byte-identical to the host "
        "path; %d keys, %d kept, %d B of text in %d slabs; select %.4f ms "
        "(bound %.4f), the %d writes %.4f ms (bound %.4f); the call with "
        "its copies and file writes %.1f ms, the host path %.1f ms"
        % (M, kept, text, len(plan), select_ms, out["select_bound_ms"],
           len(plan), write_ms, out["write_bound_ms"], out["call_ms"],
           out["host_ms"]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    runs.append(phase_app("in-memory", fq32, n32, rl, in_memory,
                          keep_host=True))
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
    fq_purge = os.path.join(WORK, "purge42.fastq")
    n_purge = generate(fq_purge, "0.1", genomes="4", coverage="200")
    purge_args = ["--variant-sigmas", "2", "--min-variant-kmer-depth", "20",
                  "--verbose", "1"]
    purge_run = phase_app("purge", fq_purge, n_purge, rl, in_memory,
                          args=purge_args, keep_host=True)
    log("phase 9 on-device variant purge ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    wide = [phase_app("wide-k33", fq32, n32, rl, in_memory, k=33),
            phase_app("wide-k63-streaming", fq32, n32, rl, in_memory, k=63,
                      port_args=["--streaming"], keep_host=True),
            phase_app("wide-k95", fq32, n32, rl, in_memory, k=95)]
    log("phase 10 k > 32 ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    mer = [phase_meraculous("meraculous-k21", fq32, n32, rl, 21,
                            keep_host=True),
           phase_meraculous("meraculous-k51", fq32, n32, rl, 51,
                            keep_host=True)]
    log("phase 11 MeraculousCounter --mesh 1 ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    asm = [phase_assembler("asm-k31", fq32, n32, rl, ms, hi, 31, 50,
                           ASM_ITERATIONS),
           phase_assembler("asm-k45", fq32, n32, rl, ms, hi, 45, 25,
                           ASM_ITERATIONS, keep_host=True)]
    log("phase 12 nucleating assembler --mesh 1 ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    dist = [phase_distributed("dist-streaming", fq32, n32, rl, K,
                              runs[1], runs[1]),
            phase_distributed("dist-k63", fq32, n32, rl, 63, wide[1],
                              wide[1])]
    log("phase 13 --streaming --distributed --nprocs 1 ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    rl.launches = 0
    tnf_run = phase_tnf(smi)
    log("phase 14 TnfDistance ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    bam_run = phase_bam(smi)
    log("phase 15 BamSort and FilterAndSortSam ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    fq_other = os.path.join(WORK, "meta32-seed8.fastq")
    generate(fq_other, "0.75", seed="8")
    small = phase_small_apps(fq32, fq_other, smi)
    os.remove(fq_other)
    if rl.launches:
        raise SystemExit("phases 14-16 launched the run-length kernel")
    log("phase 16 small apps ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    mesh_runs = phase_mesh_n(rl, ms, hi, fq32, n32, fq_purge, n_purge,
                             purge_args, in_memory, runs, wide, purge_run,
                             mer, asm)
    log("phase 17 --mesh N on one card ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    nprocs_runs = phase_nprocs([
        ("nprocs2-streaming", fq32, n32, K, ["--streaming"], runs[1]),
        ("nprocs2-in-memory", fq32, n32, K,
         ["--gathered-logs", "1", "--verbose", "1"], runs[1]),
        ("nprocs2-purge", fq_purge, n_purge, K, purge_args, purge_run),
        ("nprocs2-pressure", fq32, n32, K,
         ["--streaming", "--streaming-parts", str(PRESSURE_ROWS)], None)],
        smi)
    log("phase 18 --nprocs 2 on one card ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    library_lanes, library = phase_library(rl, smi, fq256, n256, fq32,
                                           count["torch_ms"])
    os.remove(fq256)
    log("phase 19 device library and entry points ok [%.1f s]"
        % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    wide_runs, wide_asm, wide_lanes, wide_lib = phase_wide_k(
        rl, ms, hi, fq32, n32, in_memory, asm[1]["seeds"], smi)
    for r in runs[:2] + [wide[1], purge_run] + mer:
        for path in outputs(r["host_out"]).values():
            os.remove(path)
    for path in [fq32, fq_purge, asm[1]["seeds"]] + list(
            outputs(asm[1]["host_out"]).values()):
        os.remove(path)
    log("phase 20 k > 96 ok [%.1f s]" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    prep = phase_prepare(smi)
    log("phase 21 prepare_reads ok [%.1f s]" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    fmt = phase_format_mers(smi)
    log("phase 22 format_mers ok [%.1f s]" % (time.perf_counter() - t0))
    runs += [purge_run] + wide + mer + dist
    launches += sum(r["launches"] for r in [purge_run] + wide + mer + dist)
    runs += mesh_runs["runs"]
    launches += sum(r["launches"] for r in mesh_runs["runs"])
    runs += nprocs_runs
    launches += sum(r["launches"] for r in nprocs_runs)
    launches += library["launches"]
    runs += wide_runs
    launches += sum(r["launches"] for r in wide_runs) + wide_lib["launches"]
    by_lanes = collections.Counter(library_lanes)
    by_lanes.update(wide_lanes)
    for r in runs:
        by_lanes.update(r["by_lanes"])
    by_lanes[1] += count["run_length"]
    by_lanes = dict(sorted(by_lanes.items()))
    if sum(by_lanes.values()) != launches or any(
            by_lanes.get(L, 0) <= 0 for L in (1, 2, 3, 4, 5)):
        raise SystemExit("the main path did not launch the run-length "
                         "kernel at every lane count 1-5 (or the counts "
                         "by lane miss some of its %d launches): %s"
                         % (launches, by_lanes))
    # prepare_reads: counted run by run (one a streamed chunk, one an
    # in-memory FilterReads, MeraculousCounter or assembler run); phase 18's
    # ranks run in processes of their own
    asm_runs = asm + [mesh_runs["asm"], wide_asm]
    prep_launches = sum(r.get("prep_launches", 0) for r in runs + asm_runs)
    if prep_launches <= 0:
        raise SystemExit("the main path never launched prepare_reads")
    log("prepare_reads launches on the app runs of phases 4-20: %d (%s)"
        % (prep_launches, ", ".join("%s %d" % (r["name"], r["prep_launches"])
                                    for r in runs + asm_runs
                                    if r.get("prep_launches"))))
    # format_mers: counted run by run against each MeraculousCounter run's
    # slab plan (phase_meraculous)
    fm_runs = {r["name"]: r["format_mers"] for r in runs
               if "format_mers" in r}
    if not fm_runs:
        raise SystemExit("the main path never launched format_mers")
    log("format_mers launches on the MeraculousCounter runs: %s"
        % json.dumps(fm_runs))

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
        r["name"]: {key: v for key, v in r.items()
                    if key not in ("name", "host_out", "host_log")}
        for r in runs}))
    log("assembler runs (one prepare_reads launch each): %s" % json.dumps({
        r["name"]: {key: v for key, v in r.items()
                    if key not in ("name", "host_out", "seeds")}
        for r in asm_runs}))
    log("TnfDistance, BamSort and small-app runs (no kernel launched): %s"
        % json.dumps({"tnf": tnf_run, "bam": bam_run, "small": small}))
    log("device library and entry points (phase 19): %s"
        % json.dumps(library))
    log("library-k127 (phase 20): %s" % json.dumps(wide_lib))
    log("chip_smoke: every phase passed in %.1f s"
        % (time.perf_counter() - t_start))
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
        "lanes3_bound_ms": times["drain_96M_L3"]["bound"],
        "lanes4_ms": times["drain_96M_L4"]["kernel"],
        "lanes4_plain_ms": times["drain_96M_L4"]["plain"],
        "lanes4_bound_ms": times["drain_96M_L4"]["bound"],
        "lanes5_ms": times["drain_96M_L5"]["kernel"],
        "lanes5_plain_ms": times["drain_96M_L5"]["plain"],
        "lanes5_bound_ms": times["drain_96M_L5"]["bound"]}, {
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
                                                       r["cap_hl"])[1]}, {
        "name": "prepare_reads", "route": "cuda",
        "source": "kmernator_tpu_torch/csrc/prepare_reads.cu",
        "replaces": None,
        "replaces_why": "the JAX package prepares the count path's input "
                        "on the host (float64 window weights)",
        "launches": prep_launches, "max_abs_err": prep["max_abs_err"],
        "ms": prep["meraculous_200k"]["kernel_ms"],
        "plain_ms": prep["meraculous_200k"]["host_ms"],
        "bound_ms": prep["meraculous_200k"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shape": "meraculous_200k: 200,000 reads x 150 bp, k=21",
        "call_with_copies_ms": prep["meraculous_200k"][
            "call_with_copies_ms"],
        "chunk": prep["filter_chunk"]}, {
        "name": "format_mers", "route": "cuda",
        "source": "kmernator_tpu_torch/csrc/format_mers.cu",
        "replaces": None,
        "replaces_why": "the JAX package formats MeraculousCounter's text "
                        "on the host from the table brought back",
        "launches": fm_runs,
        "ms": fmt["select_ms"] + fmt["write_ms"],
        "plain_ms": fmt["host_ms"],
        "bound_ms": fmt["select_bound_ms"] + fmt["write_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shape": "meraculous-k21.meta20x's table: %d keys, %d kept, %d B "
                 "of text" % (fmt["keys"], fmt["kept"], fmt["text_bytes"]),
        "detail": fmt}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-child"] and sys.argv[3:4] == ["--"]:
        sys.exit(rank_child(sys.argv[2], sys.argv[4:]))
    sys.exit(main())
