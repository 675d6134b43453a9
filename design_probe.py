"""Design probes of the run-length and merge kernels on one NVIDIA GPU.

    python3 design_probe.py

Each probe is a copy of a shipped source (csrc/run_length.cu or
csrc/merge_sort.cu) with one design choice undone by a text patch, built
with the package's nvcc flags into build/probe/ (one nvcc each, all started
together) and bound through the package's own wrapper, so it runs exactly
as the shipped kernel does on the main path. Probes:

  run_length.cu
    release_acquire  descriptors stored with st.release and loaded with
                     ld.acquire instead of relaxed whole-word accesses;
    all_lanes_poll   the look-back's 32 lanes poll 32 predecessors at once
                     from the start, without lane 0 waiting alone on the
                     nearest;
    no_look_back     the look-back removed (each tile's carry taken as
                     empty): wrong sums, a floor for the rest of the kernel;
    tile_IxT         I rows a thread, T threads a CTA (shipped: 8 x 256);
  merge_sort.cu
    merge_16         16 rows a thread: 4,096-row output tiles (shipped 8);
    split_launch     the splits searched one thread a tile in a launch
                     before the merge, through a device buffer, instead
                     of by two warps inside the merge kernel;
    split_launch_16  both.

Beside them: a device-to-device copy of the lanes (16 B a row, the bytes
the run-length kernel moves). The shipped kernel and the probes are timed
in turns by CUDA events (shipped, probes, probes reversed, shipped: each
the mean of its two turns) at the main path's shapes: the run-length
kernel at the drain's, the count path's and a count batch's, all merge
levels at the count path's and the drain's. Every probe but no_look_back
is first held bit-equal to the plain version. Prints one line a shape,
the card's `name, power.limit`, and a JSON line of every time. Fails
without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs

PROBE_DIR = os.path.join(cs.ROOT, "build", "probe")

# probe name -> [(text in the shipped source, its replacement), ...]
RUN_LENGTH_PROBES = {
    "release_acquire": [
        ("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64"),
        ("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64")],
    "all_lanes_poll": [("""  unsigned long long d = 0;
  if (lane == 0) {
    do {
      d = load_desc(desc + tile - 1);
    } while ((d >> 62) == 0);
  }
  d = __shfl_sync(full, d, 0);
  Seg run = unpack(d);   // combined descriptors of the tiles already read
  if ((d >> 62) == 2 || ((d >> 32) & 1)) return run;
  for (long long hi = tile - 2;; hi -= 32) {""", """  unsigned long long d = 0;
  Seg run = Seg{0, 0};
  for (long long hi = tile - 1;; hi -= 32) {""")],
    "no_look_back": [("prefix = look_back(desc, tile);",
                      "prefix = Seg{0, 0};")],
}
for items, threads in ((4, 256), (16, 256), (8, 128), (16, 128), (8, 512)):
    RUN_LENGTH_PROBES["tile_%dx%d" % (items, threads)] = [
        ("constexpr int THREADS = 256;",
         "constexpr int THREADS = %d;" % threads),
        ("constexpr int ITEMS = 8;", "constexpr int ITEMS = %d;" % items)]

MERGE_16 = [("constexpr int MERGE_ITEMS = 8;",
             "constexpr int MERGE_ITEMS = 16;")]
SPLIT_LAUNCH = [
    ("// One output tile of T = MERGE_TILE rows a CTA:", """\
__device__ int64_t g_splits[1 << 17];   // a level's tiles + 1 <= 2^17

template <class Pairs>
__global__ void merge_splits(const int64_t* __restrict__ keys, Pairs pairs,
                             int64_t ntiles) {
  const int64_t t = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (t >= ntiles) return;
  int64_t a0, alen, blen, d;
  pairs(t, MERGE_TILE, a0, alen, blen, d);
  const int64_t* A = keys + a0;
  const int64_t* B = A + alen;
  int64_t lo = d - blen > 0 ? d - blen : 0;
  int64_t hi = d < alen ? d : alen;
  while (lo < hi) {
    const int64_t m = (lo + hi) >> 1;
    if (A[m] <= B[d - m - 1]) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  g_splits[t] = lo;
}

// One output tile of T = MERGE_TILE rows a CTA:"""),
    ("""  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t d = dl + warp * rows;
    const int64_t s = d == plen ? alen : warp_merge_path(A, alen, B, blen, d);
    if ((threadIdx.x & 31) == 0) s_split[warp] = s;
  }
  __syncthreads();
  const int64_t a_lo = s_split[0];
  const int64_t a_hi = s_split[1];""", """\
  const int64_t a_lo = g_splits[t];
  const int64_t a_hi = dl + rows == plen ? alen : g_splits[t + 1];"""),
    ("""  merge_tile<<<(unsigned)ntiles, MERGE_THREADS, 0, st>>>(in, out, pairs);""",
     """  merge_splits<<<(unsigned)((ntiles + 255) / 256), 256, 0, st>>>(
      in, pairs, ntiles);
  merge_tile<<<(unsigned)ntiles, MERGE_THREADS, 0, st>>>(in, out, pairs);"""),
]
MERGE_PROBES = {"merge_16": MERGE_16, "split_launch": SPLIT_LAUNCH,
                "split_launch_16": SPLIT_LAUNCH + MERGE_16}


def patch_source(source: str, name: str, patches) -> str:
    """The text of csrc/<source>.cu with the probe's patches applied; each
    patched text must occur in the shipped source."""
    from kmernator_tpu_torch.kernels import build
    with open(os.path.join(build.CSRC_DIR, source + ".cu")) as f:
        text = f.read()
    for old, new in patches:
        if old not in text:
            raise ValueError("probe %s: %r is not in csrc/%s.cu"
                             % (name, old[:60], source))
        text = text.replace(old, new)
    return text


def patched(source: str, name: str, patches) -> str:
    """Write the probe's source to build/probe/; returns its path."""
    path = os.path.join(PROBE_DIR, "%s-%s.cu" % (source, name))
    with open(path, "w") as f:
        f.write(patch_source(source, name, patches))
    return path


def compile_probe(src: str) -> str:
    """nvcc with the package's flags; returns the library path."""
    from kmernator_tpu_torch.kernels import build
    out = src[:-3] + ".so"
    cmd = [build.find_nvcc()] + build.ARCH_FLAGS + [
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out,
        src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit("nvcc failed on %s:\n%s" % (src, proc.stderr))
    return out


def bind(module, path: str):
    """The library at path, its entry points typed by the wrapper module's
    own `_kernel_lib`."""
    from kmernator_tpu_torch.kernels import build
    load, module._lib = build.load, None
    build.load = lambda name: ctypes.CDLL(path)
    try:
        return module._kernel_lib()
    finally:
        build.load, module._lib = load, None


def through(module, lib, fn):
    """fn() with the wrapper module bound to lib."""
    def call():
        saved, module._lib = module._lib, lib
        try:
            return fn()
        finally:
            module._lib = saved
    return call


def in_turns(fns, reps: int):
    """Mean device ms of each fn over its two turns, in order then
    reversed."""
    t = {}
    for key, fn in list(fns.items()) + list(fns.items())[::-1]:
        t.setdefault(key, []).append(cs.cuda_ms(fn, reps))
    return {k: sum(v) / len(v) for k, v in t.items()}


def probe_run_length(rl, libs, count_sorted):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    shapes = {
        "drain_96M": (cs.sorted_lanes(cs.DRAIN_ROWS, 30 << 20, gen, 8 << 20),
                      torch.randint(1, 6, (cs.DRAIN_ROWS,), generator=gen,
                                    device="cuda", dtype=torch.int32)),
        "count_9.2M": (count_sorted, torch.ones(
            count_sorted.numel(), dtype=torch.int32, device="cuda")),
        "count_batch_2048x120": (
            cs.sorted_lanes(cs.BATCH_ROWS, 60000, gen, 9000),
            torch.ones(cs.BATCH_ROWS, dtype=torch.int32, device="cuda"))}
    times = {}
    for shape, (lanes, vals) in shapes.items():
        want = rl.run_length_sums_plain(lanes, vals)
        fns = {"shipped": lambda: rl.run_length_sums(lanes, vals)}
        for name, lib in libs.items():
            fns[name] = through(rl, lib, lambda: rl.run_length_sums(lanes,
                                                                     vals))
            if name != "no_look_back" and not torch.equal(fns[name](), want):
                raise SystemExit("run_length probe %s disagrees with the "
                                 "plain version on %s" % (name, shape))
        copy = torch.empty_like(lanes)
        fns["copy_16B_a_row"] = lambda: copy.copy_(lanes)
        reps = {"drain_96M": 10, "count_9.2M": 50}.get(shape, 200)
        times[shape] = in_turns(fns, reps)
        cs.log("run_length %-22s %s" % (shape, ", ".join(
            "%s %.4f ms" % kv for kv in times[shape].items())))
    return times


def probe_merge(ms, libs, count_path_lanes):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    times = {}
    for shape, lanes in (("count_9.2M", count_path_lanes),
                         ("drain_96M", cs.drain_lanes(gen))):
        padded = ms.pad_to_block(lanes, cs.BLOCK)
        blocks = ms.local_sort_blocks(padded, cs.BLOCK)
        runs = [(i * cs.BLOCK, cs.BLOCK)
                for i in range(padded.numel() // cs.BLOCK)]
        want = torch.sort(padded).values
        fns = {"shipped": lambda: ms.merge_levels(blocks, runs, cs.CHUNK)}
        for name, lib in libs.items():
            fns[name] = through(ms, lib, lambda: ms.merge_levels(
                blocks, runs, cs.CHUNK))
            if not torch.equal(fns[name]()[0], want):
                raise SystemExit("merge probe %s disagrees with torch.sort "
                                 "on %s" % (name, shape))
        times[shape] = in_turns(fns, 5 if shape == "drain_96M" else 20)
        cs.log("merge_levels %-10s %d levels: %s" % (
            shape, (len(runs) - 1).bit_length(), ", ".join(
                "%s %.4f ms" % kv for kv in times[shape].items())))
        del lanes, padded, blocks, want
        torch.cuda.empty_cache()
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("design_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from kmernator_tpu_torch.kernels import build
    from kmernator_tpu_torch.parallel import merge_sort as ms
    from kmernator_tpu_torch.parallel import run_length as rl
    os.makedirs(PROBE_DIR, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    srcs = {("run_length", n): patched("run_length", n, p)
            for n, p in RUN_LENGTH_PROBES.items()}
    srcs.update({("merge_sort", n): patched("merge_sort", n, p)
                 for n, p in MERGE_PROBES.items()})
    with ThreadPoolExecutor(len(srcs) + 2) as pool:
        shipped = [pool.submit(build.build, s)
                   for s in ("run_length", "merge_sort")]
        paths = dict(zip(srcs, pool.map(compile_probe, srcs.values())))
        for f in shipped:
            f.result()
    rl_libs = {n: bind(rl, p) for (s, n), p in paths.items()
               if s == "run_length"}
    ms_libs = {n: bind(ms, p) for (s, n), p in paths.items()
               if s == "merge_sort"}
    codes, lengths = cs.count_codes()
    count_path_lanes = cs.count_lanes(codes, lengths)[2]
    out = {"card": smi,
           "run_length": probe_run_length(
               rl, rl_libs, torch.sort(count_path_lanes).values),
           "merge_levels": probe_merge(ms, ms_libs, count_path_lanes)}
    cs.log(smi)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
