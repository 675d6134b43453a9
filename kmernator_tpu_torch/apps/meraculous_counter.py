"""MeraculousCounter on PyTorch/CUDA: the port's own copy of the JAX app.

Usage (the JAX app's flags, with --device in place of --jax-platform):
  python -m kmernator_tpu_torch.apps.meraculous_counter --device cuda \
      --mesh 1 --kmer-size 21 --out OUT in.fastq


Re-implements apps/MeraculousCounter.cpp + src/Meraculous.h: builds the
spectrum with extension tracking (minimumWeight = 0, min quality 2) and
writes <out>.mercount.m<k> (canonical kmer + revcomp, each with the total
count) and <out>.mergraph.m<k>.D<minDepth> (kmer + 13 extension counters).
The reference emits in hash-bucket order and its test sorts before diffing
(ref: test/runMeraculousTests.sh:52-60); we emit in sorted canonical-key
order.

Copied for kmernator_tpu_torch from kmernator_tpu/apps/meraculous_counter.py.
The host engines (in-memory, and streaming through disk parts) are the
source's; it differs from its source in its package imports and in these
places:

- `build_extension_spectrum_mesh` (--mesh N) builds the spectrum on N
  shards of a torch device through parallel/mesh.py
  `extension_spectrum_mesh`: each shard's 13 key-run sums come from the
  run-length kernel. Its inputs (`_padded_inputs`: codes, the exact
  weights' goodness, the extension-quality mask, lengths) are built on a
  CUDA device by the prepare_reads kernel from the reads' bytes
  (parallel/prepare_reads.py); the source builds them on the host, as the
  port does on the CPU. On a CUDA device the table stays there
  (`DeviceTable`), and the format_mers kernels write the two files' text
  from it (parallel/format_mers.py), keeping the keys of depth
  `dump_threshold(min_depth)`; only the text comes back. On the CPU
  `spectrum_from_device` carries the table to the host KmerSpectrum that
  the purge and the dumps read, as the source does.
- `build_extension_spectrum_streaming` stores the key of its spill record
  as `pack_keys` makes it: u64 for k <= 32, a big-endian byte string of 4W
  bytes above. The source stores u64 at every k, so its streaming engine
  fails for k > 32.
- `run` takes `--device cuda|cpu` (default cuda; cuda without a visible GPU
  raises) in place of `--jax-platform`. Every engine takes any k, as the
  source does (--mesh N: keys of ceil(k / 32) int64 lanes).
- `run` applies --debug and is a run of the port's tracer
  (utils/timers.py): traced when the tracer is enabled or --debug is 1 or
  more, with spans and counters on the `--mesh` path.
"""
from __future__ import annotations

import os
import sys
from typing import List

import numpy as np
import torch

from kmernator_tpu_torch.io.reads import ReadSet, load_reads, BASE_CODE
from kmernator_tpu_torch.ops.extensions import window_extensions, EXT_MIN_QUALITY
from kmernator_tpu_torch.ops.kmer import (decode_lanes, extract_kmers_flat,
                                          kmer_to_string, nwords,
                                          revcomp_words)
from kmernator_tpu_torch.ops.weights import window_weights, good_kmer_mask
from kmernator_tpu_torch.parallel.mesh import (extension_spectrum_mesh,
                                               make_mesh)
from kmernator_tpu_torch.parallel import format_mers
from kmernator_tpu_torch.parallel.prepare_reads import prepare_reads
from kmernator_tpu_torch.parallel.spectrum import KmerSpectrum, pack_keys, unpack_keys
from kmernator_tpu_torch.utils import timers
from kmernator_tpu_torch.utils.device import resolve_device
from kmernator_tpu_torch.utils.logging import Log
from kmernator_tpu_torch.utils.options import (GeneralOptions, KmerBaseOptions,
                                         KmerSpectrumOptions, compose)

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
PURGE_DEPTH = 2     # the purge before the dumps (weak-map visibility)


def dump_threshold(min_depth: int) -> int:
    """The least count of a key in the two files: the purge of
    PURGE_DEPTH, then each dump's counts >= min_depth."""
    return max(PURGE_DEPTH, min_depth)


def _extension_observations(rs: ReadSet, k: int, min_quality: int,
                            output_base: int, min_kmer_quality: float):
    """Per-window (keys, good, weights f32, is_fwd, ext_left, ext_right)
    of one ReadSet — the observation pipeline shared by the in-memory and
    streaming builders."""
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    canon, is_fwd, read_id, _ = extract_kmers_flat(codes, rs.offsets, k)
    keys = pack_keys(canon)
    p = rs.base_probabilities(min_quality, output_base)
    w = window_weights(p, rs.offsets, markup, k)
    good = good_kmer_mask(w, min_kmer_quality)
    good &= ~rs.discarded[read_id]
    phred = rs.phred()
    hq = np.repeat(rs.has_quals, rs.lengths())
    ext_ok = (phred >= EXT_MIN_QUALITY) | ~hq
    el, er = window_extensions(codes.astype(np.int64), ext_ok, rs.offsets,
                               k, is_fwd)
    return keys, good, w.astype(np.float32), is_fwd, el, er


def build_extension_spectrum(rs: ReadSet, k: int, min_quality: int,
                             output_base: int, min_kmer_quality: float) -> KmerSpectrum:
    keys, good, w, is_fwd, el, er = _extension_observations(
        rs, k, min_quality, output_base, min_kmer_quality)
    return KmerSpectrum.from_observations(k, keys, good, weights=w,
                                          is_fwd=is_fwd, ext_left=el,
                                          ext_right=er)


def build_extension_spectrum_streaming(paths: List[str], k: int,
                                       min_quality: int, output_base: int,
                                       min_kmer_quality: float,
                                       chunk_mb: float = 64.0,
                                       comment_stored: bool = True,
                                       capacity: int = 0) -> KmerSpectrum:
    """Memory-bounded extension-tracking build: chunks stream through
    range-partitioned spill parts holding (key, ext_left, ext_right,
    is_fwd) records for the GOOD windows only, then each part counts
    independently via from_observations and parts concatenate already
    globally sorted — the reference's streaming MPI MeraculousCounter
    build with disk parts instead of ranks (ref: _buildKmerSpectrumMPI,
    src/DistributedFunctions.h:333-458 as used by
    apps/MeraculousCounter.cpp; out-of-core partitioning per
    buildKmerSpectrumInParts, src/KmerSpectrum.h:1818-1902).  The BUILD
    is O(chunk + part) memory, not O(input reads); the returned table
    (and the dumps the caller formats from it) is still O(unique kmers)
    — same as the in-memory path's result, minus the whole-input ReadSet.

    Documented deviation: the weighted-count column (histogram display
    only; never consulted by the mercount/mergraph dumps) is not carried
    through the spill records."""
    import os as _os
    from kmernator_tpu_torch.io.chunked import stream_readsets
    from kmernator_tpu_torch.io.stream import estimate_raw_kmers
    from kmernator_tpu_torch.parallel.spill import (auto_parts,
                                              key_range_splitters)
    from kmernator_tpu_torch.utils.cleanup import register_path, unregister_path
    from kmernator_tpu_torch.utils.memory import fast_temp_dir

    W = nwords(k)
    key_dt = np.dtype(np.uint64) if W <= 2 else np.dtype("S%d" % (4 * W))
    rec_dt = np.dtype([("k", key_dt), ("el", np.int8), ("er", np.int8),
                       ("f", np.uint8)])
    est = estimate_raw_kmers(paths, k)
    num_parts = capacity if capacity > 0 else auto_parts(
        est, rec_bytes=rec_dt.itemsize)
    tmpdir = fast_temp_dir(est * rec_dt.itemsize, "kmtpu-merspill-")
    register_path(tmpdir)
    files = [open(_os.path.join(tmpdir, "part%d.bin" % p), "wb")
             for p in range(num_parts)]
    splitters = None
    raw = good_total = 0
    chunk_bytes = max(int(chunk_mb * (1 << 20)), 1 << 12)
    try:
        for rs in stream_readsets(paths, chunk_bytes, output_base,
                                  comment_stored):
            keys, good, _, is_fwd, el, er = _extension_observations(
                rs, k, min_quality, output_base, min_kmer_quality)
            raw += int(len(keys))
            rec = np.empty(int(good.sum()), rec_dt)
            rec["k"] = keys[good]
            rec["el"] = el[good]
            rec["er"] = er[good]
            rec["f"] = is_fwd[good]
            good_total += len(rec)
            if not len(rec):
                continue
            if splitters is None:
                step = max(1, len(rec) // 65536)
                splitters = key_range_splitters(
                    np.ascontiguousarray(rec["k"][::step]), num_parts)
            part = np.searchsorted(splitters, rec["k"], side="right")
            order = np.argsort(part, kind="stable")
            rec = rec[order]
            bounds = np.concatenate(
                [[0], np.cumsum(np.bincount(part, minlength=num_parts))])
            for p in range(num_parts):
                s, e = int(bounds[p]), int(bounds[p + 1])
                if s != e:
                    files[p].write(rec[s:e].tobytes())
    finally:
        for f in files:
            f.close()
    sp = KmerSpectrum(k=k)
    ks, cs, es, ds = [], [], [], []
    for p in range(num_parts):
        fn = _os.path.join(tmpdir, "part%d.bin" % p)
        rec = np.fromfile(fn, rec_dt)
        _os.unlink(fn)
        if not len(rec):
            continue
        part_sp = KmerSpectrum.from_observations(
            k, rec["k"], np.ones(len(rec), bool),
            is_fwd=rec["f"].astype(bool), ext_left=rec["el"],
            ext_right=rec["er"])
        ks.append(part_sp.keys)
        cs.append(part_sp.counts)
        es.append(part_sp.extensions)
        ds.append(part_sp.direction)
    if ks:
        sp.keys = np.concatenate(ks)
        sp.counts = np.concatenate(cs)
        sp.extensions = np.concatenate(es)
        sp.direction = np.concatenate(ds)
    try:
        _os.rmdir(tmpdir)
        unregister_path(tmpdir)
    except OSError:
        pass
    sp.raw_kmers = raw
    sp.raw_good_kmers = good_total
    return sp


def kmer_strings(keys: np.ndarray, k: int):
    """Vectorized decode of u64 canonical keys + their reverse complements
    to byte strings [M, k]."""
    W = nwords(k)
    words = unpack_keys(keys, W)
    rc = revcomp_words(np, words, k)

    def decode(ws):
        M = len(ws)
        out = np.zeros((M, k), dtype=np.uint8)
        for i in range(k):
            wi, o = divmod(i, 16)
            out[:, i] = _BASES[(ws[:, wi] >> np.uint32(30 - 2 * o)) & np.uint32(3)]
        return out

    return decode(words), decode(rc)


def _emit_lines(strands: np.ndarray, int_cols, col_sep: bytes,
                tail: bytes) -> bytes:
    """Vectorized formatter: every line is <kmer>\\t then each int column
    followed by col_sep, then tail.  Digits are written straight into one
    flat u8 buffer with per-row cursors (no per-row Python, no numpy 'S'
    re-copying) — 10^7 lines format in ~1 s."""
    M, k = strands.shape
    nds = []
    cols = []
    for c in int_cols:
        c = np.ascontiguousarray(c, np.int64)
        mx = int(c.max()) if M else 0
        # digit count via threshold compares (cheaper than divide loops)
        nd = np.ones(M, np.int64)
        t = 10
        while t <= mx:
            nd += c >= t
            t *= 10
        cols.append(c)
        nds.append(nd)
    sep_len = len(col_sep)
    row_len = np.full(M, k + 1 + len(tail), np.int64)
    for nd in nds:
        row_len += nd + sep_len
    off = np.concatenate([[0], np.cumsum(row_len)])
    buf = np.empty(int(off[-1]), np.uint8)
    cursor = off[:-1].copy()
    for j in range(k):  # per-column scatter — no [M, k] index matrix
        buf[cursor + j] = strands[:, j]
    cursor += k
    buf[cursor] = 9  # \t
    cursor += 1
    for c, nd in zip(cols, nds):
        maxd = int(nd.max())
        for j in range(maxd):  # digit j from the left, rows wide enough
            m = nd > j
            p = nd[m] - 1 - j
            buf[cursor[m] + j] = 48 + ((c[m] // 10 ** p) % 10)
        cursor += nd
        for t, ch in enumerate(col_sep):
            buf[cursor + t] = ch
        cursor += sep_len
    for t, ch in enumerate(tail):
        buf[cursor + t] = ch
    return buf.tobytes()


def dump_counts(spectrum: KmerSpectrum, path: str, min_depth: int):
    """ref: MeraculousDistributedKmerSpectrum::dumpCounts
    (Meraculous.h:107-120).  The reference's per-kmer ostream loop becomes
    one vectorized buffer fill; forward/revcomp lines interleave by
    stacking rows before formatting."""
    keep = spectrum.counts >= min_depth
    keys = spectrum.keys[keep]
    counts = spectrum.counts[keep]
    from kmernator_tpu_torch.io import native as native_io
    cc = counts[:, None].astype(np.int64)
    data = native_io.format_mer_lines(keys, cc, cc, spectrum.k,
                                      tail_zero=False)
    if data is None:  # wide-k or no native lib: numpy fallback
        fwd, rc = kmer_strings(keys, spectrum.k)
        M = len(keys)
        strands = np.stack([fwd, rc], axis=1).reshape(2 * M, spectrum.k)
        data = _emit_lines(strands, [np.repeat(counts, 2)], b"", b"\n")
    with open(path, "wb") as f:
        f.write(data)
    timers.count("io.bytes_written", len(data))


def dump_graphs(spectrum: KmerSpectrum, path: str, min_depth: int):
    """ref: dumpGraphs (Meraculous.h:121-133): 2x6 left/right extension
    counters + trailing 0; the revcomp line swaps directions and complements
    bases (ExtensionTracking::getReverseComplement).  Vectorized like
    dump_counts."""
    keep = spectrum.counts >= min_depth
    keys = spectrum.keys[keep]
    ext = spectrum.extensions[keep]
    # reverse-complemented counters: revLeft[rc(b)] = right[b],
    # revRight[rc(b)] = left[b]; as a single column permutation
    # (perm [3,2,1,0,4,5] is an involution, so src[j] = 6+perm[j] | perm[j])
    ext = np.ascontiguousarray(ext, np.int64)
    rev_ext = ext[:, [9, 8, 7, 6, 10, 11, 3, 2, 1, 0, 4, 5]]
    from kmernator_tpu_torch.io import native as native_io
    data = native_io.format_mer_lines(keys, ext, rev_ext, spectrum.k,
                                      tail_zero=True)
    if data is None:  # wide-k or no native lib: numpy fallback
        fwd, rc = kmer_strings(keys, spectrum.k)
        M = len(keys)
        strands = np.stack([fwd, rc], axis=1).reshape(2 * M, spectrum.k)
        both = np.stack([ext, rev_ext], axis=1).reshape(2 * M, 12)
        data = _emit_lines(strands, [both[:, c] for c in range(12)],
                           b" ", b"0\n")
    with open(path, "wb") as f:
        f.write(data)
    timers.count("io.bytes_written", len(data))


def spectrum_from_device(k: int, lanes, counts, ext) -> KmerSpectrum:
    """The device table (parallel/mesh.py count_received_ext: L int64 key
    lanes in key order, int32 counts, int32 [M, 12] extension counters) ->
    the host KmerSpectrum (pack_keys keys, int64 counts and extensions),
    in the same key order: the lanes' order is the keys' word order."""
    W = nwords(k)
    sp = KmerSpectrum(k=k)
    cols = decode_lanes(lanes, W)
    timers.count("device.d2h_bytes", sum(
        t.numel() * t.element_size() for t in cols + [counts, ext]))
    words = np.stack([c.cpu().numpy() for c in cols],
                     axis=1).astype(np.uint32).reshape(-1, W)
    sp.keys = pack_keys(words)
    sp.counts = counts.cpu().numpy().astype(np.int64)
    sp.extensions = ext.cpu().numpy().astype(np.int64)
    return sp


def build_extension_spectrum_mesh(rs: ReadSet, k: int, min_quality: int,
                                  output_base: int, min_kmer_quality: float,
                                  n_devices: int, *, device):
    """The extension-tracking spectrum on n_devices shards of one torch
    device (the JAX app's sharded MeraculousCounter path): exact float64
    weights gate goodness; the inputs, windows, extensions, the exchange
    and the counting run on the device. The reads are padded to a
    multiple of the shards; a bucket overflow retries at twice the
    capacity_factor, from 2.0 up to 32, as the JAX app does. Returns the
    table on a CUDA device (format_mers.DeviceTable), a host KmerSpectrum
    on the CPU."""
    with timers.span("apps.count_pass"):
        mesh = make_mesh(n_devices, device)
        with timers.span("apps.prepare", device=mesh.device):
            prep = _padded_inputs(rs, k, min_quality, output_base,
                                  min_kmer_quality, n_devices,
                                  device=mesh.device)
        args = (prep.codes, prep.good2d, prep.ext_ok2d, prep.lengths)
        if timers.active():
            timers.count("apps.windows_good", int(prep.totals[1]))
            if mesh.device.type == "cpu":   # the kernel counts its copies
                timers.count("device.h2d_bytes", sum(
                    t.numel() * t.element_size() for t in args))
        del prep
        with timers.span("ext.count", device=mesh.device):
            cap = 2.0
            while True:
                lanes, counts, ext, overflow = extension_spectrum_mesh(
                    mesh, k, *args, min_count=1, capacity_factor=cap)
                if not overflow:
                    break
                # hash-skewed input: double per-owner bucket capacity
                cap *= 2.0
                if cap > 32.0:
                    raise RuntimeError(
                        "mesh bucket overflow even at capacity %g" % cap)
                Log.warn("mesh bucket overflow — retrying with "
                         "capacity_factor %g" % cap)
        if mesh.device.type == "cuda":
            return format_mers.DeviceTable(lanes, counts, ext)
        with timers.span("table.to_host"):
            return spectrum_from_device(k, lanes, counts, ext)


def _padded_inputs(rs: ReadSet, k: int, min_quality: int, output_base: int,
                   min_kmer_quality: float, n_devices: int, *, device):
    """The inputs of build_extension_spectrum_mesh, prepare_reads' tensors
    on `device`: codes [B, L] u8, good2d [B, NW] bool
    (the exact weights' goodness), ext_ok2d [B, L] bool, lengths [B] i32
    and the (raw, good) window totals, the reads padded with empty rows to
    a multiple of n_devices. On a CUDA device the prepare_reads kernel
    builds them from the reads' bytes on the card; on the CPU the host's
    NumPy steps do."""
    L = max(rs.max_length(), k)
    return prepare_reads(rs, k, L, min_quality, output_base,
                         min_kmer_quality, device=device,
                         rows=rs.n + (-rs.n) % n_devices, ext_ok=True)


@timers.traced_run
def run(argv: List[str]) -> int:
    """MeraculousCounter. The JAX app's arguments, with --device cuda|cpu
    (default cuda) in place of --jax-platform. A run of the tracer
    (utils/timers.py), as FilterReads' run is."""
    argv = list(argv)
    device_name = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device_name = argv[i + 1]
        del argv[i:i + 2]
    device = resolve_device(device_name)
    opts = GeneralOptions()
    opts.min_quality_score = 2      # ref: MeraculousCounter _resetDefaults
    kopts = KmerBaseOptions()
    sopts = KmerSpectrumOptions()
    sopts.min_kmer_quality = 0.0
    argv = ["--output-file" if a == "--out" else a for a in argv]
    mesh_devices = 0
    if "--mesh" in argv:
        i = argv.index("--mesh")
        mesh_devices = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    streaming = False
    if "--streaming" in argv:
        i = argv.index("--streaming")
        streaming = True
        argv = argv[:i] + argv[i + 1:]
    streaming_chunk_mb = 64.0
    if "--streaming-chunk-mb" in argv:
        i = argv.index("--streaming-chunk-mb")
        streaming_chunk_mb = float(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    streaming_parts = 0
    if "--streaming-parts" in argv:
        i = argv.index("--streaming-parts")
        streaming_parts = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    compose([opts, kopts, sopts], argv, positional=["input-file"])
    Log.verbose_level = opts.verbose
    if getattr(opts, "log_file", ""):
        Log.set_log_file(opts.log_file)
    Log.debug_level = opts.debug
    timers.begin_run(opts.debug)

    k = kopts.kmer_size
    if k == 0:
        Log.error("The Kmer size can not be 0")
        return 1
    if mesh_devices > 0:
        make_mesh(mesh_devices, device)
    # inputs past the in-memory comfort zone auto-select the streaming
    # builder (the reference's MeraculousCounter is the streaming MPI
    # build; this is its bounded-memory single-host analogue)
    total_bytes = sum(os.path.getsize(p) for p in opts.input_file
                      if os.path.exists(p))
    if (not streaming and mesh_devices == 0 and total_bytes > (256 << 20)
            and not any(p.endswith(".gz") for p in opts.input_file)
            and all(open(p, "rb").read(1) == b"@"
                    for p in opts.input_file)):
        Log.verbose(1, "input %.0f MB: auto-selecting the streaming "
                    "builder (pass --streaming to force, --mesh for the "
                    "device path)" % (total_bytes / (1 << 20)))
        streaming = True
    if streaming and mesh_devices == 0:
        spectrum = build_extension_spectrum_streaming(
            opts.input_file, k, opts.min_quality_score,
            opts.fastq_output_base_quality, sopts.min_kmer_quality,
            streaming_chunk_mb, opts.keep_read_comment, streaming_parts)
    else:
        with timers.span("io.parse"):
            rs = load_reads(opts.input_file, opts.fastq_base_quality,
                            opts.fastq_output_base_quality,
                            opts.keep_read_comment)
        timers.count("io.reads", rs.n)
        timers.count("io.bases", len(rs.seq))
        if mesh_devices > 0:
            spectrum = build_extension_spectrum_mesh(
                rs, k, opts.min_quality_score,
                opts.fastq_output_base_quality,
                sopts.min_kmer_quality, mesh_devices, device=device)
        else:
            spectrum = build_extension_spectrum(
                rs, k, opts.min_quality_score,
                opts.fastq_output_base_quality, sopts.min_kmer_quality)
    count_path = "%s.mercount.m%d" % (opts.output_file, k)
    graph_path = "%s.mergraph.m%d.D%d" % (opts.output_file, k,
                                          sopts.min_depth)
    with timers.span("apps.output_pass"):
        if isinstance(spectrum, format_mers.DeviceTable):
            dev = spectrum.counts.device
            with timers.span("apps.purge", device=dev):
                sel = format_mers.select(spectrum, k,
                                         dump_threshold(sopts.min_depth))
            with timers.span("io.output", device=dev):
                format_mers.write(sel, count_path, graph_path)
            return 0
        timers.count("table.keys", len(spectrum.keys))
        with timers.span("apps.purge"):
            spectrum.purge_min_depth(PURGE_DEPTH)
        if timers.active():
            timers.count("io.keys_dumped",
                         int((spectrum.counts >= sopts.min_depth).sum()))
        with timers.span("io.output"):
            dump_counts(spectrum, count_path, sopts.min_depth)
            dump_graphs(spectrum, graph_path, sopts.min_depth)
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
