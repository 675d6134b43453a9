"""FilterReads on PyTorch/CUDA: the port's own copy of the JAX app.

Usage (the JAX app's flags, with --device in place of --jax-platform):
  python -m kmernator_tpu_torch.apps.filter_reads --device cuda --mesh 1 \
      --kmer-scoring-type MEDIAN --min-read-length 25 --out OUT 31 in.fastq

Copied for kmernator_tpu_torch from kmernator_tpu/apps/filter_reads.py
(CLI-compatible re-implementation of the reference FilterReads, ref:
apps/FilterReads.cpp:83-215, apps/FilterReads.h:158-282). Every engine
runs here on the port's own code: the host engine without --mesh
(in-memory, and streaming with its fork pool), the in-memory --mesh N
engine and --streaming --mesh N in one process, and across processes
(--distributed HOST:PORT --nprocs N --procid R, one process a rank) the
in-memory engine and --streaming --distributed. It differs from its
source in its package imports and in these places:

- The device seams are the port's: `window_count_lookup_mesh`
  (in-memory --mesh N and --nprocs N), `_chunk_padded`,
  `_streaming_mesh_count` (--streaming --mesh N, and inputs over 2 MB,
  which stream on their own) and `run_streaming_distributed`
  (--streaming --distributed, with grow-on-pressure and its pass-2
  lookups on the device) count and look up on a torch device through
  MeshStreamingSpectrum. Those that touch the device take it as a
  keyword, threaded from `run`. `_chunk_padded` builds the padded arrays
  of a streamed chunk, or of the in-memory --mesh engine's reads, with
  parallel/prepare_reads.py (its kernel on a CUDA device); the source
  builds them on the host. The in-memory --mesh engine sizes its shards
  by the good windows of the reads not discarded, those the table can
  receive; the source counts the discarded reads' good windows too.
- Across processes the table is the port's `multihost.global_mesh`, one
  shard a process on its `--device`, and the processes talk over
  torch.distributed with gloo (`multihost.initialize`), so the shard
  exchange's planes cross the host (parallel/multihost.py
  `all_to_all_planes`); the JAX app runs jax.distributed and XLA
  collectives. Ranks may share one card.
- `run_streaming_distributed` and the two `--mesh` engines take their
  device batch from the port's `auto_mesh_batch` (KMTPU_MESH_BATCH, else
  2,048 reads: the JAX function's answer off a TPU) and their
  collectives from the port's `parallel/multihost.py`.
- `run` takes `--device cuda|cpu` (default cuda; cuda without a visible
  GPU raises) in place of `--jax-platform`. `--distributed X` at one
  process runs with --streaming (or an input that streams on its own) in
  `run_streaming_distributed`, else on the in-memory engine, which
  ignores the coordinator as the JAX app does.
- `--mesh N` runs N shards in one process on the one device (the JAX
  mesh of N devices; parallel/mesh.py). Under --nprocs the mesh count is
  ignored, as in JAX.
  Every engine takes any k, as the source does (the --mesh paths and the
  distributed engines: keys of ceil(k / 32) int64 lanes).
- `run` is a run of the port's tracer (utils/timers.py), and the engines
  record spans and counters where their work happens: traced when the
  tracer is enabled or --debug is 1 or more, off otherwise. The source's
  stage-timing lines, behind an environment variable, are these spans in
  the fork pool's tasks, handed back to the parent's run.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np
import torch

from kmernator_tpu_torch.io.reads import (ReadSet, load_reads, format_read,
                                          format_reads_batch, BASE_CODE)
from kmernator_tpu_torch.ops.artifact import (ArtifactFilter,
                                              apply_artifact_filter)
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
from kmernator_tpu_torch.ops.trim import (ReadTrims, score_and_trim,
                                          pick_all_passing)
from kmernator_tpu_torch.ops.weights import window_weights, good_kmer_mask
from kmernator_tpu_torch.parallel.device_spectrum import (
    auto_mesh_batch, padded_to_ragged)
from kmernator_tpu_torch.parallel.mesh import make_mesh
from kmernator_tpu_torch.parallel.mesh_stream import MeshStreamingSpectrum
from kmernator_tpu_torch.parallel.prepare_reads import prepare_reads
from kmernator_tpu_torch.parallel.spectrum import KmerSpectrum, pack_keys
from kmernator_tpu_torch.utils.device import resolve_device
from kmernator_tpu_torch.utils import timers
from kmernator_tpu_torch.utils.logging import Log
from kmernator_tpu_torch.utils.options import (
    GeneralOptions, KmerBaseOptions, KmerSpectrumOptions, ReadSelectorOptions,
    FilterArtifactOptions, DuplicateFilterOptions, FilterReadsOptions, compose)


def file_prefix(path: str) -> str:
    """ref: Options::getInputFileSubstring (src/Options.h:531-551):
    basename up to the last '.'."""
    base = os.path.basename(path)
    dot = base.rfind(".")
    if dot < 0:
        return base[:len(base) - 1] if base else base
    return base[:dot]


def divert_blobs(rs: ReadSet, out, opts, aopts) -> Dict[str, bytes]:
    """Diverted-read output records for --phix-output / --filter-output
    (ref: FilterKnownOddities::recordAffectedRead -> omPhiX/omArtifact,
    src/FilterKnownOddities.h:551-661; deviation: the reference writes the
    'N' discard placeholder with full-length quals — malformed fastq — we
    write the whole read).  Returns {path: fastq bytes}; shared by the
    in-memory and both streaming engines (which append per chunk)."""
    files: Dict[str, List[bytes]] = {}
    if not opts.output_file:
        return {}
    items: List = []
    if aopts.phix_output:
        items.append(("-PhiX.fastq", [(i, b"") for i in out.phix_reads]))
    if aopts.filter_output:
        items.append(("-Artifact.fastq", out.artifact_reads))
    ph = rs.phred() if any(lst for _, lst in items) else None
    for suffix, lst in items:
        for i, label in lst:
            key = opts.output_file + "-" + file_prefix(
                opts.input_file[rs.file_idx[i]]) + suffix
            rec = format_read(
                rs.names[i], rs.comments[i],
                rs.seq[rs.offsets[i]:rs.offsets[i + 1]].tobytes(),
                ph[rs.offsets[i]:rs.offsets[i + 1]], label, 2,
                opts.fastq_output_base_quality, 0, 1 << 30, False,
                bool(rs.has_quals[i]), opts.keep_read_comment)
            files.setdefault(key, []).append(rec)
    return {p: b"".join(v) for p, v in files.items()}


def build_subtract_keys(reference_files, subtract_files, k, min_quality,
                        output_base, min_kmer_quality, min_depth):
    """Union of kmers to exclude from counting (ref: FilterReads-P.cpp:
    287-308 + KmerSpectrum::subtractReference): every kmer of the
    reference files (not subject to min-depth) plus the abundant
    (>= min-depth) kmers of the subtract files."""
    sets = []
    if reference_files:
        ref = load_reads(list(reference_files), 33, output_base, True)
        sp = build_spectrum(ref, k, min_quality, output_base, min_kmer_quality)
        sets.append(sp.keys)
    if subtract_files:
        sub = load_reads(list(subtract_files), 33, output_base, True)
        sp = build_spectrum(sub, k, min_quality, output_base, min_kmer_quality)
        if min_depth > 1:
            sp.purge_min_depth(max(min_depth, 2))
        sets.append(sp.keys)
    if not sets:
        return None
    return np.unique(np.concatenate(sets))


def build_spectrum(rs: ReadSet, k: int, min_quality: int, output_base: int,
                   min_kmer_quality: float, _keys_out: list = None,
                   subtract_keys: np.ndarray = None) -> KmerSpectrum:
    """Extract canonical kmers + exact weights and count good observations.
    Mirrors _buildKmerSpectrumParallel + append()
    (ref: src/KmerSpectrum.h:1932-2074,1578-1668).
    If _keys_out is a list, the per-window u64 keys are appended to it so
    the scoring lookup can reuse them without re-extracting."""
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    canon, is_fwd, read_id, pos = extract_kmers_flat(codes, rs.offsets, k)
    keys = pack_keys(canon)
    if _keys_out is not None:
        _keys_out.append(keys)
    p = rs.base_probabilities(min_quality, output_base)
    w = window_weights(p, rs.offsets, markup, k)
    good = good_kmer_mask(w, min_kmer_quality)
    # discarded reads contribute nothing (ref: buildWeightedKmers early-out)
    good = good & ~rs.discarded[read_id]
    if subtract_keys is not None and len(subtract_keys):
        idx = np.searchsorted(subtract_keys, keys)
        idx = np.clip(idx, 0, len(subtract_keys) - 1)
        good = good & (subtract_keys[idx] != keys)
    return KmerSpectrum.from_observations(
        k, keys, good, weights=w.astype(np.float32), is_fwd=is_fwd)


def _slice_observations(rs: ReadSet, s: int, e: int, k: int,
                        min_quality: int, output_base: int,
                        min_kmer_quality: float, subtract_keys=None):
    """_chunk_observations over the read range [s, e) without copying the
    ReadSet — the bounded extraction unit of the out-of-core build."""
    off = rs.offsets[s:e + 1]
    seq = rs.seq[off[0]:off[-1]]
    loff = off - off[0]
    codes_raw = BASE_CODE[seq]
    markup = codes_raw == 4
    codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    canon, is_fwd, read_id, _ = extract_kmers_flat(codes, loff, k)
    keys = pack_keys(canon)
    from kmernator_tpu_torch.ops.weights import phred_probability
    ph = rs.phred()[off[0]:off[-1]]
    p = phred_probability(ph, min_quality, output_base)
    lens = np.diff(off)
    hq = np.repeat(rs.has_quals[s:e], lens)
    p = np.where(hq, p, 1.0)
    w = window_weights(p, loff, markup, k)
    good = (good_kmer_mask(w, min_kmer_quality)
            & ~rs.discarded[s:e][read_id])
    if subtract_keys is not None and len(subtract_keys):
        idx = np.clip(np.searchsorted(subtract_keys, keys), 0,
                      len(subtract_keys) - 1)
        good = good & (subtract_keys[idx] != keys)
    return keys, good, w.astype(np.float32)


def build_spectrum_in_parts(rs: ReadSet, k: int, min_quality: int,
                            output_base: int, min_kmer_quality: float,
                            num_parts: int, subtract_keys=None,
                            spill_prefix: str = "",
                            reads_per_slice: int = 65536) -> KmerSpectrum:
    """Out-of-core hash-partitioned build (ref: buildKmerSpectrumInParts,
    src/KmerSpectrum.h:1818-1902): reads are extracted in bounded slices
    and every observation is spilled to its hash part's disk bucket; parts
    are then counted independently — kmer-table peak memory is
    O(slice + windows/parts), never O(all windows)."""
    from kmernator_tpu_torch.parallel.spill import make_spill_counter
    sc = make_spill_counter(k, num_parts)
    for s in range(0, rs.n, reads_per_slice):
        e = min(s + reads_per_slice, rs.n)
        keys, good, w = _slice_observations(rs, s, e, k, min_quality,
                                            output_base, min_kmer_quality,
                                            subtract_keys)
        sc.add(keys, good, w)
    return sc.finalize(min_depth=1)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Append zero rows up to n rows."""
    if a.shape[0] >= n:
        return a
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


def window_count_lookup_mesh(rs, k: int, min_depth: int, min_quality: int,
                             output_base: int, min_kmer_quality: float,
                             n_devices: int, batch_reads: int = 0,
                             capacity: int = 0, variant_sigmas: float = 0.0,
                             variant_hamming: int = 2,
                             min_variant_depth: float = 512.0, *,
                             device: torch.device):
    """In-memory --mesh N counting: pass 1 streams the reads' good windows
    into the n_devices shard tables on the device in batches of a multiple
    of n_devices reads; with variant_sigmas > 0 the tables are purged on
    the device (min depth first, then the variant purge); pass 2 looks
    every window up on the device. Returns the host path's ragged (counts,
    window_offsets). Across processes (--nprocs) the mesh is the global
    one, one shard a process, whatever n_devices: the padded read length,
    the good windows that size the shards and the batch count are agreed
    over the processes (a process with fewer reads feeds empty batches),
    and each process counts its own reads."""
    from kmernator_tpu_torch.parallel import multihost
    multi = multihost.process_count() > 1
    L = max(rs.max_length(), k)
    if multi:
        # all processes must agree on the padded read length
        L = multihost.allreduce_max_int(L)
    codes, good2d, lengths, weights2d, _, n_good = _chunk_padded(
        rs, k, L, min_quality, output_base, min_kmer_quality,
        track_weights=True, device=device)
    B = codes.shape[0]
    NW = L - k + 1
    nw = np.maximum(rs.lengths() - k + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)])

    if multi:
        mesh = multihost.global_mesh(device)
        # good windows summed over the processes size the shards
        n_good = int(multihost.allgather_ints([n_good]).sum())
    else:
        mesh = make_mesh(n_devices, device)
    D, S = mesh.size, mesh.local
    if capacity <= 0:
        capacity = max(int(np.ceil(n_good / D * 1.25)), 4096)
    if batch_reads <= 0:
        batch_reads = auto_mesh_batch(L, k)
        Log.verbose(1, "mesh batch auto-selected: %d reads (L=%d)"
                    % (batch_reads, L))
    batch_reads = max((batch_reads // S) * S, S)
    # every process issues the same collectives: the batch count is the
    # most any process needs
    n_batches = max(-(-B // batch_reads), 1)
    if multi:
        n_batches = multihost.allreduce_max_int(n_batches)
    sp = MeshStreamingSpectrum(mesh, k, capacity=capacity)
    for s in range(0, n_batches * batch_reads, batch_reads):
        sp.add_batch(_pad_rows(codes[s:s + batch_reads], batch_reads),
                     _pad_rows(good2d[s:s + batch_reads], batch_reads),
                     _pad_rows(lengths[s:s + batch_reads], batch_reads),
                     weights2d=_pad_rows(weights2d[s:s + batch_reads],
                                         batch_reads))
    if sp.purged_singletons:
        Log.warn("mesh build purged %d singletons under capacity pressure "
                 "(hash-skewed input; counts may undercount by 1); raise "
                 "--streaming-parts capacity" % sp.purged_singletons)
    if variant_sigmas > 0.0:
        # the on-device variant purge; singletons leave the table first,
        # as on the host path, so they are never purge sources
        sp.purge_min_depth(max(min_depth, 2))
        purged = sp.purge_variants_mesh(variant_sigmas, variant_hamming,
                                        min_variant_depth,
                                        min_depth=max(min_depth, 2))
        Log.verbose(1, "Removed %d kmer-variants (mesh, on-device)" % purged)
    want = np.ones((batch_reads, NW), bool)
    rows = []
    for s in range(0, n_batches * batch_reads, batch_reads):
        c2d = sp.lookup_batch(
            _pad_rows(codes[s:s + batch_reads], batch_reads), want,
            _pad_rows(lengths[s:s + batch_reads], batch_reads),
            min_count=max(min_depth, 2))
        rows.append(c2d[:max(min(batch_reads, B - s), 0)])
    counts2d = np.concatenate(rows)[:B]
    return padded_to_ragged(counts2d, nw).astype(np.int64), woff


def window_count_lookup(rs: ReadSet, spectrum: KmerSpectrum, k: int,
                        keys: np.ndarray = None):
    """Per-window spectrum counts for scoring (ref: setKmerValues,
    src/ReadSelector.h:1064-1076)."""
    if keys is None:
        from kmernator_tpu_torch.io.native import kmer_keys_from_seq
        keys = kmer_keys_from_seq(rs, k)
    if keys is None:
        codes_raw = BASE_CODE[rs.seq]
        codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        from kmernator_tpu_torch.io.native import kmer_keys
        keys = kmer_keys(codes, rs.offsets, k)
        if keys is None:
            canon, _, read_id, _ = extract_kmers_flat(codes, rs.offsets, k)
            keys = pack_keys(canon)
    counts = spectrum.lookup_counts(keys)
    lens = rs.lengths()
    nw = np.maximum(lens - k + 1, 0)
    window_offsets = np.concatenate([[0], np.cumsum(nw)])
    return counts, window_offsets


def first_markup_nor_x(rs: ReadSet) -> np.ndarray:
    """1-based position of the first N or X base per read, 0 = none
    (ref: TwoBitSequence::firstMarkupNorX)."""
    isnx = (rs.seq == ord("N")) | (rs.seq == ord("X"))
    out = np.zeros(rs.n, dtype=np.int64)
    pos = np.flatnonzero(isnx)
    if not len(pos):
        return out
    rid = np.searchsorted(rs.offsets, pos, side="right") - 1
    uniq, first = np.unique(rid, return_index=True)
    out[uniq] = pos[first] - rs.offsets[uniq] + 1
    return out


PART_MARK = "\x00part"  # output-key marker: merged-output part stream


def _part_stream_path(path: str):
    """(real_path, part_idx) for a PART_MARK-marked output key, else
    (path, None)."""
    if PART_MARK in path:
        real, idx = path.split(PART_MARK, 1)
        return real, int(idx)
    return path, None


def _append_blob(path: str, write_fn, written: set, parts: Dict):
    """Route one per-chunk output blob: plain paths append directly
    (truncating on first touch); PART_MARK paths append to their
    per-part temp file for _finalize_parts."""
    real, pi = _part_stream_path(path)
    if pi is None:
        mode = "ab" if path in written else "wb"
        written.add(path)
    else:
        mode = "ab" if (real, pi) in parts else "wb"
        path = parts[(real, pi)] = "%s.part%d.tmp" % (real, pi)
    with open(path, mode) as f:
        start = f.tell()
        write_fn(f)
        timers.count("io.bytes_written", f.tell() - start)


def _finalize_parts(written: set, parts: Dict):
    """Concatenate part streams (ascending part index = source file
    order) onto their real output paths, so the two-file streaming
    engine's merged output is file-sequential like the in-memory path's
    (ref: src/ReadSelector.h:1212-1262 writes file by file)."""
    import shutil
    for real in sorted({r for r, _ in parts}):
        mode = "ab" if real in written else "wb"
        written.add(real)
        with open(real, mode) as f:
            for rp in sorted(k for k in parts if k[0] == real):
                with open(parts[rp], "rb") as src:
                    try:
                        os.sendfile(f.fileno(), src.fileno(), 0,
                                    os.fstat(src.fileno()).st_size)
                    except OSError:
                        shutil.copyfileobj(src, f)
                os.unlink(parts[rp])
    parts.clear()


def _write_picks(rs: ReadSet, trims: ReadTrims, picks, out_name: str,
                 suffix: str, opts, ropts, input_files,
                 outputs: Dict[str, List[bytes]],
                 paired_parts: bool = False):
    pk = np.asarray(picks if isinstance(picks, (list, np.ndarray))
                    else list(picks), dtype=np.int64)
    pk = pk[(pk >= 0) & (pk < rs.n)]
    if not len(pk):
        return
    if ropts.separate_outputs:
        fis = rs.file_idx[pk]
        groups = {("-" + file_prefix(input_files[int(fi)]), ""):
                  pk[fis == fi] for fi in np.unique(fis)}
    elif paired_parts:
        # merged output from the two-file streaming engine: chunks hold
        # file-1 records then their mates, so appending per chunk would
        # interleave the files.  Split each merged output into per-source
        # PART STREAMS (PART_MARK keys, consumed by _append_blob /
        # _finalize_parts) concatenated file-sequentially at close — the
        # reference's merged ordering (ref: src/ReadSelector.h:1212-1262)
        fis = rs.file_idx[pk]
        groups = {("", PART_MARK + "%d" % fi): pk[fis == fi]
                  for fi in np.unique(fis)}
    else:
        groups = {("", ""): pk}
    from kmernator_tpu_torch.io.native import ByteRows
    for (key, tail), g in groups.items():
        if isinstance(trims.label, ByteRows):
            lab = trims.label.gather(g)  # stays columnar end to end
        else:
            lab = [trims.label[i] for i in g]
        rec = format_reads_batch(
            rs, g, lab,
            trims.offset[g], trims.length[g],
            opts.format_output, opts.fastq_output_base_quality,
            comment_stored=opts.keep_read_comment)
        outputs.setdefault(out_name + key + suffix + tail, []).append(rec)


def _pick_coverage_normalized(rs: ReadSet, trims: ReadTrims, target_depth: int,
                              min_score: float, min_length: float,
                              by_pair: bool, both_pass: bool,
                              use_logscale: bool, rng) -> List[int]:
    """RANDOM normalization (ref: pickCoverageNormalizedSubset,
    src/ReadSelector.h:661-749).  The reference uses thread-local rand();
    we use a seeded numpy generator (documented deviation — its own test
    suite does not golden this path either)."""
    from kmernator_tpu_torch.ops.trim import is_passing
    picks: List[int] = []

    def choose(score: int) -> bool:
        if score <= target_depth:
            return True
        choice = int(rng.integers(0, score))
        if use_logscale:
            return choice <= target_depth * np.log(float(score) / float(target_depth))
        return choice <= target_depth

    def pick_if_new(i):
        if 0 <= i < rs.n and trims.available[i]:
            picks.append(i)
            trims.available[i] = False

    for (r1, r2) in rs.pairs:
        p1 = is_passing(rs, trims, r1, min_score, min_length)
        p2 = is_passing(rs, trims, r2, min_score, min_length)
        s1 = int(trims.score[r1]) if p1 else -1
        s2 = int(trims.score[r2]) if p2 else -1
        if by_pair:
            v1, v2 = 0 <= r1 < rs.n, 0 <= r2 < rs.n
            ok = (p1 and p2) if (v1 and v2 and both_pass) else (p1 or p2)
            if not ok:
                continue
            if both_pass and (s1 <= 0 or s2 <= 0):
                continue
            if s1 <= 0 and s2 <= 0:
                continue
            if choose(max(s1, s2)):
                pick_if_new(r1)
                pick_if_new(r2)
        else:
            if s1 > 0 and choose(s1):
                pick_if_new(r1)
            if s2 > 0 and choose(s2):
                pick_if_new(r2)
    picks.sort()
    return picks


def _pick_best_covering(rs: ReadSet, trims: ReadTrims, spectrum, k: int,
                        max_depth: int, min_score: float, min_length: float,
                        both_pass: bool) -> List[int]:
    """OPTIMAL normalization: greedy best-covering-subset with per-kmer
    picked-depth bookkeeping (ref: pickBestCoveringSubsetPairs/Reads,
    src/ReadSelector.h:751-922), simplified to a single-threaded heap.

    Vectorized: every read's trimmed-window kmers are extracted ONCE and
    resolved to spectrum row indices up-front; rescore/account become numpy
    ops over the cached per-read index slice against a picked-depth array
    (no per-kmer Python, no dict)."""
    import heapq
    from kmernator_tpu_torch.ops.trim import is_passing
    from kmernator_tpu_torch.parallel.spectrum import pack_keys
    from kmernator_tpu_torch.ops.kmer import extract_kmers_flat

    codes_raw = BASE_CODE[rs.seq]
    codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
    dup_set = set()

    # one extraction over ALL reads; per-read trimmed slice via offsets
    canon, _, _, _ = extract_kmers_flat(codes, rs.offsets, k)
    all_keys = pack_keys(canon)
    lens = rs.lengths()
    nwin = np.maximum(lens - k + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nwin)])
    tlen = np.where(trims.length >= k, trims.length - k + 1, 0).astype(np.int64)
    toff = woff[:-1] + trims.offset  # window off of the trim start
    M = len(spectrum.keys)
    kidx_cache: Dict[int, np.ndarray] = {}
    cnt_cache: Dict[int, np.ndarray] = {}
    picked_depth = np.zeros(M, np.int64)

    def trimmed_rows(i):
        """(spectrum row idx or M for misses, counts) of read i's trimmed
        kmers, cached."""
        got = kidx_cache.get(i)
        if got is not None:
            return got, cnt_cache[i]
        ks = all_keys[toff[i]:toff[i] + tlen[i]]
        if M:
            idx = np.searchsorted(spectrum.keys, ks)
            idx = np.clip(idx, 0, M - 1)
            hit = spectrum.keys[idx] == ks
            cnt = np.where(hit, spectrum.counts[idx], 0)
            idx = np.where(hit, idx, 0)
        else:
            idx = np.zeros(len(ks), np.int64)
            cnt = np.zeros(len(ks), np.int64)
        kidx_cache[i] = idx
        cnt_cache[i] = cnt
        return idx, cnt

    def rescore(i):
        """Returns (score, blocked); blocked if any kmer at max depth."""
        idx, cnt = trimmed_rows(i)
        present = cnt > 0
        if not present.any():
            return 0.0, False
        pd = picked_depth[idx[present]]
        if (pd >= max_depth).any():
            return -1.0, True
        return float(np.sum(cnt[present] * (max_depth - pd))), False

    def account(i):
        # only spectrum-present kmers are ever consulted by rescore, so
        # absent keys need no bookkeeping (the reference's dict entries for
        # absent keys are write-only)
        idx, cnt = trimmed_rows(i)
        np.add.at(picked_depth, idx[cnt > 0], 1)

    picks: List[int] = []
    by_pair = rs.has_pairs()
    heap = []
    if by_pair:
        items = [(r1, r2) for (r1, r2) in rs.pairs]
    else:
        items = [(i, -1) for i in range(rs.n)]
    for (r1, r2) in items:
        score = 0.0
        ln = 0.0
        ok = False
        for r in (r1, r2):
            if 0 <= r < rs.n and is_passing(rs, trims, r, min_score, min_length):
                sc, blocked = rescore(r)
                if not blocked:
                    score += sc
                    ln += float(trims.length[r])
                    ok = True
        if ok and ln > 0:
            heapq.heappush(heap, (-(score / ln), r1, r2))
    while heap:
        negs, r1, r2 = heapq.heappop(heap)
        score = 0.0
        ln = 0.0
        blocked_any = False
        for r in (r1, r2):
            if 0 <= r < rs.n and trims.available[r]:
                sc, blocked = rescore(r)
                blocked_any |= blocked
                score += max(sc, 0.0)
                ln += float(trims.length[r])
        if ln <= 0 or blocked_any or score <= min_score:
            continue
        new_key = -(score / ln)
        # score dropped since it was queued: re-heap (keys are negative, so
        # "dropped" = new_key strictly above the old key plus tolerance)
        if new_key > negs + abs(negs) * 1e-4 + 1e-12:
            heapq.heappush(heap, (new_key, r1, r2))
            continue
        # pick (with duplicate-fragment suppression, ref: _addDup)
        recs = []
        for r in (r1, r2):
            if 0 <= r < rs.n and trims.available[r]:
                key = rs.get_seq(r)[int(trims.offset[r]):
                                    int(trims.offset[r]) + int(trims.length[r])]
                recs.append((r, key))
        if any(key in dup_set for _, key in recs):
            continue
        for r, key in recs:
            dup_set.add(key)
            trims.available[r] = False
            picks.append(r)
            account(r)
    picks.sort()
    return picks


def select_reads(rs: ReadSet, trims: ReadTrims, spectrum, opts, kopts, sopts,
                 ropts, input_files: List[str],
                 paired_parts: bool = False) -> Dict[str, bytes]:
    """Full selectReads flow (ref: apps/FilterReads.h:158-282): max-kmer-depth
    normalization, partition-by-depth, remainder-trim, or plain all-passing
    selection.  Returns {output_path: bytes}."""
    out_name = opts.output_file
    k = kopts.kmer_size
    min_depth = sopts.min_depth if k > 0 else 0
    suffix = ""
    if ropts.separate_outputs:
        if k > 0:
            out_name += "-MinDepth%d" % min_depth
        suffix = ".fastq" if opts.format_output in (0, 2) else ".fasta"

    outputs: Dict[str, List[bytes]] = {}
    max_kmer_depth = ropts.max_kmer_output_depth

    if max_kmer_depth > 0:
        if ropts.separate_outputs:
            out_name += "-MaxDepth%d" % max_kmer_depth
        if ropts.normalization_method == "RANDOM":
            rng = np.random.default_rng(42)
            picks = _pick_coverage_normalized(
                rs, trims, max_kmer_depth, float(min_depth),
                ropts.min_read_length, rs.has_pairs(),
                ropts.min_passing_in_pair == 2, ropts.use_logscale_above_max, rng)
        else:  # OPTIMAL
            picks = _pick_best_covering(
                rs, trims, spectrum, k, max_kmer_depth, float(min_depth),
                ropts.min_read_length, ropts.min_passing_in_pair == 2)
        _write_picks(rs, trims, picks, out_name, suffix, opts, ropts,
                     input_files, outputs, paired_parts)
    else:
        partition_depth = ropts.partition_by_depth
        is_partitioned = partition_depth > 0
        max_depth = partition_depth if is_partitioned else min_depth
        min_read_length = ropts.min_read_length
        min_passing = ropts.min_passing_in_pair
        has_remainder = False
        depth = max_depth
        while depth >= min_depth:
            tmp_min = max(min_depth, depth)
            if k == 0:
                tmp_min = 0
                depth = 0
            ofname = out_name
            if has_remainder and ropts.separate_outputs:
                ofname += "-Remainder"
            elif is_partitioned and tmp_min > 0 and ropts.separate_outputs:
                ofname += "-PartitionDepth%d" % tmp_min
            picks = pick_all_passing(rs, trims, float(tmp_min),
                                     min_read_length, min_passing == 2)
            _write_picks(rs, trims, picks, ofname, suffix, opts, ropts,
                         input_files, outputs, paired_parts)
            if depth == min_depth or depth == 0:
                if (not has_remainder and is_partitioned
                        and ropts.remainder_trim >= 0.0
                        and (min_passing != 1
                             or int(min_read_length) != ropts.remainder_trim)):
                    min_passing = 1
                    min_read_length = ropts.remainder_trim
                    has_remainder = True
                    depth *= 2
                else:
                    break
            depth //= 2
    return {path: b"".join(recs) for path, recs in outputs.items()}


def _chunk_observations(rs: ReadSet, k: int, min_quality: int,
                        output_base: int, min_kmer_quality: float,
                        subtract_keys=None, want_weights: bool = True):
    """(scalar keys, good mask, f32 weights-or-None) of every window of the
    chunk — the bit-exact host observation pipeline feeding the spill
    counter.  `want_weights=False` skips the weight output entirely (the
    spill counter only stores weights when tracking them)."""
    from kmernator_tpu_torch.io.native import observe_chunk
    fused = observe_chunk(rs, k, min_quality, output_base, min_kmer_quality,
                          want_weights=want_weights)
    if fused is not None:
        keys, good, w = fused
    else:
        codes_raw = BASE_CODE[rs.seq]
        markup = codes_raw == 4
        codes = np.where(markup, 0, codes_raw).astype(np.uint8)
        p = rs.base_probabilities(min_quality, output_base)
        lens = rs.lengths()
        nwr = np.maximum(lens - k + 1, 0)
        read_id = np.repeat(np.arange(rs.n), nwr)
        from kmernator_tpu_torch.io.native import kmer_observe
        native = kmer_observe(codes, markup, p, rs.offsets, k)
        if native is not None:
            keys, w = native
        else:
            canon, _, read_id, _ = extract_kmers_flat(codes, rs.offsets, k)
            from kmernator_tpu_torch.parallel.spectrum import pack_keys
            keys = pack_keys(canon)
            w = window_weights(p, rs.offsets, markup, k)
        good = good_kmer_mask(w, min_kmer_quality) & ~rs.discarded[read_id]
        w = w.astype(np.float32)
    if subtract_keys is not None and len(subtract_keys):
        idx = np.clip(np.searchsorted(subtract_keys, keys), 0,
                      len(subtract_keys) - 1)
        good = good & (subtract_keys[idx] != keys)
    return keys, good, w


def _chunk_padded(rs, k: int, L: int, min_quality: int, output_base: int,
                  min_kmer_quality: float, subtract_keys=None,
                  track_weights: bool = False, *, device):
    """A block of reads (a streamed chunk, or the in-memory --mesh
    engine's reads) -> padded batch arrays: codes [B, L] u8, good2d [B, NW]
    bool (exact goodness, false for a discarded read), lengths [B] i32,
    weights2d [B, NW] f32 or None, and the block's (raw, good) window
    totals (good: the true entries of good2d). On a CUDA `device`
    the prepare_reads kernel builds them on the card and they come back to
    the host in one copy each, every device buffer freed before the
    return; on the CPU the host's NumPy steps do."""
    NW = L - k + 1
    prep = prepare_reads(rs, k, L, min_quality, output_base,
                         min_kmer_quality, device=device,
                         weights=track_weights)
    on_card = prep.codes.device.type != "cpu"
    host = [None if t is None else t.cpu().numpy() for t in
            (prep.codes, prep.good2d, prep.lengths, prep.weights2d,
             prep.totals)]
    del prep
    if on_card:
        timers.count("device.d2h_bytes", sum(a.nbytes for a in host
                                             if a is not None))
    codes, good2d, lengths, weights2d, totals = host
    raw, good = int(totals[0]), int(totals[1])
    if subtract_keys is not None and len(subtract_keys):
        codes_raw = BASE_CODE[rs.seq]
        cds = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        canon, _, _, _ = extract_kmers_flat(cds, rs.offsets, k)
        keys = pack_keys(canon)
        idx = np.clip(np.searchsorted(subtract_keys, keys), 0,
                      len(subtract_keys) - 1)
        nw = np.maximum(rs.lengths() - k + 1, 0)
        windows = np.arange(NW) < nw[:, None]
        good2d[windows] &= subtract_keys[idx] != keys
        good = int(good2d.sum())
    return codes, good2d, lengths, weights2d, raw, good


def _streaming_mesh_count(chunks, input_files, k, min_quality, output_base,
                          min_kmer_quality, mesh_devices, batch_reads,
                          capacity, subtract_keys, track_w, *,
                          device: torch.device) -> KmerSpectrum:
    """Pass 1 of --streaming --mesh N: every chunk's good windows stream
    into the mesh_devices shard tables on the device; the host never holds
    more than one chunk."""
    from kmernator_tpu_torch.io.stream import estimate_raw_kmers
    with timers.span("apps.count_pass"):
        if capacity <= 0:
            # the JAX package's per-device clamp: the estimate, at most 64M
            # rows
            est = estimate_raw_kmers(input_files, k)
            capacity = min(max(int(np.ceil(est / mesh_devices)), 4096),
                           64 << 20)
        sp = MeshStreamingSpectrum(make_mesh(mesh_devices, device), k,
                                   capacity=capacity)
        raw = good_total = n_reads = 0
        L = 0
        for rs in chunks:
            need = max(rs.max_length(), k)
            if need > L:
                L = -(-need // 32) * 32  # bucketed pad length
            if batch_reads <= 0:
                batch_reads = auto_mesh_batch(L, k)
                Log.verbose(1, "mesh batch auto-selected: %d reads (L=%d)"
                            % (batch_reads, L))
            with timers.span("apps.prepare", device=device):
                codes, good2d, lengths, weights2d, r, g = _chunk_padded(
                    rs, k, L, min_quality, output_base, min_kmer_quality,
                    subtract_keys, track_w, device=device)
            timers.count("apps.windows_good", g)
            raw += r
            good_total += g
            for s in range(0, codes.shape[0], batch_reads):
                bw = weights2d[s:s + batch_reads] if weights2d is not None \
                    else None
                with timers.span("table.add"):
                    sp.add_batch(
                        _pad_rows(codes[s:s + batch_reads], batch_reads),
                        _pad_rows(good2d[s:s + batch_reads], batch_reads),
                        _pad_rows(lengths[s:s + batch_reads], batch_reads),
                        weights2d=None if bw is None
                        else _pad_rows(bw, batch_reads))
            n_reads += rs.n
        if sp.purged_singletons:
            Log.warn("mesh streaming purged %d singletons under capacity "
                     "pressure (counts may undercount by 1); raise "
                     "--streaming-parts capacity" % sp.purged_singletons)
        with timers.span("table.to_host"):
            spectrum = sp.to_host_spectrum(min_depth=1)
    spectrum.raw_kmers = raw
    spectrum.raw_good_kmers = good_total
    Log.verbose(1, "mesh-streamed %d reads on %s; spectrum: %d unique kmers"
                % (n_reads, device, spectrum.n_unique))
    return spectrum


# ---- parallel streaming (fork worker pools; ref: the reference's OpenMP
# chunk loops, e.g. src/KmerSpectrum.h:1578-1668 run under omp parallel) ----
# context is populated before Pool creation so forked workers inherit it
_PAR: Dict = {}


def _par_scan_path(ci: int):
    d = _PAR["scan_dir"]
    return os.path.join(d, "%06d.npz" % ci) if d else None


def _rs_cache_path(ci: int):
    d = _PAR.get("p2_dir") if _PAR.get("rs_cache") else None
    return os.path.join(d, "c%06d.rs.pkl" % ci) if d else None


def _rs_cache_write(path: str, rs: ReadSet):
    """Persist the parsed pre-filter chunk for pass 2 (columnar arrays +
    newline-joined name/comment blobs + the identified pairs) so pass 2
    skips the FASTQ re-parse and pair re-identification."""
    import pickle
    pr = np.asarray(rs.pairs, dtype=np.int64).reshape(-1, 2)
    blob = (b"\n".join(rs.names), b"\n".join(rs.comments), rs.seq, rs.qual,
            rs.offsets, rs.has_quals, rs.file_idx, pr, rs.input_qual_base)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(blob, f, protocol=5)
    os.replace(path + ".tmp", path)


def _rs_cache_read(path: str) -> ReadSet:
    import pickle
    with open(path, "rb") as f:
        nb, cb, seq, qual, offsets, hq, fidx, pr, iqb = pickle.load(f)
    rs = ReadSet()
    n = len(offsets) - 1
    rs.names = nb.split(b"\n") if n else []
    rs.comments = cb.split(b"\n") if n else []
    rs.seq, rs.qual, rs.offsets = seq, qual, offsets
    rs.has_quals, rs.file_idx = hq, fidx
    rs.discarded = np.zeros(n, dtype=bool)
    rs.input_qual_base = int(iqb)
    rs.pairs = [(int(a), int(b)) for a, b in pr]
    os.unlink(path)
    return rs


def _par_load_chunk(args, replay: bool):
    """Shared chunk setup for both passes: parse + artifact filter (scan
    saved on pass 1, replayed on pass 2).  Returns (rs, outcome|None)."""
    from kmernator_tpu_torch.io.chunked import read_chunk, read_chunk_paired
    c = _PAR
    ci = args[0]
    cp = _rs_cache_path(ci)
    with timers.span("io.parse"):
        if replay and cp and os.path.exists(cp):
            rs = _rs_cache_read(cp)
        else:
            if c.get("paired_paths"):
                ci, s1, e1, s2, e2 = args
                p1, p2 = c["paired_paths"]
                rs = read_chunk_paired(p1, p2, (s1, e1, s2, e2), c["base"],
                                       c["comment_stored"])
            else:
                ci, fi, path, s, e = args
                rs = read_chunk(path, s, e, c["base"], c["comment_stored"],
                                fi)
            # pairs identify BEFORE the filter (ref: FilterReads.cpp:103
            # then :114): remnant reads the filter appends never join
            # rs.pairs, so the pair-driven picks skip them (they feed the
            # spectrum only)
            rs.identify_pairs()
            if not replay and cp:
                _rs_cache_write(cp, rs)
    o = None
    if c["filt"] is not None:
        with timers.span("ops.artifact"):
            sp = _par_scan_path(ci)
            pre = None
            if replay and sp and os.path.exists(sp):
                with np.load(sp) as z:
                    pre = tuple(z[f] for f in
                                ("sv", "smn", "smx", "sso", "ssl", "sph"))
            o = apply_artifact_filter(rs, c["filt"], precomputed=pre)
            if not replay and sp:
                sv, smn, smx, sso, ssl, sph = o.scan
                np.savez(sp, sv=sv, smn=smn, smx=smx, sso=sso, ssl=ssl,
                         sph=sph)
    return rs, o


# per-process (worker or parent) persistent spill counter: observations
# aggregate in a native hash ACROSS chunks and spill only under memory
# pressure — spill IO and finalize hashing shrink by the dataset's
# duplication factor (ref: spill-under-pressure build,
# src/KmerSpectrum.h:1818-1902).  Re-created on PID change so fork
# children never share the parent's table or append fds.
_WSPILL = None
_WSPILL_PID = 0


def _worker_spill():
    global _WSPILL, _WSPILL_PID
    c = _PAR
    if _WSPILL is None or _WSPILL_PID != os.getpid():
        from kmernator_tpu_torch.parallel.spill import make_spill_counter
        _WSPILL = make_spill_counter(
            c["k"], c["num_parts"], tmpdir=c["spill_dir"],
            track_weights=c["track_w"], splitters=c["splitters"],
            suffix="w%d" % os.getpid(),
            cap_slots=c.get("agg_slots", 1 << 22))
        _WSPILL_PID = os.getpid()
    return _WSPILL


def _flush_worker_spill():
    """Flush + close this process's persistent spill counter (if any)."""
    global _WSPILL
    if _WSPILL is not None and _WSPILL_PID == os.getpid():
        _WSPILL.close()
        _WSPILL = None


def _par_flush_spill(_):
    """Pool task: rendezvous so every worker flushes exactly once (the
    barrier holds each worker until all have a flush task)."""
    b = _PAR.get("flush_barrier")
    if b is not None:
        b.wait(timeout=600)
    _flush_worker_spill()
    return 0


_CG_BUFS = [None, None]  # per-process compact_good reusable buffers

_P2SPEC = [None, 0]  # per-process pass-2 spectrum (memmap), keyed by pid


def _p2_spectrum():
    """The finalized spectrum, reconstructed once per worker from the
    parent's read-only tmpfs memmaps (spec_keys/spec_counts/spec_slots in
    p2_dir) — one page-cache copy shared by every worker, no per-worker
    hash rebuild and no fork-COW faulting.  None when pass 1 built no
    spectrum (k <= 0)."""
    c = _PAR
    if _P2SPEC[1] != os.getpid():
        _P2SPEC[0] = False
        _P2SPEC[1] = os.getpid()
    if _P2SPEC[0] is not False:
        return _P2SPEC[0]
    sp = c.get("spectrum")
    d = c.get("p2_dir")
    if sp is None and d and os.path.exists(os.path.join(d, "spec_ready")):
        sp = KmerSpectrum(k=c["k"])
        sp.keys = np.load(os.path.join(d, "spec_keys.npy"), mmap_mode="r")
        sp.counts = np.load(os.path.join(d, "spec_counts.npy"),
                            mmap_mode="r")
        slots_fn = os.path.join(d, "spec_slots.npy")
        if os.path.exists(slots_fn):
            from kmernator_tpu_torch.io.native import HashTable
            sp._hash = (sp.keys, HashTable.from_slots(
                np.load(slots_fn, mmap_mode="r")))
    _P2SPEC[0] = sp
    return sp


def _par_pass1(args):
    """Count one chunk: into the SHARED CAS table when one is active
    (remainder past its load stop diverts to the private spill), else
    into the process-persistent aggregated spill. Returns (reads, raw
    windows, good windows, key dtype, splitters, the task's spans)."""
    mark = timers.task_mark()
    counts = _par_count_chunk(args)
    return counts + (timers.task_spans(mark),)


def _par_count_chunk(args):
    c = _PAR
    rs, _ = _par_load_chunk(args, replay=False)
    if c["k"] <= 0:
        return rs.n, 0, 0, None, None
    with timers.span("apps.prepare"):
        keys, good, w = _chunk_observations(
            rs, c["k"], c["min_quality"], c["output_base"], c["min_kq"],
            c["subtract_keys"], want_weights=c["track_w"])
    with timers.span("table.spill"):
        shct = c.get("shct")
        if shct is not None:
            from kmernator_tpu_torch.io.native import compact_good
            got = compact_good(keys, good, None, _CG_BUFS[0], _CG_BUFS[1])
            if got is not None:
                gk, _, _CG_BUFS[0], _CG_BUFS[1] = got
            else:
                gk = keys[good]
            consumed = shct.insert(gk)
            if consumed < len(gk):
                sc = _worker_spill()
                rem = np.ascontiguousarray(gk[consumed:])
                sc.add(rem, np.ones(len(rem), bool))
                sc.raw_kmers -= len(rem)       # raw/good tallied below, once
                sc.raw_good_kmers -= len(rem)
            return (rs.n, len(keys), len(gk), np.dtype(np.uint64),
                    c.get("splitters"))
        sc = _worker_spill()
        r0, g0 = sc.raw_kmers, sc.raw_good_kmers
        sc.add(keys, good, w)
    return (rs.n, sc.raw_kmers - r0, sc.raw_good_kmers - g0,
            sc.key_dtype, sc.splitters)


def _iter_pool(it, n_tasks: int, what: str, timeout_s: float = 0.0):
    """Consume a Pool imap/imap_unordered iterator with a per-item
    timeout.  multiprocessing.Pool hangs FOREVER when a worker dies
    (SIGKILL/OOM/native crash) mid-task; this converts that silent hang
    into a hard error naming the phase — the streaming engine's failure
    detector (ref: the reference aborts the MPI world on worker death,
    src/MPIUtils.h).  The per-item timeout defaults to 900 s, tunable via
    KMTPU_POOL_TIMEOUT_S: the JAX package's development host (a CPU
    machine, not the H100's host) has measured >10x bimodal wall
    time under neighbor load (13 s vs 150 s for an identical 1 GiB run),
    so a loaded VM with large chunks can legitimately exceed a fixed
    cap while every worker is alive."""
    import multiprocessing as mp
    if timeout_s <= 0:
        timeout_s = float(os.environ.get("KMTPU_POOL_TIMEOUT_S", "900"))
    for _ in range(n_tasks):
        try:
            yield it.next(timeout=timeout_s)
        except mp.TimeoutError:
            raise RuntimeError(
                "%s: no chunk completed in %.0f s — a pool worker "
                "likely died (OOM or native crash); raise "
                "KMTPU_POOL_TIMEOUT_S if the host is merely overloaded"
                % (what, timeout_s))


def _par_pass2(args):
    """Score one chunk against the finalized spectrum -> ({path: bytes},
    or {path: the tmpfs file holding them} with a p2_dir; the task's
    spans)."""
    mark = timers.task_mark()
    outputs = _par_score_chunk(args)
    return outputs, timers.task_spans(mark)


def _par_score_chunk(args):
    c = _PAR
    rs, o = _par_load_chunk(args, replay=True)
    with timers.span("apps.score"):
        if c["k"] > 0:
            counts, w_off = window_count_lookup(rs, _p2_spectrum(), c["k"])
            trims = score_and_trim(rs, counts, w_off, c["k"],
                                   float(c["sopts"].min_depth),
                                   c["ropts"].kmer_scoring_type,
                                   first_markup_nor_x(rs),
                                   c["ropts"].bimodal_sigmas)
        else:
            trims = _trim_by_markup(rs)
        outputs = select_reads(rs, trims, _p2_spectrum(), c["opts"],
                               c["kopts"], c["sopts"], c["ropts"],
                               c["opts"].input_file,
                               paired_parts=bool(c.get("paired_merged")))
        if o is not None:
            outputs.update(divert_blobs(rs, o, c["opts"], c["aopts"]))
    d = c.get("p2_dir")
    if not d:
        return outputs
    # hand blobs to the parent as tmpfs files, not pool pickle IPC — the
    # pipe would copy the entire output twice more per chunk
    manifest = {}
    with timers.span("io.output"):
        for j, (path, blob) in enumerate(outputs.items()):
            fn = os.path.join(d, "p2-%06d-%d.bin" % (args[0], j))
            with open(fn, "wb") as f:
                f.write(blob)
            manifest[path] = fn
    return manifest


def _sample_splitters(rs0: ReadSet, k: int, num_parts: int):
    """Shared spill range splitters from the chunk-0 key sample: lets every
    chunk (including 0) run on the worker pool instead of serially in the
    parent.  Splitter skew only shifts per-part memory, never correctness
    (the spill counter range-partitions; parts concatenate sorted)."""
    codes_raw = BASE_CODE[rs0.seq]
    codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
    from kmernator_tpu_torch.io.native import kmer_keys
    keys = kmer_keys(codes, rs0.offsets, k)
    if keys is None:
        canon, _, _, _ = extract_kmers_flat(codes, rs0.offsets, k)
        keys = pack_keys(canon)
    if not len(keys):
        return None
    from kmernator_tpu_torch.parallel.spill import key_range_splitters
    step = max(1, len(keys) // 65536)
    return key_range_splitters(keys[::step], num_parts)


def _spectrum_outputs_and_purge(spectrum, sopts, fopts):
    """Shared post-build steps: histogram / size-history dumps, weak-map
    min-depth purge (singletons are never consulted by the selector,
    ref: FilterReads.cpp:196 binds spectrum.weak), optional variant purge
    (ref: KmerSpectrum::purgeVariants, src/KmerSpectrum.h:2117-2234)."""
    if fopts.histogram_file:
        with open(fopts.histogram_file, "w") as f:
            f.write(spectrum.histogram_table())
    if fopts.size_history_file:
        with open(fopts.size_history_file, "w") as f:
            f.write("rawKmers\trawGoodKmers\tuniqueKmers\tsingletonKmers\n")
            f.write("%d\t%d\t%d\t%d\n" % (
                spectrum.raw_kmers, spectrum.raw_good_kmers,
                spectrum.n_unique, spectrum.singleton_count()))
    spectrum.purge_min_depth(max(sopts.min_depth, 2))
    if sopts.variant_sigmas > 0.0:
        purged = spectrum.purge_variants(
            sopts.variant_sigmas, sopts.variant_hamming_distance,
            sopts.min_variant_kmer_depth,
            min_depth=max(sopts.min_depth, 2))
        Log.verbose(1, "Removed %d kmer-variants" % purged)


def _run_streaming_parallel(opts, kopts, sopts, ropts, aopts, fopts, filt,
                            scan_dir, chunk_bytes: int, capacity: int,
                            threads: int, paired: bool = False) -> int:
    """Two-pass streaming FilterReads over a fork worker pool: pass 1
    spill-counts chunks concurrently (per-chunk spill files share range
    splitters, so parts still concatenate globally sorted), pass 2 scores
    chunks concurrently and the parent appends outputs in chunk order.
    Byte-identical to the sequential engine at any thread count.
    `paired` = two-file mate mode: chunk units are aligned range pairs
    (both files advance in record lockstep, so mates share a chunk)."""
    import multiprocessing as mp
    from kmernator_tpu_torch.io.chunked import chunk_ranges, paired_chunk_ranges
    from kmernator_tpu_torch.io.reads import parse_fastq_bytes, open_maybe_gzip
    from kmernator_tpu_torch.io.stream import estimate_raw_kmers
    from kmernator_tpu_torch.parallel.spill import (SpillCounter, auto_parts,
                                              count_spill_parts)
    from kmernator_tpu_torch.utils.memory import (get_memory_usage,
                                            tune_malloc_for_streaming)

    tune_malloc_for_streaming()  # workers inherit via fork

    k = kopts.kmer_size
    # shrink chunks (never grow past the user's bound) until the pool has
    # ~4 tasks per worker to balance; floor keeps per-chunk overhead sane
    total_bytes = sum(os.path.getsize(p) for p in opts.input_file)
    chunk_bytes = max(min(chunk_bytes, total_bytes // (4 * threads) + 1),
                      min(chunk_bytes, 4 << 20))
    if paired:
        ranges = paired_chunk_ranges(opts.input_file[0], opts.input_file[1],
                                     chunk_bytes)
    else:
        ranges = chunk_ranges(opts.input_file, chunk_bytes)
    work = [(ci,) + r for ci, r in enumerate(ranges)]
    if not work:
        return 0

    # a head sample runs in the parent: detects the quality base and
    # (pass 1) seeds the spill range splitters every worker shares.  A few
    # MB suffice for both (the reference examines only the first 20000
    # reads for the base, ref: src/ReadSet.h:171-209; splitter skew only
    # shifts per-part memory, never correctness), and the full chunk 0 is
    # processed again by the pool — so keep this serial head small
    from kmernator_tpu_torch.io.reads import find_next_record
    if paired:
        fi0, path0, s0, e0 = 0, opts.input_file[0], ranges[0][0], ranges[0][1]
    else:
        fi0, path0, s0, e0 = ranges[0]
    data = open_maybe_gzip(path0, use_mmap=not path0.endswith(".gz"))
    e_s = e0
    if e0 - s0 > (5 << 20):
        e_s = find_next_record(data, s0 + (4 << 20), by_pair=True)
        if not s0 < e_s <= e0:
            e_s = e0
    rs0 = ReadSet()
    rs0.append_arrays(*parse_fastq_bytes(bytes(data[s0:e_s]),
                                         opts.keep_read_comment),
                      file_idx=fi0)
    base = rs0.detect_quality_base(opts.fastq_output_base_quality)
    del data
    Log.debug(1, "head sample parsed (%d reads)" % rs0.n)

    _PAR.clear()
    _PAR.update(
        base=base, comment_stored=opts.keep_read_comment, filt=filt,
        scan_dir=scan_dir, k=k, min_quality=opts.min_quality_score,
        output_base=opts.fastq_output_base_quality,
        min_kq=sopts.min_kmer_quality, opts=opts, kopts=kopts, sopts=sopts,
        ropts=ropts, aopts=aopts, subtract_keys=None, spectrum=None,
        paired_paths=tuple(opts.input_file[:2]) if paired else None,
        paired_merged=paired and not ropts.separate_outputs)

    ctx = mp.get_context("fork")
    spectrum = None
    if k > 0:
        track_w = bool(fopts.histogram_file) or sopts.variant_sigmas > 0.0
        subtract_keys = build_subtract_keys(
            fopts.reference_file, fopts.subtract_file, k,
            opts.min_quality_score, opts.fastq_output_base_quality,
            sopts.min_kmer_quality, sopts.min_depth)
        est = estimate_raw_kmers(opts.input_file, k)
        num_parts = capacity if capacity > 0 else auto_parts(est)
        if capacity <= 0:
            # round up to a multiple of the pool width: the finalize
            # starmap then has no straggler wave
            num_parts = -(-num_parts // threads) * threads
        from kmernator_tpu_torch.utils.cleanup import register_path
        from kmernator_tpu_torch.utils.memory import fast_temp_dir
        spill_dir = fast_temp_dir(est * 12, "kmtpu-spill-")
        register_path(spill_dir)
        # size each worker's aggregator by the EXPECTED UNIQUE load, not
        # the raw stream: every worker sees (mostly) the same unique
        # population, the tables replicate threads-fold, and random
        # probes beyond sum-of-tables ~ L3 go to DRAM.  est_pw/6 tracks
        # the unique fraction of a ~5x-coverage stream; measured on the
        # JAX package's development host (a 260 MB-L3 4-core CPU machine,
        # not the H100's host): 256 MB input wants 4M slots/worker
        # (spill 3.64 vs 4.58 core-s at the old est/2-sized 16M, -0.4 s
        # wall), 1 GiB wants 16M (14.4 vs 15.6 s capped at 4M).  Clamped
        # to the RAM budget and the 16M AggSpillCounter growth cap;
        # KMTPU_AGG_SLOTS overrides for tuning.
        from kmernator_tpu_torch.utils.memory import available_mb
        est_pw = est // max(1, threads)
        slot_b = 20 if track_w else 16
        budget_slots = int(available_mb() * (1 << 20) / 4 / threads / slot_b)
        cand = max(min(est_pw // 6, 1 << 24, budget_slots), 1)
        # pow2 CEIL in [4M, 16M]: 256 MB (cand 3.6M) -> 4M, 1 GiB
        # (cand 14.3M) -> 16M, the two optima measured on that host
        agg_slots = min(1 << max(22, int(cand - 1).bit_length()), 1 << 24)
        if os.environ.get("KMTPU_AGG_SLOTS"):
            agg_slots = 1 << int(
                np.log2(int(os.environ["KMTPU_AGG_SLOTS"])))
        _PAR.update(track_w=track_w, subtract_keys=subtract_keys,
                    num_parts=num_parts, spill_dir=spill_dir, splitters=None,
                    agg_slots=agg_slots)
        # shared splitters seed from the chunk-0 sample (already parsed for
        # base detection) so every chunk runs on the pool; if the sample has
        # zero kmers, fall back to counting chunks in the parent until some
        # chunk seeds them — forked workers must never seed their own
        # inconsistent ranges or parts stop concatenating globally sorted
        n_reads = raw = good = 0
        key_dt = None
        wi = 0
        splitters = _sample_splitters(rs0, k, num_parts)
        while splitters is None and wi < len(work):
            rn, rk, rgk, kd, splitters, spans = _par_pass1(work[wi])
            timers.absorb(spans)
            n_reads += rn
            raw += rk
            good += rgk
            if key_dt is None:
                key_dt = kd
            wi += 1
        _PAR["splitters"] = splitters
        # shared CAS count table (one table, all workers; the reference's
        # shared bucket map re-done for fork workers).  MEASURED NEGATIVE
        # on the JAX package's development host (a 4-core CPU machine,
        # not the H100's host), kept opt-in (KMTPU_SHCT=1) with the numbers:
        # interleaved A/B at 1 GiB ran 31-41 s shared vs 20-23 s private.
        # The hoped-for win (the 20x-repeated genome keys resident ONCE,
        # shared in L3) inverts under atomics: every fetch_add needs the
        # line EXCLUSIVE, so exactly the hot lines ping-pong between all
        # 4 cores, and the 2 GB mapping adds 8x the dTLB reach of the
        # 256 MB private tables.  Exact (unit-tested) but slower; the
        # private grow-under-pressure tables stand.
        shct = None
        # k <= 31 keeps keys < 2^62, so the native table's key+1 sentinel
        # can never wrap (k=32 would rely on the canonical-key invariant
        # that ~0ULL never occurs — not worth trusting across callers)
        if splitters is not None and not track_w and k <= 31 \
                and os.environ.get("KMTPU_SHCT"):
            from kmernator_tpu_torch.utils.memory import available_mb
            try:
                from kmernator_tpu_torch.io.native import SharedCountTable
                budget = int(available_mb() * (1 << 20) / 8 / 16)
                want = max(est // 3, 1 << 22)
                # the table rounds capacity up to the next power of two;
                # budget-check the ROUNDED size or the resident bound can
                # land ~2x over the 1/8-of-MemAvailable slot budget
                want_pow2 = 1 << (want - 1).bit_length()
                if want_pow2 <= budget:
                    shct = SharedCountTable(want)
            except RuntimeError:
                shct = None
        _PAR["shct"] = shct
        _PAR["flush_barrier"] = ctx.Barrier(threads)
    # ONE pool serves both passes: pass 2 on fresh forks would re-pay the
    # per-worker warmup (buffer faulting, malloc arena growth) a second
    # time, so instead the finalized spectrum hands off to the live
    # workers through read-only tmpfs memmaps (one page-cache copy shared
    # by all workers — cheaper than even fork COW, which faults per
    # worker on first touch)
    from kmernator_tpu_torch.io import native as _native
    from kmernator_tpu_torch.utils.cleanup import register_path
    from kmernator_tpu_torch.utils.memory import fast_temp_dir
    # pool workers own whole cores; native kernels inside them must not
    # fan out another cpu_count threads each (forked state)
    _native.set_default_threads(1)
    p2_dir = None
    if opts.output_file:
        p2_dir = fast_temp_dir(chunk_bytes * 2 * threads, "kmtpu-p2-")
        register_path(p2_dir)
        _PAR["p2_dir"] = p2_dir
        # pass-1 parsed-chunk cache (skips the pass-2 re-parse).
        # MEASURED NEGATIVE with the native parse in place, on the JAX
        # package's development host (a CPU machine, not the H100's
        # host), kept opt-in
        # (KMTPU_RS_CACHE=1) with the numbers: interleaved 1 GiB A/B ran
        # 19.8-22.0 s cached vs 16.2-16.6 s re-parsing — the memchr
        # newline scan + fused-normalize gather parse (~80 ms/16 MB
        # chunk) is cheaper than the pickle round-trip plus rebuilding
        # 78k-name lists and pair tuples per chunk.
        try:
            st = os.statvfs(p2_dir)
            _PAR["rs_cache"] = \
                st.f_bavail * st.f_frsize > 3 * total_bytes \
                and os.environ.get("KMTPU_RS_CACHE", "0") == "1"
        except OSError:
            _PAR["rs_cache"] = False
    Log.debug(1, "pass1 pool start (head done)")
    with ctx.Pool(threads) as pool:
        if k > 0:
            with timers.timed("apps.count_pass") as p1:
                for rn, rk, rgk, kd, _, spans in _iter_pool(
                        pool.imap_unordered(_par_pass1, work[wi:],
                                            chunksize=1),
                        len(work) - wi, "pass1"):
                    timers.absorb(spans)
                    n_reads += rn
                    raw += rk
                    good += rgk
                    if key_dt is None:
                        key_dt = kd
                # every worker (and the parent, if it seeded chunks)
                # flushes its aggregated spill before the parts are counted
                for _ in pool.imap_unordered(_par_flush_spill,
                                             range(threads), chunksize=1):
                    pass
                _flush_worker_spill()
                if shct is not None:
                    # export the shared table into the part files (exact:
                    # merges with any pressure-spilled partials at count)
                    _native.set_default_threads(threads)
                    s_ko, s_co = shct.export()
                    _native.set_default_threads(1)
                    from kmernator_tpu_torch.parallel.spill import \
                        append_agg_records
                    append_agg_records(spill_dir, num_parts, splitters,
                                       "shct", s_ko, s_co)
                    shct.close()
                    _PAR["shct"] = None
                # singletons are only ever consulted by the histogram /
                # size-history outputs; when neither is requested, finalize
                # straight to the >= 2 table the selector uses (the purge in
                # _spectrum_outputs_and_purge then keeps it unchanged)
                fin_depth = 1 if (fopts.histogram_file
                                  or fopts.size_history_file) else 2
                with timers.timed("table.finalize") as fin:
                    spectrum = count_spill_parts(
                        spill_dir, num_parts, k, key_dt, track_w, fin_depth,
                        raw, good, pool=pool)
            Log.verbose(1, "streamed %d reads through %d spill parts on %d "
                        "workers; spectrum: %d unique kmers; chunks %.2fs "
                        "finalize %.2fs; %s"
                        % (n_reads, num_parts, threads, spectrum.n_unique,
                           p1.seconds - fin.seconds, fin.seconds,
                           get_memory_usage()))
            with timers.span("apps.purge"):
                _spectrum_outputs_and_purge(spectrum, sopts, fopts)

        if not opts.output_file:
            return 0
        with timers.span("apps.output_pass"):
            if spectrum is not None:
                with timers.span("table.hash"):
                    # purged spectrum -> read-only tmpfs memmaps for the
                    # live workers; the lookup hash is built ONCE here
                    # (multithreaded) and shared via its slots file
                    np.save(os.path.join(p2_dir, "spec_keys.npy"),
                            spectrum.keys)
                    np.save(os.path.join(p2_dir, "spec_counts.npy"),
                            spectrum.counts)
                    if len(spectrum.keys) >= 4096 \
                            and spectrum.keys.dtype == np.uint64:
                        # build the lookup table DIRECTLY into a
                        # tmpfs-backed memmap (the workers' read-only
                        # mapping) — no second 2*cap*16 B copy through
                        # np.save
                        from kmernator_tpu_torch.io.native import HashTable
                        _native.set_default_threads(os.cpu_count() or 1)
                        try:
                            m = len(spectrum.keys)
                            cap = 1
                            while cap < max(2 * m, 16):
                                cap <<= 1
                            slots = np.lib.format.open_memmap(
                                os.path.join(p2_dir, "spec_slots.npy"),
                                mode="w+", dtype=np.uint64,
                                shape=(2 * cap,))
                            HashTable.build_into(spectrum.keys,
                                                 spectrum.counts, slots)
                            slots.flush()
                            del slots
                        except RuntimeError:
                            pass
                        _native.set_default_threads(1)
                    with open(os.path.join(p2_dir, "spec_ready"), "w") as f:
                        f.write("%d" % k)
            written = set()
            parts: Dict = {}
            for outputs, spans in _iter_pool(
                    pool.imap(_par_pass2, work, chunksize=1), len(work),
                    "pass2"):
                timers.absorb(spans)
                with timers.span("io.output"):
                    for path, src_fn in outputs.items():
                        def _sendfile(f, src_fn=src_fn):
                            with open(src_fn, "rb") as src:
                                try:
                                    os.sendfile(
                                        f.fileno(), src.fileno(), 0,
                                        os.fstat(src.fileno()).st_size)
                                except OSError:
                                    f.write(src.read())
                        _append_blob(path, _sendfile, written, parts)
                        os.unlink(src_fn)
            with timers.span("io.output"):
                _finalize_parts(written, parts)
    import shutil
    shutil.rmtree(p2_dir, ignore_errors=True)
    for path in written:
        Log.verbose(1, "wrote %s (%d bytes)" % (path, os.path.getsize(path)))
    return 0


def run_streaming(opts, kopts, sopts, ropts, aopts, fopts, chunk_mb: float,
                  capacity: int, mesh_devices: int = 0,
                  mesh_batch: int = 0, device: torch.device = None) -> int:
    """Memory-bounded FilterReads: two passes over the input in bounded
    chunks.  Pass 1 counts with one of two engines:
      - host (default): observations spill into hash-partitioned disk
        buckets, counted part by part (EXACT counts; the reference's
        out-of-core buildKmerSpectrumInParts,
        ref: src/KmerSpectrum.h:1818-1902);
      - device mesh (`--mesh N` with `--streaming`): chunks route through
        the sharded device spectrum (the reference's streaming MPI build,
        ref: src/DistributedFunctions.h:333-458).
    Pass 2 re-streams reads, scores them against the finalized table, and
    appends output per chunk.  Peak RSS is O(chunk + table), not O(input).
    `capacity` > 0 overrides the spill part count / mesh shard capacity
    (--streaming-parts). `device` is the torch device of the mesh engine.

    Unsupported here (use the in-memory path): normalization
    (--max-kmer-output-depth), dedup, save/load-kmer-mmap."""
    from kmernator_tpu_torch.io.chunked import (paired_files_aligned,
                                          stream_paired_readsets,
                                          stream_readsets)
    from kmernator_tpu_torch.io.stream import estimate_raw_kmers
    from kmernator_tpu_torch.utils.memory import tune_malloc_for_streaming

    tune_malloc_for_streaming()

    k = kopts.kmer_size
    if ropts.max_kmer_output_depth > 0:
        Log.error("--streaming does not support max-kmer-output-depth "
                  "normalization (global state); use the in-memory path")
        return 1
    # paired two-file mode: both mate files advance in record lockstep so
    # mates share a chunk (ref: the byPair resync of
    # src/ReadFileReader.h:657-740 applied to split pair files)
    paired_stream = (len(opts.input_file) == 2
                     and not any(p.endswith(".gz") for p in opts.input_file)
                     and paired_files_aligned(*opts.input_file))
    if len(opts.input_file) == 2 and not paired_stream:
        Log.warn("two input files do not pair positionally; streaming "
                 "treats them as independent single-end inputs (mates "
                 "split across files will not pair — use the in-memory "
                 "path for name-matched pairing)")
    chunk_bytes = max(int(chunk_mb * (1 << 20)), 1 << 12)
    filt = None
    if not aopts.skip_artifact_filter:
        filt = ArtifactFilter(
            match_length=aopts.artifact_match_length,
            edit_distance=aopts.artifact_edit_distance,
            build_edits_in_filter=aopts.build_artifact_edits_in_filter,
            mask_simple_repeats=aopts.mask_simple_repeats,
            phix=aopts.phix_output,
            extra_reference_files=aopts.artifact_reference_file,
            min_quality=opts.min_quality_score,
            min_read_length=ropts.min_read_length)

    # the artifact scan is deterministic per chunk, so pass 1 spills its
    # per-read scan arrays to disk (~40 B/read) and pass 2 replays them
    # instead of rescanning (the scan dominates two-pass filter cost)
    scan_dir = None
    if filt is not None and opts.output_file:
        from kmernator_tpu_torch.utils.cleanup import register_path
        from kmernator_tpu_torch.utils.memory import fast_temp_dir
        scan_dir = fast_temp_dir(
            sum(os.path.getsize(p) for p in opts.input_file) // 4,
            "kmtpu-afscan-")
        register_path(scan_dir)

    # chunk workers are embarrassingly parallel (the artifact scan, spill
    # counting, and scoring are all per-chunk; outputs append in chunk
    # order) — fork a pool when threads allow.  gz inputs have no random
    # access and the mesh engine owns the devices, so those stay sequential.
    threads = opts.threads if opts.threads > 0 else (os.cpu_count() or 1)
    if (threads > 1 and mesh_devices == 0
            and not any(p.endswith(".gz") for p in opts.input_file)):
        return _run_streaming_parallel(opts, kopts, sopts, ropts, aopts,
                                       fopts, filt, scan_dir, chunk_bytes,
                                       capacity, threads,
                                       paired=paired_stream)

    last_outcome: Dict[str, object] = {}

    def _chunk_source():
        if paired_stream:
            return stream_paired_readsets(
                opts.input_file, chunk_bytes,
                opts.fastq_output_base_quality, opts.keep_read_comment)
        return stream_readsets(opts.input_file, chunk_bytes,
                               opts.fastq_output_base_quality,
                               opts.keep_read_comment)

    def chunks(replay: bool = False):
        source = enumerate(_chunk_source())
        while True:
            with timers.span("io.parse"):
                ci, rs = next(source, (None, None))
                if rs is None:
                    return
                # pairs identify BEFORE the filter (the reference's order,
                # FilterReads.cpp:103 then :114): remnant reads the filter
                # appends never join rs.pairs, so the pair-driven picks
                # skip them (they feed the spectrum only)
                rs.identify_pairs()
            if not replay or k <= 0:   # the input's reads, counted once
                timers.count("io.reads", rs.n)
                timers.count("io.bases", len(rs.seq))
            last_outcome.pop("o", None)
            if filt is not None:
                with timers.span("ops.artifact"):
                    pre = None
                    path = (os.path.join(scan_dir, "%06d.npz" % ci)
                            if scan_dir else None)
                    if replay and path and os.path.exists(path):
                        with np.load(path) as z:
                            pre = tuple(z[f] for f in ("sv", "smn", "smx",
                                                       "sso", "ssl", "sph"))
                    o = apply_artifact_filter(rs, filt, precomputed=pre)
                    if not replay and path:
                        sv, smn, smx, sso, ssl, sph = o.scan
                        np.savez(path, sv=sv, smn=smn, smx=smx, sso=sso,
                                 ssl=ssl, sph=sph)
                last_outcome["o"] = o
            yield rs

    spectrum = None
    if k > 0:
        # weights only matter for the weighted histogram / variant purge
        track_w = bool(fopts.histogram_file) or sopts.variant_sigmas > 0.0
        subtract_keys = build_subtract_keys(
            fopts.reference_file, fopts.subtract_file, k,
            opts.min_quality_score, opts.fastq_output_base_quality,
            sopts.min_kmer_quality, sopts.min_depth)
        if mesh_devices:
            spectrum = _streaming_mesh_count(
                chunks(), opts.input_file, k, opts.min_quality_score,
                opts.fastq_output_base_quality, sopts.min_kmer_quality,
                mesh_devices, mesh_batch, capacity, subtract_keys, track_w,
                device=device)
        else:
            from kmernator_tpu_torch.parallel.spill import (auto_parts,
                                                      make_spill_counter)
            from kmernator_tpu_torch.utils.memory import get_memory_usage
            est = estimate_raw_kmers(opts.input_file, k)
            num_parts = capacity if capacity > 0 else auto_parts(est)
            sc = make_spill_counter(k, num_parts, track_weights=track_w)
            n_reads = 0
            with timers.span("apps.count_pass"):
                for rs in chunks():
                    with timers.span("apps.prepare"):
                        keys, good, w = _chunk_observations(
                            rs, k, opts.min_quality_score,
                            opts.fastq_output_base_quality,
                            sopts.min_kmer_quality, subtract_keys,
                            want_weights=track_w)
                    with timers.span("table.spill"):
                        sc.add(keys, good, w)
                    n_reads += rs.n
                    Log.debug(1, "chunk %d reads; %s"
                              % (rs.n, get_memory_usage()))
                fin_depth = 1 if (fopts.histogram_file
                                  or fopts.size_history_file) else 2
                with timers.span("table.finalize"):
                    spectrum = sc.finalize(min_depth=fin_depth)
            Log.verbose(1, "streamed %d reads through %d spill parts; "
                        "spectrum: %d unique kmers"
                        % (n_reads, num_parts, spectrum.n_unique))
        with timers.span("apps.purge"):
            _spectrum_outputs_and_purge(spectrum, sopts, fopts)

    if not opts.output_file:
        return 0
    written = set()
    parts: Dict = {}
    with timers.span("apps.output_pass"):
        for rs in chunks(replay=True):
            with timers.span("apps.score"):
                if k > 0:
                    counts, w_off = window_count_lookup(rs, spectrum, k)
                    trims = score_and_trim(rs, counts, w_off, k,
                                           float(sopts.min_depth),
                                           ropts.kmer_scoring_type,
                                           first_markup_nor_x(rs),
                                           ropts.bimodal_sigmas)
                else:
                    trims = _trim_by_markup(rs)
                outputs = select_reads(
                    rs, trims, spectrum, opts, kopts, sopts, ropts,
                    opts.input_file,
                    paired_parts=paired_stream and not ropts.separate_outputs)
                if "o" in last_outcome:
                    outputs.update(divert_blobs(rs, last_outcome["o"], opts,
                                                aopts))
            with timers.span("io.output"):
                for path, data in outputs.items():
                    _append_blob(path, lambda f, d=data: f.write(d), written,
                                 parts)
        with timers.span("io.output"):
            _finalize_parts(written, parts)
    for path in written:
        Log.verbose(1, "wrote %s (%d bytes)" % (path, os.path.getsize(path)))
    return 0


def _slice_pad_batch(cur, off: int, n: int, L: int, k: int, track_w: bool):
    """Row-slice [off, off+n) of a chunk's padded arrays, re-padded to the
    globally-agreed (n rows, L columns) batch shape.  cur=None yields the
    all-empty batch a drained rank feeds to keep collectives in lockstep."""
    NW = L - k + 1
    out_c = np.zeros((n, L), np.uint8)
    out_g = np.zeros((n, NW), bool)
    out_l = np.zeros(n, np.int32)
    out_w = np.zeros((n, NW), np.float32) if track_w else None
    if cur is None:
        return out_c, out_g, out_l, out_w, 0
    codes, good2d, lengths, weights2d = cur
    e = min(off + n, codes.shape[0])
    m = e - off
    out_c[:m, :codes.shape[1]] = codes[off:e]
    out_g[:m, :good2d.shape[1]] = good2d[off:e]
    out_l[:m] = lengths[off:e]
    if track_w and weights2d is not None:
        out_w[:m, :weights2d.shape[1]] = weights2d[off:e]
    return out_c, out_g, out_l, out_w, m


def run_streaming_distributed(opts, kopts, sopts, ropts, aopts, fopts,
                              chunk_mb: float, capacity: int,
                              mesh_batch: int, *,
                              device: torch.device) -> int:
    """--streaming x --distributed: the reference's flagship composition —
    rank-partitioned STREAMING input feeding the DISTRIBUTED table
    (ref: _buildKmerSpectrumMPI, src/DistributedFunctions.h:333-458, fed
    by the rank-partitioned ReadSetStream, src/ReadSet.h:656-748).

    Every process streams only its byte-range partition of the inputs
    (pair-preserving resync; the union over ranks is exactly the input).
    Pass 1 feeds chunks through a MeshStreamingSpectrum on `device` in
    lockstep rounds: each round every process allgathers (has-data,
    padded-L) flags, agrees on the batch shape, and issues one add_batch —
    drained ranks feed empty batches so collectives stay in lockstep (the
    empty-cycle consensus of MPIBuffer::finalize, src/MPIBuffer.h:922).
    The table starts at the estimate / 6 and grows on pressure. Pass 2
    re-streams each rank's partition and scores it with lockstep lookups
    against the table on the device (the ReqResp RPC of
    src/DistributedFunctions.h:749-1062), so the full table never reaches
    the host unless histograms ask for it. Outputs land as rank-ordered
    gathered files (rank 0 first — apps/FilterReads-P.cpp:190-197). Peak
    per-process RSS is O(chunk + table/P). The table is the global mesh's:
    one shard a process, on each process's `device`."""
    from kmernator_tpu_torch.io.chunked import stream_partition_readsets
    from kmernator_tpu_torch.io.stream import estimate_raw_kmers
    from kmernator_tpu_torch.parallel import multihost as mh
    from kmernator_tpu_torch.utils.memory import (get_memory_usage,
                                                  tune_malloc_for_streaming)

    tune_malloc_for_streaming()
    k = kopts.kmer_size
    rank, nprocs = mh.process_index(), mh.process_count()
    if any(p.endswith(".gz") for p in opts.input_file):
        Log.error("--streaming --distributed needs random-access input; "
                  "decompress gz files first")
        return 1
    chunk_bytes = max(int(chunk_mb * (1 << 20)), 1 << 12)
    filt = None
    if not aopts.skip_artifact_filter:
        filt = ArtifactFilter(
            match_length=aopts.artifact_match_length,
            edit_distance=aopts.artifact_edit_distance,
            build_edits_in_filter=aopts.build_artifact_edits_in_filter,
            mask_simple_repeats=aopts.mask_simple_repeats,
            phix=aopts.phix_output,
            extra_reference_files=aopts.artifact_reference_file,
            min_quality=opts.min_quality_score,
            min_read_length=ropts.min_read_length)
    scan_dir = None
    if filt is not None and opts.output_file:
        from kmernator_tpu_torch.utils.cleanup import register_path
        from kmernator_tpu_torch.utils.memory import fast_temp_dir
        scan_dir = fast_temp_dir(
            sum(os.path.getsize(p) for p in opts.input_file)
            // (4 * nprocs), "kmtpu-afscan-r%d-" % rank)
        register_path(scan_dir)

    last_outcome: Dict[str, object] = {}

    # paired two-file inputs stream in record LOCKSTEP here too: every
    # rank computes the same aligned chunk ranges (deterministic) and
    # owns a CONTIGUOUS block, so the rank-ordered gathered outputs
    # reproduce the single-process chunk order byte-for-byte
    from kmernator_tpu_torch.io.chunked import paired_files_aligned
    paired_stream = (len(opts.input_file) == 2
                     and paired_files_aligned(*opts.input_file))
    if len(opts.input_file) == 2 and not paired_stream:
        Log.warn("two input files do not pair positionally; each rank "
                 "streams its byte-range partition of each file "
                 "independently (mates split across files will not pair)")

    def _rank_readsets():
        if paired_stream:
            from kmernator_tpu_torch.io.chunked import (
                detect_base_from_head, paired_chunk_ranges,
                read_chunk_paired)
            p1, p2 = opts.input_file
            ranges = paired_chunk_ranges(p1, p2, chunk_bytes)
            base = detect_base_from_head([p1], chunk_bytes,
                                         opts.fastq_output_base_quality,
                                         opts.keep_read_comment)
            n = len(ranges)
            lo, hi = rank * n // nprocs, (rank + 1) * n // nprocs
            for rng in ranges[lo:hi]:
                yield read_chunk_paired(p1, p2, rng, base,
                                        opts.keep_read_comment)
        else:
            yield from stream_partition_readsets(
                opts.input_file, rank, nprocs, chunk_bytes,
                opts.fastq_output_base_quality, opts.keep_read_comment)

    def chunks(replay: bool = False):
        for ci, rs in enumerate(_rank_readsets()):
            last_outcome.pop("o", None)
            # pairs before the filter: see run_streaming.chunks()
            rs.identify_pairs()
            if filt is not None:
                pre = None
                path = (os.path.join(scan_dir, "%06d.npz" % ci)
                        if scan_dir else None)
                if replay and path and os.path.exists(path):
                    with np.load(path) as z:
                        pre = tuple(z[f] for f in
                                    ("sv", "smn", "smx", "sso", "ssl", "sph"))
                o = apply_artifact_filter(rs, filt, precomputed=pre)
                if not replay and path:
                    sv, smn, smx, sso, ssl, sph = o.scan
                    np.savez(path, sv=sv, smn=smn, smx=smx, sso=sso,
                             ssl=ssl, sph=sph)
                last_outcome["o"] = o
            yield rs

    track_w = bool(fopts.histogram_file) or sopts.variant_sigmas > 0.0
    subtract_keys = None
    sp = None
    stats = {"raw": 0, "good": 0, "reads": 0}

    def chunk_arrays(replay: bool):
        for rs in chunks(replay):
            if k <= 0:
                # no spectrum: only the row count matters downstream
                yield rs, (np.zeros((rs.n, 1), np.uint8), None, None, None)
                continue
            need = max(rs.max_length(), k)
            Lc = -(-need // 32) * 32
            codes, good2d, lengths, weights2d, r, g = _chunk_padded(
                rs, k, Lc, opts.min_quality_score,
                opts.fastq_output_base_quality, sopts.min_kmer_quality,
                subtract_keys, track_w, device=device)
            if not replay:
                stats["raw"] += r
                stats["good"] += g
                stats["reads"] += rs.n
            yield rs, (codes, good2d, lengths, weights2d)

    mesh = mh.global_mesh(device)
    D = mesh.size
    L_glob = -(-k // 32) * 32
    batch_reads = mesh_batch

    if k > 0:
        subtract_keys = build_subtract_keys(
            fopts.reference_file, fopts.subtract_file, k,
            opts.min_quality_score, opts.fastq_output_base_quality,
            sopts.min_kmer_quality, sopts.min_depth)
        est = estimate_raw_kmers(opts.input_file, k)
        if capacity > 0:
            sp = MeshStreamingSpectrum(mesh, k, capacity=capacity)
        else:
            # expected-unique start + grow on pressure (see
            # _streaming_mesh_count)
            sp = MeshStreamingSpectrum(
                mesh, k,
                capacity=min(max(int(np.ceil(est / D / 6)), 4096), 2 << 20),
                max_capacity=64 << 20)

        # ---- pass 1: lockstep streaming build ----
        it = iter(chunk_arrays(False))
        cur, off = None, 0
        cur_item = next(it, None)
        if cur_item is not None:
            cur = cur_item[1]
        while True:
            if cur is not None and off >= cur[0].shape[0]:
                nxt = next(it, None)
                cur = nxt[1] if nxt is not None else None
                off = 0
            has = 0 if cur is None else 1
            need_l = cur[0].shape[1] if cur is not None else 0
            f = mh.allgather_ints([has, need_l])
            if int(f[:, 0].max()) == 0:
                break
            L_glob = max(L_glob, int(f[:, 1].max()))
            if batch_reads <= 0:
                batch_reads = auto_mesh_batch(L_glob, k)
                Log.verbose(1, "mesh batch auto-selected: %d reads (L=%d)"
                            % (batch_reads, L_glob))
            bc, bg, bl, bw, m = _slice_pad_batch(cur, off, batch_reads,
                                                 L_glob, k, track_w)
            sp.add_batch(bc, bg, bl, weights2d=bw)
            if cur is not None:
                off += batch_reads
        if sp.purged_singletons:
            Log.warn("mesh streaming purged %d singletons under capacity "
                     "pressure (counts may undercount by 1); raise "
                     "--streaming-parts capacity" % sp.purged_singletons)
        tot = mh.allgather_ints(
            [stats["raw"], stats["good"], stats["reads"]]).sum(axis=0)
        Log.verbose(1, "rank %d streamed %d reads (global %d) over %d "
                    "devices; %s" % (rank, stats["reads"], int(tot[2]), D,
                                     get_memory_usage()))
        # histogram / size-history want the pre-purge global table
        if fopts.histogram_file or fopts.size_history_file:
            spectrum_h = sp.to_host_spectrum(min_depth=1)
            spectrum_h.raw_kmers = int(tot[0])
            spectrum_h.raw_good_kmers = int(tot[1])
            if rank == 0:
                if fopts.histogram_file:
                    with open(fopts.histogram_file, "w") as fh:
                        fh.write(spectrum_h.histogram_table())
                if fopts.size_history_file:
                    with open(fopts.size_history_file, "w") as fh:
                        fh.write("rawKmers\trawGoodKmers\tuniqueKmers\t"
                                 "singletonKmers\n")
                        fh.write("%d\t%d\t%d\t%d\n" % (
                            spectrum_h.raw_kmers, spectrum_h.raw_good_kmers,
                            spectrum_h.n_unique,
                            spectrum_h.singleton_count()))
            del spectrum_h
        # purge order parity with the host path: singletons leave the
        # table before the variant purge
        sp.purge_min_depth(max(sopts.min_depth, 2))
        if sopts.variant_sigmas > 0.0:
            purged = sp.purge_variants_mesh(
                sopts.variant_sigmas, sopts.variant_hamming_distance,
                sopts.min_variant_kmer_depth,
                min_depth=max(sopts.min_depth, 2))
            Log.verbose(1, "Removed %d kmer-variants (mesh, on-device)"
                        % purged)

    if not opts.output_file:
        return 0

    # ---- pass 2: lockstep lookups, local scoring, gathered writes ----
    import tempfile
    from kmernator_tpu_torch.utils.cleanup import register_path
    part_dir = tempfile.mkdtemp(prefix="kmtpu-dist-out-r%d-" % rank)
    register_path(part_dir)
    local_parts: Dict[str, str] = {}

    def append_local(path: str, data: bytes):
        lp = local_parts.get(path)
        if lp is None:
            lp = os.path.join(part_dir,
                              "%05d.part" % len(local_parts))
            local_parts[path] = lp
        with open(lp, "ab") as fh:
            fh.write(data)

    def finish_chunk(rs, arrays, rows):
        codes = arrays[0]
        B = codes.shape[0]
        NWc = codes.shape[1] - k + 1
        if k > 0:
            nw = np.maximum(rs.lengths() - k + 1, 0)
            counts2d = np.concatenate(rows)[:B, :NWc] if rows else \
                np.zeros((B, NWc), np.int32)
            counts = padded_to_ragged(counts2d, nw).astype(np.int64)
            w_off = np.concatenate([[0], np.cumsum(nw)])
            trims = score_and_trim(rs, counts, w_off, k,
                                   float(sopts.min_depth),
                                   ropts.kmer_scoring_type,
                                   first_markup_nor_x(rs),
                                   ropts.bimodal_sigmas)
        else:
            trims = _trim_by_markup(rs)
        outputs = select_reads(
            rs, trims, None, opts, kopts, sopts, ropts, opts.input_file,
            paired_parts=paired_stream and not ropts.separate_outputs)
        if "o" in last_outcome:
            outputs.update(divert_blobs(rs, last_outcome["o"], opts, aopts))
        for path, data in outputs.items():
            append_local(path, data)

    it2 = iter(chunk_arrays(True))
    cur_rs, cur, off, rows = None, None, 0, []
    nxt = next(it2, None)
    if nxt is not None:
        cur_rs, cur = nxt
    while True:
        if cur is not None and off >= cur[0].shape[0]:
            finish_chunk(cur_rs, cur, rows)
            nxt = next(it2, None)
            cur_rs, cur = nxt if nxt is not None else (None, None)
            off, rows = 0, []
        if k <= 0:
            # no table: score chunks locally with no collectives
            if cur is None:
                break
            off = cur[0].shape[0]
            continue
        has = 0 if cur is None else 1
        need_l = cur[0].shape[1] if cur is not None else 0
        f = mh.allgather_ints([has, need_l])
        if int(f[:, 0].max()) == 0:
            break
        L_glob = max(L_glob, int(f[:, 1].max()))
        bc, _, bl, _, m = _slice_pad_batch(cur, off, batch_reads,
                                           L_glob, k, False)
        want = np.ones((batch_reads, L_glob - k + 1), bool)
        c2d = sp.lookup_batch(bc, want, bl,
                              min_count=max(sopts.min_depth, 2))
        if cur is not None:
            rows.append(c2d[:m])
            off += batch_reads
    # zero-read partition edge: a rank whose partition was empty still
    # joins the gathered writes below.  PART_MARK keys (the merged
    # paired-output part streams) gather into per-part temp files first,
    # then concatenate in (part, rank) order onto the real path — all
    # ranks' file-1 picks before any file-2 picks, the file-sequential
    # merged ordering of the in-memory path (src/ReadSelector.h:1212).
    all_paths = mh.allgather_strings(sorted(local_parts.keys()))
    pending_parts: Dict[str, list] = {}
    for path in all_paths:
        real, pi = _part_stream_path(path)
        if pi is None:
            mh.write_gathered_file(path, local_parts.get(path))
            if rank == 0:
                Log.verbose(1, "wrote %s (%d bytes)"
                            % (path, os.path.getsize(path)))
        else:
            tmp = "%s.gpart%d" % (real, pi)
            mh.write_gathered_file(tmp, local_parts.get(path))
            pending_parts.setdefault(real, []).append((pi, tmp))
    if rank == 0:
        import shutil
        for real in sorted(pending_parts):
            with open(real, "wb") as outf:
                for pi, tmp in sorted(pending_parts[real]):
                    with open(tmp, "rb") as f:
                        shutil.copyfileobj(f, outf)
                    os.unlink(tmp)
            Log.verbose(1, "wrote %s (%d bytes)"
                        % (real, os.path.getsize(real)))
    return 0



@timers.traced_run
def run(argv: List[str]) -> int:
    """FilterReads. The JAX app's arguments, with --device cuda|cpu
    (default cuda) in place of --jax-platform. A run of the tracer
    (utils/timers.py): traced when the tracer is enabled or --debug is 1
    or more, which logs its spans and counters at its end."""
    argv = list(argv)
    device_name = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device_name = argv[i + 1]
        del argv[i:i + 2]
    device = resolve_device(device_name)
    opts = GeneralOptions()
    kopts = KmerBaseOptions()
    sopts = KmerSpectrumOptions()
    ropts = ReadSelectorOptions()
    aopts = FilterArtifactOptions()
    dopts = DuplicateFilterOptions()
    fopts = FilterReadsOptions()
    # FilterReads aliases --out for --output-file (test scripts use --out)
    argv = ["--output-file" if a == "--out" else a for a in argv]
    mesh_devices = 0
    if "--mesh" in argv:
        i = argv.index("--mesh")
        mesh_devices = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    mesh_batch = 0  # 0 = auto (pow2-aligned on attached TPU, 2048 otherwise)
    if "--mesh-batch" in argv:
        i = argv.index("--mesh-batch")
        mesh_batch = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    streaming = False
    streaming_chunk_mb = 16
    streaming_capacity = 0
    if "--streaming" in argv:
        streaming = True
        argv.remove("--streaming")
    if "--streaming-chunk-mb" in argv:
        i = argv.index("--streaming-chunk-mb")
        streaming_chunk_mb = float(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if "--streaming-parts" in argv:
        i = argv.index("--streaming-parts")
        streaming_capacity = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    # multi-process mode (the FilterReads-P mpirun analogue): every process
    # runs this same command with its own --procid
    dist_coord, dist_nprocs, dist_procid = None, 1, 0
    if "--distributed" in argv:
        i = argv.index("--distributed")
        dist_coord = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if "--nprocs" in argv:
        i = argv.index("--nprocs")
        dist_nprocs = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if "--procid" in argv:
        i = argv.index("--procid")
        dist_procid = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    compose([opts, kopts, sopts, ropts, aopts, dopts, fopts], argv,
            positional=["kmer-size", "input-file"])
    Log.verbose_level = opts.verbose
    if getattr(opts, "log_file", ""):
        Log.set_log_file(opts.log_file)
    Log.debug_level = opts.debug
    Log.gathered = opts.gathered_logs > 0
    timers.begin_run(opts.debug)

    if not opts.input_file:
        Log.error("Please specify at least one input file")
        return 1

    def _is_plain_fastq(p: str) -> bool:
        """Streaming handles FASTQ only (gz included); FASTA(+qual)
        stays on the in-memory loader."""
        try:
            if p.endswith(".gz"):
                import gzip
                with gzip.open(p, "rb") as f:
                    return f.read(1) == b"@"
            with open(p, "rb") as f:
                return f.read(1) == b"@"
        except OSError:
            return False

    auto_streamable = (
        not streaming and dist_nprocs == 1
        and ropts.max_kmer_output_depth <= 0 and dopts.dedup_mode <= 0
        and not sopts.save_kmer_mmap and not sopts.load_kmer_mmap
        and ropts.partition_by_depth <= 0 and kopts.kmer_size != 0
        and sopts.build_partitions <= 0
        and all(os.path.exists(p) for p in opts.input_file)
        and all(_is_plain_fastq(p) for p in opts.input_file))
    # auto-engage threshold; env-tunable so the gate itself is testable.
    # Default 2 MB = the engine crossover measured on the JAX package's
    # development host (a CPU machine, not the H100's host) (1 MB:
    # in-memory 0.56 s vs streaming 0.69 s; 4 MB: 1.7-1.9 vs 1.0-1.1;
    # 256 MB: 130 vs 5.2 s — all the round-2..5 perf work lives in the
    # streaming engine, and it is byte-compatible feature-for-feature,
    # so anything above the fork-pool overhead should use it)
    auto_mb = int(os.environ.get("KMTPU_AUTO_STREAM_MB", "2"))
    if (auto_streamable and len(opts.input_file) == 1
            and os.path.getsize(opts.input_file[0]) > (auto_mb << 20)):
        # the streaming engine is byte-compatible feature-for-feature and
        # both faster (worker pool + native kernels) and bounded-memory;
        # auto-enable it for large SINGLE-file inputs unless an
        # in-memory-only feature (normalization, dedup, mmap save/load,
        # partition-by-depth) is on.
        Log.verbose(1, "input > %d MB: using the streaming engine "
                    "(pass --streaming-chunk-mb to tune)" % auto_mb)
        streaming = True
    elif (auto_streamable and len(opts.input_file) == 2
          and not any(p.endswith(".gz") for p in opts.input_file)
          and sum(os.path.getsize(p) for p in opts.input_file)
          > (auto_mb << 20)):
        # large paired two-file inputs keep the bounded-memory engine too,
        # via record-lockstep chunking of the file PAIR — merged output
        # included (part streams concatenate file-sequentially at close,
        # see _finalize_parts) — but only when the heads actually pair
        # positionally (the standard R1/R2 layout); name-scrambled pairs
        # stay in-memory where global name matching pairs them
        from kmernator_tpu_torch.io.chunked import paired_files_aligned
        if paired_files_aligned(*opts.input_file):
            Log.verbose(1, "paired input > %d MB: using the streaming "
                        "engine in two-file lockstep mode" % auto_mb)
            streaming = True
    if streaming:
        # in-memory-only features must fail loudly, not silently no-op
        # (the auto-streaming gate above already excludes them)
        if sopts.save_kmer_mmap or sopts.load_kmer_mmap:
            Log.error("--streaming does not support --save-kmer-mmap/"
                      "--load-kmer-mmap (global table); use the in-memory "
                      "path")
            return 1
        if dopts.dedup_mode > 0 and dopts.dedup_edit_distance != -1:
            Log.error("--streaming does not support duplicate-fragment "
                      "dedup (global pairing state); use the in-memory path")
            return 1
        if dist_nprocs > 1 or dist_coord is not None:
            # the flagship composition: rank-partitioned streaming input
            # feeding the distributed table (nprocs == 1 runs the same
            # lockstep code degenerately)
            if ropts.max_kmer_output_depth > 0:
                Log.error("--streaming does not support "
                          "max-kmer-output-depth normalization (global "
                          "state); use the in-memory path")
                return 1
            from kmernator_tpu_torch.parallel import multihost
            multihost.initialize(dist_coord, dist_nprocs, dist_procid)
            rc = run_streaming_distributed(opts, kopts, sopts, ropts, aopts,
                                           fopts, streaming_chunk_mb,
                                           streaming_capacity, mesh_batch,
                                           device=device)
            Log.flush_gathered()
            return rc
        rc = run_streaming(opts, kopts, sopts, ropts, aopts, fopts,
                           streaming_chunk_mb, streaming_capacity,
                           mesh_devices=mesh_devices, mesh_batch=mesh_batch,
                           device=device)
        Log.flush_gathered()
        return rc

    multi = dist_nprocs > 1
    if multi:
        from kmernator_tpu_torch.parallel import multihost
        multihost.initialize(dist_coord, dist_nprocs, dist_procid)
        if mesh_devices == 0:
            mesh_devices = -1  # distributed implies the mesh count path

    Log.verbose(1, "Reading input files")
    if multi:
        rs = multihost.load_partitioned_reads(
            opts.input_file, opts.fastq_base_quality,
            opts.fastq_output_base_quality, opts.keep_read_comment)
    else:
        rs = load_reads(opts.input_file, opts.fastq_base_quality,
                        opts.fastq_output_base_quality,
                        opts.keep_read_comment)
    Log.verbose(1, "loaded %d reads" % rs.n)
    rs.identify_pairs()

    filt = None
    if not aopts.skip_artifact_filter:
        filt = ArtifactFilter(
            match_length=aopts.artifact_match_length,
            edit_distance=aopts.artifact_edit_distance,
            build_edits_in_filter=aopts.build_artifact_edits_in_filter,
            mask_simple_repeats=aopts.mask_simple_repeats,
            phix=aopts.phix_output,
            extra_reference_files=aopts.artifact_reference_file,
            min_quality=opts.min_quality_score,
            min_read_length=ropts.min_read_length)
        out = apply_artifact_filter(rs, filt)
        Log.verbose(1, "filter affected (trimmed/removed) %d reads" % out.affected)
        # diverted-read outputs (shared builder: divert_blobs above)
        blobs = divert_blobs(rs, out, opts, aopts)
        if multi and opts.output_file and (aopts.phix_output
                                           or aopts.filter_output):
            # every rank must join the gathered write even with no picks
            for path in multihost.allgather_strings(list(blobs.keys())):
                multihost.write_gathered(path, blobs.get(path, b""))
        else:
            for path, blob in blobs.items():
                with open(path, "wb") as f:
                    f.write(blob)

    if dopts.dedup_mode > 0 and dopts.dedup_edit_distance != -1:
        from kmernator_tpu_torch.ops.dedup import filter_duplicate_fragments
        dups = filter_duplicate_fragments(
            rs, dedup_length=dopts.dedup_length, mode=dopts.dedup_mode,
            consensus=dopts.dedup_consensus, dedup_single=dopts.dedup_single,
            start_offset=dopts.dedup_start_offset,
            min_quality=opts.min_quality_score,
            output_base=opts.fastq_output_base_quality,
            artifact_filter=filt, edit_distance=dopts.dedup_edit_distance)
        Log.verbose(1, "filter removed duplicate fragment pair reads: %d" % dups)

    k = kopts.kmer_size
    spectrum = None
    if k > 0 and mesh_devices != 0 and not sopts.load_kmer_mmap:
        # FilterReads-P analogue: counting via the sharded device mesh
        counts, w_off = window_count_lookup_mesh(
            rs, k, sopts.min_depth, opts.min_quality_score,
            opts.fastq_output_base_quality, sopts.min_kmer_quality,
            mesh_devices, batch_reads=mesh_batch,
            variant_sigmas=sopts.variant_sigmas,
            variant_hamming=sopts.variant_hamming_distance,
            min_variant_depth=sopts.min_variant_kmer_depth, device=device)
        trims = score_and_trim(rs, counts, w_off, k, float(sopts.min_depth),
                               ropts.kmer_scoring_type, first_markup_nor_x(rs),
                               ropts.bimodal_sigmas)
    elif k > 0:
        if sopts.load_kmer_mmap:
            spectrum = KmerSpectrum.load(sopts.load_kmer_mmap)
        else:
            subtract_keys = build_subtract_keys(
                fopts.reference_file, fopts.subtract_file, k,
                opts.min_quality_score, opts.fastq_output_base_quality,
                sopts.min_kmer_quality, sopts.min_depth)
            keys_cache = []
            if sopts.build_partitions > 1:
                # out-of-core hash-range partitioned build + merge
                # (ref: buildKmerSpectrumInParts, src/KmerSpectrum.h:1818-1902)
                spectrum = build_spectrum_in_parts(
                    rs, k, opts.min_quality_score,
                    opts.fastq_output_base_quality, sopts.min_kmer_quality,
                    sopts.build_partitions, subtract_keys,
                    opts.output_file + "-mmap" if opts.output_file else "")
                keys_cache = None
            else:
                spectrum = build_spectrum(rs, k, opts.min_quality_score,
                                          opts.fastq_output_base_quality,
                                          sopts.min_kmer_quality, keys_cache,
                                          subtract_keys)
            _spectrum_outputs_and_purge(spectrum, sopts, fopts)
            if sopts.save_kmer_mmap and opts.output_file:
                spectrum.save(opts.output_file + "-mmap")
                # np.savez appends .npz; keep the bare name for reload parity
                if os.path.exists(opts.output_file + "-mmap.npz"):
                    os.replace(opts.output_file + "-mmap.npz", opts.output_file + "-mmap")
        if sopts.gc_heat_map and opts.output_file:
            with open(opts.output_file + "-GC.txt", "w") as f:
                f.write(spectrum.gc_heat_map())
        Log.verbose(1, "spectrum: %d unique kmers" % spectrum.n_unique)
        cached = locals().get("keys_cache")
        counts, w_off = window_count_lookup(rs, spectrum, k,
                                            cached[0] if cached else None)
        trims = score_and_trim(rs, counts, w_off, k, float(sopts.min_depth),
                               ropts.kmer_scoring_type, first_markup_nor_x(rs),
                               ropts.bimodal_sigmas)
    else:
        trims = _trim_by_markup(rs)

    if opts.output_file:
        outputs = select_reads(rs, trims, spectrum, opts, kopts, sopts, ropts,
                               opts.input_file)
        if multi:
            # rank-ordered gathered writes over the union of output keys
            # (ref: DistributedOfstreamMap close, rank0-first append order,
            # apps/FilterReads-P.cpp:190-197)
            for path in multihost.allgather_strings(list(outputs.keys())):
                multihost.write_gathered(path, outputs.get(path, b""))
                Log.verbose(1, "wrote %s (gathered)" % path)
        else:
            for path, data in outputs.items():
                with open(path, "wb") as f:
                    f.write(data)
                Log.verbose(1, "wrote %s (%d bytes)" % (path, len(data)))
    # collective when --gathered-logs: all ranks reach this point
    Log.flush_gathered()
    return 0


def _trim_by_markup(rs: ReadSet) -> ReadTrims:
    """kmer-size == 0 path: trim at first markup
    (ref: trimReadByMarkupLength, src/ReadSelector.h:933-946)."""
    n = rs.n
    lens = rs.lengths()
    mk = first_markup_nor_x(rs)
    off = np.zeros(n, dtype=np.int64)
    length = np.where(mk != 0, mk - 1, lens)
    score = length.astype(np.float64)
    labels = [b""] * n
    for i in range(n):
        if rs.discarded[i]:
            length[i] = 0
            score[i] = 0.0
            continue
        lab = b""
        if mk[i] != 0:
            lab += b"Trim:%d+%d " % (0, length[i])
        lab += b"Score:%d" % int(score[i] + 0.5)
        labels[i] = lab
    return ReadTrims(off, length, score, labels, np.ones(n, dtype=bool))


def main():
    rc = run(sys.argv[1:])
    # fast exit: temp teardown runs explicitly, then skip interpreter
    # finalization (GC of multi-GB numpy heaps cost ~0.3 s per run as
    # measured on the JAX package's development host, a CPU machine,
    # not the H100's host)
    from kmernator_tpu_torch.utils import cleanup
    cleanup._flush()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


if __name__ == "__main__":
    main()
