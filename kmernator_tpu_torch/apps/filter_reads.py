"""FilterReads with its device seams on PyTorch/CUDA.

Usage (the JAX app's flags, plus --device):
  python -m kmernator_tpu_torch.apps.filter_reads --device cuda --mesh 1 \
      --kmer-scoring-type MEDIAN --min-read-length 25 --out OUT 31 in.fastq

Everything but device counting and lookup is the JAX package's own host
code: `run` executes kmernator_tpu.apps.filter_reads.run (which imports no
jax on these paths) with its two device seams, `window_count_lookup_mesh`
(in-memory `--mesh 1`) and `_streaming_mesh_count` (`--streaming --mesh 1`,
and inputs over 2 MB, which stream on their own), bound to the torch
versions below for the duration of the call. The JAX module looks both up
as module globals when it calls them, so rebinding them there is enough.

`--device cuda|cpu` (default cuda) names the device; cuda without a GPU
raises. Refused, each waiting for a later PR: --distributed, --nprocs > 1,
--mesh > 1, --variant-sigmas > 0 with the in-memory --mesh, --gathered-logs
and k > 32.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from typing import List

import numpy as np
import torch

import kmernator_tpu.apps.filter_reads as host_app
from kmernator_tpu.io.reads import BASE_CODE
from kmernator_tpu.ops.kmer import extract_kmers_flat
from kmernator_tpu.ops.weights import good_kmer_mask, window_weights
from kmernator_tpu.parallel.spectrum import KmerSpectrum, pack_keys
from kmernator_tpu.utils.logging import Log
from kmernator_tpu_torch.ops.kmer import check_k
from kmernator_tpu_torch.parallel.device_spectrum import (
    DEFAULT_BATCH_READS, pack_readset, padded_to_ragged, ragged_to_padded)
from kmernator_tpu_torch.parallel.mesh import make_mesh
from kmernator_tpu_torch.parallel.mesh_stream import MeshStreamingSpectrum
from kmernator_tpu_torch.utils.device import resolve_device


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
    """In-memory --mesh 1 counting: pass 1 streams the reads' good windows
    into the device table in batches, pass 2 looks every window up on the
    device. Returns the host path's ragged (counts, window_offsets)."""
    check_k(k)
    if variant_sigmas > 0.0:
        raise NotImplementedError(
            "--variant-sigmas with the in-memory --mesh (the on-mesh "
            "variant purge) waits for a later PR of kmernator_tpu_torch")
    L = max(rs.max_length(), k)
    codes, _, lengths = pack_readset(rs, L, min_quality, output_base)
    B = codes.shape[0]
    NW = L - k + 1
    # exact good mask from the host recurrence
    markup = BASE_CODE[rs.seq] == 4
    p = rs.base_probabilities(min_quality, output_base)
    w = window_weights(p, rs.offsets, markup, k)
    exact_good = good_kmer_mask(w, min_kmer_quality)
    nw = np.maximum(rs.lengths() - k + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)])
    good2d = ragged_to_padded(exact_good, nw, NW, fill=False)
    good2d &= ~rs.discarded[:, None]
    weights2d = ragged_to_padded(w.astype(np.float32), nw, NW, fill=0.0)

    if capacity <= 0:
        capacity = max(int(np.ceil(int(exact_good.sum()) * 1.25)), 4096)
    if batch_reads <= 0:
        batch_reads = DEFAULT_BATCH_READS
    n_batches = max(-(-B // batch_reads), 1)
    sp = MeshStreamingSpectrum(make_mesh(n_devices, device), k,
                               capacity=capacity)
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


def _chunk_padded(rs, k: int, L: int, min_quality: int, output_base: int,
                  min_kmer_quality: float, subtract_keys=None,
                  track_weights: bool = False):
    """One streamed chunk -> padded batch arrays: codes [B, L] u8, good2d
    [B, NW] bool (exact host goodness), lengths [B] i32, weights2d [B, NW]
    f32 or None, and the chunk's (raw, good) window totals."""
    NW = L - k + 1
    codes, _, lengths = pack_readset(rs, L, min_quality, output_base)
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    p = rs.base_probabilities(min_quality, output_base)
    w = window_weights(p, rs.offsets, markup, k)
    good = good_kmer_mask(w, min_kmer_quality)
    if subtract_keys is not None and len(subtract_keys):
        cds = np.where(markup, 0, codes_raw).astype(np.uint8)
        canon, _, _, _ = extract_kmers_flat(cds, rs.offsets, k)
        keys = pack_keys(canon)
        idx = np.clip(np.searchsorted(subtract_keys, keys), 0,
                      len(subtract_keys) - 1)
        good = good & (subtract_keys[idx] != keys)
    nw = np.maximum(rs.lengths() - k + 1, 0)
    good2d = ragged_to_padded(good, nw, NW, fill=False)
    good2d &= ~rs.discarded[:, None]
    weights2d = None
    if track_weights:
        weights2d = ragged_to_padded(w.astype(np.float32), nw, NW, fill=0.0)
    return codes, good2d, lengths, weights2d, int(nw.sum()), int(
        (good & ~rs.discarded[np.repeat(np.arange(rs.n), nw)]).sum())


def _streaming_mesh_count(chunks, input_files, k, min_quality, output_base,
                          min_kmer_quality, mesh_devices, batch_reads,
                          capacity, subtract_keys, track_w, *,
                          device: torch.device) -> KmerSpectrum:
    """Pass 1 of --streaming --mesh 1: every chunk's good windows stream
    into the device table; the host never holds more than one chunk."""
    from kmernator_tpu.io.stream import estimate_raw_kmers
    check_k(k)
    if capacity <= 0:
        # the JAX package's per-device clamp: the estimate, at most 64M rows
        est = estimate_raw_kmers(input_files, k)
        capacity = min(max(int(np.ceil(est / mesh_devices)), 4096), 64 << 20)
    if batch_reads <= 0:
        batch_reads = DEFAULT_BATCH_READS
    sp = MeshStreamingSpectrum(make_mesh(mesh_devices, device), k,
                               capacity=capacity)
    raw = good_total = n_reads = 0
    L = 0
    for rs in chunks:
        need = max(rs.max_length(), k)
        if need > L:
            L = -(-need // 32) * 32  # bucketed pad length
        codes, good2d, lengths, weights2d, r, g = _chunk_padded(
            rs, k, L, min_quality, output_base, min_kmer_quality,
            subtract_keys, track_w)
        raw += r
        good_total += g
        for s in range(0, codes.shape[0], batch_reads):
            bw = weights2d[s:s + batch_reads] if weights2d is not None \
                else None
            sp.add_batch(_pad_rows(codes[s:s + batch_reads], batch_reads),
                         _pad_rows(good2d[s:s + batch_reads], batch_reads),
                         _pad_rows(lengths[s:s + batch_reads], batch_reads),
                         weights2d=None if bw is None
                         else _pad_rows(bw, batch_reads))
        n_reads += rs.n
    if sp.purged_singletons:
        Log.warn("mesh streaming purged %d singletons under capacity "
                 "pressure (counts may undercount by 1); raise "
                 "--streaming-parts capacity" % sp.purged_singletons)
    spectrum = sp.to_host_spectrum(min_depth=1)
    spectrum.raw_kmers = raw
    spectrum.raw_good_kmers = good_total
    Log.verbose(1, "mesh-streamed %d reads on %s; spectrum: %d unique kmers"
                % (n_reads, device, spectrum.n_unique))
    return spectrum


@contextlib.contextmanager
def torch_seams(device: torch.device):
    """Bind the JAX app's two device seams to the torch versions on
    `device`, restoring the originals on exit."""
    saved = (host_app.window_count_lookup_mesh,
             host_app._streaming_mesh_count)
    host_app.window_count_lookup_mesh = functools.partial(
        window_count_lookup_mesh, device=device)
    host_app._streaming_mesh_count = functools.partial(
        _streaming_mesh_count, device=device)
    try:
        yield
    finally:
        (host_app.window_count_lookup_mesh,
         host_app._streaming_mesh_count) = saved


def _flag_value(argv: List[str], flag: str):
    return argv[argv.index(flag) + 1] if flag in argv else None


def refusal(argv: List[str]):
    """The reason this port cannot run `argv` yet, or None."""
    if "--distributed" in argv or int(_flag_value(argv, "--nprocs")
                                      or 1) > 1:
        return ("--distributed/--nprocs (multi-process runs over "
                "torch.distributed) wait for the D > 1 PR")
    if int(_flag_value(argv, "--mesh") or 0) not in (0, 1):
        return ("--mesh %s waits for the D > 1 PR (owner hash, bucket "
                "scatter and all_to_all over NCCL); use --mesh 1"
                % _flag_value(argv, "--mesh"))
    if int(_flag_value(argv, "--gathered-logs") or 0) > 0:
        return ("--gathered-logs (rank-gathered logs) waits for the D > 1 "
                "PR")
    return None


def run(argv: List[str]) -> int:
    """FilterReads on the torch engine. Same arguments as
    kmernator_tpu.apps.filter_reads.run, plus --device cuda|cpu."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    why = refusal(argv)
    if why:
        raise NotImplementedError("kmernator_tpu_torch FilterReads: " + why)
    with torch_seams(resolve_device(device)):
        return host_app.run(argv)


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
