"""The count path's padded input, built from a ReadSet's raw bytes.

`prepare_reads(rs, k, L, ..., device=)` returns, as tensors on `device`,
what the card's count path takes for a block of reads: codes [rows, L] u8
(markup bases as 0), good2d [rows, NW] bool (the exact float64 window
weights' goodness, NW = L - k + 1, false for discarded reads), lengths
[rows] i32, optionally weights2d [rows, NW] f32 and ext_ok2d [rows, L] bool
(MeraculousCounter's extension-quality mask), and totals [2] int64 (the
reads' windows, and the good ones). Rows from rs.n to `rows` are empty
reads, the shards' padding.

On a CUDA device the wrapper copies the reads' ragged bytes (sequence,
raw quality, offsets, one flag byte a read) to the card and launches the
hand-written kernel in csrc/prepare_reads.cu on the current stream, with
two 256-entry tables (`device_tables`): the base codes (BASE_CODE) and the
probability of each raw quality byte (`quality_table`, the host's
`phred_probability` of the byte less the input's quality base). On a CPU
device it takes the plain version beside it, `prepare_reads_plain`: the
host's NumPy steps (`pack_readset`, `window_weights`, `good_kmer_mask`,
`ragged_to_padded`). Nothing else chooses between them, and a failed build
or launch raises.

This replaces no TPU kernel: the JAX package prepares these arrays on the
host, since a TPU has no fast float64 for the weights' running product.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from kmernator_tpu_torch.io.reads import BASE_CODE
from kmernator_tpu_torch.ops.extensions import EXT_MIN_QUALITY
from kmernator_tpu_torch.ops.weights import (good_kmer_mask,
                                             phred_probability,
                                             window_weights)
from kmernator_tpu_torch.parallel.device_spectrum import (pack_readset,
                                                          ragged_to_padded)
from kmernator_tpu_torch.utils import timers

launches = 0          # kernel launches made by prepare_reads on CUDA devices

_lib = None
_tables = {}          # (device, input base, min quality, output base) ->
                      # the two tables on that device
_DTYPES = {np.uint8: torch.uint8, np.int64: torch.int64,
           np.float64: torch.float64}


class Prepared(NamedTuple):
    codes: torch.Tensor
    good2d: torch.Tensor
    lengths: torch.Tensor
    weights2d: Optional[torch.Tensor]
    ext_ok2d: Optional[torch.Tensor]
    totals: torch.Tensor


def _kernel_lib():
    global _lib
    if _lib is None:
        from kmernator_tpu_torch.kernels.build import load
        lib = load("prepare_reads")
        lib.kmtpu_prepare_reads_threads.argtypes = []
        lib.kmtpu_prepare_reads_threads.restype = ctypes.c_int
        p = ctypes.c_void_p
        lib.kmtpu_prepare_reads.argtypes = [
            p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int64,
            p, p, p, p, p, p, p]
        lib.kmtpu_prepare_reads.restype = ctypes.c_int
        _lib = lib
    return _lib


def quality_table(input_qual_base: int, min_quality: int,
                  output_base: int) -> np.ndarray:
    """[256] float64: P(correct) of each raw quality byte q, as the host
    computes it, phred_probability(q - input_qual_base) (the same int16
    phred, the same clip)."""
    phred = np.arange(256, dtype=np.int16) - np.int16(input_qual_base)
    return phred_probability(phred, min_quality, output_base)


def _pad(a: np.ndarray, rows: int) -> np.ndarray:
    if rows == a.shape[0]:
        return a
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


def prepare_reads_plain(rs, k: int, L: int, min_quality: int,
                        output_base: int, min_kmer_quality: float, *,
                        rows: Optional[int] = None, weights: bool = False,
                        ext_ok: bool = False) -> Prepared:
    """The plain version: the host's NumPy steps, as CPU tensors."""
    NW = L - k + 1
    rows = rs.n if rows is None else rows
    codes, _, lengths = pack_readset(rs, L, min_quality, output_base)
    markup = BASE_CODE[rs.seq] == 4
    p = rs.base_probabilities(min_quality, output_base)
    w = window_weights(p, rs.offsets, markup, k)
    lens = rs.lengths()
    nw = np.maximum(lens - k + 1, 0)
    good2d = ragged_to_padded(good_kmer_mask(w, min_kmer_quality), nw, NW,
                              fill=False)
    good2d &= ~rs.discarded[:, None]
    weights2d = ext_ok2d = None
    if weights:
        weights2d = torch.from_numpy(_pad(ragged_to_padded(
            w.astype(np.float32), nw, NW, fill=0.0), rows))
    if ext_ok:
        read_id = np.repeat(np.arange(rs.n), lens)
        ok_flat = (rs.phred() >= EXT_MIN_QUALITY) | ~rs.has_quals[read_id]
        ext_ok2d = torch.from_numpy(_pad(ragged_to_padded(
            ok_flat, lens, L, fill=False), rows))
    totals = torch.tensor([int(nw.sum()), int(good2d.sum())],
                          dtype=torch.int64)
    return Prepared(torch.from_numpy(_pad(codes, rows)),
                    torch.from_numpy(_pad(good2d, rows)),
                    torch.from_numpy(_pad(lengths, rows)), weights2d,
                    ext_ok2d, totals)


def _upload(a: np.ndarray, dev: torch.device, size: int) -> torch.Tensor:
    """a (1-D) into the head of a new device tensor of `size` elements."""
    t = torch.empty(size, dtype=_DTYPES[a.dtype.type], device=dev)
    if a.size:
        if not a.flags.writeable:
            a = a.copy()
        t[:a.size].copy_(torch.from_numpy(a))
    return t


def device_tables(dev: torch.device, input_qual_base: int,
                   min_quality: int, output_base: int):
    """The kernel's two tables on `dev`, made once a process: [256]
    float64 P(correct) by raw quality byte, and [256] u8 BASE_CODE."""
    key = (str(dev), input_qual_base, min_quality, output_base)
    tabs = _tables.get(key)
    if tabs is None:
        tabs = (_upload(quality_table(input_qual_base, min_quality,
                                      output_base), dev, 256),
                _upload(BASE_CODE, dev, 256))
        _tables[key] = tabs
    return tabs


def reads_on_device(rs, dev: torch.device):
    """The kernel's inputs: rs's ragged bytes, offsets (from 0) and flags
    copied to `dev`, and the widest span of bytes a block of the kernel's
    reads covers. (seq, qual, offsets, flags, max_span)."""
    lib = _kernel_lib()
    n = rs.n
    off = np.asarray(rs.offsets, dtype=np.int64)
    lo, hi = int(off[0]), int(off[-1])
    padded = max(-(-(hi - lo) // 16) * 16, 16)
    seq = _upload(np.ascontiguousarray(rs.seq[lo:hi]), dev, padded)
    qual = _upload(np.ascontiguousarray(rs.qual[lo:hi]), dev, padded)
    offsets = _upload(off - lo, dev, n + 1)
    flags = _upload(rs.has_quals.astype(np.uint8)
                    | (rs.discarded.astype(np.uint8) << 1), dev, n)
    timers.count("device.h2d_bytes", 2 * (hi - lo) + 9 * n + 8)
    T = lib.kmtpu_prepare_reads_threads()
    starts = np.arange(0, n, T)
    max_span = int((off[np.minimum(starts + T, n)] - off[starts]).max()
                   ) if n else 0
    return seq, qual, offsets, flags, max_span


def launch(reads, tables, n: int, k: int, L: int, min_kmer_quality: float,
           ext_min: int, out: Prepared) -> None:
    """One launch of the kernel on the current stream: `reads` from
    reads_on_device, `tables` the probability and code tables on the
    card, `out` the Prepared outputs to write (weights2d and ext_ok2d may
    be None). Raises if the launch fails."""
    global launches
    lib = _kernel_lib()
    seq, qual, offsets, flags, max_span = reads
    stream = torch.cuda.current_stream(seq.device).cuda_stream
    err = lib.kmtpu_prepare_reads(
        seq.data_ptr(), qual.data_ptr(), offsets.data_ptr(),
        flags.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), n,
        out.codes.shape[0], k, L, float(np.float32(min_kmer_quality)),
        ext_min, max_span, out.codes.data_ptr(), out.good2d.data_ptr(),
        out.lengths.data_ptr(),
        None if out.weights2d is None else out.weights2d.data_ptr(),
        None if out.ext_ok2d is None else out.ext_ok2d.data_ptr(),
        out.totals.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("prepare_reads kernel launch failed: CUDA error "
                           "%d" % err)
    launches += 1


def _prepare_reads_cuda(rs, k: int, L: int, min_quality: int,
                        output_base: int, min_kmer_quality: float,
                        dev: torch.device, rows: int, weights: bool,
                        ext_ok: bool) -> Prepared:
    NW = L - k + 1
    with torch.cuda.device(dev):
        reads = reads_on_device(rs, dev)
        out = Prepared(
            torch.empty((rows, L), dtype=torch.uint8, device=dev),
            torch.empty((rows, NW), dtype=torch.bool, device=dev),
            torch.empty(rows, dtype=torch.int32, device=dev),
            torch.empty((rows, NW), dtype=torch.float32, device=dev)
            if weights else None,
            torch.empty((rows, L), dtype=torch.bool, device=dev)
            if ext_ok else None,
            torch.empty(2, dtype=torch.int64, device=dev))
        launch(reads, device_tables(dev, rs.input_qual_base, min_quality,
                                    output_base),
               rs.n, k, L, min_kmer_quality,
               int(rs.input_qual_base) + EXT_MIN_QUALITY, out)
    return out


def prepare_reads(rs, k: int, L: int, min_quality: int, output_base: int,
                  min_kmer_quality: float, *, device,
                  rows: Optional[int] = None, weights: bool = False,
                  ext_ok: bool = False) -> Prepared:
    """rs: a ReadSet whose reads are at most L >= k bases; rows >= rs.n
    (default rs.n). Returns the Prepared tensors on `device` (see the
    module's note): the kernel on a CUDA device, the plain version on the
    CPU."""
    device = torch.device(device)
    rows = rs.n if rows is None else int(rows)
    if not 1 <= k <= L or rows < rs.n:
        raise ValueError("prepare_reads needs 1 <= k <= L and rows >= the "
                         "reads, got k=%d, L=%d, rows=%d for %d reads"
                         % (k, L, rows, rs.n))
    if rs.n and rs.max_length() > L:
        raise ValueError("a read of %d bases is longer than L=%d"
                         % (rs.max_length(), L))
    if len(rs.qual) != len(rs.seq):
        raise ValueError("quality and sequence bytes differ in length")
    if device.type not in ("cpu", "cuda"):
        raise ValueError("prepare_reads has no kernel for device %s"
                         % device)
    NW = L - k + 1
    # the bytes the work needs: two a base in, the offsets and a flag a
    # read, the padded rows out
    timers.count("kernel.prepare_reads_bytes",
                 2 * int(rs.offsets[-1] - rs.offsets[0]) + 9 * rs.n + 8
                 + rows * (L + NW + 4 + (4 * NW if weights else 0)
                           + (L if ext_ok else 0)))
    if device.type == "cpu":
        return prepare_reads_plain(rs, k, L, min_quality, output_base,
                                   min_kmer_quality, rows=rows,
                                   weights=weights, ext_ok=ext_ok)
    return _prepare_reads_cuda(rs, k, L, min_quality, output_base,
                               min_kmer_quality, device, rows, weights,
                               ext_ok)
