"""Streaming batched read input.

The reference never materializes large datasets (ReadSetStream,
ref: src/ReadSet.h:656-748); here the streaming unit is a dense padded
device batch: fixed [B, L] code/logp tensors produced straight from the raw
FASTQ buffer by the native indexer/packer (io/native.py), with byte-range
partitioning + pair-preserving resync for multi-host runs.

Copied for kmernator_tpu_torch from kmernator_tpu/io/stream.py; it differs
from its source only in its package imports. The lazy import of
`pack_readset` names the port's numpy copy in
kmernator_tpu_torch/parallel/device_spectrum.py, not the jax module.
"""
from __future__ import annotations

import os

from typing import Iterator, Optional, Tuple

import numpy as np

from kmernator_tpu_torch.io.reads import open_maybe_gzip, extract_partition
from kmernator_tpu_torch.io import native as native_io
from kmernator_tpu_torch.ops.weights import probability_table


def log2_table(min_quality: int, output_base: int, input_base: int,
               floor: float = -1e30) -> np.ndarray:
    """256-entry log2(P(correct)) indexed by RAW input quality char."""
    tab = probability_table(min_quality, output_base)
    out = np.full(256, floor, dtype=np.float64)
    for raw in range(256):
        phred = raw - input_base
        ch = phred + output_base
        if 0 <= ch < 256 and tab[ch] > 0.0:
            out[raw] = np.log2(tab[ch])
    return out


def detect_input_base(qual_sample: np.ndarray, initial: int = 33) -> int:
    """Quality-base detection over a sample (ref: ReadSet::validateFastqStart
    state machine)."""
    B = initial
    m = int(qual_sample.min()) if len(qual_sample) else initial
    if m < B:
        B = 33
    elif m > B + 40:
        B = 64
    return B


class FastqBatchStream:
    """Iterate fixed-size padded batches from FASTQ file(s).

    raw_qual=True yields (codes u8, qual u8, lengths) — 1 byte/base on the
    host->device link instead of a 4-byte float, with the logp table lookup
    fused into the device count step (see StreamingSpectrum.add_batch); the
    table for the conversion is exposed as .device_table after iteration
    starts."""

    def __init__(self, paths, batch_reads: int = 8192, L: int = 0,
                 min_quality: int = 3, output_base: int = 33,
                 rank: int = 0, size: int = 1, raw_qual: bool = False,
                 pack2: bool = False):
        self.paths = list(paths)
        self.batch_reads = batch_reads
        self.L = L
        self.min_quality = min_quality
        self.output_base = output_base
        self.rank, self.size = rank, size
        self.raw_qual = raw_qual or pack2
        self.pack2 = pack2
        self.device_table = None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        for path in self.paths:
            data = open_maybe_gzip(path, use_mmap=(self.size == 1))
            if self.size > 1:
                data = extract_partition(data, self.rank, self.size)
            idx = native_io.fastq_index(data)
            if idx is None:
                yield from self._python_batches(data)
                continue
            buf = np.frombuffer(data, dtype=np.uint8)
            n = len(idx["seq_off"])
            if n == 0:
                continue
            L = self.L or int(idx["seq_len"].max())
            input_base = detect_input_base(
                buf[idx["qual_off"][0]:idx["qual_off"][0] + idx["seq_len"][0]])
            ltab = log2_table(self.min_quality, self.output_base, input_base)
            self.device_table = ltab.astype(np.float32)
            self.device_table[self.device_table < -1e29] = -1e30
            for s in range(0, n, self.batch_reads):
                e = min(s + self.batch_reads, n)
                if self.pack2:
                    packed = native_io.pack_batch_2bit_qual(
                        buf, idx["seq_off"][s:e], idx["qual_off"][s:e],
                        idx["seq_len"][s:e], L)
                elif self.raw_qual:
                    packed = native_io.pack_batch_qual(
                        buf, idx["seq_off"][s:e], idx["qual_off"][s:e],
                        idx["seq_len"][s:e], L)
                else:
                    packed = native_io.pack_batch_idx(
                        buf, idx["seq_off"][s:e], idx["qual_off"][s:e],
                        idx["seq_len"][s:e], L, ltab)
                if packed is None:
                    continue
                codes, q_or_lp, lengths = packed
                if e - s < self.batch_reads:
                    pad = self.batch_reads - (e - s)
                    codes = np.concatenate(
                        [codes, np.zeros((pad, codes.shape[1]), np.uint8)])
                    fill = (np.zeros((pad, L), np.uint8) if self.raw_qual else
                            np.full((pad, L), -1e30, np.float32))
                    q_or_lp = np.concatenate([q_or_lp, fill])
                    lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
                yield codes, q_or_lp, lengths

    def _python_batches(self, data: bytes):
        from kmernator_tpu_torch.io.reads import parse_fastq_bytes, ReadSet
        from kmernator_tpu_torch.parallel.device_spectrum import pack_readset
        rs = ReadSet()
        rs.append_arrays(*parse_fastq_bytes(data))
        rs.detect_quality_base(self.output_base)
        L = self.L or rs.max_length()
        codes, logp, lengths = pack_readset(rs, L, self.min_quality,
                                            self.output_base)
        for s in range(0, rs.n, self.batch_reads):
            e = min(s + self.batch_reads, rs.n)
            c, lp, ln = codes[s:e], logp[s:e], lengths[s:e]
            if e - s < self.batch_reads:
                pad = self.batch_reads - (e - s)
                c = np.concatenate([c, np.zeros((pad, L), np.uint8)])
                lp = np.concatenate([lp, np.full((pad, L), -1e30, np.float32)])
                ln = np.concatenate([ln, np.zeros(pad, np.int32)])
            yield c, lp, ln


def estimate_raw_kmers(paths, k: int) -> int:
    """Estimate the total kmer-window count from file sizes (used to size
    streaming-table capacity; ref: KmerSpectrum::estimateRawKmers,
    src/KmerSpectrum.h:546-585 estimates from partition byte sizes).

    Samples the head of each file for bytes/record and read length, then
    extrapolates by file size (gz inputs assume ~3x compression)."""
    total = 0
    for path in paths:
        size = os.path.getsize(path)
        if path.endswith(".gz"):
            import gzip
            with gzip.open(path, "rb") as f:
                head = f.read(1 << 20)
            size *= 3
        else:
            with open(path, "rb") as f:
                head = f.read(1 << 20)
        if not head:
            continue
        if head[:1] == b">":
            # fasta: ~all bases; windows ~= bases (long sequences)
            total += size
            continue
        recs = head.split(b"\n")
        nrec = max(len(recs) // 4, 1)
        rec_bytes = len(head) / nrec
        rlen = max((len(recs[1]) if len(recs) > 1 else 100), 1)
        nreads = size / max(rec_bytes, 1.0)
        total += int(nreads * max(rlen - k + 1, 0))
    return total
