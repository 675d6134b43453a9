"""EstimateSize: genome size / error-rate estimation from subsampled k-mer
growth curves (ref: apps/EstimateSize-P.cpp + apps/EstimateSize.R).

Reads progressively larger fractions of the input, tracks (rawKmers,
uniqueKmers) growth with hash-subsampled kmers, and fits the R script's
asymptote model  unique(x) = a*x + b - b*((b+a-1)/b)^x  where a ~ error
kmers per raw kmer and b ~ (subsampled) genome size.  The fit replaces the
offline R nls() with a numpy Gauss-Newton loop.

Copied for kmernator_tpu_torch from kmernator_tpu/apps/estimate_size.py.
It differs from its source in its package imports and in accepting
`--device cuda|cpu`, as the port's other apps do, and ignoring it
(utils/device.py `drop_device`): the app runs on the host whichever device
is named, with or without a visible GPU.
It drops the source's unused import of `owner_hash` from
kmernator_tpu/parallel/mesh.py, the only reason the source imports jax;
`owner_hash_np` stays.
"""
from __future__ import annotations

import sys
from typing import List

import numpy as np

from kmernator_tpu_torch.io.reads import load_reads, open_maybe_gzip, extract_partition, BASE_CODE
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
from kmernator_tpu_torch.ops.weights import window_weights, good_kmer_mask
from kmernator_tpu_torch.parallel.spectrum import pack_keys
from kmernator_tpu_torch.utils.logging import Log
from kmernator_tpu_torch.utils.options import (GeneralOptions, KmerBaseOptions,
                                               KmerSpectrumOptions, compose)
from kmernator_tpu_torch.utils.device import drop_device


class _ESOptions:
    FLAGS = {"sample-partitions": int, "max-sample-fraction": float}

    def __init__(self):
        self.sample_partitions = 50
        self.max_sample_fraction = 0.05


def fit_asymptote(x: np.ndarray, y: np.ndarray, iters: int = 200):
    """Gauss-Newton fit of y = a*x + b - b*c^x, c = (b+a-1)/b
    (ref: apps/EstimateSize.R fun3)."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    scale = x.max() if len(x) else 1.0
    a = max((y[-1] - y[len(y) // 2]) / max(x[-1] - x[len(x) // 2], 1.0), 1e-6)
    b = max(y.max(), 1.0)
    for _ in range(iters):
        c = (b + a - 1.0) / b
        cx = np.power(c, x)
        r = y - (a * x + b - b * cx)
        # gradient (from the R script)
        dyda = ((-b * cx + b + a - 1.0) * x) / (b + a - 1.0)
        dydb = ((a - 1.0) * cx * x + (-b - a + 1.0) * cx + b + a - 1.0) / (b + a - 1.0)
        J = np.stack([dyda, dydb], axis=1)
        try:
            delta, *_ = np.linalg.lstsq(J, r, rcond=None)
        except np.linalg.LinAlgError:
            break
        a = float(a + 0.5 * delta[0])
        b = float(b + 0.5 * delta[1])
        a = min(max(a, 1e-9), 1.0)
        b = max(b, 1.0)
    return a, b


def run(argv: List[str]) -> int:
    opts = GeneralOptions()
    kopts = KmerBaseOptions()
    sopts = KmerSpectrumOptions()
    sopts.min_depth = 1
    sopts.kmer_subsample = 1000
    eso = _ESOptions()
    argv = ["--output-file" if a == "--out" else a for a in argv]
    argv = drop_device(argv)
    compose([opts, kopts, sopts, eso], argv,
            positional=["kmer-size", "input-file"])
    k = kopts.kmer_size
    if k <= 0:
        Log.error("kmer-size required")
        return 1
    subsample = max(sopts.kmer_subsample, 1)

    partitions = eso.sample_partitions
    total_partitions = int(partitions / eso.max_sample_fraction)
    seen = set()
    history = []  # (raw_kmers_scaled, unique)
    raw = 0
    total_reads = 0
    total_bases = 0
    datas = [open_maybe_gzip(p) for p in opts.input_file]
    for it in range(partitions):
        for data in datas:
            part = extract_partition(data, it, total_partitions)
            if not part:
                continue
            rs = load_reads_from_bytes(part, opts)
            total_reads += rs.n
            total_bases += int(rs.lengths().sum())
            codes_raw = BASE_CODE[rs.seq]
            markup = codes_raw == 4
            codes = np.where(markup, 0, codes_raw).astype(np.uint8)
            canon, _, read_id, _ = extract_kmers_flat(codes, rs.offsets, k)
            keys = pack_keys(canon)
            p = rs.base_probabilities(opts.min_quality_score,
                                      opts.fastq_output_base_quality)
            w = window_weights(p, rs.offsets, markup, k)
            good = good_kmer_mask(w, sopts.min_kmer_quality)
            keys = keys[good]
            raw += len(keys)
            # hash-based subsample (ref: kmer-subsample option)
            h = owner_hash_np(keys)
            keys = keys[h % subsample == 0]
            seen.update(keys.tolist())
        history.append((raw / subsample, len(seen)))

    hist = np.array(history, dtype=np.float64)
    a, b = fit_asymptote(hist[:, 0], hist[:, 1])
    genome_size = b * subsample
    error_rate = a  # error kmers per raw kmer
    fraction = partitions / total_partitions
    est_total_reads = int(total_reads / fraction)
    est_total_bases = int(total_bases / fraction)
    out = sys.stdout
    if opts.output_file:
        out = open(opts.output_file, "w")
    out.write("sampledFraction\t%.4f\n" % fraction)
    out.write("sampledReads\t%d\nsampledBases\t%d\n" % (total_reads, total_bases))
    out.write("estimatedReads\t%d\nestimatedBases\t%d\n" % (est_total_reads, est_total_bases))
    out.write("estimatedGenomeSize\t%d\n" % int(genome_size))
    out.write("estimatedErrorKmersPerRawKmer\t%.4f\n" % error_rate)
    if opts.output_file:
        out.close()
    return 0


def owner_hash_np(keys: np.ndarray) -> np.ndarray:
    """murmur-style mix over key words; u64 keys use the historical 2-word
    form, wide ('S4W' byte) keys mix all W words."""
    if keys.dtype != np.uint64:
        W = keys.dtype.itemsize // 4
        words = np.ascontiguousarray(keys).view(">u4").reshape(len(keys), W)
        cols = [words[:, w].astype(np.uint32) for w in range(W)]
    else:
        cols = [((keys >> np.uint64(32)) & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    h = np.uint32(0x9E3779B9) * np.ones(len(keys), dtype=np.uint32)
    for w in cols:
        h = h ^ w
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h


def load_reads_from_bytes(data: bytes, opts):
    from kmernator_tpu_torch.io.reads import ReadSet, parse_fastq_bytes, parse_fasta_bytes
    rs = ReadSet()
    if data[:1] == b">":
        rs.append_arrays(*parse_fasta_bytes(data, opts.keep_read_comment))
    else:
        rs.append_arrays(*parse_fastq_bytes(data, opts.keep_read_comment))
    rs.detect_quality_base(opts.fastq_output_base_quality)
    return rs


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
