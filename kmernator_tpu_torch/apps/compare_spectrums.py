"""CompareSpectrums: shared/unique k-mer content between two read sets
(ref: apps/CompareSpectrums.cpp).  Output table columns:
Set1 Set2 Common %Uniq1 %Tot1 %Uniq2 %Tot2 [label].

Copied for kmernator_tpu_torch from kmernator_tpu/apps/compare_spectrums.py.
It differs from its source in its package imports and in accepting
`--device cuda|cpu`, as the port's other apps do, and ignoring it
(utils/device.py `drop_device`): the app runs on the host whichever device
is named, with or without a visible GPU.
"""
from __future__ import annotations

import sys
from typing import List

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet, load_reads, BASE_CODE
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
from kmernator_tpu_torch.parallel.spectrum import KmerSpectrum, pack_keys
from kmernator_tpu_torch.utils.options import (GeneralOptions, KmerBaseOptions,
                                               KmerSpectrumOptions, compose)
from kmernator_tpu_torch.utils.device import drop_device


class _CSOptions:
    FLAGS = {"reference-file": list,
             "circular-reference": lambda v: str(v).lower() not in ("0", "false", ""),
             "per-read": lambda v: str(v).lower() not in ("0", "false", "")}

    def __init__(self):
        self.reference_file = []
        self.circular_reference = False
        self.per_read = False


def solid_spectrum(rs: ReadSet, k: int) -> KmerSpectrum:
    """All kmers counted regardless of weight (ref: setSolidOnly +
    buildKmerSpectrum(..., isSolid=true) — solid tracking has no discard)."""
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    canon, is_fwd, read_id, _ = extract_kmers_flat(codes, rs.offsets, k)
    keys = pack_keys(canon)
    # markup windows still weigh 0 even for solid (weight 0 -> isDiscard when
    # min weight > 0; solid path via buildWeightedKmers zeroes markups)
    from kmernator_tpu_torch.ops.weights import window_weights, good_kmer_mask
    p = rs.base_probabilities(3, 33)
    w = window_weights(p, rs.offsets, markup, k)
    good = good_kmer_mask(w, 0.10) & ~rs.discarded[read_id]
    return KmerSpectrum.from_observations(k, keys, good)


def compare(sp1: KmerSpectrum, sp2: KmerSpectrum):
    common_mask = np.isin(sp1.keys, sp2.keys)
    common = int(common_mask.sum())
    c1 = int(sp1.counts[common_mask].sum())
    idx = np.searchsorted(sp2.keys, sp1.keys[common_mask])
    c2 = int(sp2.counts[np.clip(idx, 0, max(len(sp2.keys) - 1, 0))].sum()) if common else 0
    tot1 = int(sp1.counts.sum())
    tot2 = int(sp2.counts.sum())
    return common, c1, c2, tot1, tot2


def fmt_row(sp1, sp2, label=""):
    common, c1, c2, tot1, tot2 = compare(sp1, sp2)
    m1, m2 = sp1.n_unique, sp2.n_unique
    def pct(a, b):
        return "%.4g" % (a * 100.0 / b) if b else "0"
    return "%d\t%d\t%d\t%s\t%s\t%s\t%s\t%s" % (
        m1, m2, common, pct(common, m1), pct(c1, tot1),
        pct(common, m2), pct(c2, tot2), label)


def run(argv: List[str]) -> int:
    opts = GeneralOptions()
    kopts = KmerBaseOptions()
    sopts = KmerSpectrumOptions()
    cso = _CSOptions()
    argv = ["--output-file" if a == "--out" else a for a in argv]
    argv = drop_device(argv)
    compose([opts, kopts, sopts, cso], argv,
            positional=["kmer-size", "reference-file", "input-file"])
    k = kopts.kmer_size

    rs1 = load_reads(cso.reference_file, opts.fastq_base_quality,
                     opts.fastq_output_base_quality, opts.keep_read_comment)
    if cso.circular_reference:
        # append the first k bases to each sequence (ref: ReadSet::circularize)
        for i in range(rs1.n):
            seq = rs1.get_seq(i)
            ph = rs1.get_phred(i) if rs1.has_quals[i] else None
            rs1.append_read(rs1.names[i] + b"-circ", rs1.comments[i],
                            seq + seq[:k], None if ph is None else
                            np.concatenate([ph, ph[:k]]))
    rs2 = load_reads(opts.input_file, opts.fastq_base_quality,
                     opts.fastq_output_base_quality, opts.keep_read_comment)

    sp2 = solid_spectrum(rs2, k)
    lines = ["", "Set 1\tSet 2\tCommon\t%Uniq1\t%Tot1\t%Uniq2\t%Tot2"]
    if cso.per_read:
        for i in range(rs1.n):
            sub = ReadSet()
            sub.input_qual_base = rs1.input_qual_base
            sub.append_read(rs1.names[i], rs1.comments[i], rs1.get_seq(i),
                            rs1.get_phred(i) if rs1.has_quals[i] else None)
            sp1 = solid_spectrum(sub, k)
            lines.append(fmt_row(sp1, sp2, rs1.names[i].decode()))
    else:
        sp1 = solid_spectrum(rs1, k)
        lines.append(fmt_row(sp1, sp2))
    text = "\n".join(lines) + "\n"
    if opts.output_file:
        open(opts.output_file, "w").write(text)
    else:
        sys.stdout.write(text)
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
