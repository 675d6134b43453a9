"""RandomlySample: exact-count random sampling of reads or pairs
(ref: apps/RandomlySample.cpp:55-336).  The reference samples file
positions to avoid loading everything; here the columnar ReadSet is cheap
enough to load and sample indices directly — same output contract (exactly
num-samples records, input order preserved).

Copied for kmernator_tpu_torch from kmernator_tpu/apps/randomly_sample.py.
It differs from its source in its package imports and in accepting
`--device cuda|cpu`, as the port's other apps do, and ignoring it
(utils/device.py `drop_device`): the app runs on the host whichever device
is named, with or without a visible GPU.
"""
from __future__ import annotations

import sys
from typing import List

import numpy as np

from kmernator_tpu_torch.io.reads import load_reads, format_read
from kmernator_tpu_torch.utils.options import GeneralOptions, compose
from kmernator_tpu_torch.utils.device import drop_device


class _RSOptions:
    FLAGS = {"by-pair": lambda v: str(v).lower() not in ("0", "false", ""),
             "num-samples": int, "seed": int}

    def __init__(self):
        self.by_pair = True
        self.num_samples = 1000
        self.seed = 0


def run(argv: List[str]) -> int:
    opts = GeneralOptions()
    rso = _RSOptions()
    argv = ["--output-file" if a == "--out" else a for a in argv]
    argv = drop_device(argv)
    compose([opts, rso], argv, positional=["input-file"])

    rs = load_reads(opts.input_file, opts.fastq_base_quality,
                    opts.fastq_output_base_quality, opts.keep_read_comment)
    rng = np.random.default_rng(rso.seed)
    out = sys.stdout.buffer
    f = None
    if opts.output_file:
        f = open(opts.output_file, "wb")
        out = f
    ph = rs.phred()

    def emit(i):
        out.write(format_read(
            rs.names[i], rs.comments[i],
            rs.seq[rs.offsets[i]:rs.offsets[i + 1]].tobytes(),
            ph[rs.offsets[i]:rs.offsets[i + 1]],
            b"", opts.format_output, opts.fastq_output_base_quality,
            0, 1 << 30, bool(rs.discarded[i]), bool(rs.has_quals[i]),
            comment_stored=opts.keep_read_comment))

    if rso.by_pair:
        rs.identify_pairs()
        n = len(rs.pairs)
        k = min(rso.num_samples, n)
        sel = np.sort(rng.choice(n, size=k, replace=False))
        for pi in sel:
            r1, r2 = rs.pairs[pi]
            for r in (r1, r2):
                if 0 <= r < rs.n:
                    emit(r)
    else:
        n = rs.n
        k = min(rso.num_samples, n)
        sel = np.sort(rng.choice(n, size=k, replace=False))
        for i in sel:
            emit(i)
    if f:
        f.close()
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
