"""FilterAndSortSam: flag-filter + coordinate-sort a single SAM/BAM file
(ref: apps/FilterAndSortSam.c — the samtools-based single-file variant of
BamSort).

Usage: filter_and_sort_sam [--require-flags N] [--exclude-flags N]
                           [--min-mapq N] output.bam input.[sb]am

Copied for kmernator_tpu_torch from kmernator_tpu/apps/filter_and_sort_sam.py.
It differs from its source in its package imports and in accepting
`--device cuda|cpu`, as the port's other apps do, and ignoring it
(utils/device.py `drop_device`): the app runs on the host whichever device
is named, with or without a visible GPU.
"""
from __future__ import annotations

import struct
import sys
from typing import List

import numpy as np

from kmernator_tpu_torch.io.bam import (coordinate_sort_order,
                                        load_alignments, write_bam)
from kmernator_tpu_torch.utils.device import drop_device


def run(argv: List[str]) -> int:
    argv = drop_device(argv)
    require = exclude = 0
    min_mapq = 0
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--require-flags":
            require = int(argv[i + 1]); i += 2
        elif a == "--exclude-flags":
            exclude = int(argv[i + 1]); i += 2
        elif a == "--min-mapq":
            min_mapq = int(argv[i + 1]); i += 2
        else:
            args.append(a); i += 1
    if len(args) != 2:
        print("usage: filter_and_sort_sam [options] output.bam input", file=sys.stderr)
        return 1
    out_path, in_path = args

    bd = load_alignments(in_path)
    keep = np.ones(bd.n, dtype=bool)
    if require:
        keep &= (bd.flag & require) == require
    if exclude:
        keep &= (bd.flag & exclude) == 0
    if min_mapq:
        mapq = np.array([bd.records[i][9] for i in range(bd.n)], np.int32)
        keep &= mapq >= min_mapq
    order = coordinate_sort_order(bd)
    order = order[keep[order]]
    with open(out_path, "wb") as f:
        f.write(write_bam(bd, order))
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
