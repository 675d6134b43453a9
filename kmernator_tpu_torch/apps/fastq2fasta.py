"""Fastq2Fasta: format conversion with optional pair splitting and
size-partitioned outputs (ref: apps/Fastq2Fasta.cpp:55-188).

Copied for kmernator_tpu_torch from kmernator_tpu/apps/fastq2fasta.py.
It differs from its source in its package imports and in accepting
`--device cuda|cpu`, as the port's other apps do, and ignoring it
(utils/device.py `drop_device`): the app runs on the host whichever device
is named, with or without a visible GPU.
"""
from __future__ import annotations

import sys
from typing import Dict, List

from kmernator_tpu_torch.io.reads import load_reads, format_read
from kmernator_tpu_torch.apps.filter_reads import file_prefix
from kmernator_tpu_torch.utils.options import GeneralOptions, compose
from kmernator_tpu_torch.utils.device import drop_device


class _F2FOptions:
    FLAGS = {"split-pairs": lambda v: str(v).lower() not in ("0", "false", ""),
             "split-size-mbase": int,
             "write-qual": lambda v: str(v).lower() not in ("0", "false", "")}

    def __init__(self):
        self.split_pairs = False
        self.split_size_mbase = 0
        # Fastq2FastaQual mode (ref: apps/Fastq2FastaQual.cpp): also emit
        # .qual files with whitespace-separated integer phreds
        self.write_qual = False


def run(argv: List[str]) -> int:
    opts = GeneralOptions()
    opts.format_output = 3  # default fasta unmasked (ref: _resetDefaults)
    f2f = _F2FOptions()
    argv = ["--output-file" if a == "--out" else a for a in argv]
    argv = drop_device(argv)
    compose([opts, f2f], argv, positional=["input-file"])

    rs = load_reads(opts.input_file, opts.fastq_base_quality,
                    opts.fastq_output_base_quality, opts.keep_read_comment)
    rs.identify_pairs()

    split_size = f2f.split_size_mbase * 1_000_000
    out_name = opts.output_file
    if not out_name:
        split_size = 0
    outputs: Dict[str, List[bytes]] = {}
    quals_out: Dict[str, List[bytes]] = {}
    ph = rs.phred()
    current_base = 0
    partition = 1

    def emit(i, key):
        if f2f.write_qual and rs.has_quals[i]:
            q = ph[rs.offsets[i]:rs.offsets[i + 1]]
            rec = (b">" + rs.names[i] + b"\n"
                   + b" ".join(b"%d" % v for v in q) + b" \n")
            quals_out.setdefault(key, []).append(rec)
        rec = format_read(
            rs.names[i], rs.comments[i],
            rs.seq[rs.offsets[i]:rs.offsets[i + 1]].tobytes(),
            ph[rs.offsets[i]:rs.offsets[i + 1]],
            b"", opts.format_output, opts.fastq_output_base_quality,
            0, 1 << 30, bool(rs.discarded[i]), bool(rs.has_quals[i]),
            comment_stored=opts.keep_read_comment)
        outputs.setdefault(key, []).append(rec)

    suffix = ".fastq" if opts.format_output in (0, 2) else ".fasta"
    for (r1, r2) in rs.pairs:
        lesser = r1 if (0 <= r1 < rs.n) else r2
        filekey = ""
        if out_name:
            filekey = "-" + file_prefix(opts.input_file[rs.file_idx[lesser]])
        if split_size > 0:
            ln = int(rs.lengths()[lesser])
            current_base += ln
            if current_base > split_size:
                partition += 1
                current_base = ln
            filekey += "-%d" % partition
        if 0 <= r1 < rs.n and 0 <= r2 < rs.n:
            k1 = filekey + ("-1" if f2f.split_pairs else "")
            k2 = filekey + ("-2" if f2f.split_pairs else "")
            emit(r1, k1)
            emit(r2, k2)
        else:
            emit(lesser, filekey)

    if out_name:
        for key, recs in outputs.items():
            with open(out_name + key + suffix, "wb") as f:
                f.write(b"".join(recs))
        for key, recs in quals_out.items():
            with open(out_name + key + ".qual", "wb") as f:
                f.write(b"".join(recs))
    else:
        for recs in outputs.values():
            sys.stdout.buffer.write(b"".join(recs))
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


def main_qual():
    """Fastq2FastaQual entry point: fasta + sibling .qual output
    (ref: apps/Fastq2FastaQual.cpp)."""
    sys.exit(run(["--write-qual", "1"] + sys.argv[1:]))


if __name__ == "__main__":
    main()
