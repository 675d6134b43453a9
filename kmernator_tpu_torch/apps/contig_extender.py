"""ContigExtender: standalone greedy k-mer extension of given contigs with
given reads (no matching loop — the single-shot CLI around the same core
the assembler uses).

Re-implements apps/ContigExtender.cpp (ref: :102-140): load reads and the
--contig-file, optionally dedup-filter the reads, run
ContigExtender::extendContigs, write the extended contigs as FASTA
(the reference forces FASTA output, ref: :81 getFormatOutput() = 3).
Artifact filtering is skipped by default as in the reference (ref: :79).

Usage:
  python -m kmernator_tpu_torch.apps.contig_extender --device cpu \
      --contig-file contigs.fa --out extended reads.fastq

Copied for kmernator_tpu_torch from kmernator_tpu/apps/contig_extender.py.
It differs from its source in its package imports and in taking `--device
cuda|cpu` (default cuda; utils/device.py `take_device`, so cuda
without a visible GPU raises) in place of `--jax-platform`. The app runs
on the host whichever device is named.
"""
from __future__ import annotations

import sys
from typing import List

from kmernator_tpu_torch.io.reads import load_reads
from kmernator_tpu_torch.ops.extend import ExtendParams, extend_contigs
from kmernator_tpu_torch.utils.device import take_device
from kmernator_tpu_torch.utils.logging import Log
from kmernator_tpu_torch.utils.options import (GeneralOptions, KmerBaseOptions,
                                         DuplicateFilterOptions, compose)


class ContigExtenderOptions:
    """ref: _ContigExtenderBaseOptions (src/ContigExtender.h:61-128)."""
    FLAGS = {"contig-file": str, "minimum-consensus": float,
             "minimum-coverage": float, "maximum-delta-ratio": float,
             "minimum-extension-factor": float}

    def __init__(self):
        self.contig_file = ""
        self.minimum_consensus = 85.0
        self.minimum_coverage = 4.8
        self.maximum_delta_ratio = 0.33
        self.minimum_extension_factor = 0.90


def run(argv: List[str]) -> int:
    opts = GeneralOptions()
    kopts = KmerBaseOptions()
    copts = ContigExtenderOptions()
    dopts = DuplicateFilterOptions()
    argv = ["--output-file" if a == "--out" else a for a in argv]
    argv = take_device(argv)[1]
    compose([opts, kopts, copts, dopts], argv,
            positional=["kmer-size", "input-file"])
    Log.verbose_level = opts.verbose
    if not copts.contig_file:
        Log.error("There was no --contig-file specified!")
        return 1
    if not opts.input_file:
        Log.error("no input files specified")
        return 1

    reads = load_reads(list(opts.input_file), 33,
                       opts.fastq_output_base_quality, opts.keep_read_comment)
    Log.verbose(1, "loaded %d reads" % reads.n)
    contigs = load_reads([copts.contig_file], 33,
                         opts.fastq_output_base_quality,
                         opts.keep_read_comment)
    Log.verbose(1, "loaded %d contigs" % contigs.n)

    if dopts.dedup_mode > 0 and dopts.dedup_edit_distance >= 0:
        from kmernator_tpu_torch.ops.dedup import filter_duplicate_fragments
        reads.identify_pairs()
        removed = filter_duplicate_fragments(
            reads, dedup_length=dopts.dedup_length, mode=dopts.dedup_mode,
            consensus=dopts.dedup_consensus, dedup_single=dopts.dedup_single,
            start_offset=dopts.dedup_start_offset,
            min_quality=opts.min_quality_score,
            output_base=opts.fastq_output_base_quality,
            edit_distance=dopts.dedup_edit_distance)
        Log.verbose(1, "filter removed duplicate fragment pair reads: %d"
                    % removed)

    params = ExtendParams(
        minimum_consensus=copts.minimum_consensus / 100.0,
        minimum_coverage=copts.minimum_coverage,
        maximum_delta_ratio=copts.maximum_delta_ratio)
    min_k = kopts.kmer_size if kopts.kmer_size > 0 else 25
    new_contigs = extend_contigs(contigs, reads, params, min_k,
                                 min_quality=opts.min_quality_score,
                                 output_base=opts.fastq_output_base_quality)

    if opts.output_file:
        with open(opts.output_file, "wb") as f:
            for i in range(new_contigs.n):
                f.write(b">" + new_contigs.names[i] + b"\n"
                        + new_contigs.get_seq(i) + b"\n")
    Log.verbose(1, "Finished")
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
