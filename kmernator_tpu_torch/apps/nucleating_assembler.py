"""DistributedNucleatingAssembler: iterative targeted seed assembly.

Re-implements apps/DistributedNucleatingAssembler.cpp:339-547: load reads
(artifact-filtered), build the k-mer read matcher, then iterate: match reads
to each contig's edges, pool them, greedily extend each contig with the
k-mer extender at ascending k, retire contigs that stopped growing or
exceeded --max-contig-length, and checkpoint contig FASTAs every iteration.

This is the single-process entry point; the matcher/extender cores are the same
modules the mesh path shards.

Copied for kmernator_tpu_torch from kmernator_tpu/apps/nucleating_assembler.py.
It differs from its source in its package imports and in:
- `--device cuda|cpu` (default cuda) in place of `--jax-platform`,
  resolved before anything is read (utils/device.py `resolve_device`:
  cuda without a visible GPU raises, so the host and vmatch engines need
  `--device cpu` on a machine without one);
- the `--mesh` branch builds the read index of parallel/dist_match.py on
  that device in place of the JAX mesh; `--mesh` other than 1 (when the
  k-mer matcher is selected, k > 0) is refused by `make_mesh` and k > 96
  by `check_k`, both before the input is read. The host engines take any
  k, as in the source.
"""
from __future__ import annotations

import os
import sys
from typing import List

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet, load_reads, format_read
from kmernator_tpu_torch.ops.artifact import ArtifactFilter, apply_artifact_filter
from kmernator_tpu_torch.ops.extend import (ExtendParams, extend_contigs,
                                      get_min_max_kmer_size, new_contig_name)
from kmernator_tpu_torch.ops.kmer import check_k
from kmernator_tpu_torch.ops.match import KmerReadIndex, match_pools
from kmernator_tpu_torch.parallel.mesh import make_mesh
from kmernator_tpu_torch.utils.device import resolve_device
from kmernator_tpu_torch.utils.logging import Log
from kmernator_tpu_torch.utils.options import (GeneralOptions, KmerBaseOptions,
                                         KmerSpectrumOptions,
                                         FilterArtifactOptions, compose)


class _AsmOptions:
    FLAGS = {"contig-file": str, "max-iterations": int,
             "max-contig-length": int, "max-contigs-per-batch": int,
             "minimum-consensus": float, "minimum-coverage": float,
             "maximum-delta-ratio": float, "minimum-extension-factor": float,
             "match-max-positions-from-edge": int, "max-read-matches": int,
             "max-read-depth-matches": int,
             "include-mate": lambda v: str(v).lower() not in ("0", "false"),
             "min-match-overlap": int, "min-identity-fraction": float,
             "return-overlap-only":
                 lambda v: str(v).lower() not in ("0", "false"),
             "mesh": int, "device": str,
             # Vmatch backend knobs (ref: src/Vmatch.h:62-92); vmatch-path/
             # index-path/preload are accepted for CLI parity but unused —
             # the matcher is built in, no external binary or disk index
             "vmatch-path": str, "vmatch-options": str,
             "vmatch-index-path": str,
             "vmatch-preload":
                 lambda v: str(v).lower() not in ("0", "false")}

    def __init__(self):
        self.contig_file = ""
        self.max_iterations = 1000
        self.max_contig_length = 3000
        self.max_contigs_per_batch = 25
        self.minimum_consensus = 85.0
        self.minimum_coverage = 4.8
        self.maximum_delta_ratio = 0.33
        self.minimum_extension_factor = 0.2  # ref: ContigExtender.h:93
        self.match_max_positions_from_edge = 500
        # MatcherInterface screening defaults (ref: MatcherInterface.h:66)
        self.max_read_matches = 450
        self.max_read_depth_matches = 0
        self.include_mate = True
        self.min_match_overlap = 51
        self.min_identity_fraction = 0.986
        self.return_overlap_only = True
        self.mesh = 0
        self.device = "cuda"
        self.vmatch_path = ""
        self.vmatch_options = "-d -p -seedlength 10 -l 50 -e 3"
        self.vmatch_index_path = "."
        self.vmatch_preload = False


def _subset(rs: ReadSet, indices) -> ReadSet:
    out = ReadSet()
    out.input_qual_base = rs.input_qual_base
    for i in indices:
        out.append_read(rs.names[i], rs.comments[i], rs.get_seq(i),
                        rs.get_phred(i) if rs.has_quals[i] else None)
        out.discarded[-1] = rs.discarded[i]
    return out


def screen_pools(rs: ReadSet, contigs: ReadSet, pools, asm, k: int,
                 mate: dict):
    """MatcherInterface match screening (ref: MatcherInterface.h:189-350):
    keep reads that overlap-align to the contig (min-match-overlap +
    min-identity-fraction), add their mates (include-mate), and subsample
    to the read/depth caps."""
    from kmernator_tpu_torch.ops.align import KmerAligner
    rng = np.random.default_rng(0)
    lens = rs.lengths()
    avg_len = float(lens.mean()) if rs.n else 76.0
    out = []
    for ci in range(contigs.n):
        ids = pools[ci]
        if asm.return_overlap_only and ids:
            aligner = KmerAligner(contigs.get_seq(ci), k)
            keep = set()
            for r in ids:
                a = aligner.align(rs.get_seq(r))
                ov = a.overlap
                if (ov >= asm.min_match_overlap and ov > 0 and
                        (ov - a.mismatches) / ov >= asm.min_identity_fraction):
                    keep.add(r)
            ids = keep
        if asm.include_mate:
            ids = ids | {mate[r] for r in ids if r in mate}
        max_reads = asm.max_read_matches
        if asm.max_read_depth_matches > 0:
            depth_cap = int(asm.max_read_depth_matches *
                            len(contigs.get_seq(ci)) / max(avg_len, 1.0))
            max_reads = max(max_reads, depth_cap)
        if max_reads and len(ids) > 2 * max_reads:
            frac = (2.0 * max_reads) / len(ids)
            ids = {r for r in ids if rng.random() < frac}
        out.append(ids)
    return out


def write_fasta(rs: ReadSet, path: str):
    with open(path, "wb") as f:
        for i in range(rs.n):
            f.write(b">" + rs.names[i] + b"\n" + rs.get_seq(i) + b"\n")


def run(argv: List[str]) -> int:
    opts = GeneralOptions()
    kopts = KmerBaseOptions()
    sopts = KmerSpectrumOptions()
    aopts = FilterArtifactOptions()
    asm = _AsmOptions()
    argv = ["--output-file" if a == "--out" else a for a in argv]
    compose([opts, kopts, sopts, aopts, asm], argv,
            positional=["kmer-size", "input-file"])
    device = resolve_device(asm.device)
    Log.verbose_level = opts.verbose
    if getattr(opts, "log_file", ""):
        Log.set_log_file(opts.log_file)
    if not asm.contig_file:
        Log.error("you must specify the --contig-file")
        return 1
    use_vmatch = kopts.kmer_size == 0  # ref: the assembler selects the
    # Vmatch matcher iff --kmer-size is 0
    # (apps/DistributedNucleatingAssembler.cpp:392-397)
    if asm.mesh and not use_vmatch:
        make_mesh(asm.mesh, device)     # raises for --mesh other than 1
        check_k(kopts.kmer_size)

    rs = load_reads(opts.input_file, opts.fastq_base_quality,
                    opts.fastq_output_base_quality, opts.keep_read_comment)
    rs.identify_pairs()
    if not aopts.skip_artifact_filter:
        filt = ArtifactFilter(edit_distance=aopts.artifact_edit_distance,
                              min_quality=opts.min_quality_score)
        apply_artifact_filter(rs, filt)

    if use_vmatch:
        # Vmatch backend: local seed-and-verify substring index over the
        # reads (ref: src/Vmatch.h:93-279). Built in-process — the reference
        # forks the external vmatch binary per rank; vmatch-path/index-path
        # are accepted but unused.
        from kmernator_tpu_torch.ops.vmatch import (SeedReadIndex,
                                              parse_vmatch_options,
                                              vmatch_pools)
        seed, min_len, max_err = parse_vmatch_options(asm.vmatch_options)
        index = SeedReadIndex(rs, seed, min_len, max_err)
        pool_fn = lambda idx, ctg: vmatch_pools(idx, ctg)
    elif asm.mesh:
        # distributed matcher: index sharded over the device mesh, edge-kmer
        # queries resolved collectively (the exchangeGlobalReads analogue);
        # one device here
        from kmernator_tpu_torch.parallel.dist_match import (MeshReadIndex,
                                                             mesh_match_pools)
        mesh = make_mesh(asm.mesh, device)
        index = MeshReadIndex(mesh, rs, kopts.kmer_size, sopts.min_depth,
                              opts.min_quality_score,
                              opts.fastq_output_base_quality,
                              sopts.min_kmer_quality)
        pool_fn = lambda idx, ctg: mesh_match_pools(
            idx, ctg, asm.match_max_positions_from_edge, 0)
    else:
        index = KmerReadIndex(rs, kopts.kmer_size, sopts.min_depth,
                              opts.min_quality_score,
                              opts.fastq_output_base_quality,
                              sopts.min_kmer_quality)
        pool_fn = lambda idx, ctg: match_pools(
            idx, ctg, asm.match_max_positions_from_edge, 0)
    min_k, max_k, k_step = get_min_max_kmer_size(rs, kopts.kmer_size)
    if min_k < 2:
        # kmer-size 0 (Vmatch mode): the reference's k=0 spectrum is empty and
        # extends nothing, so the first productive ladder rung is min+step
        min_k += k_step
    # overlap screening aligns with a kmer seed; with kmer-size 0 the
    # reference's KmerAlign seed is degenerate — use the first extension k
    align_k = kopts.kmer_size or min_k
    max_extend = max_k
    params = ExtendParams(minimum_consensus=asm.minimum_consensus / 100.0,
                          minimum_coverage=asm.minimum_coverage,
                          maximum_delta_ratio=asm.maximum_delta_ratio,
                          max_extend=max_extend)

    mate = {}
    for p1, p2 in rs.pairs:
        if p1 >= 0 and p2 >= 0:
            mate[p1] = p2
            mate[p2] = p1

    contigs = load_reads([asm.contig_file])
    final = ReadSet()
    final.input_qual_base = rs.input_qual_base

    from kmernator_tpu_torch.utils.timers import PhaseTimer
    timer = PhaseTimer()
    iteration = 0
    while iteration < asm.max_iterations and contigs.n > 0:
        iteration += 1
        timer.reset("iteration-%d" % iteration)
        Log.verbose(1, "Iteration %d: %d contigs" % (iteration, contigs.n))
        pools = pool_fn(index, contigs)
        pools = screen_pools(rs, contigs, pools, asm, align_k, mate)
        timer.record("match")
        changed = ReadSet()
        changed.input_qual_base = rs.input_qual_base
        for ci in range(contigs.n):
            old_len = int(contigs.lengths()[ci])
            pool_ids = sorted(pools[ci])
            if len(pool_ids) <= asm.minimum_coverage:
                final.append_read(contigs.names[ci], b"",
                                  contigs.get_seq(ci), None)
                continue
            pool = _subset(rs, pool_ids)
            single = _subset(contigs, [ci])
            new_len = 0
            my_k = min_k
            new_contig = None
            # ascending-k retry (ref: extendContigsWithContigExtender)
            while new_len <= old_len and my_k <= max_k:
                new_contig = extend_contigs(single, pool, params, my_k, my_k, 2,
                                            opts.min_quality_score,
                                            opts.fastq_output_base_quality,
                                            sopts.min_kmer_quality)
                new_len = int(new_contig.lengths()[0])
                my_k += k_step
            if new_len > old_len:
                changed.append_read(new_contig.names[0], b"",
                                    new_contig.get_seq(0), None)
            else:
                final.append_read(contigs.names[ci], b"",
                                  contigs.get_seq(ci), None)
        # retire long contigs (ref: finishLongContigs)
        keep_idx = []
        for ci in range(changed.n):
            if changed.lengths()[ci] >= asm.max_contig_length:
                final.append_read(changed.names[ci], b"",
                                  changed.get_seq(ci), None)
            else:
                keep_idx.append(ci)
        contigs = _subset(changed, keep_idx)
        timer.record("extendContigs")
        Log.verbose(1, "Iteration %d times: %s" % (iteration, timer.report()))
        # checkpoint (ref: per-iteration final/changed fasta writes)
        if opts.output_file:
            write_fasta(final, opts.output_file)
            if contigs.n:
                write_fasta(contigs, opts.output_file + "-inputcontigs-%d.fasta" % iteration)

    for ci in range(contigs.n):
        final.append_read(contigs.names[ci], b"", contigs.get_seq(ci), None)
    if opts.output_file:
        write_fasta(final, opts.output_file)
    else:
        for i in range(final.n):
            sys.stdout.buffer.write(b">" + final.names[i] + b"\n" +
                                    final.get_seq(i) + b"\n")
    Log.verbose(1, "Done: %d final contigs" % final.n)
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
