"""External assembler wrappers.

Re-implements the reference's fork-external-binary contig extension backends
(ref: src/ExternalAssembler.h, src/Cap3.h, src/Newbler.h,
src/VelvetOptimizer.h): write the contig + pooled reads to a temp fasta,
run the external assembler, and pick the resulting contig that best contains
the original (>= minimum-extension-factor of it).  The binaries are not
bundled; the native k-mer extender (ops/extend.py) is the default backend.

Copied for kmernator_tpu_torch from kmernator_tpu/ops/external.py; it
differs from its source only in its package imports.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet
from kmernator_tpu_torch.ops.align import KmerAligner


class ExternalAssembler:
    """Base wrapper: subclasses define the command line and output file."""

    name = "external"
    binary = None

    def is_available(self) -> bool:
        return self.binary is not None and shutil.which(self.binary) is not None

    def command(self, input_fasta: str, workdir: str) -> List[str]:
        raise NotImplementedError

    def output_contigs(self, input_fasta: str, workdir: str) -> str:
        raise NotImplementedError

    def extend_contig(self, contig_name: bytes, contig_seq: bytes,
                      pool: ReadSet, min_extension_factor: float = 0.90,
                      seed_k: int = 21) -> Tuple[bytes, bytes]:
        """Assemble contig + pool; return (name, seq) of the best extension
        (the input contig if nothing longer contains it,
        ref: ExternalAssembler::extendContig)."""
        if not self.is_available():
            raise RuntimeError("%s binary not available" % self.name)
        with tempfile.TemporaryDirectory(prefix="kmtpu-%s-" % self.name) as wd:
            fa = os.path.join(wd, "pool.fasta")
            with open(fa, "wb") as f:
                f.write(b">" + contig_name + b"\n" + contig_seq + b"\n")
                for i in range(pool.n):
                    f.write(b">" + pool.names[i] + b"\n" + pool.get_seq(i) + b"\n")
            subprocess.run(self.command(fa, wd), check=True, cwd=wd,
                           capture_output=True)
            out = self.output_contigs(fa, wd)
            best = (contig_name, contig_seq)
            if os.path.exists(out):
                aligner = KmerAligner(contig_seq, seed_k)
                for name, seq in _iter_fasta(out):
                    if len(seq) <= len(best[1]):
                        continue
                    aln = aligner.align(seq)
                    if aln.aligned and aln.overlap >= min_extension_factor * len(contig_seq):
                        best = (name, seq)
            return best


def _iter_fasta(path: str):
    name = None
    seq = []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(seq)
                name = line[1:].split(b" ")[0]
                seq = []
            else:
                seq.append(line)
    if name is not None:
        yield name, b"".join(seq)


class ExternalOptions:
    """CLI options for the external assembler wrappers
    (ref: src/Cap3.h:76, src/Newbler.h:90-95)."""
    FLAGS = {"cap3-path": str, "newbler-path": str, "newbler-opts": str,
             "newbler-ml": int, "newbler-mi": int, "newbler-l": int,
             "newbler-scaffold":
                 lambda v: str(v).lower() not in ("0", "false", "")}

    def __init__(self):
        self.cap3_path = ""
        self.newbler_path = ""
        self.newbler_opts = ""
        self.newbler_ml = 40
        self.newbler_mi = 90
        self.newbler_l = 500
        self.newbler_scaffold = False


class Cap3(ExternalAssembler):
    """ref: src/Cap3.h."""
    name = "cap3"
    binary = "cap3"

    def __init__(self, opts: "ExternalOptions" = None):
        self.opts = opts or ExternalOptions()
        if self.opts.cap3_path:
            self.binary = os.path.join(self.opts.cap3_path, "cap3")

    def command(self, input_fasta, workdir):
        return [self.binary, input_fasta]

    def output_contigs(self, input_fasta, workdir):
        return input_fasta + ".cap.contigs"


class Newbler(ExternalAssembler):
    """ref: src/Newbler.h (runAssembly)."""
    name = "newbler"
    binary = "runAssembly"

    def __init__(self, opts: "ExternalOptions" = None):
        self.opts = opts or ExternalOptions()
        if self.opts.newbler_path:
            self.binary = os.path.join(self.opts.newbler_path, "runAssembly")

    def command(self, input_fasta, workdir):
        o = self.opts
        cmd = [self.binary, "-o", os.path.join(workdir, "asm"),
               "-ml", str(o.newbler_ml), "-mi", str(o.newbler_mi),
               "-l", str(o.newbler_l)]
        if o.newbler_scaffold:
            cmd.append("-scaffold")
        if o.newbler_opts:
            cmd.extend(o.newbler_opts.split())
        cmd.append(input_fasta)
        return cmd

    def output_contigs(self, input_fasta, workdir):
        return os.path.join(workdir, "asm", "454AllContigs.fna")


class VelvetOptimizer(ExternalAssembler):
    """ref: src/VelvetOptimizer.h."""
    name = "velvetoptimiser"
    binary = "VelvetOptimiser.pl"

    def command(self, input_fasta, workdir):
        return ["VelvetOptimiser.pl", "-s", "19", "-e", "31",
                "-f", "-short -fasta %s" % input_fasta,
                "-p", os.path.join(workdir, "vo")]

    def output_contigs(self, input_fasta, workdir):
        return os.path.join(workdir, "vo_data", "contigs.fa")
