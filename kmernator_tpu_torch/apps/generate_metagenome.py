"""Synthetic metagenome FASTQ generator for benchmarks and scale tests.

Generates a community of random genomes with log-uniform abundances and
samples error-bearing reads — the >=10GB multi-host benchmark input called
for by BASELINE.md.

Usage: generate_metagenome --genomes 20 --total-genome-mb 100 \
          --coverage 20 --read-length 150 --out meta.fastq [--seed 7]

Copied for kmernator_tpu_torch from
kmernator_tpu/apps/generate_metagenome.py; it differs from its source only
in its package imports.
"""
from __future__ import annotations

import sys

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)


def run(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=20)
    ap.add_argument("--total-genome-mb", type=float, default=100.0)
    ap.add_argument("--coverage", type=float, default=20.0)
    ap.add_argument("--read-length", type=int, default=150)
    ap.add_argument("--error-rate", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    total = int(args.total_genome_mb * 1e6)
    # log-uniform genome sizes
    raw = np.exp(rng.uniform(0, 2.5, args.genomes))
    sizes = (raw / raw.sum() * total).astype(np.int64)
    L = args.read_length
    q_hi, q_lo = 38, 12

    with open(args.out, "wb") as f:
        rid = 0
        for gi, size in enumerate(sizes):
            genome = rng.integers(0, 4, size, dtype=np.uint8)
            n_reads = int(size * args.coverage / L)
            CH = 100000
            for s in range(0, n_reads, CH):
                n = min(CH, n_reads - s)
                starts = rng.integers(0, size - L, n)
                reads = genome[starts[:, None] + np.arange(L)[None, :]]
                # substitution errors
                err = rng.random((n, L)) < args.error_rate
                reads = np.where(err, (reads + rng.integers(1, 4, (n, L))) % 4,
                                 reads)
                quals = rng.integers(q_lo, q_hi, (n, L)).astype(np.uint8) + 33
                quals[err] = q_lo + 33
                txt = _BASES[reads]
                buf = bytearray()
                for i in range(n):
                    buf += b"@g%d_%d/1\n" % (gi, rid + i)
                    buf += txt[i].tobytes() + b"\n+\n" + quals[i].tobytes() + b"\n"
                f.write(buf)
                rid += n
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
