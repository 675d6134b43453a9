"""The traffic generator: a seeded synthetic metagenome as FASTQ.

Frozen from kmernator_tpu_torch/apps/generate_metagenome.py, the same
draws in the same order, so a seed gives the same file as the program's
generator with the same parameters: genomes of log-uniform sizes, each read
at the coverage, with substitution errors at the error rate (their quality
set to the floor). The parameters come from a traffic file
(`kbench/traffic/<name>.json`, "generator": "metagenome").
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)


def write(params: Dict, seed: int, path: str) -> Tuple[int, int]:
    """Write the FASTQ; returns (reads, bases)."""
    rng = np.random.default_rng(seed & ((1 << 64) - 1))
    total = int(params["total_genome_mb"] * 1e6)
    raw = np.exp(rng.uniform(0, 2.5, params["genomes"]))
    sizes = (raw / raw.sum() * total).astype(np.int64)
    L = params["read_length"]
    q_hi, q_lo = 38, 12
    rid = 0
    with open(path, "wb") as f:
        for gi, size in enumerate(sizes):
            genome = rng.integers(0, 4, size, dtype=np.uint8)
            n_reads = int(size * params["coverage"] / L)
            CH = 100000
            for s in range(0, n_reads, CH):
                n = min(CH, n_reads - s)
                starts = rng.integers(0, size - L, n)
                reads = genome[starts[:, None] + np.arange(L)[None, :]]
                err = rng.random((n, L)) < params["error_rate"]
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
    return rid, rid * L


def head(src: str, dst: str, mb: float) -> Tuple[int, int]:
    """Copy the whole records of src's first `mb` MB to dst; returns
    (reads, bases)."""
    with open(src, "rb") as f:
        data = f.read(int(mb * (1 << 20)))
    lines = data.split(b"\n")
    n = (len(lines) - 1) // 4
    keep = lines[:4 * n]
    with open(dst, "wb") as f:
        f.write(b"\n".join(keep) + b"\n")
    return n, sum(len(s) for s in keep[1::4])
