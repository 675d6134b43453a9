"""Probability-weighted consensus of a set of reads.

Replicates ProbabilityBases voting (ref: src/Sequence.cpp:563-582,870-967 +
ReadSet::getConsensusRead, src/ReadSet.cpp): each read contributes
P(correct) to its called base and (1-P)/3 to the other three, stopping at
the first base below the minimum quality; the winner at each position is
chosen by the reference's exact comparison tree and re-quality-scored from
the accumulated probability.

Copied for kmernator_tpu_torch from kmernator_tpu/ops/consensus.py; it
differs from its source only in its package imports.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet, BASE_CODE
from kmernator_tpu_torch.ops.weights import probability_table


def probability_bases(rs: ReadSet, indices, min_quality: int,
                      output_base: int) -> np.ndarray:
    """Accumulated [L, 4] probabilities over the selected reads
    (ref: Read::getProbabilityBases + ProbabilityBases::operator+=)."""
    tab = probability_table(0, output_base)  # raw table; min handled below
    L = max((int(rs.lengths()[i]) for i in indices), default=0)
    acc = np.zeros((L, 4), dtype=np.float64)
    ph = rs.phred()
    for i in indices:
        s, e = rs.offsets[i], rs.offsets[i + 1]
        seq = rs.seq[s:e]
        codes = BASE_CODE[seq]
        phred = ph[s:e]
        hq = rs.has_quals[i]
        for j in range(e - s):
            ch = int(phred[j]) + output_base if hq else 255
            if ch < min_quality + output_base:
                break  # ref: getProbabilityBases stops at first low-qual base
            prob = tab[min(ch, 255)]
            if prob < 0.2501:
                prob = 0.2501  # ref: "slightly better than random"
            c = codes[j]
            if c > 3:
                continue  # non-ACGT observes nothing (ref: observe() switch)
            other = (1.0 - prob) / 3.0
            acc[j] += other
            acc[j, c] += prob - other
    return acc


def consensus_call(acc: np.ndarray, output_base: int) -> Tuple[bytes, np.ndarray]:
    """Winner base + quality per position (ref: ProbabilityBase::getBaseQual
    comparison tree + BaseQual::getQualChar)."""
    L = len(acc)
    bases = bytearray(L)
    quals = np.zeros(L, dtype=np.int16)
    letters = b"ACGT"
    for j in range(L):
        a, c, g, t = acc[j]
        if a > c:
            if a > g:
                code, p = (0, a) if a > t else (3, t)
            else:
                code, p = (2, g) if g > t else (3, t)
        else:
            if c > g:
                code, p = (1, c) if c > t else (3, t)
            else:
                code, p = (2, g) if g > t else (3, t)
        bases[j] = letters[code]
        if p >= 0.9999:
            q = 40
        else:
            q = int(-10.0 * math.log10(1.0 - p))
        quals[j] = q
    return bytes(bases), quals


def get_centroid(rs: ReadSet, indices, min_quality: int,
                 output_base: int) -> int:
    """Index (within `indices`) of the read closest to the consensus:
    argmax of sum(own_probs * group_probs) (ref: ReadSet::getCentroidRead +
    Read::scoreProbabilityBases)."""
    acc = probability_bases(rs, indices, min_quality, output_base)
    best_i = -1
    best = 0.0
    for j, i in enumerate(indices):
        mine = probability_bases(rs, [i], min_quality, output_base)
        L = min(len(mine), len(acc))
        score = float((mine[:L] * acc[:L]).sum())
        if best_i < 0 or score > best:
            best_i, best = j, score
    return best_i


def consensus_read(rs: ReadSet, indices, min_quality: int,
                   output_base: int) -> Tuple[bytes, bytes, np.ndarray]:
    """(name, fasta, phred) of the consensus; name = C<n>-<firstName>
    (ref: ReadSet::getConsensusRead)."""
    acc = probability_bases(rs, indices, min_quality, output_base)
    fasta, quals = consensus_call(acc, output_base)
    name = b"C%d-" % len(indices) + rs.names[indices[0]]
    return name, fasta, quals
