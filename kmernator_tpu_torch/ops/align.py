"""Kmer-anchored ungapped pairwise alignment.

Re-implements KmerAlign (ref: src/KmerAlign.h): seed on a shared canonical
k-mer between target and query, then zipper-extend left/right counting
mismatches; the best alignment maximizes overlap * identity.  Used by the
matcher/assembler to screen candidate read overlaps.

Copied for kmernator_tpu_torch from kmernator_tpu/ops/align.py; it differs
from its source only in its package imports.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kmernator_tpu_torch.io.reads import BASE_CODE
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
from kmernator_tpu_torch.parallel.spectrum import pack_keys

_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


@dataclass
class AlignmentRecord:
    """ref: KmerAlign.h AlignmentRecord; reversed alignments have
    start > end."""
    start: int = 0
    end: int = 0

    @property
    def aligned(self) -> bool:
        return self.start != self.end

    @property
    def overlap(self) -> int:
        if not self.aligned:
            return 0
        return abs(self.end - self.start) + 1

    @property
    def reversed(self) -> bool:
        return self.start > self.end

    def contains(self, pos: int) -> bool:
        if not self.aligned:
            return False
        lo, hi = sorted((self.start, self.end))
        return lo <= pos <= hi

    def is_at_end(self, length: int, dist: int = 0) -> bool:
        if not self.aligned:
            return False
        dist = min(dist, length - 1)
        lo, hi = sorted((self.start, self.end))
        return lo <= dist or hi >= length - 1 - dist


@dataclass
class Alignment:
    target: AlignmentRecord = field(default_factory=AlignmentRecord)
    query: AlignmentRecord = field(default_factory=AlignmentRecord)
    mismatches: int = 0

    @property
    def aligned(self) -> bool:
        return self.target.aligned and self.query.aligned

    @property
    def overlap(self) -> int:
        return min(self.target.overlap, self.query.overlap)

    @property
    def identity(self) -> float:
        if not self.aligned:
            return 0.0
        return 1.0 - self.mismatches / self.overlap

    def score(self) -> float:
        return self.overlap * self.identity


def _zipper(tseq: bytes, tpos: int, qseq: bytes, qpos: int, k: int) -> Alignment:
    """Ungapped extension around a seed (ref: KmerAlign::getAlignment
    zipper).  Handles the reverse-complement seed case."""
    aln = Alignment()
    tlen, qlen = len(tseq), len(qseq)
    if tpos + k > tlen or qpos + k > qlen:
        return aln
    tmer = tseq[tpos:tpos + k]
    rc = False
    qs = qseq
    qp = qpos
    if tmer != qseq[qpos:qpos + k]:
        qs = revcomp(qseq)
        qp = qlen - qpos - k
        if tmer != qs[qp:qp + k]:
            return aln
        rc = True
    q = AlignmentRecord(qp, qp + k - 1)
    t = AlignmentRecord(tpos, tpos + k - 1)
    mism = 0
    while q.start > 0 and t.start > 0:
        q.start -= 1
        t.start -= 1
        if tseq[t.start] != qs[q.start]:
            mism += 1
    while q.end < qlen - 1 and t.end < tlen - 1:
        q.end += 1
        t.end += 1
        if tseq[t.end] != qs[q.end]:
            mism += 1
    if rc:
        q = AlignmentRecord(qlen - 1 - q.start, qlen - 1 - q.end)
    aln.target, aln.query, aln.mismatches = t, q, mism
    return aln


class KmerAligner:
    """Index the target's canonical kmers, align queries against it."""

    def __init__(self, target_seq: bytes, k: int):
        self.k = k
        self.target = target_seq.upper()
        codes_raw = BASE_CODE[np.frombuffer(self.target, np.uint8)]
        codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        if len(codes) < k:
            self.keys = np.zeros(0, np.uint64)
            self.positions = np.zeros(0, np.int64)
            return
        canon, _, _, pos = extract_kmers_flat(codes, np.array([0, len(codes)]), k)
        keys = pack_keys(canon)
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.positions = pos[order]

    def align(self, query_seq: bytes) -> Alignment:
        """Best seed-extended alignment (ref: KmerAlign::getAlignment)."""
        query = query_seq.upper()
        best = Alignment()
        k = self.k
        if len(query) < k or len(self.keys) == 0:
            return best
        codes_raw = BASE_CODE[np.frombuffer(query, np.uint8)]
        codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        canon, _, _, _ = extract_kmers_flat(codes, np.array([0, len(codes)]), k)
        qkeys = pack_keys(canon)
        idx = np.searchsorted(self.keys, qkeys)
        idx = np.clip(idx, 0, len(self.keys) - 1)
        hit = self.keys[idx] == qkeys
        for j in np.flatnonzero(hit):
            i = idx[j]
            while i < len(self.keys) and self.keys[i] == qkeys[j]:
                tpos = int(self.positions[i])
                if not (best.target.contains(tpos) and best.query.contains(int(j))):
                    test = _zipper(self.target, tpos, query, int(j), k)
                    if test.score() > best.score() or not best.aligned:
                        best = test if test.aligned else best
                i += 1
        return best
