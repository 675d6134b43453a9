"""Read-to-contig matching via a k-mer -> read-id index.

Re-implements KmerMatch / MatcherInterface (ref: src/KmerMatch.h:93-186,
src/MatcherInterface.h:138-350): a spectrum over the reads where each
canonical k-mer keeps the full list of (read, position) observations
(TrackingDataWithAllReads); contigs query only k-mers within
`match-max-positions-from-edge` of their ends; hits above the sampling cap
are down-sampled.

Columnar design: one sort of (key, read_id) pairs; the index is (unique
keys, offsets, read_id array) — the multi-chip version routes query keys by
owner shard and alltoalls the hit lists back (mirroring the reference's
exchangeGlobalReads).

Copied for kmernator_tpu_torch from kmernator_tpu/ops/match.py; it differs
from its source only in its package imports.
"""
from __future__ import annotations

from typing import List, Set

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet, BASE_CODE
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
from kmernator_tpu_torch.ops.weights import window_weights, good_kmer_mask
from kmernator_tpu_torch.parallel.spectrum import pack_keys


class KmerReadIndex:
    def __init__(self, rs: ReadSet, k: int, min_depth: int = 2,
                 min_quality: int = 3, output_base: int = 33,
                 min_kmer_quality: float = 0.10):
        self.k = k
        codes_raw = BASE_CODE[rs.seq]
        markup = codes_raw == 4
        codes = np.where(markup, 0, codes_raw).astype(np.uint8)
        canon, _, read_id, _ = extract_kmers_flat(codes, rs.offsets, k)
        keys = pack_keys(canon)
        p = rs.base_probabilities(min_quality, output_base)
        w = window_weights(p, rs.offsets, markup, k)
        good = good_kmer_mask(w, min_kmer_quality) & ~rs.discarded[read_id]
        keys = keys[good]
        rids = read_id[good]
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        self.read_ids = rids[order].astype(np.int64)
        boundary = np.concatenate([[True], sk[1:] != sk[:-1]]) if len(sk) else \
            np.zeros(0, bool)
        self.keys = sk[boundary] if len(sk) else sk
        starts = np.flatnonzero(boundary)
        self.offsets = np.concatenate([starts, [len(sk)]]) if len(sk) else \
            np.zeros(1, np.int64)
        # min-depth purge: kmers below min_depth match nothing unless
        # min_depth <= 1 (singletons consulted when not purged,
        # ref: KmerMatch ctor purgeMinDepth + _matchLocal singleton branch)
        counts = np.diff(self.offsets)
        keep = counts >= min(min_depth, 2) if min_depth <= 1 else counts >= min_depth
        self._keep = keep

    def match_contig(self, contig_codes: np.ndarray,
                     max_positions_from_edge: int = 500,
                     max_hits: int = 0,
                     rng: np.random.Generator = None) -> Set[int]:
        """Read ids matching the contig's edge kmers
        (ref: KmerMatch::_matchLocal)."""
        k = self.k
        L = len(contig_codes)
        if L < k or len(self.keys) == 0:
            return set()
        canon, _, _, _ = extract_kmers_flat(contig_codes,
                                            np.array([0, L]), k)
        qkeys = pack_keys(canon)
        nw = len(qkeys)
        max_kmers = max_positions_from_edge - k + 1
        pos = np.arange(nw)
        lower = max_kmers
        upper = nw - max_kmers if nw > max_kmers else 0
        sel = (pos <= lower) | (pos >= upper)
        qkeys = qkeys[sel]
        idx = np.searchsorted(self.keys, qkeys)
        idx = np.clip(idx, 0, len(self.keys) - 1)
        hit = (self.keys[idx] == qkeys) & self._keep[idx]
        out: Set[int] = set()
        for i in np.flatnonzero(hit):
            s, e = self.offsets[idx[i]], self.offsets[idx[i] + 1]
            out.update(self.read_ids[s:e].tolist())
        if max_hits and len(out) > 2 * max_hits:
            if rng is None:
                rng = np.random.default_rng(0)
            frac = (2.0 * max_hits) / len(out)
            out = {r for r in out if rng.random() < frac}
        return out


def match_pools(index: KmerReadIndex, contigs: ReadSet,
                max_positions_from_edge: int = 500,
                max_hits: int = 10000) -> List[Set[int]]:
    pools = []
    rng = np.random.default_rng(0)
    for i in range(contigs.n):
        codes_raw = BASE_CODE[np.frombuffer(contigs.get_seq(i), np.uint8)]
        codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        pools.append(index.match_contig(codes, max_positions_from_edge,
                                        max_hits, rng))
    return pools
