"""Seed-and-verify substring matcher: the Vmatch backend equivalent.

The reference's alternative MatcherInterface forks the external `vmatch`
suffix-index tool (a mkvtree index over each rank's reads, queried with
``-d -p -seedlength 10 -l 50 -e 3``: direct + reverse-complement local
matches of length >= l with <= e errors; matching read ids are collected
per query contig; ref: src/Vmatch.h:93-279).  The assembler selects it
when --kmer-size is 0 (ref: apps/DistributedNucleatingAssembler.cpp:392-397).

This implementation is self-contained and vectorized instead of forking an
external binary: exact seed-kmer hits from one sorted seed index are
clustered per (read, relative strand, diagonal band), screened with the
q-gram lemma (a length-l match with <= e edits shares >= l+1-seed*(e+1)
seeds near one diagonal), and confirmed with a banded edit-distance check
over the clustered region.

Copied for kmernator_tpu_torch from kmernator_tpu/ops/vmatch.py; it
differs from its source only in its package imports.
"""
from __future__ import annotations

from typing import List, Set

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet, BASE_CODE
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
from kmernator_tpu_torch.parallel.spectrum import pack_keys


def parse_vmatch_options(opt_string: str):
    """(seed_length, min_length, max_errors) from the reference's
    --vmatch-options string (default "-d -p -seedlength 10 -l 50 -e 3");
    -d/-p are implied (both strands always searched)."""
    seed, min_len, max_err = 10, 50, 3
    toks = opt_string.split()
    for i, t in enumerate(toks):
        if t == "-seedlength" and i + 1 < len(toks):
            seed = int(toks[i + 1])
        elif t == "-l" and i + 1 < len(toks):
            min_len = int(toks[i + 1])
        elif t == "-e" and i + 1 < len(toks):
            max_err = int(toks[i + 1])
    return seed, min_len, max_err


def banded_edit_distance(a: np.ndarray, b: np.ndarray, band: int) -> int:
    """Levenshtein distance of code arrays a, b restricted to |i-j|<=band
    (returns band+1 when exceeded).  Vectorized over the band diagonal."""
    n, m = len(a), len(b)
    if abs(n - m) > band:
        return band + 1
    width = 2 * band + 1
    BIG = band + 1
    # row[j - i + band] = edit distance ending at (i, j)
    row = np.full(width, BIG, dtype=np.int32)
    row[band:band + min(band, m) + 1] = np.arange(min(band, m) + 1)
    for i in range(1, n + 1):
        j = np.arange(i - band, i + band + 1)
        valid = (j >= 0) & (j <= m)
        sub = np.full(width, BIG, np.int32)
        jj = np.clip(j - 1, 0, m - 1)
        mism = np.where((j >= 1) & (j <= m) & (a[i - 1] == b[jj]), 0, 1)
        sub = np.where((j >= 1) & valid, row + mism, BIG)  # diagonal move
        dele = np.concatenate([row[1:], [BIG]]) + 1        # skip in a
        ins = np.full(width, BIG, np.int32)                # skip in b
        new = np.minimum(sub, dele)
        new = np.where(j == 0, i, new)
        # insertion needs a left-to-right scan within the row
        for w in range(1, width):
            if new[w - 1] + 1 < new[w]:
                new[w] = new[w - 1] + 1
        row = np.where(valid, np.minimum(new, BIG), BIG)
    d = row[m - n + band] if 0 <= m - n + band < width else BIG
    return int(d)


class SeedReadIndex:
    """Index of every canonical seed-length-mer of every read, with
    (read id, position, stored-strand) per occurrence."""

    def __init__(self, rs: ReadSet, seed_length: int = 10,
                 min_length: int = 50, max_errors: int = 3):
        self.seed = seed_length
        self.min_length = min_length
        self.max_errors = max_errors
        self.rs = rs
        codes_raw = BASE_CODE[rs.seq]
        markup = codes_raw == 4
        codes = np.where(markup, 0, codes_raw).astype(np.uint8)
        self._read_codes = codes
        canon, is_fwd, read_id, pos = extract_kmers_flat(codes, rs.offsets,
                                                         seed_length)
        keys = pack_keys(canon)
        ok = ~rs.discarded[read_id]
        keys, read_id, pos, is_fwd = (keys[ok], read_id[ok], pos[ok],
                                      is_fwd[ok])
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        self.read_ids = read_id[order].astype(np.int64)
        self.pos = pos[order].astype(np.int64)
        self.is_fwd = is_fwd[order]
        boundary = (np.concatenate([[True], sk[1:] != sk[:-1]])
                    if len(sk) else np.zeros(0, bool))
        self.keys = sk[boundary] if len(sk) else sk
        starts = np.flatnonzero(boundary)
        self.offsets = (np.concatenate([starts, [len(sk)]])
                        if len(sk) else np.zeros(1, np.int64))

    def _read_seg(self, rid: int, s: int, e: int) -> np.ndarray:
        off = self.rs.offsets
        s = max(s, 0)
        e = min(e, int(off[rid + 1] - off[rid]))
        return self._read_codes[off[rid] + s:off[rid] + e]

    def match_contig(self, contig_codes: np.ndarray) -> Set[int]:
        """Read ids with a >=min_length, <=max_errors local match against
        the contig on either strand (the vmatch -d -p contract)."""
        seed, e = self.seed, self.max_errors
        L = len(contig_codes)
        if L < seed or len(self.keys) == 0:
            return set()
        canon, c_fwd, _, c_pos = extract_kmers_flat(
            contig_codes, np.array([0, L]), seed)
        qkeys = pack_keys(canon)
        idx = np.clip(np.searchsorted(self.keys, qkeys), 0,
                      len(self.keys) - 1)
        hit = self.keys[idx] == qkeys
        hidx = np.flatnonzero(hit)
        if not len(hidx):
            return set()
        # expand each hit key into its occurrence list
        s, eo = self.offsets[idx[hidx]], self.offsets[idx[hidx] + 1]
        cnt = (eo - s).astype(np.int64)
        occ = (np.arange(int(cnt.sum())) -
               np.repeat(np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
               + np.repeat(s, cnt))
        rid = self.read_ids[occ]
        rpos = self.pos[occ]
        rfwd = self.is_fwd[occ]
        cpos = np.repeat(c_pos[hidx], cnt)
        cfwd = np.repeat(c_fwd[hidx], cnt)
        same = rfwd == cfwd  # canonical forms agree in orientation -> direct
        diag = np.where(same, rpos - cpos, rpos + cpos)
        strand = same.astype(np.int64)
        # cluster hits per (read, strand, ~diagonal): sorted run grouping
        order = np.lexsort((diag, strand, rid))
        rid, rpos, cpos, diag, strand = (rid[order], rpos[order],
                                         cpos[order], diag[order],
                                         strand[order])
        newc = np.concatenate([[True],
                               (rid[1:] != rid[:-1])
                               | (strand[1:] != strand[:-1])
                               | (np.abs(diag[1:] - diag[:-1]) > e)])
        cid = np.cumsum(newc) - 1
        ncl = int(cid[-1]) + 1
        counts = np.bincount(cid, minlength=ncl)
        cmin = np.full(ncl, 1 << 60, np.int64)
        cmax = np.zeros(ncl, np.int64)
        np.minimum.at(cmin, cid, cpos)
        np.maximum.at(cmax, cid, cpos)
        rmin = np.full(ncl, 1 << 60, np.int64)
        rmax = np.zeros(ncl, np.int64)
        np.minimum.at(rmin, cid, rpos)
        np.maximum.at(rmax, cid, rpos)
        starts = np.flatnonzero(newc)
        cl_rid = rid[starts]
        cl_strand = strand[starts]
        # q-gram lemma screen (necessary condition for a true match)
        qgram = max(self.min_length + 1 - seed * (e + 1), 1)
        span_ok = (cmax - cmin) + seed >= self.min_length - e
        cand = np.flatnonzero((counts >= qgram) & span_ok)
        out: Set[int] = set()
        for c in cand:
            r = int(cl_rid[c])
            if r in out:
                continue
            cseg = contig_codes[cmin[c]:cmax[c] + seed]
            if not cl_strand[c]:  # reverse-complement match
                cseg = (3 - cseg)[::-1]
            rseg = self._read_seg(r, int(rmin[c]), int(rmax[c]) + seed)
            if len(rseg) < self.min_length or len(cseg) < self.min_length:
                continue
            if banded_edit_distance(rseg, np.ascontiguousarray(cseg),
                                    e) <= e:
                out.add(r)
        return out


def vmatch_pools(index: SeedReadIndex, contigs: ReadSet) -> List[Set[int]]:
    """MatchResults: per-contig matching read id sets
    (ref: Vmatch::matchLocalImpl, src/Vmatch.h:186-212)."""
    pools = []
    for i in range(contigs.n):
        codes_raw = BASE_CODE[np.frombuffer(contigs.get_seq(i), np.uint8)]
        codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        pools.append(index.match_contig(codes))
    return pools
