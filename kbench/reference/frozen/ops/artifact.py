"""Frozen for the benchmark's plain reference from kmernator_tpu_torch/ops/artifact.py
and cut to the NumPy paths the benchmark's configurations reach: the
built-in artifact sequences (no simple repeats, no PhiX, no extra
references), every edit pre-built into the table, single reads.

Artifact screen: primer/adapter/homopolymer filtering with quality-run
trimming.

Re-implements FilterKnownOddities (ref: src/FilterKnownOddities.h:171-736)
with a flat table of canonical 24-mers (exact + pre-built hamming-<=d edits,
ref: prepareMaps :242-286) and a vectorized byte-aligned scan: the reference
hops byte-by-byte over the 2-bit sequence (every 4 bases,
ref: applyFilterToRead :446-490), so only window positions that are
multiples of 4 are probed.

The built-in artifact data (public adapter/primer sequences from TagDust and
Illumina documentation) is frozen/data/artifacts.fasta, a copy of the
program's; it is part of the behavioral contract (ref: getArtifactFasta
:742-794).
"""
from __future__ import annotations

import os

import numpy as np

from kbench.reference.frozen.io.reads import (BASE_CODE, ReadSet,
                                              _BASE_NORM, _ragged_indices)
from kbench.reference.frozen.ops.kmer import (extract_kmers_flat,
                                              last_word_mask, nwords, pack16,
                                              revcomp_words, words_less)

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "artifacts.fasta")
TABLE_EDITS_MAX = 750000  # edits are pre-built while the table is smaller


def _canonical_ints(canon: np.ndarray) -> np.ndarray:
    """[N, W <= 2] u32 words -> u64 keys."""
    out = canon[:, 0].astype(np.uint64) << np.uint64(32)
    if canon.shape[1] == 2:
        out |= canon[:, 1].astype(np.uint64)
    return out


def _fasta_records(path: str):
    """(name, normalized sequence bytes) of each record of a FASTA file."""
    recs = []
    with open(path, "rb") as f:
        for line in f.read().split(b"\n"):
            line = line.rstrip(b"\r")
            if line.startswith(b">"):
                head = line[1:]
                cut = min([i for i in (head.find(b" "), head.find(b"\t"),
                                       head.find(b"\r")) if i >= 0]
                          or [len(head)])
                recs.append([head[:cut], bytearray()])
            elif line and recs:
                recs[-1][1].extend(line)
    return [(nm, _BASE_NORM[np.frombuffer(bytes(s), np.uint8)].tobytes())
            for nm, s in recs]


class ArtifactFilter:
    """Holds the 24-mer lookup table and applies the filter to a ReadSet."""

    def __init__(self, edit_distance: int, min_quality: int,
                 min_read_length: float, match_length: int = 24):
        self.k = match_length
        self.min_quality = min_quality
        self.min_read_length = min_read_length
        # sequence registry: index 0 is the no-match sentinel (ref: :198-200)
        self.seq_names = [b""]
        seqs = [b""]
        for nm, s in _fasta_records(ARTIFACTS):
            self.seq_names.append(nm)
            seqs.append(s)
        self.num_sequences = len(seqs)

        # circularize (ref: ReadSet::circularize, src/ReadSet.cpp:120-130)
        seqs = [s + s[:self.k] for s in seqs]

        # build exact canonical kmer -> value table; first writer wins
        # (ref: filter.getOrSetElement, :253)
        table = {}
        for idx, s in enumerate(seqs):
            if idx == 0 or len(s) < self.k:
                continue
            codes = BASE_CODE[np.frombuffer(s, np.uint8)]
            codes = np.where(codes == 4, 0, codes).astype(np.uint8)
            canon, _, _, _ = extract_kmers_flat(codes, np.array([0, len(s)]), self.k)
            for key in _canonical_ints(canon):
                table.setdefault(int(key), idx)

        # pre-build hamming-edit permutations into the table
        # (ref: prepareMaps :260-282, buildEditsInFilter 2)
        for _err in range(edit_distance):
            if len(table) >= TABLE_EDITS_MAX:
                raise ValueError("the reference pre-builds every edit")
            keys = np.fromiter(table.keys(), dtype=np.uint64, count=len(table))
            vals = np.fromiter(table.values(), dtype=np.int64, count=len(table))
            nk, nv = self._permute_all(keys, vals)
            for key, v in zip(nk, nv):
                table.setdefault(int(key), int(v))
        self._table_keys = np.fromiter(table.keys(), dtype=np.uint64, count=len(table))
        self._table_vals = np.fromiter(table.values(), dtype=np.int64, count=len(table))
        order = np.argsort(self._table_keys, kind="stable")
        self._table_keys = self._table_keys[order]
        self._table_vals = self._table_vals[order]

    def _permute_all(self, keys: np.ndarray, vals: np.ndarray):
        """All hamming-1 neighbors (canonicalized) of the given canonical
        kmers (ref: KmerArrayPair::permuteBases, src/Kmer.h:1377-1454)."""
        k = self.k
        words = np.zeros((len(keys), nwords(k)), dtype=np.uint32)
        words[:, 0] = (keys >> np.uint64(32)).astype(np.uint32)
        if nwords(k) == 2:
            words[:, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        outs = []
        outv = []
        for posn in range(k):
            w, o = divmod(posn, 16)
            shift = np.uint32(30 - 2 * o)
            cur = (words[:, w] >> shift) & np.uint32(3)
            for nb in range(4):
                mutated = words.copy()
                mutated[:, w] = ((words[:, w] & ~(np.uint32(3) << shift))
                                 | (np.uint32(nb) << shift))
                keep = cur != nb
                rc = revcomp_words(mutated, k)
                le = ~words_less(rc, mutated)
                canon = np.where(le[:, None], mutated, rc)
                outs.append(_canonical_ints(canon[keep]))
                outv.append(vals[keep])
        return np.concatenate(outs), np.concatenate(outv)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Value (0 = miss) per canonical u64 key, by binary search."""
        idx = np.searchsorted(self._table_keys, keys)
        idx = np.clip(idx, 0, len(self._table_keys) - 1)
        hit = self._table_keys[idx] == keys
        return np.where(hit, self._table_vals[idx], 0)

    def scan_all(self, rs: ReadSet):
        """Whole-ReadSet scan (ref: applyFilterToRead :389-541, minus record
        effects): per-read (value, min_pass, max_pass, second_off,
        second_len)."""
        n = rs.n
        lens = rs.lengths().astype(np.int64)
        phred = rs.phred()
        k = self.k
        # --- quality runs (best & second best, ref: :407-442) ---
        L = int(lens.max()) if n else 0
        base = int(rs.offsets[0]) if n else 0
        good = np.zeros((n, L), dtype=bool)
        if n and L:
            rows = np.repeat(np.arange(n), lens)
            cols = np.arange(int(lens.sum())) - np.repeat(
                rs.offsets[:-1].astype(np.int64) - base, lens)
            flat_good = phred[base:int(rs.offsets[-1])] >= self.min_quality
            good[rows, cols] = flat_good | ~rs.has_quals[rows]
        good &= np.arange(L)[None, :] < lens[:, None]
        # column-wise transcription of the reference's best/second loop: at
        # every run end, the run challenges best (strictly longer wins; the
        # demoted ex-best then challenges second).  A masked argmax is NOT
        # equivalent — when the pre-best leader ties an already-accepted
        # second candidate, the reference keeps the candidate.
        z = np.zeros(n, dtype=np.int64)
        best_off, best_len = z.copy(), z.copy()
        sec_off, sec_len = z.copy(), z.copy()
        prev = z.copy()
        for j in range(L + 1):
            gj = good[:, j] if j < L else np.zeros(n, dtype=bool)
            end = ~gj & (j <= lens)
            t_len = prev
            t_off = j - prev
            swap = end & (t_len > best_len)
            cand_len = np.where(swap, best_len, t_len)
            cand_off = np.where(swap, best_off, t_off)
            best_len = np.where(swap, t_len, best_len)
            best_off = np.where(swap, t_off, best_off)
            s_upd = end & (cand_len > sec_len)
            sec_len = np.where(s_upd, cand_len, sec_len)
            sec_off = np.where(s_upd, cand_off, sec_off)
            prev = np.where(gj, prev + 1, 0)
        min_pass = np.where(best_len > 0, best_off, 0)
        max_pass = np.where(best_len > 0, best_off + best_len, 0)

        # --- artifact 24-mer scan at byte-aligned positions ---
        value = np.zeros(n, dtype=np.int64)
        min_aff = max_pass.copy()
        max_aff = min_pass.copy()
        bytes_ = (lens + 3) // 4
        byte_hops = (max_pass + 3) // 4 - k // 4 - np.where(lens % 4 == 0, 0, 1)
        byte_hops = np.where((byte_hops < 0) | (byte_hops > bytes_), 0, byte_hops)
        start_hop = min_pass // 4
        # scan over padded rows: Lp = 4*ceil(L/4) pad bases read as 'A'
        Lp = 4 * ((L + 3) // 4)
        if Lp >= k and n:
            NWp = Lp - k + 1
            H = Lp // 4
            W = nwords(k)
            flat_codes = BASE_CODE[rs.seq[base:int(rs.offsets[-1])]]
            flat_codes = np.where(flat_codes == 4, 0,
                                  flat_codes).astype(np.uint8)
            codes = np.zeros((n, Lp), dtype=np.uint8)
            if L:
                codes[rows, cols] = flat_codes
            # canonical words at the byte-aligned positions only
            p16 = pack16(codes)  # [n, Lp]
            fwd = np.zeros((n, H, W), dtype=np.uint32)
            for w in range(W):
                sl = p16[:, 16 * w::4][:, :H]
                fwd[:, :sl.shape[1], w] = sl
            fwd[:, :, W - 1] &= np.uint32(last_word_mask(k))
            rc = revcomp_words(fwd, k)
            fwd_le = ~words_less(rc, fwd)
            canon = np.where(fwd_le[..., None], fwd, rc)
            keys2d = _canonical_ints(canon.reshape(-1, W)).reshape(n, H)
            hops = np.arange(H)[None, :]  # byte positions
            pos = hops * 4
            active = ((hops >= start_hop[:, None]) & (hops <= byte_hops[:, None])
                      & (pos < NWp) & (lens[:, None] >= k)
                      & (byte_hops[:, None] >= start_hop[:, None]))
            vals = self.lookup(keys2d.reshape(-1)).reshape(n, -1)
            vals = np.where(active, vals, 0)
            hit = vals > 0
            any_hit = hit.any(axis=1)
            if any_hit.any():
                # last hit (highest position with a hit) wins the value
                last_idx = vals.shape[1] - 1 - np.argmax(hit[:, ::-1], axis=1)
                value = np.where(any_hit, vals[np.arange(n), last_idx], 0)
                min_hit = np.where(hit, pos, np.iinfo(np.int64).max).min(axis=1)
                max_hit = np.where(hit, pos, -1).max(axis=1)
                min_aff = np.where(any_hit, np.minimum(min_aff, min_hit), min_aff)
                max_aff = np.where(any_hit, np.maximum(max_aff, max_hit + k), max_aff)

        # --- trim to the larger clean side ---
        act = (value > 0) & (min_aff <= max_aff)
        keep_left = (min_aff - min_pass) >= (max_pass - max_aff)
        max_pass = np.where(act & keep_left, min_aff, max_pass)
        min_pass = np.where(act & ~keep_left, max_aff, min_pass)
        return value, min_pass, max_pass, sec_off, sec_len


def _slice_readset(rs: ReadSet, cs: int, ce: int) -> ReadSet:
    """View-copy of reads [cs, ce) for chunked scanning."""
    if cs == 0 and ce == rs.n:
        return rs
    sub = ReadSet()
    s, e = rs.offsets[cs], rs.offsets[ce]
    sub.names = rs.names[cs:ce]
    sub.comments = rs.comments[cs:ce]
    sub.seq = rs.seq[s:e]
    sub.qual = rs.qual[s:e]
    sub.offsets = rs.offsets[cs:ce + 1] - s
    sub.discarded = rs.discarded[cs:ce]
    sub.has_quals = rs.has_quals[cs:ce]
    sub.input_qual_base = rs.input_qual_base
    return sub


def apply_artifact_filter(rs: ReadSet, filt: ArtifactFilter):
    """ref: FilterKnownOddities::applyFilter (:663-732) +
    recordAffectedRead (:551-661) over single reads.  Mutates rs in place:
    trims reads (AFTrim labels appended to comments), marks discards,
    appends -qtrim remnant reads."""
    n = rs.n
    lens = rs.lengths()
    CH = 65536  # the scan in chunks, to bound memory
    sv = np.zeros(n, np.int64)
    smn = np.zeros(n, np.int64)
    smx = np.zeros(n, np.int64)
    sso = np.zeros(n, np.int64)
    ssl = np.zeros(n, np.int64)
    for cs in range(0, n, CH):
        ce = min(cs + CH, n)
        v, mn, mx, so, sl = filt.scan_all(_slice_readset(rs, cs, ce))
        sv[cs:ce], smn[cs:ce], smx[cs:ce] = v, mn, mx
        sso[cs:ce], ssl[cs:ce] = so, sl

    NS = filt.num_sequences
    mrl = filt.min_read_length
    plen = smx - smn

    def passes_vec(length, rl):
        ok = length > 1
        if mrl <= 1.0:
            return ok & (rl * mrl <= length)
        return ok & (mrl <= length)

    # rescue: untouched value but quality trimming shrank the read
    # (ref: :523-533) — value becomes num_sequences; a passing second-best
    # run is re-appended as a "-qtrim" remnant read
    rescued = (sv == 0) & (plen != lens)
    val = np.where(rescued, NS, sv)
    remn = rescued & passes_vec(ssl, lens)
    aff = val != 0
    bad_len = (plen <= 0) | ~passes_vec(plen, lens)
    rs.discarded[aff & bad_len] = True
    trim_sel = np.flatnonzero(aff & ~bad_len)
    remn_sel = np.flatnonzero(remn)
    if len(remn_sel):
        # remnant bases and quals, gathered before apply_trims rebuilds
        # the flat arrays
        starts = (rs.offsets[remn_sel] + sso[remn_sel]).astype(np.int64)
        rlens = ssl[remn_sel].astype(np.int64)
        idx = _ragged_indices(starts, rlens)
        seq_flat = rs.seq[idx]
        qual_flat = rs.qual[idx]
        labs = [b"AFTrim:%d+%d" % (o, l)
                for o, l in zip(sso[remn_sel], rlens)]
        names_r = [rs.names[int(i)] + b"-qtrim" for i in remn_sel]
        comments_r = [lab if not c else c + b"\t" + lab
                      for c, lab in zip((rs.comments[int(i)]
                                         for i in remn_sel), labs)]
        offs_r = np.concatenate([[0], np.cumsum(rlens)]).astype(np.int64)
    if len(trim_sel):
        rs.apply_trims(smn[trim_sel], plen[trim_sel], trim_sel,
                       [b"AFTrim:%d+%d" % (o, l)
                        for o, l in zip(smn[trim_sel], plen[trim_sel])])
    if len(remn_sel):
        # remnants only arise from quality-trimmed, qual-bearing reads
        rs.append_arrays(names_r, comments_r, seq_flat, qual_flat, offs_r,
                         np.ones(len(remn_sel), dtype=bool))
