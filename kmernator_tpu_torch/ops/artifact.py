"""Artifact screen: primer/adapter/homopolymer (and optional simple-repeat /
PhiX) filtering with quality-run trimming.

Re-implements FilterKnownOddities (ref: src/FilterKnownOddities.h:171-736)
with a flat table of canonical 24-mers (exact + pre-built hamming-<=d edits,
ref: prepareMaps :242-286) and a vectorized byte-aligned scan: the reference
hops byte-by-byte over the 2-bit sequence (every 4 bases,
ref: applyFilterToRead :446-490), so only window positions that are
multiples of 4 are probed.

The built-in artifact data (public adapter/primer sequences from TagDust and
Illumina documentation, plus PhiX174) live in kmernator_tpu_torch/data/*.fasta —
they are part of the behavioral contract (ref: getArtifactFasta :742-794).

Copied for kmernator_tpu_torch from kmernator_tpu/ops/artifact.py; it
differs from its source only in its package imports. DATA_DIR, the same
expression, now names the port's copy of the screen's FASTA files,
kmernator_tpu_torch/data/.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet, BASE_CODE, parse_fasta_bytes
from kmernator_tpu_torch.ops.kmer import (extract_kmers_flat, nwords,
                                    revcomp_words, words_less)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _canonical_ints(canon: np.ndarray) -> np.ndarray:
    """[N, W<=4] u32 words -> object-free packed python-int-compatible u64/u128.
    For match length <= 32 (W <= 2) a u64 suffices."""
    N, W = canon.shape
    if W > 2:
        raise ValueError("artifact match length > 32 not supported")
    out = canon[:, 0].astype(np.uint64) << np.uint64(32)
    if W == 2:
        out |= canon[:, 1].astype(np.uint64)
    return out


def _canon_int_of_words(words: np.ndarray, k: int) -> np.ndarray:
    return _canonical_ints(words.reshape(-1, nwords(k)))


class ArtifactFilter:
    """Holds the 24-mer lookup table and applies the filter to a ReadSet."""

    def __init__(self, match_length: int = 24, edit_distance: int = 2,
                 build_edits_in_filter: int = 2,
                 mask_simple_repeats: bool = False, phix: bool = False,
                 extra_reference_files: Optional[List[str]] = None,
                 min_quality: int = 3, min_read_length: float = 0.40):
        if match_length > 28:
            raise ValueError("match length must be <= 28 bases")
        if match_length % 4 != 0:
            raise ValueError("match length must be a multiple of 4")
        self.k = match_length
        self.min_quality = min_quality
        self.min_read_length = min_read_length
        self.remaining_errors = edit_distance

        # sequence registry: index 0 is the no-match sentinel (ref: :198-200)
        self.seq_names: List[bytes] = [b""]
        seqs: List[bytes] = [b""]
        self.simple_repeat_range = (1 << 30, -1)
        self.phix_idx = -1
        self.reference_idx = 1 << 30

        def load(path):
            names, comments, seq, qual, offsets, hq = parse_fasta_bytes(
                open(path, "rb").read())
            for i, nm in enumerate(names):
                self.seq_names.append(nm)
                seqs.append(seq[offsets[i]:offsets[i + 1]].tobytes())

        load(os.path.join(DATA_DIR, "artifacts.fasta"))
        if mask_simple_repeats:
            begin = len(seqs)
            load(os.path.join(DATA_DIR, "simple_repeats.fasta"))
            self.simple_repeat_range = (begin, len(seqs))
        if phix:
            self.phix_idx = len(seqs)
            load(os.path.join(DATA_DIR, "phix174.fasta"))
        if extra_reference_files:
            self.reference_idx = len(seqs)
            for f in extra_reference_files:
                load(f)
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
        # (ref: prepareMaps :260-282)
        build = build_edits_in_filter
        for _err in range(edit_distance):
            if build == 1 or (build == 2 and len(table) < 750000):
                self.remaining_errors -= 1
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

    # ---- table helpers ----
    def _unpack(self, keys: np.ndarray) -> np.ndarray:
        W = nwords(self.k)
        words = np.zeros((len(keys), W), dtype=np.uint32)
        words[:, 0] = (keys >> np.uint64(32)).astype(np.uint32)
        if W == 2:
            words[:, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return words

    def _permute_all(self, keys: np.ndarray, vals: np.ndarray):
        """All hamming-1 neighbors (canonicalized) of the given canonical
        kmers (ref: KmerArrayPair::permuteBases, src/Kmer.h:1377-1454)."""
        k = self.k
        words = self._unpack(keys)
        outs = []
        outv = []
        for posn in range(k):
            w, o = divmod(posn, 16)
            shift = np.uint32(30 - 2 * o)
            cur = (words[:, w] >> shift) & np.uint32(3)
            for nb in range(4):
                mutated = words.copy()
                nw_val = (words[:, w] & ~(np.uint32(3) << shift)) | (np.uint32(nb) << shift)
                mutated[:, w] = nw_val
                keep = cur != nb
                rc = revcomp_words(np, mutated, k)
                le = ~words_less(np, rc, mutated)
                canon = np.where(le[:, None], mutated, rc)
                outs.append(_canonical_ints(canon[keep]))
                outv.append(vals[keep])
        return np.concatenate(outs), np.concatenate(outv)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized table lookup: value (0 = miss) per canonical u64 key.
        Uses the native hash probe when available (the table is immutable
        after __init__); falls back to binary search."""
        ht = getattr(self, "_ht", None)
        if ht is None and len(keys) >= 4096:
            from kmernator_tpu_torch.io.native import make_hash
            self._ht = ht = (make_hash(self._table_keys, self._table_vals),)
        if ht is not None and ht[0] is not None:
            return ht[0].lookup(keys)
        idx = np.searchsorted(self._table_keys, keys)
        idx = np.clip(idx, 0, len(self._table_keys) - 1)
        hit = self._table_keys[idx] == keys
        return np.where(hit, self._table_vals[idx], 0)

    def is_phix(self, v) -> bool:
        return self.phix_idx >= 0 and v == self.phix_idx

    def is_simple_repeat(self, v) -> bool:
        return self.simple_repeat_range[0] <= v < self.simple_repeat_range[1]

    def is_reference(self, v) -> bool:
        return v >= self.reference_idx

    # ---- per-read scan ----
    def _quality_runs(self, phred: np.ndarray, has_quals: bool):
        """Best and second-best runs of q >= minQuality
        (ref: applyFilterToRead :407-442).  Returns ((b0,b1),(s0,s1))."""
        L = len(phred)
        if not has_quals:
            return (0, L), (0, 0)
        bad = phred < self.min_quality
        best = (0, 0)
        second = (0, 0)
        t0 = 0
        for i in range(L + 1):
            if i == L or bad[i]:
                t = (t0, i)
                if t[1] - t[0] > best[1] - best[0]:
                    best, t = t, best
                if t[1] - t[0] > second[1] - second[0]:
                    second = t
                t0 = i + 1
        return best, second

    def _scan_read(self, rs: ReadSet, i: int):
        """ref: applyFilterToRead :389-541 (minus record effects).
        Returns (value, min_pass, max_pass, second_best, was_phix)."""
        s, e = rs.offsets[i], rs.offsets[i + 1]
        L = int(e - s)
        phred = rs.phred()[s:e]
        best, second = self._quality_runs(phred, bool(rs.has_quals[i]))
        if best[1] > best[0]:
            min_pass, max_pass = best
        else:
            min_pass = max_pass = 0

        value = 0
        was_phix = False
        min_aff, max_aff = max_pass, min_pass

        k = self.k
        tb_len = k // 4
        bytes_ = (L + 3) // 4
        byte_hops = (max_pass + 3) // 4 - tb_len - (0 if L % 4 == 0 else 1)
        if byte_hops < 0 or byte_hops > bytes_:
            byte_hops = 0
        start_hop = min_pass // 4
        if byte_hops >= start_hop and L >= k:
            positions = np.arange(start_hop, byte_hops + 1) * 4
            # pad to the 2-bit byte boundary: the reference's packed buffer
            # zero-fills the trailing pad bases (read as 'A')
            Lp = 4 * bytes_
            codes = np.zeros(Lp, dtype=np.uint8)
            c = BASE_CODE[rs.seq[s:e]]
            codes[:L] = np.where(c == 4, 0, c)
            canon, _, _, _ = extract_kmers_flat(codes, np.array([0, Lp]), k)
            nw = Lp - k + 1
            positions = positions[positions < nw]
            if len(positions):
                keys = _canonical_ints(canon[positions])
                vals = self.lookup(keys)
                if self.remaining_errors > 0:
                    # query-side permutations (build_edits_in_filter == 0 path)
                    for qi in np.flatnonzero(vals == 0):
                        nk, _ = self._permute_all(keys[qi:qi + 1],
                                                  np.zeros(1, np.int64))
                        v2 = self.lookup(nk)
                        hitn = np.flatnonzero(v2 > 0)
                        if len(hitn):
                            vals[qi] = v2[hitn[-1]]
                hits = vals > 0
                if hits.any():
                    hp = positions[hits]
                    hv = vals[hits]
                    value = int(hv[-1])  # last hit wins (ref keeps overwriting)
                    was_phix = any(self.is_phix(v) for v in hv)
                    min_aff = min(min_aff, int(hp.min()))
                    max_aff = max(max_aff, int(hp.max()) + k)

        if was_phix:
            value = self.phix_idx
        elif self.is_simple_repeat(value):
            good_margin = (min_aff - min_pass) >= (3 * k) // 2 and \
                          (max_pass - max_aff) >= (3 * k) // 2
            if good_margin:
                value = 0
                min_aff, max_aff = max_pass, min_pass

        if value > 0 and min_aff <= max_aff:
            if (min_aff - min_pass) >= (max_pass - max_aff):
                max_pass = min_aff
            else:
                min_pass = max_aff

        return value, min_pass, max_pass, second, was_phix


    def scan_all(self, rs: ReadSet):
        """Vectorized whole-ReadSet scan: returns per-read
        (value, min_pass, max_pass, second_off, second_len, was_phix) arrays
        with identical semantics to _scan_read (which remains as the scalar
        reference for testing)."""
        n = rs.n
        lens = rs.lengths().astype(np.int64)
        phred = rs.phred()
        k = self.k
        # --- quality runs (best & second best) ---
        from kmernator_tpu_torch.io import native
        L = int(lens.max()) if n else 0
        base = int(rs.offsets[0]) if n else 0
        qr = native.quality_runs(phred[base:], rs.has_quals,
                                 rs.offsets - base, self.min_quality) \
            if n else None
        if qr is not None:
            best_off, best_len, sec_off, sec_len = qr
        else:
            good = np.zeros((n, L), dtype=bool)
            if n and L:
                rows = np.repeat(np.arange(n), lens)
                cols = np.arange(int(lens.sum())) - np.repeat(
                    rs.offsets[:-1].astype(np.int64) - base, lens)
                flat_good = phred[base:int(rs.offsets[-1])] >= self.min_quality
                good[rows, cols] = flat_good | ~rs.has_quals[rows]
            col = np.arange(L)[None, :]
            in_read = col < lens[:, None]
            good &= in_read
            # column-wise transcription of the scalar best/second loop
            # (_quality_runs): at every run end, the run challenges best
            # (strictly longer wins; the demoted ex-best then challenges
            # second).  A masked argmax is NOT equivalent — when the
            # pre-best leader ties an already-accepted second candidate,
            # the reference keeps the candidate, not the leader.
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
        was_phix = np.zeros(n, dtype=bool)
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
            # fused native scan: canonical byte-hop windows probed against
            # the artifact hash in one pass (no [n, H] key/mask planes) —
            # fed the raw ASCII sequence (bases map inline; non-ACGT scans
            # as 'A' exactly like BASE_CODE==4 -> 0 below), so the two
            # whole-chunk passes building flat_codes are skipped entirely
            fused = None
            if W <= 2:
                ht = getattr(self, "_ht", None)
                if ht is None:
                    from kmernator_tpu_torch.io.native import make_hash
                    self._ht = ht = (make_hash(self._table_keys,
                                               self._table_vals),)
                fused = native.artifact_scan(
                    rs.seq[base:int(rs.offsets[-1])], rs.offsets - base, k,
                    start_hop, byte_hops, ht[0],
                    self.phix_idx if self.phix_idx >= 0 else -1,
                    raw_ascii=True)
            if fused is not None:
                value, fmin, fmax, was_phix = fused
                any_hit = value > 0
                min_aff = np.where(any_hit, np.minimum(min_aff, fmin),
                                   min_aff)
                max_aff = np.where(any_hit, np.maximum(max_aff, fmax + k),
                                   max_aff)
                if self.simple_repeat_range[1] > 0:
                    is_sr = ((value >= self.simple_repeat_range[0])
                             & (value < self.simple_repeat_range[1]))
                    good_margin = (((min_aff - min_pass) >= (3 * k) // 2)
                                   & ((max_pass - max_aff) >= (3 * k) // 2))
                    clear = is_sr & good_margin & ~was_phix
                    value = np.where(clear, 0, value)
                    min_aff = np.where(clear, max_pass, min_aff)
                    max_aff = np.where(clear, min_pass, max_aff)
                act = (value > 0) & (min_aff <= max_aff)
                keep_left = (min_aff - min_pass) >= (max_pass - max_aff)
                max_pass = np.where(act & keep_left, min_aff, max_pass)
                min_pass = np.where(act & ~keep_left, max_aff, min_pass)
                return (value, min_pass, max_pass, sec_off, sec_len,
                        was_phix)
            flat_codes = BASE_CODE[rs.seq[base:int(rs.offsets[-1])]]
            flat_codes = np.where(flat_codes == 4, 0,
                                  flat_codes).astype(np.uint8)
            keys2d = native.artifact_keys(flat_codes, rs.offsets - base,
                                          k, H) if W <= 2 else None
            if keys2d is None:
                from kmernator_tpu_torch.ops.kmer import last_word_mask, pack16
                codes = np.zeros((n, Lp), dtype=np.uint8)
                if L:
                    rows = np.repeat(np.arange(n), lens)
                    cols = (np.arange(int(lens.sum()))
                            - np.repeat(rs.offsets[:-1].astype(np.int64)
                                        - base, lens))
                    codes[rows, cols] = flat_codes
                # the scan only probes byte-aligned windows (every 4th base,
                # ref: applyFilterToRead :446-490) — build canonical words at
                # those positions directly rather than extracting every
                # window then keeping every 4th (4x less pack/revcomp work)
                p16 = pack16(np, codes)  # [n, Lp]
                fwd = np.zeros((n, H, W), dtype=np.uint32)
                for w in range(W):
                    sl = p16[:, 16 * w::4][:, :H]
                    fwd[:, :sl.shape[1], w] = sl
                fwd[:, :, W - 1] &= np.uint32(last_word_mask(k))
                rc = revcomp_words(np, fwd, k)
                fwd_le = ~words_less(np, rc, fwd)
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
                hp = np.where(hit, pos, np.iinfo(np.int64).max)
                min_hit = hp.min(axis=1)
                hp2 = np.where(hit, pos, -1)
                max_hit = hp2.max(axis=1)
                min_aff = np.where(any_hit, np.minimum(min_aff, min_hit), min_aff)
                max_aff = np.where(any_hit, np.maximum(max_aff, max_hit + k), max_aff)
                if self.phix_idx >= 0:
                    was_phix = (vals == self.phix_idx).any(axis=1)
                    value = np.where(was_phix, self.phix_idx, value)
                if self.simple_repeat_range[1] > 0:
                    is_sr = ((value >= self.simple_repeat_range[0])
                             & (value < self.simple_repeat_range[1]))
                    good_margin = (((min_aff - min_pass) >= (3 * k) // 2)
                                   & ((max_pass - max_aff) >= (3 * k) // 2))
                    clear = is_sr & good_margin & ~was_phix
                    value = np.where(clear, 0, value)
                    min_aff = np.where(clear, max_pass, min_aff)
                    max_aff = np.where(clear, min_pass, max_aff)

        # --- trim to the larger clean side ---
        act = (value > 0) & (min_aff <= max_aff)
        keep_left = (min_aff - min_pass) >= (max_pass - max_aff)
        max_pass = np.where(act & keep_left, min_aff, max_pass)
        min_pass = np.where(act & ~keep_left, max_aff, min_pass)
        return value, min_pass, max_pass, sec_off, sec_len, was_phix


def passes_length(length: float, read_length: int, minimum_length: float) -> bool:
    """ref: ReadSelectorUtil::passesLength (src/ReadSelector.h:209-228)."""
    if length <= 1.0:
        return False
    if minimum_length <= 1.0:
        return read_length * minimum_length <= length
    return minimum_length <= length


def _slice_readset(rs: ReadSet, cs: int, ce: int) -> ReadSet:
    """Lightweight view-copy of reads [cs, ce) for chunked scanning."""
    if cs == 0 and ce == rs.n:
        return rs
    sub = ReadSet.__new__(ReadSet)
    s, e = rs.offsets[cs], rs.offsets[ce]
    sub.names = rs.names[cs:ce]
    sub.comments = rs.comments[cs:ce]
    sub.seq = rs.seq[s:e]
    sub.qual = rs.qual[s:e]
    sub.offsets = rs.offsets[cs:ce + 1] - s
    sub.discarded = rs.discarded[cs:ce]
    sub.has_quals = rs.has_quals[cs:ce]
    sub.file_idx = rs.file_idx[cs:ce]
    sub.input_qual_base = rs.input_qual_base
    sub.pairs = []
    sub._phred = None
    sub._lengths = None
    return sub


@dataclass
class FilterOutcome:
    affected: int = 0
    discarded: int = 0
    trimmed: int = 0
    phix_reads: List[int] = field(default_factory=list)
    # (read_idx, label) of non-phix discards, for --filter-output
    artifact_reads: List[Tuple[int, bytes]] = field(default_factory=list)
    # per-read scan arrays (value, min/max pass, second off/len, phix) —
    # deterministic for a given ReadSet, so two-pass streaming callers can
    # replay them instead of rescanning (the scan dominates filter cost)
    scan: Optional[Tuple[np.ndarray, ...]] = None


def apply_artifact_filter(rs: ReadSet, filt: ArtifactFilter,
                          precomputed=None) -> FilterOutcome:
    """ref: FilterKnownOddities::applyFilter (:663-732) +
    recordAffectedRead (:551-661).  Mutates rs in place: trims reads
    (AFTrim labels appended to comments), marks discards, appends -qtrim
    remnant reads.  `precomputed` replays a prior FilterOutcome.scan for
    an identical ReadSet (pass 2 of the streaming app)."""
    out = FilterOutcome()
    by_pair = rs.has_pairs()
    n = rs.n
    lens = rs.lengths()

    if precomputed is not None:
        sv, smn, smx, sso, ssl, sph = precomputed
    else:
        # vectorized whole-set scan (chunked to bound memory)
        CH = 65536
        sv = np.zeros(n, np.int64)
        smn = np.zeros(n, np.int64)
        smx = np.zeros(n, np.int64)
        sso = np.zeros(n, np.int64)
        ssl = np.zeros(n, np.int64)
        sph = np.zeros(n, bool)
        for cs in range(0, n, CH):
            ce = min(cs + CH, n)
            sub = _slice_readset(rs, cs, ce)
            v, mn, mx, so, sl, wp = filt.scan_all(sub)
            sv[cs:ce], smn[cs:ce], smx[cs:ce] = v, mn, mx
            sso[cs:ce], ssl[cs:ce], sph[cs:ce] = so, sl, wp
    out.scan = (sv, smn, smx, sso, ssl, sph)

    # emission order: per-pair (r1 then r2) when pairing is known, else
    # read order — phix/artifact/trim/remnant lists must follow it so
    # downstream --phix-output/--filter-output writes stay byte-identical
    # to the reference's per-pair loop (ref: applyFilter :663-732)
    if by_pair:
        pmat = np.asarray(rs.pairs, dtype=np.int64).reshape(-1, 2)
        flat = pmat.reshape(-1)
        order = flat[flat >= 0]
        # joint phix: either member's phix hit condemns both (ref: :688-704)
        memb_ph = np.zeros(pmat.shape, dtype=bool)
        for c in (0, 1):
            vmask = pmat[:, c] >= 0
            memb_ph[vmask, c] = sph[pmat[vmask, c]]
        jointp = memb_ph[:, 0] | memb_ph[:, 1]
        joint = np.zeros(n, dtype=bool)
        for c in (0, 1):
            vmask = pmat[:, c] >= 0
            joint[pmat[vmask, c]] = jointp[vmask]
    else:
        order = np.arange(n, dtype=np.int64)
        joint = None

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

    if by_pair:
        eff_phix = joint
        aff = joint | (val != 0)
    else:
        eff_phix = sph & (val != 0)
        aff = val != 0
    is_ref = (val >= filt.reference_idx) & (val != NS)
    bad_len = (plen <= 0) | ~passes_vec(plen, lens)
    disc_phix = aff & eff_phix
    disc_art = aff & ~eff_phix & (is_ref | bad_len)
    trim = aff & ~eff_phix & ~(is_ref | bad_len)

    sel = lambda m: order[m[order]]
    phix_sel = sel(disc_phix)
    art_sel = sel(disc_art)
    trim_sel = sel(trim)
    rs.discarded[phix_sel] = True
    rs.discarded[art_sel] = True
    out.affected = int(aff[order].sum())
    out.discarded = len(phix_sel) + len(art_sel)
    out.trimmed = len(trim_sel)
    out.phix_reads = [int(i) for i in phix_sel]
    nnames = len(filt.seq_names)
    qlabel = b"MinQualityTrim%d" % filt.min_quality
    out.artifact_reads = [
        (int(i), filt.seq_names[v] if v < nnames else qlabel)
        for i, v in zip(art_sel, val[art_sel])]

    remn_sel = sel(remn)
    if len(remn_sel):
        # gather remnant bases/quals columnar BEFORE apply_trims rebuilds
        # the flat arrays (ragged gather; was a per-read slice loop)
        starts = (rs.offsets[remn_sel] + sso[remn_sel]).astype(np.int64)
        rlens = ssl[remn_sel].astype(np.int64)
        from kmernator_tpu_torch.io import native as _nat
        seq_flat = _nat.gather_ragged(rs.seq, starts, rlens)
        if seq_flat is not None:
            qual_flat = _nat.gather_ragged(rs.qual, starts, rlens)
        else:
            from kmernator_tpu_torch.io.reads import _ragged_indices
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
        # matches append_reads_batch semantics for remnants: has_quals True
        # (remnants only arise from quality-trimmed, qual-bearing reads),
        # file_idx 0
        rs.append_arrays(names_r, comments_r, seq_flat, qual_flat, offs_r,
                         np.ones(len(remn_sel), dtype=bool), file_idx=0)
    return out
