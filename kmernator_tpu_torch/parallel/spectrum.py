"""K-mer spectrum: the counted table of canonical k-mers.

Design replaces the reference's three open-hash maps (solid/weak/singleton,
ref: src/KmerSpectrum.h:344-420) with ONE sorted columnar table of
(key, count, weighted_count, direction_bias[, extension counters]).  The
reference splits maps only to save host RAM during promote-on-second-sight
insertion; the final counts are order-independent, so a batched
sort+segment-reduce produces identical results (singletons are simply rows
with count == 1; `purge_min_depth` drops rows below the threshold, matching
KmerSpectrum::purgeMinDepth + ReadSelector scoring against the weak map).

This module is the host/exact implementation (numpy); the device (TPU)
implementation with identical semantics lives in device_spectrum.py and the
sharded multi-chip version in mesh.py.

Copied for kmernator_tpu_torch from kmernator_tpu/parallel/spectrum.py; it
differs from its source only in its package imports.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from kmernator_tpu_torch.ops.kmer import nwords


def pack_u64(canon: np.ndarray) -> np.ndarray:
    """[N, W<=2] u32 -> u64 preserving lexicographic order."""
    W = canon.shape[1]
    if W > 2:
        raise ValueError("pack_u64 requires k <= 32")
    out = canon[:, 0].astype(np.uint64) << np.uint64(32)
    if W == 2:
        out |= canon[:, 1].astype(np.uint64)
    return out


def pack_keys(canon: np.ndarray) -> np.ndarray:
    """[N, W] u32 -> sortable scalar keys: u64 for W <= 2, big-endian byte
    strings ('S4W', lexicographic == word order) for wider kmers."""
    W = canon.shape[1]
    if W <= 2:
        return pack_u64(canon)
    be = np.ascontiguousarray(canon.astype(">u4"))
    return be.view("S%d" % (4 * W)).reshape(-1)


def unpack_u64(keys: np.ndarray, W: int) -> np.ndarray:
    out = np.zeros((len(keys), W), dtype=np.uint32)
    out[:, 0] = (keys >> np.uint64(32)).astype(np.uint32)
    if W == 2:
        out[:, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def unpack_keys(keys: np.ndarray, W: int) -> np.ndarray:
    """Inverse of pack_keys: scalar keys (u64 or 'S4W' bytes) -> [N, W] u32."""
    if keys.dtype == np.uint64:
        return unpack_u64(keys, W)
    be = np.ascontiguousarray(keys).view(">u4").reshape(len(keys), W)
    return be.astype(np.uint32)


def _key_id(key):
    """Hashable identity of a scalar key (int for u64, bytes for wide)."""
    return int(key) if isinstance(key, (int, np.integer)) else bytes(key)


def _hamming1_canonical(words: np.ndarray, k: int) -> np.ndarray:
    """All canonical keys (pack_keys dtype) at hamming distance 1 from the
    [1, W] kmer."""
    from kmernator_tpu_torch.ops.kmer import revcomp_words, words_less
    out = []
    W = words.shape[1]
    for posn in range(k):
        w, o = divmod(posn, 16)
        shift = np.uint32(30 - 2 * o)
        cur = (words[0, w] >> shift) & np.uint32(3)
        for nb in range(4):
            if nb == cur:
                continue
            mut = words.copy()
            mut[0, w] = (words[0, w] & ~(np.uint32(3) << shift)) | (np.uint32(nb) << shift)
            rc = revcomp_words(np, mut, k)
            canon = rc if words_less(np, rc, mut)[0] else mut
            out.append(pack_keys(canon)[0])
    return np.array(out)


def hamming_shell_batch(words: np.ndarray, k: int) -> np.ndarray:
    """[S, W] kmer words -> [S, 4k, W] canonical keys of every single-base
    substitution (including the identity rows where the substituted base
    equals the original — harmless: a source never tests below its own
    threshold).  Vectorized over S; 4k small host loops only."""
    from kmernator_tpu_torch.ops.kmer import revcomp_words, words_less
    S, W = words.shape
    out = np.repeat(words[:, None, :], 4 * k, axis=1).copy()
    for p in range(k):
        w, o = divmod(p, 16)
        shift = np.uint32(30 - 2 * o)
        cleared = words[:, w] & ~(np.uint32(3) << shift)
        for nb in range(4):
            out[:, 4 * p + nb, w] = cleared | (np.uint32(nb) << shift)
    flat = out.reshape(S * 4 * k, W)
    rc = revcomp_words(np, flat, k)
    less = words_less(np, rc, flat)
    canon = np.where(less[:, None], rc, flat)
    return canon.reshape(S, 4 * k, W)


@dataclass
class KmerSpectrum:
    """Sorted spectrum table (host representation)."""
    k: int
    keys: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    counts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    weighted: Optional[np.ndarray] = None      # sum of (float) weights
    direction: Optional[np.ndarray] = None     # forward-orientation track count
    extensions: Optional[np.ndarray] = None    # [M, 12] 2x6 left/right counters
    raw_kmers: int = 0
    raw_good_kmers: int = 0

    @property
    def n_unique(self) -> int:
        return len(self.keys)

    def singleton_count(self) -> int:
        return int((self.counts == 1).sum())

    @staticmethod
    def from_observations(k: int, keys: np.ndarray, good: np.ndarray,
                          weights: Optional[np.ndarray] = None,
                          is_fwd: Optional[np.ndarray] = None,
                          ext_left: Optional[np.ndarray] = None,
                          ext_right: Optional[np.ndarray] = None) -> "KmerSpectrum":
        """Count observations.

        keys:   [N] u64 canonical kmers (all windows)
        good:   [N] bool — weight above the discard threshold
                (ref: TrackingData::isDiscard); only good observations count
        weights:[N] float32 weights (summed for weightedCount parity)
        is_fwd: [N] bool — stored orientation was the read's forward strand
                (tracks directionBias, ref: TrackingDataWithDirection)
        ext_left/ext_right: [N] int8 extension codes 0..5 (A,C,G,T,N,X) or -1
                when below the extension quality threshold
                (ref: ExtensionTracking::trackExtension)
        """
        sp = KmerSpectrum(k=k)
        sp.raw_kmers = int(len(keys))
        gk = keys[good]
        sp.raw_good_kmers = int(len(gk))
        if len(gk) == 0:
            return sp
        order = np.argsort(gk, kind="stable")
        sk = gk[order]
        boundary = np.concatenate([[True], sk[1:] != sk[:-1]])
        seg = np.cumsum(boundary) - 1
        M = int(seg[-1]) + 1
        sp.keys = sk[boundary]
        sp.counts = np.bincount(seg, minlength=M).astype(np.int64)
        if weights is not None:
            # reference accumulates float32 weightedCount += (float)weight in
            # insertion order; we sum in sorted order (documented deviation —
            # weightedCount is only used for histograms/uncertainty displays)
            sp.weighted = np.bincount(seg, weights=weights[good][order].astype(np.float64),
                                      minlength=M)
        if is_fwd is not None:
            sp.direction = np.bincount(seg, weights=is_fwd[good][order].astype(np.float64),
                                       minlength=M).astype(np.int64)
        if ext_left is not None:
            sp.extensions = np.zeros((M, 12), dtype=np.int64)
            el = ext_left[good][order]
            er = ext_right[good][order]
            for code in range(6):
                sp.extensions[:, code] += np.bincount(seg[el == code], minlength=M)
                sp.extensions[:, 6 + code] += np.bincount(seg[er == code], minlength=M)
        return sp

    def purge_min_depth(self, min_depth: int):
        """ref: KmerSpectrum::purgeMinDepth (src/KmerSpectrum.h:1805-1815)."""
        keep = self.counts >= min_depth
        self.keys = self.keys[keep]
        self.counts = self.counts[keep]
        if self.weighted is not None:
            self.weighted = self.weighted[keep]
        if self.direction is not None:
            self.direction = self.direction[keep]
        if self.extensions is not None:
            self.extensions = self.extensions[keep]

    def lookup_counts(self, query: np.ndarray) -> np.ndarray:
        """count per query key (0 for absent): native hash probes when
        available (binary search costs ~log2(M) dependent cache misses per
        query), else vectorized binary search."""
        if len(self.keys) == 0:
            return np.zeros(len(query), dtype=np.int64)
        if len(query) >= 4096 and len(self.keys) >= 4096:
            ht = getattr(self, "_hash", None)
            if ht is None or ht[0] is not self.keys:
                from kmernator_tpu_torch.io.native import make_hash
                self._hash = ht = (self.keys,
                                   make_hash(self.keys, self.counts))
            if ht[1] is not None:
                return ht[1].lookup(query)
        idx = np.searchsorted(self.keys, query)
        idx = np.clip(idx, 0, len(self.keys) - 1)
        hit = self.keys[idx] == query
        return np.where(hit, self.counts[idx], 0)

    def merge(self, other: "KmerSpectrum") -> "KmerSpectrum":
        """Merge two spectra (out-of-core / sharded builds)."""
        keys = np.concatenate([self.keys, other.keys])
        counts = np.concatenate([self.counts, other.counts])
        order = np.argsort(keys, kind="stable")
        keys, counts = keys[order], counts[order]
        boundary = np.concatenate([[True], keys[1:] != keys[:-1]])
        seg = np.cumsum(boundary) - 1
        out = KmerSpectrum(k=self.k)
        out.keys = keys[boundary]
        out.counts = np.bincount(seg, weights=counts.astype(np.float64)).astype(np.int64)
        out.raw_kmers = self.raw_kmers + other.raw_kmers
        out.raw_good_kmers = self.raw_good_kmers + other.raw_good_kmers
        return out

    # ---------- persistence (replaces storeMmap/restoreMmap,
    # ref: src/KmerSpectrum.h:476-519) ----------
    def save(self, path: str):
        np.savez(path, k=self.k, keys=self.keys, counts=self.counts,
                 weighted=self.weighted if self.weighted is not None else np.zeros(0),
                 direction=self.direction if self.direction is not None else np.zeros(0),
                 extensions=self.extensions if self.extensions is not None else np.zeros((0, 12)),
                 raw=np.array([self.raw_kmers, self.raw_good_kmers]))

    @staticmethod
    def load(path: str) -> "KmerSpectrum":
        z = np.load(path)
        sp = KmerSpectrum(k=int(z["k"]))
        sp.keys = z["keys"]
        sp.counts = z["counts"]
        if len(z["weighted"]):
            sp.weighted = z["weighted"]
        if len(z["direction"]):
            sp.direction = z["direction"]
        if len(z["extensions"]):
            sp.extensions = z["extensions"]
        sp.raw_kmers, sp.raw_good_kmers = (int(x) for x in z["raw"])
        return sp

    # ---------- histogram (ref: KmerSpectrum::Histogram,
    # src/KmerSpectrum.h:909-1058) ----------
    def histogram_table(self, zoom_max: int = 256, log_base: float = 2.0) -> str:
        """Reference-format histogram: linear buckets up to zoom_max, then
        log-scale; columns Bucket/Cumulative/Unique/%Unique/Count/%Count/
        Weight/QualProb/%Weight (ref: Histogram::toString)."""
        import math
        log_factor = math.log(log_base)
        zoom_log_skip = int(math.log(zoom_max + 1.0) / log_factor - 1.0)
        max_idx = (1 << 16) + 1 + zoom_max
        visits = np.zeros(max_idx + 1, np.int64)
        vcount = np.zeros(max_idx + 1, np.int64)
        vweight = np.zeros(max_idx + 1, np.float64)
        counts = self.counts
        weights = (self.weighted if self.weighted is not None
                   else counts.astype(np.float64))
        nz = counts > 0
        c = counts[nz].astype(np.float64)
        idx = np.where(counts[nz] <= zoom_max, counts[nz],
                       (np.log(c) / log_factor - zoom_log_skip + zoom_max
                        ).astype(np.int64)).astype(np.int64)
        idx = np.clip(idx, 0, max_idx)
        np.add.at(visits, idx, 1)
        np.add.at(vcount, idx, counts[nz])
        np.add.at(vweight, idx, weights[nz])
        # finish(): cumulative from the top
        cum = np.cumsum(visits[::-1])[::-1]
        total_visits = int(visits.sum())
        total_count = float(vcount.sum())
        total_weight = float(vweight.sum())
        nz_idx = np.flatnonzero(visits)
        last_bucket = int(nz_idx.max()) if len(nz_idx) else 0
        out = ["Counts, Weights and Directions"]
        out.append("Counts:\t%d\t%.3f\t%.3f\t" % (
            total_visits, total_count,
            total_count / total_visits if total_visits else 0.0))
        out.append("Weights:\t%d\t%.3f\t%.3f\t%.3f" % (
            total_visits, total_weight,
            total_weight / total_visits if total_visits else 0.0,
            total_weight / total_count if total_count else 0.0))
        out.append("")
        out.append("Bucket\tCumulative\tUnique\t%Unique\tCount\t%Count\tWeight\tQualProb\t%Weight")
        for i in range(1, last_bucket + 1):
            if i <= zoom_max:
                bucket_val = i
            else:
                bucket_val = int(log_base ** (i + zoom_log_skip - zoom_max))
            out.append("%d\t%d\t%d\t%.3f\t%d\t%.3f\t\t%.3f\t%.3f\t%.3f\t" % (
                bucket_val, int(cum[i]), int(visits[i]),
                100.0 * visits[i] / total_visits if total_visits else 0.0,
                int(vcount[i]),
                100.0 * vcount[i] / total_count if total_count else 0.0,
                vweight[i],
                vweight[i] / vcount[i] if vcount[i] else 0.0,
                100.0 * vweight[i] / total_weight if total_weight else 0.0))
        return "\n".join(out) + "\n"

    def gc_heat_map(self) -> str:
        """GC-vs-coverage weight heat map (ref: KmerSpectrum::GCCoverageHeatMap,
        src/KmerSpectrum.h:1073-1140): rows = coverage count, columns =
        GC-base count 0..k, cells = summed weighted counts."""
        k = self.k
        W = nwords(k)
        header = "".join("depth\t%g" % (100.0 * gc / k) for gc in range(k + 1))
        if len(self.keys) == 0:
            return header + "\n"
        words = unpack_keys(self.keys, W)
        # GC count per key: count 01/10 2-bit groups
        gc = np.zeros(len(self.keys), dtype=np.int64)
        for w in range(W):
            x = words[:, w]
            for o in range(16):
                code = (x >> np.uint32(30 - 2 * o)) & np.uint32(3)
                if w * 16 + o < k:
                    gc += ((code == 1) | (code == 2)).astype(np.int64)
        weights = (self.weighted if self.weighted is not None
                   else self.counts.astype(np.float64))
        max_cover = int(self.counts.max()) + 1
        hm = np.zeros((max_cover, k + 1), dtype=np.float64)
        np.add.at(hm, (np.minimum(self.counts, max_cover - 1), gc), weights)
        lines = [header]
        for cover in range(max_cover):
            row = [str(cover)]
            for g in range(k + 1):
                v = hm[cover, g]
                row.append(("%g" % v) if v != 0.0 else "")
            lines.append("\t".join(row))
        return "\n".join(lines) + "\n"

    # ---------- variant purge (ref: KmerSpectrum::purgeVariants,
    # src/KmerSpectrum.h:2117-2235) ----------
    def purge_variants(self, variant_sigmas: float, edit_distance: int = 2,
                       min_variant_kmer_depth: float = 512,
                       use_weighted: bool = True, min_depth: int = 2) -> int:
        """Purge hamming-neighbor kmers that are far less abundant than a
        strong kmer: threshold = (count - sigmas*sqrt(count)) / (20 XOR
        (d-1)) (the reference's `^` is XOR — bug-compatible).

        Vectorized: all sources' hamming shells are generated in batch and
        resolved against the sorted table with searchsorted; the
        purged-sources-don't-purge rule (a kmer purged by a more abundant
        source no longer acts as a source, ref: the reference erasing
        purged entries) is a downward fixpoint — iterate 'active sources ->
        purge set' until stable.  Purgers are always strictly more abundant
        than their victims, so this equals sequential descending-order
        processing (the reference's bucket order is nondeterministic; ours
        is the deterministic resolution).  Ends with purge_min_depth."""
        if variant_sigmas <= 0.0 or len(self.keys) == 0:
            return 0
        vals0 = (self.weighted if (use_weighted and self.weighted is not None)
                 else self.counts.astype(np.float64)).copy()
        purged = np.zeros(len(self.keys), dtype=bool)
        is_source0 = vals0 > min_variant_kmer_depth
        for _ in range(32):
            newly = self._purge_pass(vals0, is_source0 & ~purged,
                                     variant_sigmas, edit_distance,
                                     min_variant_kmer_depth)
            if np.array_equal(newly, purged):
                break
            purged = newly
        n = int(purged.sum())
        self.counts[purged] = 0
        if self.weighted is not None:
            self.weighted[purged] = 0.0
        self.purge_min_depth(min_depth)
        return n

    def _purge_pass(self, vals0: np.ndarray, active: np.ndarray,
                    sigmas: float, edit_distance: int,
                    min_var: float, chunk: int = 512) -> np.ndarray:
        """One vectorized pass: the purge set induced by `active` sources
        against original values."""
        from kmernator_tpu_torch.ops.kmer import nwords
        k, W = self.k, nwords(self.k)
        out = np.zeros(len(self.keys), dtype=bool)
        src = np.flatnonzero(active)
        for s in range(0, len(src), chunk):
            si = src[s:s + chunk]
            v = vals0[si]
            thr_base = v - np.sqrt(v) * sigmas
            # per-source max edit distance (ref: the d-shrink loop)
            d = np.full(len(si), edit_distance, dtype=np.int64)
            for _ in range(max(edit_distance - 1, 0)):
                shrink = (d > 1) & ~(v > min_var * (20 ^ d))
                d[shrink] -= 1
            words = unpack_keys(self.keys[si], W)
            # frontier rows: (source row, key words); dist-1 shell first
            srow = np.repeat(np.arange(len(si)), 4 * k)
            frontier = hamming_shell_batch(words, k).reshape(-1, W)
            for dist in range(1, edit_distance + 1):
                fkeys = pack_keys(frontier)
                idx = np.searchsorted(self.keys, fkeys)
                idx = np.clip(idx, 0, len(self.keys) - 1)
                hit = self.keys[idx] == fkeys
                thr = thr_base[srow] / (20 ^ (dist - 1))
                ok = (hit & (d[srow] >= dist)
                      & (vals0[idx] > 0.0) & (vals0[idx] < thr))
                out[idx[ok]] = True
                if dist < edit_distance and (d > dist).any():
                    # expand to the next shell: dedup (source, key) first
                    # (the reference's set-expansion, keeps the blowup at
                    # O(unique) instead of O(4k)^d)
                    order = np.lexsort((fkeys, srow))
                    fs, fk = srow[order], fkeys[order]
                    keep = np.concatenate(
                        [[True], (fs[1:] != fs[:-1]) | (fk[1:] != fk[:-1])])
                    sel = order[keep]
                    base_words = unpack_keys(fkeys[sel], W)
                    srow = np.repeat(srow[sel], 4 * k)
                    frontier = hamming_shell_batch(base_words,
                                                   k).reshape(-1, W)
                else:
                    break
        return out
