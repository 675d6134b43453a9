"""Read scoring / trimming / selection (the ReadSelector semantics).

Re-implements ReadSelector<Map> (ref: src/ReadSelector.h:232-1263):
 - longest-run trim over per-window spectrum counts
   (trimReadByMinimumKmerScore :948-1014)
 - scoring types SUM/MEDIAN/AVG/MIN/MAX (:1088-1180; note SUM is
   bug-compatible with the reference: it leaves the run-length score)
 - trim headers "Trim:o+l" / "<Type>Score:n" (:1015-1035)
 - pair-aware pick logic (pickAllPassingPairs :585-596, isPassing* :547-574)

The count lookups themselves run against a KmerSpectrum table; this module
only consumes a ragged [N_windows] count vector.

Copied for kmernator_tpu_torch from kmernator_tpu/ops/trim.py; it differs
from its source only in its package imports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet
from kmernator_tpu_torch.ops.artifact import passes_length

SCORING_LABELS = {
    "SUM": b"Score",
    "MEDIAN": b"MedianScore",
    "MIN": b"MinScore",
    "MAX": b"MaxScore",
    "AVG": b"AvgScore",
}


@dataclass
class ReadTrims:
    offset: np.ndarray   # [n] base offset of the kept region
    length: np.ndarray   # [n] kept length in bases (0 = fails)
    score: np.ndarray    # [n] float score (-1 = fails)
    label: List[bytes]   # [n] trim label
    available: np.ndarray  # [n] bool (pick state)


def _longest_run(passing: np.ndarray) -> Tuple[int, int]:
    """First longest run of True.  ref: trimReadByMinimumKmerScore loop —
    a new best requires a strictly greater run score."""
    best_off = best_len = 0
    off = 0
    cur = 0
    for i in range(len(passing)):
        if passing[i]:
            cur += 1
        else:
            if cur > best_len:
                best_off, best_len = off, cur
            off = i + 1
            cur = 0
    if cur > best_len:
        best_off, best_len = off, cur
    return best_off, best_len


def _mean_var_count(vals: np.ndarray, poisson: bool = True):
    """ref: Statistics::MeanStdCount (src/Utils.h:997-1028).  NOTE the
    reference's 'stdDev' is the sample VARIANCE, floored at sqrt(mean)
    (bug-compatible)."""
    n = len(vals)
    mean = float(vals.sum())
    var = 0.0
    if n > 1:
        mean /= n
        var = float(((vals - mean) ** 2).sum()) / (n - 1)
    if poisson and mean > 0.0:
        var = max(var, float(np.sqrt(mean)))
    return mean, var, n


def find_bimodal_partition(num_sigmas: float, vals: np.ndarray):
    """ref: Statistics::findBimodalPartition (src/Utils.h:1031-1055).
    Returns (split_index or None, first_mean, second_mean)."""
    n = len(vals)
    best = None
    best_diff = 0.0
    fm = sm = 0.0
    for p in range(1, n):
        m1, v1, c1 = _mean_var_count(vals[:p])
        m2, v2, c2 = _mean_var_count(vals[p:])
        if c1 == 1 and c2 == 1:
            continue
        diff = abs(m1 - m2)
        sd = max(v1, v2)
        if diff > num_sigmas * sd and diff > best_diff:
            best_diff = diff
            best = p
            fm, sm = m1, m2
    return best, fm, sm


def _vectorized_runs(counts2d: np.ndarray, nk: np.ndarray, min_score: float):
    """First-longest-run per row, vectorized over reads.

    counts2d: [R, NW] padded counts; nk: [R] valid kmers per row.
    Returns (off [R], length [R]) in kmer units."""
    R, NW = counts2d.shape
    col = np.arange(NW)[None, :]
    passing = (counts2d >= min_score) & (col < nk[:, None])
    run = np.zeros((R, NW), dtype=np.int64)
    prev = np.zeros(R, dtype=np.int64)
    for j in range(NW):
        prev = np.where(passing[:, j], prev + 1, 0)
        run[:, j] = prev
    best_len = run.max(axis=1)
    # first occurrence of the max = end of the FIRST longest run (strict-
    # greater replacement in the reference keeps the first)
    best_end = np.argmax(run, axis=1)
    best_off = best_end - best_len + 1
    best_off = np.where(best_len > 0, best_off, 0)
    return best_off, best_len


def _vectorized_scores(counts2d, off, length, scoring_type):
    """Per-row score over [off, off+length) (scoring types, vectorized)."""
    R, NW = counts2d.shape
    col = np.arange(NW)[None, :]
    in_run = (col >= off[:, None]) & (col < (off + length)[:, None])
    vals = counts2d.astype(np.float64)
    if scoring_type == "MEDIAN":
        tmp = np.where(in_run, vals, np.inf)
        tmp = np.sort(tmp, axis=1)
        idx = np.minimum(length // 2, NW - 1)
        sc = tmp[np.arange(R), idx]
    elif scoring_type == "AVG":
        cnt = np.maximum(length, 1)
        sc = np.where(in_run, vals, 0.0).sum(axis=1) / cnt
    elif scoring_type == "MIN":
        sc = np.where(in_run, vals, np.inf).min(axis=1)
    elif scoring_type == "MAX":
        sc = np.where(in_run, vals, -np.inf).max(axis=1)
    else:  # SUM — run length (bug-compatible)
        sc = length.astype(np.float64)
    return np.where(length > 0, sc, -1.0)


def score_and_trim(rs: ReadSet, window_counts: np.ndarray,
                   window_offsets: np.ndarray, k: int,
                   min_kmer_score: float, scoring_type: str = "MAX",
                   markup_first: Optional[np.ndarray] = None,
                   bimodal_sigmas: float = -1.0) -> ReadTrims:
    """Dispatch: vectorized path for large read sets (no bimodal), scalar
    reference transcription otherwise."""
    if rs.n > 20000 and bimodal_sigmas < 0.0:
        return _score_and_trim_vectorized(rs, window_counts, window_offsets,
                                          k, min_kmer_score, scoring_type,
                                          markup_first)
    return _score_and_trim_scalar(rs, window_counts, window_offsets, k,
                                  min_kmer_score, scoring_type, markup_first,
                                  bimodal_sigmas)


def _score_and_trim_vectorized(rs: ReadSet, window_counts: np.ndarray,
                               window_offsets: np.ndarray, k: int,
                               min_kmer_score: float, scoring_type: str,
                               markup_first: Optional[np.ndarray]) -> ReadTrims:
    n = rs.n
    lens = rs.lengths()
    nw = (window_offsets[1:] - window_offsets[:-1]).astype(np.int64)
    nk = nw.copy()
    if markup_first is not None:
        mk = markup_first.astype(np.int64)
        nk = np.where(mk != 0, np.where(mk > k, mk - k, 0), nk)
    nk = np.where(rs.discarded, 0, nk)
    from kmernator_tpu_torch.io.native import score_trim
    native = score_trim(window_counts, window_offsets, nk, min_kmer_score,
                        scoring_type)
    if native is not None:
        off, length, sc = native
    else:
        NW = int(nw.max()) if n else 0
        counts2d = np.zeros((n, NW), dtype=np.int64)
        if n and NW:
            rows = np.repeat(np.arange(n), nw)
            cols = (np.arange(int(nw.sum()))
                    - np.repeat(window_offsets[:-1].astype(np.int64), nw))
            counts2d[rows, cols] = window_counts
        off, length = _vectorized_runs(counts2d, nk, min_kmer_score)
        sc = _vectorized_scores(counts2d, off, length, scoring_type)
    was_trimmed = length < nk
    t_len = np.where(length > 0, length + k - 1, 0)
    t_off = np.where(length > 0, off, 0)
    sc = np.where(length > 0, sc, -1.0)
    slabel = SCORING_LABELS[scoring_type]
    int_sc = (sc + 0.5).astype(np.int64)  # C-truncation matches for sc >= -1
    disc = rs.discarded
    t_off = np.where(disc, 0, t_off)
    t_len = np.where(disc, 0, t_len)
    sc = np.where(disc, 0.0, sc)
    from kmernator_tpu_torch.io.native import render_labels
    labels = render_labels(t_off, t_len, int_sc, was_trimmed, disc,
                           slabel + b":")
    if labels is None:
        labels = [b""] * n
        for i in range(n):
            if disc[i]:
                continue
            if was_trimmed[i]:
                labels[i] = b"Trim:%d+%d %s:%d" % (t_off[i], t_len[i],
                                                   slabel, int_sc[i])
            else:
                labels[i] = b"%s:%d" % (slabel, int_sc[i])
    return ReadTrims(t_off, t_len, sc, labels, np.ones(n, dtype=bool))


def _score_and_trim_scalar(rs: ReadSet, window_counts: np.ndarray,
                           window_offsets: np.ndarray, k: int,
                           min_kmer_score: float, scoring_type: str = "MAX",
                           markup_first: Optional[np.ndarray] = None,
                           bimodal_sigmas: float = -1.0) -> ReadTrims:
    """ref: ReadSelector::scoreAndTrimReads (src/ReadSelector.h:1182-1209).

    window_counts:  concatenated per-read per-window spectrum counts
    window_offsets: [n+1] boundaries into window_counts (reads shorter than k
                    have zero windows)
    markup_first:   [n] 1-based position of first N/X markup (0 = none),
                    ref: TwoBitSequence::firstMarkupNorX
    """
    n = rs.n
    lens = rs.lengths()
    off = np.zeros(n, dtype=np.int64)
    tlen = np.zeros(n, dtype=np.int64)
    score = np.zeros(n, dtype=np.float64)
    labels: List[bytes] = [b""] * n
    slabel = SCORING_LABELS[scoring_type]

    for i in range(n):
        if rs.discarded[i]:
            continue
        s, e = window_offsets[i], window_offsets[i + 1]
        counts = window_counts[s:e]
        num_kmers = len(counts)
        # markup truncation (ref: _setNumKmers :1037-1047)
        if markup_first is not None and markup_first[i] != 0:
            max_trim = int(markup_first[i])
            num_kmers = max_trim - k if max_trim > k else 0
        counts = counts[:num_kmers]
        passing = counts >= min_kmer_score
        b_off, b_len = _longest_run(passing)
        was_trimmed = b_len < num_kmers

        bimodal_label = b""
        if b_len >= 3 and bimodal_sigmas >= 0.0:
            # ref: trimReadByMinimumKmerScore bimodal branch (:981-1008)
            vals = counts[b_off:b_off + b_len].astype(np.float64)
            p, fm, sm = find_bimodal_partition(bimodal_sigmas, vals)
            if p is not None:
                lab = b"Bimodal@%d:%d/%d" % (p + k, int(fm), int(sm))
                if fm > sm:
                    b_len -= (b_len - p)
                    bimodal_label = lab
                else:
                    b_len -= p
                    b_off += p
                    bimodal_label = b"Inv" + lab

        if b_len > 0:
            vals = counts[b_off:b_off + b_len].astype(np.float64)
            if scoring_type == "MEDIAN":
                sc = float(np.sort(vals)[len(vals) // 2])
            elif scoring_type == "AVG":
                sc = float(vals.sum() / max(len(vals), 1))
            elif scoring_type == "MIN":
                sc = float(vals.min())
            elif scoring_type == "MAX":
                sc = float(vals.max())
            else:  # SUM — run length (bug-compatible, see module docstring)
                sc = float(b_len)
        else:
            sc = -1.0

        # setTrimHeaders (ref: :1015-1035)
        t_off, t_len = b_off, b_len
        if t_len > 0:
            t_len += k - 1
        else:
            t_off = 0
            sc = -1.0
        lab = bimodal_label
        if was_trimmed:
            if lab:
                lab += b" "
            lab += b"Trim:%d+%d" % (t_off, t_len)
        if was_trimmed or lab:
            lab += b" "
        lab += slabel + b":%d" % int(sc + 0.5)
        off[i], tlen[i], score[i] = t_off, t_len, sc
        labels[i] = lab

    return ReadTrims(off, tlen, score, labels,
                     np.ones(n, dtype=bool))


def is_passing(rs: ReadSet, trims: ReadTrims, i: int,
               min_score: float, min_length: float) -> bool:
    """ref: isPassingRead (src/ReadSelector.h:550-557)."""
    if i < 0 or i >= rs.n:
        return False
    return bool(trims.available[i] and trims.score[i] >= min_score and
                passes_length(float(trims.length[i]), int(rs.lengths()[i]), min_length))


def passing_mask(rs: ReadSet, trims: ReadTrims, min_score: float,
                 min_length: float) -> np.ndarray:
    """Vectorized isPassingRead over all reads
    (ref: src/ReadSelector.h:550-557)."""
    tl = trims.length.astype(np.float64)
    ok = trims.available & (trims.score >= min_score) & (tl > 1.0)
    if min_length <= 1.0:
        return ok & (rs.lengths() * min_length <= tl)
    return ok & (min_length <= tl)


def pick_all_passing(rs: ReadSet, trims: ReadTrims, min_score: float,
                     min_length: float, both_pass: bool) -> List[int]:
    """pickAllPassingPairs / pickAllPassingReads
    (ref: src/ReadSelector.h:576-596).  Returns picked read indices sorted
    ascending (optimizePickOrder sorts picks, :1212-1221)."""
    mask = passing_mask(rs, trims, min_score, min_length)
    if rs.has_pairs():
        pm = np.asarray(rs.pairs, dtype=np.int64).reshape(-1, 2)
        valid = (pm >= 0) & (pm < rs.n)
        p = np.zeros(pm.shape, dtype=bool)
        p[valid] = mask[pm[valid]]
        need_both = valid[:, 0] & valid[:, 1] & both_pass
        ok = np.where(need_both, p[:, 0] & p[:, 1], p[:, 0] | p[:, 1])
        # both members of a passing pair are picked if merely valid+available
        cand = pm[ok]
        cand = cand[(cand >= 0) & (cand < rs.n)]
        picks = np.unique(cand[trims.available[cand]])
    else:
        picks = np.flatnonzero(mask)
    trims.available[picks] = False
    return picks.astype(np.int64)  # ascending (unique/flatnonzero sort)
