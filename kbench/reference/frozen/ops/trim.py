"""Frozen for the benchmark's plain reference from kmernator_tpu_torch/ops/trim.py
and cut to the NumPy paths the benchmark's configurations reach: single
reads, no bimodal split, the vectorized scoring at every read count.

Read scoring / trimming / selection (the ReadSelector semantics).

Re-implements ReadSelector<Map> (ref: src/ReadSelector.h:232-1263):
 - longest-run trim over per-window spectrum counts
   (trimReadByMinimumKmerScore :948-1014)
 - scoring types SUM/MEDIAN/AVG/MIN/MAX (:1088-1180; note SUM is
   bug-compatible with the reference: it leaves the run-length score)
 - trim headers "Trim:o+l" / "<Type>Score:n" (:1015-1035)
 - pickAllPassingReads (:576-596, isPassingRead :550-557)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from kbench.reference.frozen.io.reads import ReadSet

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
                   min_kmer_score: float, scoring_type: str,
                   markup_first: Optional[np.ndarray]) -> ReadTrims:
    """ref: ReadSelector::scoreAndTrimReads (src/ReadSelector.h:1182-1209).

    window_counts:  concatenated per-read per-window spectrum counts
    window_offsets: [n+1] boundaries into window_counts (reads shorter than k
                    have zero windows)
    markup_first:   [n] 1-based position of first N/X markup (0 = none),
                    ref: TwoBitSequence::firstMarkupNorX
    """
    n = rs.n
    nw = (window_offsets[1:] - window_offsets[:-1]).astype(np.int64)
    nk = nw.copy()
    if markup_first is not None:
        # markup truncation (ref: _setNumKmers :1037-1047)
        mk = markup_first.astype(np.int64)
        nk = np.where(mk != 0, np.where(mk > k, mk - k, 0), nk)
    nk = np.where(rs.discarded, 0, nk)
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
    labels = [b""] * n
    for i in range(n):
        if disc[i]:
            continue
        if was_trimmed[i]:
            labels[i] = b"Trim:%d+%d %s:%d" % (t_off[i], t_len[i],
                                               slabel, int_sc[i])
        else:
            labels[i] = b"%s:%d" % (slabel, int_sc[i])
    return ReadTrims(t_off, t_len, sc, labels)


def pick_all_passing(rs: ReadSet, trims: ReadTrims, min_score: float,
                     min_length: float, n_input: int) -> np.ndarray:
    """pickAllPassingPairs over single reads (ref: src/ReadSelector.h:
    576-596, isPassingRead :550-557): the passing reads' indices in
    ascending order (optimizePickOrder sorts picks, :1212-1221). Only the
    first `n_input` reads, those of the input, can be picked: the remnant
    reads the artifact filter appends join no pair entry, so they feed
    the spectrum only."""
    tl = trims.length.astype(np.float64)
    ok = (trims.score >= min_score) & (tl > 1.0)
    if min_length <= 1.0:
        ok &= rs.lengths() * min_length <= tl
    else:
        ok &= min_length <= tl
    return np.flatnonzero(ok[:n_input]).astype(np.int64)
