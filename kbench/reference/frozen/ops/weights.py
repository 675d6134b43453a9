"""Frozen for the benchmark's plain reference from kmernator_tpu_torch/ops/weights.py.

Quality-weighted k-mer window weights.

Replicates KmerReadUtils::buildWeightedKmers bit-for-bit
(ref: src/KmerReadUtils.h:176-248): the weight of window i is the running
double-precision product of per-base P(correct) over the k-window, updated
incrementally as weight *= p[i+k-1]/p[i-1], with a full (sequential)
re-computation whenever i % 1024 == 0 or the previous weight was exactly 0.0,
and zeroed when the window covers a markup position.

The recurrence is order-dependent in floating point, so we reproduce the
exact operation order using per-run cumulative products (np.cumprod is
sequential left-to-right, matching the reference's loop).  The spectrum
discard test then compares the float32 cast of the weight against the
float32 minimum (ref: TrackingData::isDiscard, src/KmerTrackingData.h:353
with WeightType = float).
"""
from __future__ import annotations

import numpy as np


def window_weights(p: np.ndarray, offsets: np.ndarray, markup: np.ndarray,
                   k: int) -> np.ndarray:
    """Exact per-window weights for ragged reads.

    p:       [total_bases] float64 per-base P(correct) (0.0 for quality < min)
    offsets: [n+1] read boundaries into p
    markup:  [total_bases] bool, True where the base is a markup (non-ACGT)
    Returns [N] float64 weights for all windows (reads < k contribute none),
    ordered (read-major, position-minor).
    """
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    nw = np.maximum(lens - k + 1, 0)
    N = int(nw.sum())
    if N == 0:
        return np.zeros(0, dtype=np.float64)

    read_id = np.repeat(np.arange(len(lens)), nw)
    first_w = np.concatenate([[0], np.cumsum(nw)[:-1]])
    pos = np.arange(N) - first_w[read_id]
    base0 = offsets[:-1][read_id] + pos  # flat index of window start

    # window-level masks via prefix sums within the flat arrays (windows never
    # cross read boundaries so flat prefix sums are safe)
    zcum = np.concatenate([[0], np.cumsum(p == 0.0)])
    mcum = np.concatenate([[0], np.cumsum(markup.astype(np.int64))])
    zero_w = (zcum[base0 + k] - zcum[base0]) > 0
    mark_w = (mcum[base0 + k] - mcum[base0]) > 0
    bad = zero_w | mark_w

    # recompute points: window 0 of each read, pos % 1024 == 0, or previous
    # window bad (weight was exactly 0.0)
    prev_bad = np.concatenate([[False], bad[:-1]])
    recompute = (pos % 1024 == 0) | (pos == 0) | (prev_bad & (pos > 0))

    run_id = np.cumsum(recompute) - 1          # [N]
    n_runs = int(run_id[-1]) + 1
    run_start = np.flatnonzero(recompute)      # [n_runs] window indices
    run_len = np.diff(np.concatenate([run_start, [N]]))

    # seeds: sequential product p[s]*p[s+1]*...*p[s+k-1] per run
    seeds = np.ones(n_runs, dtype=np.float64)
    sbase = base0[run_start]
    for j in range(k):
        seeds = seeds * p[sbase + j]

    # ratios for incremental windows
    ratios = np.ones(N, dtype=np.float64)
    inc = ~recompute
    ratios[inc] = p[base0[inc] + k - 1] / p[base0[inc] - 1]
    ratios[recompute] = seeds

    # grouped sequential cumprod: scatter runs into a [rows, runlen] matrix.
    # Done in bounded row blocks — bad windows fragment the runs, so n_runs
    # can approach N and a single dense [n_runs, maxlen] matrix reaches GBs
    # (measured 2.2 GB transient on an 8 MB read chunk on the JAX
    # package's development host, a CPU machine, not the H100's host);
    # blocking caps the
    # transient at ~32 MB with identical fp operation order.
    maxlen = int(run_len.max())
    col = np.arange(N) - run_start[run_id]
    w = np.empty(N, dtype=np.float64)
    rows_per = max(1, (2 << 20) // max(maxlen, 1))
    for r0 in range(0, n_runs, rows_per):
        r1 = min(r0 + rows_per, n_runs)
        i0 = int(run_start[r0])
        i1 = int(run_start[r1]) if r1 < n_runs else N
        ml = int(run_len[r0:r1].max())
        mat = np.ones((r1 - r0, ml), dtype=np.float64)
        mat[run_id[i0:i1] - r0, col[i0:i1]] = ratios[i0:i1]
        mat = np.cumprod(mat, axis=1)
        w[i0:i1] = mat[run_id[i0:i1] - r0, col[i0:i1]]

    w[mark_w] = 0.0
    return w


def good_kmer_mask(w: np.ndarray, min_weight: float) -> np.ndarray:
    """TrackingData::isDiscard in float32: keep iff (float)w > (float)min.
    ref: src/KmerTrackingData.h:353-364; append() casts the double weight to
    the float WeightType parameter (ref: src/KmerSpectrum.h:1578)."""
    return w.astype(np.float32) > np.float32(min_weight)


_PROB_TABLES = {}


def probability_table(min_quality: int, output_base: int) -> np.ndarray:
    """The 256-entry qualityToProbability table, built with scalar libm pow to
    match the reference bit-for-bit (ref: src/Sequence.cpp:522-540):
    table[ch] = 0 for ch < base+minQ, 1 - 10^((base-ch)/10) for ch in
    [base+minQ, 103), 1.0 for ch >= 103."""
    key = (min_quality, output_base)
    tab = _PROB_TABLES.get(key)
    if tab is None:
        tab = np.zeros(256, dtype=np.float64)
        for ch in range(output_base + min_quality, 103):
            tab[ch] = 1.0 - 10.0 ** ((output_base - ch) / 10.0)
        tab[103:] = 1.0
        _PROB_TABLES[key] = tab
    return tab


_PHRED_TABLES = {}


def phred_probability(phred: np.ndarray, min_quality: int, output_base: int) -> np.ndarray:
    """qualityToProbability by integer phred (ref: src/Sequence.cpp:522-540).
    char = phred + output_base; p = 0 below output_base+minQ, 1.0 at or above
    PRINT_REF_QUAL (103), else 1 - 10^(-phred/10).

    The table is pre-shifted by output_base so a u8 phred array gathers
    directly (no i64 promotion / clip temps — this runs over every base of
    every chunk in the streaming engine)."""
    key = (min_quality, output_base)
    tab_q = _PHRED_TABLES.get(key)
    if tab_q is None:
        tab = probability_table(min_quality, output_base)
        idx = np.minimum(np.arange(256, dtype=np.int64) + output_base, 255)
        tab_q = tab[idx]
        _PHRED_TABLES[key] = tab_q
    phred = np.asarray(phred)
    # clip-mode take == the original clip(phred+base, 0, 255) gather:
    # negative phred clips to tab_q[0] = tab[output_base] = 0.0 (ch <
    # base+minQ or the 1-10^0 boundary), oversized clips to tab_q[255] =
    # tab[255], exactly where ch would clip to
    return tab_q.take(phred, mode="clip")
