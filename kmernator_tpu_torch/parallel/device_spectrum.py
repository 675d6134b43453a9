"""Canonical window extraction and batch counting in PyTorch.

Twins of kmernator_tpu/parallel/device_spectrum.py: `extract_canonical_cols`
(with `_shift_left_cols`) and `count_batch`, plus copies of the numpy-only
host helpers `pack_readset`, `ragged_to_padded` and `padded_to_ragged`
(copied, not imported: the JAX module imports jax). Words are int64 in
[0, 2^32) (ops/kmer.py); `count_batch` sorts the int64 key lanes (one
lane for k <= 32, with the merge-path sort kernels (parallel/merge_sort.py)
where `_use_merge_sort` says so and with torch.sort otherwise; L > 1 lanes
lexicographically with `sort_lanes`), and takes its run totals from the
run-length kernel (parallel/run_length.py).
"""
from __future__ import annotations

import os
from typing import List, Sequence, Union

import numpy as np
import torch

from kmernator_tpu_torch.io.reads import BASE_CODE
from kmernator_tpu_torch.ops.kmer import (MASK32, SENTINEL_LANE,
                                          SENTINEL_WORD, decode_lanes,
                                          encode_lanes, last_word_mask,
                                          nwords, pack16_torch,
                                          reverse_bases)
from kmernator_tpu_torch.ops.weights import probability_table
from kmernator_tpu_torch.parallel.merge_sort import merge_sort_lanes
from kmernator_tpu_torch.parallel.run_length import run_length_sums

# device batch of the non-TPU default (kmernator_tpu device_spectrum
# auto_mesh_batch); no measurement on the card has chosen another yet
DEFAULT_BATCH_READS = 2048


def _use_merge_sort(N: int, W: int, device: torch.device) -> bool:
    """Route count_batch's sort through the merge-path sort kernels
    (parallel/merge_sort.py): the JAX package's gate (its
    device_spectrum.py `_use_merge_sort`) with a CUDA tensor standing where
    its TPU backend stands. 2-word keys, N >= 2^20 and KMTPU_MERGE_SORT in
    ("1", "on", "true"); off by default, and off on the CPU, as the JAX
    gate is off its TPU."""
    if W != 2 or N < (1 << 20):
        return False
    if os.environ.get("KMTPU_MERGE_SORT", "0") not in ("1", "on", "true"):
        return False
    return torch.device(device).type == "cuda"


# --------------------------------------------------------------------------
# host helpers (numpy only)
# --------------------------------------------------------------------------

def pack_readset(rs, L: int, min_quality: int, output_base: int):
    """ReadSet -> (codes [B, L] uint8, logp [B, L] f32, lengths [B] i32).

    logp is log2(P(correct)) with -inf (here: -1e30) for zero-probability
    bases; markup positions also get -inf so windows covering them weigh 0.
    """
    B = rs.n
    codes = np.zeros((B, L), dtype=np.uint8)
    logp = np.full((B, L), np.float32(-1e30), dtype=np.float32)
    lengths = rs.lengths().astype(np.int32)
    tab = probability_table(min_quality, output_base)
    with np.errstate(divide="ignore"):
        ltab = np.where(tab > 0, np.log2(tab, where=tab > 0),
                        -1e30).astype(np.float32)
    ph = rs.phred()
    hq = np.repeat(rs.has_quals, rs.lengths())
    ch = np.clip(ph + output_base, 0, 255)
    lp_flat = np.where(hq, ltab[ch], np.float32(0.0)).astype(np.float32)
    c_raw = BASE_CODE[rs.seq]
    markup = c_raw == 4
    c_flat = np.where(markup, 0, c_raw).astype(np.uint8)
    lp_flat = np.where(markup, np.float32(-1e30), lp_flat)
    dis = np.repeat(rs.discarded, rs.lengths())
    lp_flat = np.where(dis, np.float32(-1e30), lp_flat)
    lens = np.diff(rs.offsets)
    rows = np.repeat(np.arange(B), lens)
    cols = np.arange(int(rs.offsets[-1])) - np.repeat(rs.offsets[:-1], lens)
    codes[rows, cols] = c_flat
    logp[rows, cols] = lp_flat
    return codes, logp, lengths


def ragged_to_padded(flat: np.ndarray, nw: np.ndarray, width: int,
                     fill=0) -> np.ndarray:
    """Scatter ragged per-read values (read i owns flat[woff[i]:woff[i] +
    nw[i]]) into a padded [B, width] matrix."""
    B = len(nw)
    out = np.full((B, width), fill, dtype=flat.dtype)
    rows = np.repeat(np.arange(B), nw)
    cols = np.arange(int(nw.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(nw)[:-1]]), nw)
    out[rows, cols] = flat
    return out


def padded_to_ragged(padded: np.ndarray, nw: np.ndarray) -> np.ndarray:
    """Inverse of ragged_to_padded: the first nw[i] entries of each row,
    flattened."""
    rows = np.repeat(np.arange(len(nw)), nw)
    cols = np.arange(int(nw.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(nw)[:-1]]), nw)
    return padded[rows, cols]


# --------------------------------------------------------------------------
# device steps
# --------------------------------------------------------------------------

def _shift_left_cols(cols: List[torch.Tensor], s_bases: int):
    """Shift a big-endian list of word columns left by s_bases bases,
    zero-filling from the right."""
    Wn = len(cols)
    word_shift, bit = divmod(s_bases, 16)
    z = torch.zeros_like(cols[0])
    if word_shift:
        cols = list(cols[word_shift:]) + [z] * word_shift
    if bit:
        cols = [((cols[i] << (2 * bit)) & MASK32)
                | ((cols[i + 1] if i + 1 < Wn else z) >> (32 - 2 * bit))
                for i in range(Wn)]
    return cols


def extract_canonical_cols(codes: torch.Tensor, lengths: torch.Tensor,
                           k: int):
    """codes [B, L] (0..3), lengths [B] -> (canon: W [B, NW] int64 word
    columns, sentinel words at invalid windows; fwd_le [B, NW] bool; valid
    [B, NW] bool). Bit-equal to the JAX extract_canonical_cols."""
    B, L = codes.shape
    W = nwords(k)
    NW = L - k + 1
    p16 = pack16_torch(codes)
    fwd = []
    for w in range(W):
        start = 16 * w
        if start + NW <= L:
            fwd.append(p16[:, start:start + NW])
        else:
            pad = torch.zeros((B, start + NW - L), dtype=torch.int64,
                              device=codes.device)
            fwd.append(torch.cat([p16[:, start:], pad], dim=1))
    mask = last_word_mask(k)
    fwd[W - 1] = fwd[W - 1] & mask
    rc = [reverse_bases((~fwd[w]) & MASK32) for w in range(W - 1, -1, -1)]
    rc = _shift_left_cols(rc, 16 * W - k)
    rc[W - 1] = rc[W - 1] & mask
    lt = rc[W - 1] < fwd[W - 1]
    for w in range(W - 2, -1, -1):
        lt = torch.where(rc[w] == fwd[w], lt, rc[w] < fwd[w])
    fwd_le = ~lt
    pos = torch.arange(NW, dtype=torch.int32, device=codes.device)[None, :]
    valid = pos <= (lengths.to(torch.int32)[:, None] - k)
    sent = torch.full((), SENTINEL_WORD, dtype=torch.int64,
                      device=codes.device)
    canon = [torch.where(valid, torch.where(fwd_le, fwd[w], rc[w]), sent)
             for w in range(W)]
    return canon, fwd_le, valid


def sort_lanes(lanes: List[torch.Tensor]):
    """Sort keys of L int64 lanes lexicographically -> (sorted lanes,
    permutation). One lane: one torch.sort. L > 1: L stable torch.sort
    passes from the last lane to the first, each over the lane gathered by
    the permutation so far. Equal keys may come in any order for L = 1 (as
    the JAX package's unstable lax.sort); for L > 1 they keep input order."""
    if len(lanes) == 1:
        s, perm = torch.sort(lanes[0])
        return [s], perm
    perm = torch.sort(lanes[-1], stable=True).indices
    for lane in lanes[-2::-1]:
        perm = perm[torch.sort(lane[perm], stable=True).indices]
    return [lane[perm] for lane in lanes], perm


def search_lanes(table: List[torch.Tensor], queries: List[torch.Tensor],
                 right: bool) -> torch.Tensor:
    """Insertion points of the queries in a table sorted lexicographically
    over L int64 lanes: the first row not below (right=False) or above
    (right=True) each query, in [0, C]. One lane: torch.searchsorted. L > 1:
    the JAX package's lexicographic binary search (its dist_match `search`
    and mesh_stream lookup), ceil(log2 C) + 1 probes. An empty table puts
    every query at 0."""
    C = table[0].numel()
    if C == 0:
        return torch.zeros_like(queries[0])
    if len(table) == 1:
        return torch.searchsorted(table[0], queries[0], right=right)
    lo = torch.zeros_like(queries[0])
    hi = torch.full_like(queries[0], C)
    for _ in range(int(np.ceil(np.log2(max(C, 2)))) + 1):
        mid = (lo + hi) // 2
        cmid = mid.clamp(0, C - 1)
        less = torch.zeros_like(queries[0], dtype=torch.bool)
        eq = torch.ones_like(less)
        for t, q in zip(table, queries):
            mk = t[cmid]
            less |= eq & (mk < q)
            eq &= mk == q
        go_right = (less | eq) if right else less
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    # a probe past convergence at lo = hi = C compares row C - 1 again and
    # can step to C + 1 (the JAX search's tables end in sentinel rows)
    return lo.clamp_(max=C)


def is_sentinel(lanes: List[torch.Tensor]) -> torch.Tensor:
    """[N] bool: the key is the all-ones sentinel (every lane INT64_MAX)."""
    sent = lanes[0] == SENTINEL_LANE
    for lane in lanes[1:]:
        sent &= lane == SENTINEL_LANE
    return sent


def count_batch(keys: Union[torch.Tensor, Sequence[torch.Tensor]],
                good: torch.Tensor, min_count: int = 1):
    """Spectrum-build-only counting of one batch (the JAX count_batch).

    keys: [N, W] int64 words OR a list of W [N] int64 word columns; good
    [N] bool. Returns (sorted keys [N, W] int64 words, sentinel where not
    kept; counts [N] int32, > 0 only at run starts; n_unique at or above
    min_count), bit-equal to the JAX function."""
    if isinstance(keys, (list, tuple)):
        cols = list(keys)
    else:
        cols = [keys[:, w] for w in range(keys.shape[1])]
    W = len(cols)
    N = cols[0].shape[0]
    sent = torch.full((), SENTINEL_LANE, dtype=torch.int64,
                      device=cols[0].device)
    # pre-mask bad windows to the sentinel so only good observations count
    lanes = [torch.where(good, lane, sent) for lane in encode_lanes(cols)]
    if len(lanes) > 1:
        s = sort_lanes(lanes)[0]
    elif _use_merge_sort(N, W, good.device):
        s = [merge_sort_lanes(lanes[0])]
    else:
        s = [torch.sort(lanes[0]).values]
    # every row counts 1, so each run total is the run's length, at its end
    ends_total = run_length_sums(
        s, torch.ones(N, dtype=torch.int32, device=good.device))
    ends = torch.nonzero(ends_total > 0).squeeze(1)
    starts = torch.zeros_like(ends)
    starts[1:] = ends[:-1] + 1
    cnt = torch.zeros(N, dtype=torch.int32, device=good.device)
    cnt[starts] = ends_total[ends]
    table_counts = torch.where(~is_sentinel(s) & (cnt >= min_count), cnt,
                               torch.zeros_like(cnt))
    keep = table_counts > 0
    out_keys = torch.stack(decode_lanes(
        [torch.where(keep, lane, sent) for lane in s], W), dim=-1)
    return out_keys, table_counts, keep.sum()
