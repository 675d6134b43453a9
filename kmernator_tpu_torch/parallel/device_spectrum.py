"""Canonical window extraction, window weights and counting in PyTorch.

Twin of kmernator_tpu/parallel/device_spectrum.py, all of it: the batch
sizes (`pow2_aligned_batch`, `auto_mesh_batch`), window extraction
(`extract_canonical_cols` with `_shift_left_cols`, and its stacked form
`extract_canonical`), `window_good`, `count_and_score`, `count_batch`,
`compact_spectrum`, `merge_tables`, `spectrum_step` and `lookup_join`,
the KMTPU_SORT1 experiment's sort `_sort2_via_1key` (its gate has no
twin: see the function), plus copies of the
numpy-only host helpers `pack_readset`, `ragged_to_padded` and
`padded_to_ragged` (copied, not imported: the JAX module imports jax).

Words are int64 in [0, 2^32) (ops/kmer.py). Every sort is over the int64
key lanes (`encode_lanes`: one lane for k <= 32, sorted by torch.sort or,
in `count_batch` where `_use_merge_sort` says so, by the merge-path sort
kernels (parallel/merge_sort.py); L > 1 lanes lexicographically with
`sort_lanes`), and every run total comes from the run-length kernel
(parallel/run_length.py). Where the JAX functions re-sort a run-length
table so that its unique rows lead, the port compacts the rows it keeps,
which are already in key order: the same table without the second sort.

Two JAX faults are not copied (ROADMAP queue 3, items o and p):
- `window_good` leaves zero-probability bases out of the weight prefix
  and counts them apart, so that a window after such a base weighs its
  own bases; the JAX f32 prefix is absorbed by the -1e30 and every later
  window weighs exactly 0.
- `compact_spectrum` reads `seg_counts` at each run's first row, as
  `count_and_score` lays it out (one total a row); the JAX one reads it
  at the run's index and miscounts that state.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Union

import numpy as np
import torch

from kmernator_tpu_torch.io.reads import BASE_CODE
from kmernator_tpu_torch.ops.kmer import (MASK32, SENTINEL_LANE,
                                          SENTINEL_WORD, decode_lanes,
                                          encode_lanes,
                                          last_word_mask,
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
# batch sizes
# --------------------------------------------------------------------------

def pow2_aligned_batch(L: int, k: int, target_reads: int) -> int:
    """Largest batch <= target_reads whose window count B * (L - k + 1)
    sits just under a power of two (a copy of the JAX function, which XLA's
    power-of-two padding of a sort's rows motivates)."""
    nw = max(L - k + 1, 1)
    m = 1
    while (2 * m) // nw <= target_reads and m < (1 << 40):
        m *= 2
    return max(m // nw, 1)


def auto_mesh_batch(L: int, k: int, default: int = DEFAULT_BATCH_READS) -> int:
    """The device batch of the streaming and mesh pipelines, in reads:
    KMTPU_MESH_BATCH when it is set, else `default`. This is the JAX
    function's answer off a TPU. On a directly attached TPU it takes
    `pow2_aligned_batch`, because XLA pads a sort's rows to a power of two
    and aligned batches measured faster there, and behind the TPU's remote
    relay (found from the PJRT platform_version) the default again.
    torch.sort pads nothing, and the card is attached directly, so neither
    branch has a counterpart here; no measurement on the card has chosen
    another default yet."""
    env = os.environ.get("KMTPU_MESH_BATCH", "")
    if env:
        return int(env)
    return default


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


def extract_canonical(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """codes [B, L] (0..3), lengths [B] -> (canon [B, NW, W] int64 words,
    the sentinel word at invalid windows; fwd_le [B, NW] bool; valid [B, NW]
    bool): the stacked form of extract_canonical_cols, bit-equal to the JAX
    extract_canonical."""
    cols, fwd_le, valid = extract_canonical_cols(codes, lengths, k)
    return torch.stack(cols, dim=-1), fwd_le, valid


# logp at or below this is a base of probability 0 (pack_readset and the
# streams give such bases -1e30)
ZERO_PROBABILITY = -1e29


def window_good(logp: torch.Tensor, lengths: torch.Tensor, k: int,
                log2_min_weight: float):
    """Window weights (log2) and the goodness test: logp [B, L] float32
    log2-probabilities, lengths [B] -> (wsum [B, NW] float32, good [B, NW]
    bool, wsum > log2_min_weight (as float32) on valid windows).

    A window covering a zero-probability base (logp <= -1e29) is bad, with
    wsum = -1e30 times the number of such bases it covers, counted by an
    int32 prefix. Any other window's wsum is the sum of its own bases: a
    float64 prefix over the row with the zero-probability bases set to 0
    (torch.cumsum: in order on the CPU, a parallel scan on the card), the
    window's difference rounded to float32 once. Either prefix lies within
    L * 2^-52 * M of the exact sums (M: the row's largest |prefix|), so
    the card and the CPU give the same float32 wsum but next to a rounding
    tie, and the same good mask but for a window next to the threshold.

    The JAX function differences a float32 prefix (XLA's reduce_window, in
    its own order) over the raw logp. Where that prefix is not absorbed by
    a -1e30 (windows before a row's first zero-probability base, and
    windows covering one) the two agree to 4 * L * 2^-24 * M
    (`window_good_bound`): each JAX prefix entry, a float32 sum of at most
    L terms of one sign, lies within L * 2^-24 * M of the exact sum; the
    difference of two entries and the roundings of both results add at
    most 2 * 2^-24 * M. After a row's first zero-probability base the JAX
    prefix is -1e30 or less, a window there weighs exactly 0, and
    0 > log2_min_weight passes it: ROADMAP queue 3, item o."""
    B, L = logp.shape
    NW = L - k + 1
    dev = logp.device
    lp = logp.to(torch.float32)
    zero = lp <= ZERO_PROBABILITY
    cs = torch.zeros((B, L + 1), dtype=torch.float64, device=dev)
    cs[:, 1:] = torch.cumsum(torch.where(zero, 0.0, lp), 1,
                             dtype=torch.float64)
    nz = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)
    nz[:, 1:] = torch.cumsum(zero, 1, dtype=torch.int32)
    covered = nz[:, k:] - nz[:, :-k]
    wsum = torch.where(covered > 0, covered.to(torch.float32) * -1e30,
                       (cs[:, k:] - cs[:, :-k]).to(torch.float32))
    pos = torch.arange(NW, dtype=torch.int32, device=dev)[None, :]
    valid = pos <= (lengths.to(torch.int32)[:, None] - k)
    # the threshold as float32 (the JAX one), compared exactly
    good = (wsum > float(np.float32(log2_min_weight))) & valid
    return wsum, good


def window_good_bound(logp: torch.Tensor) -> torch.Tensor:
    """[B] float64: the bound window_good keeps against the JAX function
    on each row, 4 * L * 2^-24 times the row's largest |prefix| over its
    finite bases."""
    L = logp.shape[1]
    lp = logp.to(torch.float64)
    finite = torch.where(lp <= ZERO_PROBABILITY, 0.0, lp)
    return 4 * L * 2.0 ** -24 * torch.cumsum(finite, 1).abs().amax(1)


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


def run_bounds(lanes: List[torch.Tensor]):
    """(boundary, is_end) [N] bool for keys sorted over L int64 lanes: row
    i starts (ends) a run of equal keys."""
    n = lanes[0].numel()
    boundary = torch.ones(n, dtype=torch.bool, device=lanes[0].device)
    is_end = torch.ones_like(boundary)
    if n > 1:
        neq = lanes[0][1:] != lanes[0][:-1]
        for lane in lanes[1:]:
            neq |= lane[1:] != lane[:-1]
        boundary[1:] = neq
        is_end[:-1] = neq
    return boundary, is_end


def run_totals(lanes: List[torch.Tensor], vals: torch.Tensor):
    """For keys sorted over L int64 lanes and int32 values: (boundary [N]
    bool, seg [N] int32, the run index of each row, total [N] int32, the
    sum of vals over each row's run, wrapping at 32 bits as the JAX int32
    scans do). The sums come from the run-length kernel at the run ends
    and go to every row of their run through seg."""
    boundary, is_end = run_bounds(lanes)
    seg = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    ends = run_length_sums(lanes, vals.to(torch.int32))
    return boundary, seg, ends[is_end][seg.long()]


def _sort2_via_1key(hi: torch.Tensor, lo: torch.Tensor):
    """The KMTPU_SORT1 sort of 2-word keys (the JAX `_sort2_via_1key`):
    sort on the hi word alone, lo riding along, then odd-even transposition
    passes (even pairs, then odd pairs) over the rows of equal hi until no
    adjacent (hi == hi, lo > lo) pair is left. Returns [hi, lo], the 2-key
    sort's result.

    Nothing routes through it. The JAX gate in count_batch exists so that
    2-word u32 keys need not be sorted with two keys; the port sorts them
    as one int64 lane (`encode_lane`), so the gate could only give the same
    table more slowly (a host sync each pass, and a pass count that grows
    with the longest run of equal hi words). It is kept as a twin that the
    tests hold to the JAX function."""
    hi, perm = torch.sort(hi)
    lo = lo[perm]
    n1 = hi.numel() - 1
    if n1 <= 0:
        return [hi, lo]
    same = hi[:-1] == hi[1:]
    odd = (torch.arange(n1, device=hi.device) & 1).bool()
    while bool((same & (lo[:-1] > lo[1:])).any()):
        for parity in (~odd, odd):
            swap = parity & same & (lo[:-1] > lo[1:])
            nxt = lo.clone()
            nxt[:-1] = torch.where(swap, lo[1:], lo[:-1])
            nxt[1:] = torch.where(swap, lo[:-1], nxt[1:])
            lo = nxt
    return [hi, lo]


def count_and_score(canon: torch.Tensor, good: torch.Tensor, k: int,
                    min_count: int = 2):
    """Count the good observations of every canonical key and give each
    window its key's count (the JAX count_and_score). canon [B, NW, W]
    int64 words (the sentinel at padding windows), good [B, NW] bool.
    Returns (counts [B, NW] int32: the count of good windows with the
    window's key, whatever the window's own goodness, 0 below min_count
    and at sentinel windows; the sorted state (skeys [N, W] int64 words in
    key order, boundary [N] bool, seg [N] int32 = cumsum(boundary) - 1,
    seg_counts [N] int32: each row's run total)). skeys, boundary, seg and
    seg_counts are the JAX ones bit for bit; the row order within a run
    (the JAX `sidx`, not returned) is the sort's."""
    B, NW, W = canon.shape
    N = B * NW
    keys = canon.reshape(N, W)
    s, perm = sort_lanes(encode_lanes([keys[:, w] for w in range(W)]))
    boundary, seg, seg_counts = run_totals(s, good.reshape(N)[perm])
    scored = torch.where(is_sentinel(s) | (seg_counts < min_count),
                         torch.zeros_like(seg_counts), seg_counts)
    counts = torch.empty_like(scored)
    counts[perm] = scored
    skeys = torch.stack(decode_lanes(s, W), dim=-1)
    return counts.reshape(B, NW), (skeys, boundary, seg, seg_counts)


def _compact_rows(lanes: List[torch.Tensor], counts: torch.Tensor,
                  rows: torch.Tensor, W: int):
    """The kept rows (ascending, so in key order) first, then sentinel
    rows with count 0: ([N, W] int64 words, [N] counts)."""
    n = rows.numel()
    out = [torch.full_like(lane, SENTINEL_LANE) for lane in lanes]
    for o, lane in zip(out, lanes):
        o[:n] = lane[rows]
    out_counts = torch.zeros_like(counts)
    out_counts[:n] = counts[rows]
    return torch.stack(decode_lanes(out, W), dim=-1), out_counts


def compact_spectrum(skeys: torch.Tensor, boundary: torch.Tensor,
                     seg: torch.Tensor, seg_counts: torch.Tensor):
    """The sorted state of count_and_score -> (keys [N, W] int64 words:
    each run of a non-sentinel key with a count > 0, in key order, then
    the sentinel; counts [N] int32; n_unique). compact_spectrum(
    *count_and_score(...)[1]) is np.unique over the good windows' keys.

    It reads seg_counts at each run's first row, where count_and_score
    puts the run's total (one total a row). The JAX function reads
    seg_counts[seg]: it takes the run's index for a row index, and so the
    total of whatever run holds that row, which miscounts count_and_score's
    state (ROADMAP queue 3, item p); seg is not read here. Where the JAX
    one re-sorts, this compacts: the rows are in key order already."""
    W = skeys.shape[1]
    lanes = encode_lanes([skeys[:, w] for w in range(W)])
    keep = boundary & ~is_sentinel(lanes) & (seg_counts > 0)
    rows = torch.nonzero(keep).squeeze(1)
    out_keys, out_counts = _compact_rows(lanes, seg_counts, rows, W)
    return out_keys, out_counts, keep.sum()


def merge_tables(keys_a: torch.Tensor, counts_a: torch.Tensor,
                 keys_b: torch.Tensor, counts_b: torch.Tensor):
    """Merge two spectrum tables (the JAX merge_tables): keys [Na, W] and
    [Nb, W] int64 words (sentinel padded), int32 counts -> (keys [Na + Nb,
    W], counts [Na + Nb]): every non-sentinel key once, with the sum of
    its counts (wrapping at 32 bits, as the JAX int32 scan does), in key
    order, then sentinel rows with count 0. The run totals come from the
    run-length kernel; the JAX re-sort that puts the unique rows first is a
    compaction here."""
    keys = torch.cat([keys_a, keys_b])
    counts = torch.cat([counts_a, counts_b])
    W = keys.shape[1]
    s, perm = sort_lanes(encode_lanes([keys[:, w] for w in range(W)]))
    totals = run_length_sums(s, counts[perm].to(torch.int32))
    _, is_end = run_bounds(s)
    rows = torch.nonzero(is_end & ~is_sentinel(s)).squeeze(1)
    out_keys, out_counts = _compact_rows(s, totals, rows, W)
    return out_keys, out_counts.to(counts.dtype)


def spectrum_step(codes: torch.Tensor, logp: torch.Tensor,
                  lengths: torch.Tensor, k: int, min_count: int = 2,
                  log2_min_weight: float = -3.3219281):
    """The fused step of the JAX package's entry point: codes [B, L]
    (0..3), logp [B, L] float32, lengths [B] -> (counts [B, NW] int32,
    canon [B, NW, W] int64 words, good [B, NW] bool), through
    extract_canonical, window_good and count_and_score."""
    canon, _, _ = extract_canonical(codes, lengths, k)
    _, good = window_good(logp, lengths, k, log2_min_weight)
    counts, _ = count_and_score(canon, good, k, min_count)
    return counts, canon, good


def lookup_join(table_keys: torch.Tensor, table_counts: torch.Tensor,
                query_keys: torch.Tensor) -> torch.Tensor:
    """[Q] int32: the count of each query key in a table (0 for an absent
    key), the JAX sort-merge join's answers. table_keys [M, W] int64 words
    in key order (sentinel padded, as compact_spectrum and merge_tables
    return them), table_counts [M] int32, query_keys [Q, W]. Each query's
    rows are found by binary search (`search_lanes`) and their counts
    summed from an int64 prefix, wrapped to int32: the JAX join sums the
    same rows (every table row of the query's key) in an int32 prefix."""
    W = table_keys.shape[1]
    table = encode_lanes([table_keys[:, w] for w in range(W)])
    queries = encode_lanes([query_keys[:, w] for w in range(W)])
    lo = search_lanes(table, queries, right=False)
    hi = search_lanes(table, queries, right=True)
    cum = torch.zeros(table_counts.numel() + 1, dtype=torch.int64,
                      device=table_counts.device)
    cum[1:] = torch.cumsum(table_counts, 0, dtype=torch.int64)
    return (cum[hi] - cum[lo]).to(torch.int32)
