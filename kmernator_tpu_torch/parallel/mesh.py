"""The device mesh of the port, its shard exchange, and the spectra on it.

Twin of kmernator_tpu/parallel/mesh.py: `make_mesh`, the owner hash
(`owner_hash_cols`, `owner_hash`), the bucket scatter
(`bucket_scatter_cols`, the JAX `_bucket_scatter_cols`), the exchange that
stands for its all_to_all, the count of received rows
(`count_received_cols`, `count_received`), the three shard_map steps
(`distributed_spectrum_fn`, `distributed_count_fn`,
`distributed_extension_fn`, every shard in one process), and the
MeraculousCounter mesh path (`extension_spectrum_mesh`: the extension
step with the app's capacity retry; `window_extensions_device` and
`count_received_ext`, the JAX `_window_extensions_device` and
`_count_received_ext`).

`--mesh N` is one process with N shards. The JAX `make_mesh` takes the
first N of jax.devices() and, on a host with fewer, builds a smaller mesh
without a word, while its apps size each shard for N (ROADMAP fault 3n).
The port's `Mesh` is N shards on one torch device, whatever the number of
cards: the shard planes carry a leading axis of N, and `exchange`, the
all_to_all, is a transpose of that axis with the destination axis.

`--nprocs P` is P processes with one shard each (parallel/multihost.py
`global_mesh`, the JAX global mesh at one device a process). A process's
planes carry a leading axis of 1, and `exchange` is an all_to_all over
torch.distributed (`multihost.all_to_all_planes`: gloo, through the
host). Every size that a collective moves is agreed first: `plane_width`
is the largest bucket load over all processes.

Words are int64 tensors holding values in [0, 2^32) (ops/kmer.py); the
owner hash runs on the W key words, never on the int64 key lanes, and
multiplies in 16-bit halves so that no int64 product overflows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from kmernator_tpu_torch.ops.extensions import EXT_X
from kmernator_tpu_torch.ops.kmer import (MASK32, SENTINEL_LANE,
                                          SENTINEL_WORD,
                                          decode_lanes, encode_lanes,
                                          nwords)
from kmernator_tpu_torch.parallel.device_spectrum import (
    extract_canonical_cols, is_sentinel, run_bounds, run_totals,
    sort_lanes, window_good)
from kmernator_tpu_torch.parallel.multihost import (all_to_all_planes,
                                                    allreduce_max_int)
from kmernator_tpu_torch.parallel.run_length import run_length_sums
from kmernator_tpu_torch.utils import timers


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of `size` shards over `nprocs` processes: this
    process (`rank`) holds `local` of them, global shards `first` to
    `first + local - 1`, all on `device`. Either every shard is in one
    process (nprocs == 1) or each process holds one (size == nprocs)."""
    device: torch.device
    size: int = 1
    rank: int = 0
    nprocs: int = 1

    def __post_init__(self):
        if self.nprocs > 1 and self.size != self.nprocs:
            raise ValueError("a mesh over %d processes holds one shard a "
                             "process, not %d" % (self.nprocs, self.size))

    @property
    def local(self) -> int:
        return self.size // self.nprocs

    @property
    def first(self) -> int:
        return self.rank * self.local


def make_mesh(n_devices: int = 1, device="cuda") -> Mesh:
    """n_devices shards on one torch device (any n_devices >= 1: the JAX
    mesh of n devices in one process, each shard's table and exchange
    planes a slice of one tensor on `device`)."""
    if int(n_devices) < 1:
        raise ValueError("a mesh needs at least one shard, got %d"
                         % n_devices)
    return Mesh(torch.device(device), int(n_devices))


# ---- owner hash, bucket scatter, exchange ----

def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32): two products below 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def owner_hash_cols(key_cols: List[torch.Tensor]) -> torch.Tensor:
    """The JAX murmur3-style finalizer over W word columns, bit for bit:
    a u32 hash of each key as an int64 in [0, 2^32)."""
    h = torch.full_like(key_cols[0], 0x9E3779B9)
    for col in key_cols:
        h = h ^ col
        h = _mul32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        h = _mul32(h, 0xC2B2AE35)
        h = h ^ (h >> 16)
    return h


def owner_hash(keys: torch.Tensor) -> torch.Tensor:
    """keys [..., W] words -> the hash of each key (the JAX owner_hash)."""
    return owner_hash_cols([keys[..., w] for w in range(keys.shape[-1])])


def bucket_loads(owner: torch.Tensor, real: torch.Tensor,
                 D: int) -> torch.Tensor:
    """[S, D] int64: the real rows of each source shard (rows of owner
    [S, N]) that each destination owns. A bucket of C rows overflows by
    max(load - C, 0); the JAX scatter's overflow count is their sum."""
    with timers.span("exchange", device=owner.device):
        S = owner.shape[0]
        src = torch.arange(S, device=owner.device)[:, None] * D
        return torch.bincount((src + owner)[real],
                              minlength=S * D).view(S, D)


def owners(key_cols: List[torch.Tensor], D: int) -> torch.Tensor:
    """The owner shard of each key: owner_hash_cols(key_cols) % D (0 at
    D = 1, where the hash is not computed)."""
    with timers.span("exchange", device=key_cols[0].device):
        if D == 1:
            return torch.zeros_like(key_cols[0])
        return owner_hash_cols(key_cols) % D


def bucket_slots(owner: torch.Tensor, real: torch.Tensor, D: int,
                 C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slots of the JAX `_bucket_scatter_cols` for each source shard:
    owner, real [S, N] -> (win_slot [S, N] int64, owner * C + the row's rank
    among its source's real rows of that owner, or -1 for a row not routed
    (not real) or dropped (past C); overflow [S] int64, the real rows
    dropped). Ranks follow row order (the JAX sort is unstable; a bucket is
    the same multiset): a running count a destination, in place of the
    JAX sort by owner."""
    with timers.span("exchange", device=owner.device):
        S, N = owner.shape
        win_slot = torch.full_like(owner, -1)
        overflow = torch.zeros(S, dtype=torch.int64, device=owner.device)
        if N == 0:   # a process with no candidates left in a purge chunk
            return win_slot, overflow
        zero = torch.zeros(1, dtype=torch.int64, device=owner.device)
        for d in range(D):
            mine = real & (owner == d)
            # one scan over the sources laid end to end, then each
            # source's count before its row taken off: on the card, scans
            # along the rows of an [S, N] tensor with S of 2-4 ran several
            # times slower
            run = torch.cumsum(mine.reshape(-1), 0).view(S, N)
            rank = run - torch.cat([zero, run[:-1, -1]])[:, None] - 1
            ok = mine & (rank < C)
            win_slot = torch.where(ok, rank + d * C, win_slot)
            overflow += (mine & ~ok).sum(1)
        return win_slot, overflow


def scatter_plane(x: torch.Tensor, win_slot: torch.Tensor, D: int, C: int,
                  fill) -> torch.Tensor:
    """Rows of x [S, N] into their slots of an [S, D, C] send plane; the
    slots no row takes hold `fill`."""
    with timers.span("exchange", device=x.device):
        S = x.shape[0]
        buf = torch.full((S, D * C + 1), fill, dtype=x.dtype,
                         device=x.device)
        routed = win_slot >= 0
        buf.scatter_(1, torch.where(routed, win_slot,
                                    torch.full_like(win_slot, D * C)),
                     torch.where(routed, x, torch.full_like(x, fill)))
        return buf[:, :D * C].reshape(S, D, C)


def bucket_scatter_cols(key_cols: List[torch.Tensor], good: torch.Tensor,
                        owner: torch.Tensor, D: int, C: int):
    """The JAX `_bucket_scatter_cols` for S source shards at once: key word
    columns, good, owner [S, N] -> (key planes [S, D, C] (the sentinel word
    in empty slots), good plane [S, D, C] int32, win_slot [S, N], overflow
    [S]). Rows whose key is the sentinel in every word are not routed and
    do not count as overflow; a row past C of its owner is dropped
    (win_slot -1) and counted. The apps route key lanes through
    bucket_slots and scatter_plane, in planes of `plane_width` columns."""
    sent = key_cols[0] == SENTINEL_WORD
    for col in key_cols[1:]:
        sent = sent & (col == SENTINEL_WORD)
    win_slot, overflow = bucket_slots(owner, ~sent, D, C)
    planes = [scatter_plane(c, win_slot, D, C, SENTINEL_WORD)
              for c in key_cols]
    send_good = scatter_plane(good.to(torch.int32), win_slot, D, C, 0)
    return planes, send_good, win_slot, overflow


def exchange(send: torch.Tensor) -> torch.Tensor:
    """The all_to_all of the local shards' send planes: [D_src_local, D, C,
    ...] -> the received [D_dst_local, D * C, ...], each local destination
    d holding every source's bucket d in source order. The reply travels
    the same way: exchange(x.reshape(D_dst_local, D, C)) gives
    [D_src_local, D * C], which a source reads at its win_slot. Callers use
    only this contract. With every shard in this process (D_src_local ==
    D) it is a transpose; with one shard a process, an all_to_all over the
    processes (`multihost.all_to_all_planes`), every process passing the
    same shape."""
    with timers.span("exchange", device=send.device):
        S, D, C = send.shape[:3]
        rest = tuple(send.shape[3:])
        if S == D:
            return send.transpose(0, 1).reshape((D, D * C) + rest)
        if S != 1:
            raise ValueError("%d local shards of %d: a mesh holds every "
                             "shard in one process or one a process"
                             % (S, D))
        return all_to_all_planes(send[0]).reshape((1, D * C) + rest)


def plane_width(loads: torch.Tensor) -> int:
    """The columns a send plane needs: the largest bucket load of `loads`
    ([S, D], from bucket_loads) over every process, at least 1. The JAX
    planes are C wide, the rows past a bucket's load the sentinel, which
    every receiver drops; the port's planes stop at the largest load (one
    host sync, and one allreduce across processes, so that every process
    sends planes of one shape)."""
    return max(allreduce_max_int(int(loads.max()) if loads.numel() else 0),
               1)


def bucket_capacity(width: int, C: int, limit: int) -> Tuple[int, int]:
    """The callers' retry on overflow: C doubled while the largest bucket
    load `width` (`plane_width`: over every process, so that every process
    takes the same C and retries) is past it. Returns (C, retries); raises
    once C passes `limit`."""
    retries = 0
    while width > C:
        C *= 2
        retries += 1
        if C > limit:
            raise RuntimeError("mesh bucket overflow even at C=%d" % C)
    return C, retries


def window_extensions_device(codes: torch.Tensor, lengths: torch.Tensor,
                             is_fwd: torch.Tensor, ext_ok: torch.Tensor,
                             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left/right extension codes of every window, on the codes' device
    (the JAX `_window_extensions_device`; ops/extensions.py over ragged
    reads; ref: src/KmerReadUtils.h:200-236). codes [B, L] (0..3), lengths
    [B], is_fwd [B, NW] bool, ext_ok [B, L] bool -> (left, right) [B, NW]
    int32: 0..3 a base, EXT_X off the end of the read, -1 below the
    extension quality; reverse windows swap sides and complement."""
    B, L = codes.shape
    NW = L - k + 1
    dev = codes.device
    pos = torch.arange(NW, dtype=torch.int32, device=dev)[None, :]
    c = codes.to(torch.int32)
    zc = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    zb = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    left_codes = torch.cat([zc, c[:, :NW - 1]], dim=1)
    left_ok = torch.cat([zb, ext_ok[:, :NW - 1]], dim=1)
    left = torch.where(pos == 0, EXT_X,
                       torch.where(left_ok, left_codes, -1))
    del left_codes, left_ok
    # the right neighbour of window i is base i + k
    right_codes = torch.cat([c[:, k:], zc], dim=1)
    right_ok = torch.cat([ext_ok[:, k:], zb], dim=1)
    in_read = (pos + k) < lengths.to(torch.int32)[:, None]
    right = torch.where(~in_read, EXT_X,
                        torch.where(right_ok, right_codes, -1))
    del c, right_codes, right_ok, in_read

    def comp(e):
        return torch.where((e >= 0) & (e < 4), 3 - e, e)

    return (torch.where(is_fwd, left, comp(right)),
            torch.where(is_fwd, right, comp(left)))


def count_received_ext(lanes: List[torch.Tensor], good: torch.Tensor,
                       el: torch.Tensor, er: torch.Tensor, min_count: int):
    """The count and the 2 x 6 extension counters of every key run (the
    JAX `_count_received_ext`). lanes: L [n] int64 key lanes
    (ops/kmer.py encode_lanes); good [n] bool; el, er [n] int32 codes
    (0..5, or -1 untracked). Returns the kept runs in key order: (L [M]
    int64 lanes, counts [M] int32, ext [M, 12] int32, columns left A C G T
    N X then right A C G T N X). A run is kept when its key is not the
    sentinel and its count of good rows is >= min_count. The JAX function
    returns the same runs at their first rows of an [n] table padded with
    the sentinel; here each sum comes from the run-length kernel at the
    run's last row, and the 13 sums are reduced to the kept rows one at a
    time, so that only one [n] sum is held at once. Counts wrap at 32 bits
    as the JAX scans do."""
    s, _, keep, counts, ext = _count_ext_runs(lanes, good, el, er, min_count)
    return [lane[keep] for lane in s], counts, ext


def _count_ext_runs(lanes: List[torch.Tensor], good: torch.Tensor,
                    el: torch.Tensor, er: torch.Tensor, min_count: int):
    """count_received_ext with its sorted state: (s, the L sorted [n]
    lanes; first, last [M] int64, the first and the last row of each kept
    run in s; counts [M] int32; ext [M, 12] int32)."""
    s, perm = sort_lanes(lanes)
    sgood = good[perm]
    cnt = run_length_sums(s, sgood.to(torch.int32))
    boundary, is_end = run_bounds(s)
    ends = torch.nonzero(is_end).squeeze(1)
    kept = ~is_sentinel([lane[ends] for lane in s]) & (cnt[ends] >= min_count)
    first = torch.nonzero(boundary).squeeze(1)[kept]
    keep = ends[kept]
    counts = cnt[keep]
    del cnt, boundary, is_end, ends, kept
    ext = torch.empty((keep.numel(), 12), dtype=torch.int32,
                      device=counts.device)
    for side, col in enumerate((el, er)):
        scol = col[perm]
        for code in range(6):
            ext[:, 6 * side + code] = run_length_sums(
                s, (sgood & (scol == code)).to(torch.int32))[keep]
        del scol
    return s, first, keep, counts, ext


def _route_extensions(mesh: Mesh, k: int, codes: torch.Tensor,
                      good2d: torch.Tensor, ext_ok2d: torch.Tensor,
                      lengths: torch.Tensor, capacity_factor: float,
                      fixed: bool):
    """The route of the extension spectrum: the reads split into D
    contiguous blocks, as shard_map splits them; each block's good
    windows' key lanes, good flags and extension codes go to their owners
    in buckets of C = ceil(N / D * capacity_factor) rows (N windows a
    block). fixed: planes C wide, the rows past C dropped and counted (the
    JAX step); else planes as wide as the largest bucket (`plane_width`),
    and nothing routed when that passes C. Returns ((received lanes L x [D,
    D * width], good, left, right [D, D * width]), overflow [D] int64 rows
    past C a source) or (None, their sum)."""
    D = mesh.size
    B = codes.shape[0]
    if B % D:
        raise ValueError("%d reads do not split into %d shards" % (B, D))
    canon, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
    g = (good2d & valid).reshape(D, -1)
    del valid
    N = g.shape[1]
    words = [torch.where(g, c.reshape(D, -1), SENTINEL_WORD) for c in canon]
    del canon
    owner = owners(words, D)
    C = math.ceil(N / D * capacity_factor)
    if fixed:
        width = C
    else:
        loads = bucket_loads(owner, g, D)
        width = plane_width(loads)
        if width > C:
            return None, int((loads - C).clamp_(min=0).sum())
    win_slot, overflow = bucket_slots(owner, g, D, width)
    del owner
    el, er = window_extensions_device(codes, lengths, is_fwd, ext_ok2d, k)
    del is_fwd
    recv = [exchange(scatter_plane(lane, win_slot, D, width, SENTINEL_LANE))
            for lane in encode_lanes(words)]
    del words
    rg, rl, rr = (exchange(scatter_plane(x.reshape(D, -1), win_slot, D,
                                         width, fill))
                  for x, fill in ((g, False), (el, -1), (er, -1)))
    return (recv, rg, rl, rr), overflow


def extension_spectrum_mesh(mesh: Mesh, k: int, codes: torch.Tensor,
                            good2d: torch.Tensor, ext_ok2d: torch.Tensor,
                            lengths: torch.Tensor, min_count: int,
                            capacity_factor: float = 2.0):
    """The extension-tracking spectrum over the mesh's shards (the JAX
    `distributed_extension_fn` step, with the MeraculousCounter app's
    retry). codes [B, L] (0..3), good2d [B, NW] bool (the exact host mask),
    ext_ok2d [B, L] bool, lengths [B]; all on mesh.device, B a multiple of
    D = mesh.size. Routes as `_route_extensions` with planes as wide as
    the largest bucket, and each owner counts what it received. Returns
    (lanes, counts, ext, overflow): count_received_ext's tables of all
    shards merged in key order, and 0; or (None, None, None, the rows past
    C) when a bucket overflows, for the caller to retry at a larger
    capacity_factor."""
    routed, overflow = _route_extensions(mesh, k, codes, good2d, ext_ok2d,
                                         lengths, capacity_factor, False)
    if routed is None:
        return None, None, None, overflow
    recv, rg, rl, rr = routed
    D = mesh.size
    shards = [count_received_ext([lane[d] for lane in recv], rg[d], rl[d],
                                 rr[d], min_count) for d in range(D)]
    del recv, rg, rl, rr, routed
    if D == 1:
        return shards[0] + (0,)
    # each key lives in one shard: the shards laid end to end, then put in
    # key order, are the one table of all keys
    lanes, perm = sort_lanes([torch.cat([s[0][j] for s in shards])
                              for j in range(len(shards[0][0]))])
    counts = torch.cat([s[1] for s in shards])[perm]
    ext = torch.cat([s[2] for s in shards])[perm]
    return lanes, counts, ext, 0


# ---- the JAX shard_map steps, every shard in this process ----

def _count_received_lanes(lanes: List[torch.Tensor], good: torch.Tensor,
                          min_count: int, W: int):
    """count_received_cols over L int64 key lanes of W-word keys."""
    s, perm = sort_lanes(lanes)
    boundary, _, total = run_totals(s, good[perm].to(torch.int32))
    sent = is_sentinel(s)
    zero = torch.zeros_like(total)
    cnt = torch.empty_like(total)
    cnt[perm] = torch.where(sent | (total < min_count), zero, total)
    keep = boundary & ~sent & (total > 0)
    shard_keys = torch.stack(decode_lanes(
        [torch.where(keep, lane, SENTINEL_LANE) for lane in s], W), dim=-1)
    return cnt, shard_keys, torch.where(boundary, total, zero)


def count_received_cols(key_cols: List[torch.Tensor], good: torch.Tensor,
                        min_count: int):
    """The count of one shard's received rows (the JAX
    `_count_received_cols`): key_cols W [n] int64 word columns (the
    sentinel in empty slots), good [n] (bool or int 0/1). Returns (cnt [n]
    int32: the good rows of each row's key, 0 below min_count and at the
    sentinel, in the rows' order; shard_keys [n, W] int64 words: the
    received keys in key order, the sentinel but at the first row of each
    non-sentinel run with a good row; shard_counts [n] int32: each run's
    good rows at its first row, 0 elsewhere), as JAX lays them out. The
    run totals come from the run-length kernel (one launch), wrapping at
    32 bits as the JAX int32 scans do."""
    return _count_received_lanes(encode_lanes(list(key_cols)), good,
                                 min_count, len(key_cols))


def count_received(keys2d: torch.Tensor, good: torch.Tensor,
                   min_count: int):
    """count_received_cols of keys2d [n, W] int64 words (the JAX
    `_count_received`)."""
    return count_received_cols([keys2d[:, w] for w in range(keys2d.shape[1])],
                               good, min_count)


def _one_process(mesh: Mesh) -> None:
    if mesh.nprocs > 1:
        raise NotImplementedError(
            "the distributed_*_fn steps hold every shard in one process; "
            "across processes FilterReads routes through mesh_stream")


def _count_step(mesh: Mesh, k: int, codes: torch.Tensor,
                good2d: torch.Tensor, lengths: torch.Tensor,
                capacity_factor: float, min_count: int):
    """The body of distributed_spectrum_fn and distributed_count_fn: the
    reads split into D contiguous blocks; every non-sentinel window of a
    block, good or not, goes to its owner in a bucket of C rows with its
    good flag (the rows past C dropped and counted); each owner counts
    what it received (`count_received_cols`), and the counts come back the
    same way to the windows that sent them. Returns (counts [B, NW] int32,
    shard_keys [D * D * C, W], shard_counts [D * D * C], overflow [D]
    int32)."""
    _one_process(mesh)
    D = mesh.size
    B = codes.shape[0]
    if B % D:
        raise ValueError("%d reads do not split into %d shards" % (B, D))
    cols, _, valid = extract_canonical_cols(codes, lengths, k)
    W = len(cols)
    NW = valid.shape[1]
    key_cols = [c.reshape(D, -1) for c in cols]
    del cols
    N = key_cols[0].shape[1]
    C = math.ceil(N / D * capacity_factor)
    sent = key_cols[0] == SENTINEL_WORD
    for col in key_cols[1:]:
        sent &= col == SENTINEL_WORD
    win_slot, overflow = bucket_slots(owners(key_cols, D), ~sent, D, C)
    del sent
    recv = [exchange(scatter_plane(lane, win_slot, D, C, SENTINEL_LANE))
            for lane in encode_lanes(key_cols)]
    del key_cols
    g = (good2d & valid).reshape(D, N).to(torch.int32)
    rgood = exchange(scatter_plane(g, win_slot, D, C, 0))
    del g
    shards = [_count_received_lanes([lane[d] for lane in recv], rgood[d],
                                    min_count, W) for d in range(D)]
    del recv, rgood
    back = exchange(torch.stack([s[0] for s in shards]).reshape(D, D, C))
    counts = back.gather(1, win_slot.clamp(min=0))
    counts = torch.where((win_slot >= 0) & valid.reshape(D, N), counts,
                         torch.zeros_like(counts))
    return (counts.reshape(B, NW), torch.cat([s[1] for s in shards]),
            torch.cat([s[2] for s in shards]), overflow.to(torch.int32))


def distributed_spectrum_fn(mesh: Mesh, k: int, capacity_factor: float = 2.0,
                            min_count: int = 2,
                            log2_min_weight: float = math.log2(0.10)):
    """The multi-shard spectrum step (the JAX distributed_spectrum_fn) over
    `mesh`, every shard in this process. Returns fn(codes [B, L] (0..3),
    logp [B, L] float32, lengths [B]), tensors on mesh.device with B a
    multiple of D = mesh.size, split into D contiguous blocks as the JAX
    P(axis) sharding splits them -> (counts [B, NW] int32: each window's
    key count over all blocks' good windows, 0 below min_count and at
    invalid windows; shard_keys [D * D * C, W] int64 words and
    shard_counts [D * D * C] int32: each shard's `count_received_cols`
    table, shards end to end; overflow [D] int32, the windows of each
    block dropped past C). The good mask is window_good's (ROADMAP 3o);
    C = ceil(N / D * capacity_factor) for N windows a block, fixed, with no
    retry. Where a bucket overflows, which rows it drops follows the rows'
    order here and the JAX sort's tie order there."""
    def fn(codes, logp, lengths):
        _, good = window_good(logp, lengths, k, log2_min_weight)
        return _count_step(mesh, k, codes, good, lengths, capacity_factor,
                           min_count)
    return fn


def distributed_count_fn(mesh: Mesh, k: int, capacity_factor: float = 2.0,
                         min_count: int = 2):
    """distributed_spectrum_fn with the good mask given (the JAX
    distributed_count_fn, the FilterReads --mesh count): fn(codes [B, L],
    good [B, NW] bool, lengths [B]) -> (counts [B, NW] int32, overflow [D]
    int32)."""
    def fn(codes, good, lengths):
        counts, _, _, overflow = _count_step(mesh, k, codes, good, lengths,
                                             capacity_factor, min_count)
        return counts, overflow
    return fn


def distributed_extension_fn(mesh: Mesh, k: int, capacity_factor: float = 2.0,
                             min_count: int = 2):
    """The extension-tracking spectrum step (the JAX
    distributed_extension_fn) over `mesh`, every shard in this process:
    fn(codes [B, L], good [B, NW] bool, ext_ok [B, L] bool, lengths [B]),
    tensors on mesh.device, B split into D contiguous blocks -> (shard_keys
    [D * D * C, W] int64 words, shard_counts [D * D * C] int32, shard_ext
    [D * D * C, 12] int32, overflow [D] int32), each shard's rows as the
    JAX `_count_received_ext` lays them out: its received keys in key
    order, a run's key, count and extension counters at the run's first
    row where the key is not the sentinel and counts >= min_count, the
    sentinel and zeros elsewhere. C is fixed at ceil(N / D *
    capacity_factor), the rows past it dropped and counted, with no retry
    (the MeraculousCounter app retries through extension_spectrum_mesh).
    Each shard's rows come from one sort (`_count_ext_runs`, the counters
    of count_received_ext with the first row of each kept run)."""
    def fn(codes, good, ext_ok, lengths):
        _one_process(mesh)
        (recv, rg, rl, rr), overflow = _route_extensions(
            mesh, k, codes, good, ext_ok, lengths, capacity_factor, True)
        W = nwords(k)
        out = []
        for d in range(mesh.size):
            s, first, _, counts, ext = _count_ext_runs(
                [lane[d] for lane in recv], rg[d], rl[d], rr[d], min_count)
            n = s[0].numel()
            keys = torch.full((n, W), SENTINEL_WORD, dtype=torch.int64,
                              device=counts.device)
            keys[first] = torch.stack(
                decode_lanes([lane[first] for lane in s], W), dim=-1)
            full_counts = torch.zeros(n, dtype=torch.int32,
                                      device=counts.device)
            full_counts[first] = counts
            full_ext = torch.zeros((n, 12), dtype=torch.int32,
                                   device=counts.device)
            full_ext[first] = ext
            out.append((keys, full_counts, full_ext))
        return (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]),
                torch.cat([o[2] for o in out]), overflow.to(torch.int32))
    return fn
