"""The device mesh of the port, its shard exchange, and the extension
spectrum on it.

Twin of kmernator_tpu/parallel/mesh.py: `make_mesh`, the owner hash
(`owner_hash_cols`, `owner_hash`), the bucket scatter
(`bucket_scatter_cols`, the JAX `_bucket_scatter_cols`), the exchange that
stands for its all_to_all, and the MeraculousCounter mesh path,
`distributed_extension_fn` with its `_window_extensions_device` and
`_count_received_ext` (`extension_spectrum_mesh`,
`window_extensions_device`, `count_received_ext`).

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
                                          SENTINEL_WORD, check_k,
                                          encode_lanes)
from kmernator_tpu_torch.parallel.device_spectrum import (
    extract_canonical_cols, is_sentinel, sort_lanes)
from kmernator_tpu_torch.parallel.multihost import (all_to_all_planes,
                                                    allreduce_max_int)
from kmernator_tpu_torch.parallel.run_length import run_length_sums


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
    S = owner.shape[0]
    src = torch.arange(S, device=owner.device)[:, None] * D
    return torch.bincount((src + owner)[real], minlength=S * D).view(S, D)


def owners(key_cols: List[torch.Tensor], D: int) -> torch.Tensor:
    """The owner shard of each key: owner_hash_cols(key_cols) % D (0 at
    D = 1, where the hash is not computed)."""
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
    S, N = owner.shape
    win_slot = torch.full_like(owner, -1)
    overflow = torch.zeros(S, dtype=torch.int64, device=owner.device)
    if N == 0:   # a process with no candidates left in a purge chunk
        return win_slot, overflow
    zero = torch.zeros(1, dtype=torch.int64, device=owner.device)
    for d in range(D):
        mine = real & (owner == d)
        # one scan over the sources laid end to end, then each source's
        # count before its row taken off: on the card, scans along the
        # rows of an [S, N] tensor with S of 2-4 ran several times slower
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
    S = x.shape[0]
    buf = torch.full((S, D * C + 1), fill, dtype=x.dtype, device=x.device)
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
    S, D, C = send.shape[:3]
    rest = tuple(send.shape[3:])
    if S == D:
        return send.transpose(0, 1).reshape((D, D * C) + rest)
    if S != 1:
        raise ValueError("%d local shards of %d: a mesh holds every shard "
                         "in one process or one a process" % (S, D))
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
    s, perm = sort_lanes(lanes)
    sgood = good[perm]
    n = s[0].numel()
    cnt = run_length_sums(s, sgood.to(torch.int32))
    is_end = torch.ones(n, dtype=torch.bool, device=cnt.device)
    if n > 1:
        neq = s[0][1:] != s[0][:-1]
        for lane in s[1:]:
            neq |= lane[1:] != lane[:-1]
        is_end[:-1] = neq
        del neq
    keep = torch.nonzero(is_end & ~is_sentinel(s)
                         & (cnt >= min_count)).squeeze(1)
    counts = cnt[keep]
    del cnt, is_end
    ext = torch.empty((keep.numel(), 12), dtype=torch.int32,
                      device=counts.device)
    for side, col in enumerate((el, er)):
        scol = col[perm]
        for code in range(6):
            ext[:, 6 * side + code] = run_length_sums(
                s, (sgood & (scol == code)).to(torch.int32))[keep]
        del scol
    return [lane[keep] for lane in s], counts, ext


def extension_spectrum_mesh(mesh: Mesh, k: int, codes: torch.Tensor,
                            good2d: torch.Tensor, ext_ok2d: torch.Tensor,
                            lengths: torch.Tensor, min_count: int,
                            capacity_factor: float = 2.0):
    """The extension-tracking spectrum over the mesh's shards (the JAX
    `distributed_extension_fn` step). codes [B, L] (0..3), good2d [B, NW]
    bool (the exact host mask), ext_ok2d [B, L] bool, lengths [B]; all on
    mesh.device, B a multiple of D = mesh.size. The reads split into D
    contiguous blocks, as shard_map splits them; each block routes its good
    windows' keys, good flags and extension codes to their owners in
    buckets of C = ceil(N / D * capacity_factor) rows (N windows a block),
    and each owner counts what it received (the planes as wide as the
    largest bucket, `plane_width`). Returns (lanes, counts, ext,
    overflow): count_received_ext's tables of all shards merged in key
    order, and 0; or (None, None, None, the rows past C) when a bucket
    overflows, for the caller to retry at a larger capacity_factor."""
    check_k(k)
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
    loads = bucket_loads(owner, g, D)
    width = plane_width(loads)
    if width > C:
        return None, None, None, int((loads - C).clamp_(min=0).sum())
    win_slot, _ = bucket_slots(owner, g, D, width)
    del owner
    el, er = window_extensions_device(codes, lengths, is_fwd, ext_ok2d, k)
    del is_fwd
    recv = [exchange(scatter_plane(lane, win_slot, D, width, SENTINEL_LANE))
            for lane in encode_lanes(words)]
    del words
    rg, rl, rr = (exchange(scatter_plane(x.reshape(D, -1), win_slot, D,
                                         width, fill))
                  for x, fill in ((g, False), (el, -1), (er, -1)))
    del win_slot, el, er
    shards = [count_received_ext([lane[d] for lane in recv], rg[d], rl[d],
                                 rr[d], min_count) for d in range(D)]
    del recv, rg, rl, rr
    if D == 1:
        return shards[0] + (0,)
    # each key lives in one shard: the shards laid end to end, then put in
    # key order, are the one table of all keys
    lanes, perm = sort_lanes([torch.cat([s[0][j] for s in shards])
                              for j in range(len(shards[0][0]))])
    counts = torch.cat([s[1] for s in shards])[perm]
    ext = torch.cat([s[2] for s in shards])[perm]
    return lanes, counts, ext, 0
