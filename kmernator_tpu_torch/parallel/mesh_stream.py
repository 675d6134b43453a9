"""Streaming shard tables on a mesh: the port of mesh_stream.py.

Twin of kmernator_tpu/parallel/mesh_stream.py `MeshStreamingSpectrum`: D =
mesh.size shard tables, all on the mesh's one torch device.

  route:   unpack the 2-bit codes and 1-bit good mask, extract canonical
           keys, pre-mask non-good windows to the sentinel; the batch,
           padded to a multiple of D reads, splits into D source blocks,
           and each block's real windows go to the shard their owner hash
           names (parallel/mesh.py: bucket scatter into send planes, C
           doubled while a bucket overflows, then the exchange). Each shard
           STAGES the rows it received and counts D * C staged rows, as the
           JAX package stages its C-wide planes (sentinel padding
           included), so its drains fall on the same batches; the port's
           planes stop at the largest bucket load. No per-batch sort.
  drain:   once a shard's staged rows reach drain_threshold, each shard
           sorts (its table + its staged rows) on the key lanes, takes run
           totals from the run-length kernel (one launch a shard), and
           compacts to `cap` rows: all solid (count >= 2) runs first, then
           singletons, each in key order, so the table stays sorted
           without the JAX package's two further sorts.
  lookup:  each wanted window goes to its owner through the exchange, the
           owner binary-searches its sorted shard (device_spectrum.py
           `search_lanes`: torch.searchsorted on one lane; for L > 1 lanes
           the JAX package's lexicographic search, ceil(log2 cap) + 1
           probes), and the counts come back through the exchange.
  purge:   the on-device variant purge (`purge_variants_mesh`, with
           `_shell_cols`, the purge rounds and `_apply_purge_fn` of the JAX
           module) and `purge_min_depth`, shard by shard; `set_table`
           loads a host table split by owner.

A shard table is L = ceil(W/2) int64 key lanes (ops/kmer.py encode_lanes:
one lane for k <= 32, up to 3 for k <= 96), int32 counts and float32
weights, each [D, cap] on the mesh's device. Keys and counts are bit-equal
to the JAX drain's. Run weights are sums of the run's window weights taken
from a float64 prefix sum over the shard's sorted drain, differenced at
run ends and rounded to float32 once. The JAX drain (its `_drain_fn`)
differences a float32 prefix instead, whose rounding grows with the
drain's total weight: past a total of 2^23 a float32 ulp is 1, so a run of
weight under 1 can come out as 0 or 1 there. The two agree to a few
float32 ulps of the drain's total weight (the tests hold them to 1e-6 of
it); the port's run weights are the host engine's float64 sums to float32
rounding. The shards laid end to end are not in key order: `finalize`
sorts the keys on the host, as the JAX one does.

Differences from the JAX purge, none of which changes its marks (a set
union over candidates): a candidate is searched in the shard its owner
hash names, with no bucket (the JAX buckets hold twice a uniform share of
a chunk's candidates, so overflow_retries counts no purge retry here);
the sources of a round are taken in groups of one
search distance d (after the `20 ^ d` shrink), so a group of d = 1 never
builds the distance-2 shell, and each group is cut into chunks of at most
`chunk_rows` candidate rows (the JAX package: 128 sources a chunk, every
source expanded to the full distance and masked). The thresholds are the
JAX mesh path's float32 ones as XLA on the CPU computes them
(tests/test_torch_variant_purge.py shows both rewrites): `v - sqrt(v) *
sigmas` rounded once, as the fused multiply-add XLA makes of it, with a
correctly rounded square root, and the division by 20 ^ (dist - 1) a
multiply by its float32 reciprocal.

Grow-on-pressure (max_capacity > capacity, the JAX `_maybe_grow` and
`_pad_table_fn`): before a drain the tables grow until a shard can take
twice its uniform share of the real staged rows as new keys (headroom 1:
last fill + (2 * staged real) // D + 1), after it until the fullest shard
is at most half full (headroom 2), 4x a step up to max_capacity. A step
appends sentinel rows, which sort last, so each table stays sorted. The
steps are the JAX ones row for row: the same count of real staged rows
(the host good mask, padding included as zeros) and the same rows kept by
a drain.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from kmernator_tpu_torch.ops.kmer import (MASK32, SENTINEL_LANE,
                                          SENTINEL_WORD, check_k,
                                          decode_lanes, encode_lanes,
                                          last_word_mask, nlanes, nwords,
                                          reverse_bases)
from kmernator_tpu_torch.parallel.device_spectrum import (
    _shift_left_cols, extract_canonical_cols, is_sentinel, search_lanes,
    sort_lanes)
from kmernator_tpu_torch.parallel.mesh import (
    Mesh, bucket_capacity, bucket_loads, bucket_slots, exchange, owners,
    plane_width, scatter_plane)
from kmernator_tpu_torch.parallel.run_length import run_length_sums
from kmernator_tpu_torch.parallel.spectrum import KmerSpectrum, pack_keys
from kmernator_tpu_torch.utils.logging import Log

# candidate rows a purge chunk holds at most, by device type
PURGE_CHUNK_ROWS = {"cuda": 1 << 24, "cpu": 1 << 20}


# wire format: base codes cross the host->device link 2-bit packed and
# window masks bit-packed; the device unpacks them with shift masks

def pack_codes_host(codes: np.ndarray) -> np.ndarray:
    """[B, L] u8 base codes -> [B, ceil(L/4)] u8, base i at bits 2*(i%4)."""
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    if L4 != L:
        codes = np.concatenate(
            [codes, np.zeros((B, L4 - L), np.uint8)], axis=1)
    c = codes.reshape(B, L4 // 4, 4).astype(np.uint16)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) \
        | (c[:, :, 3] << 6)
    return packed.astype(np.uint8)


def pack_bits_host(mask: np.ndarray) -> np.ndarray:
    """[B, NW] bool -> [B, ceil(NW/8)] u8 (little-endian bit order)."""
    return np.packbits(mask, axis=1, bitorder="little")


def _unpack_codes_dev(packed: torch.Tensor, L: int) -> torch.Tensor:
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = (packed[:, :, None] >> shifts) & 3
    return codes.reshape(packed.shape[0], -1)[:, :L]


def _unpack_bits_dev(packed: torch.Tensor, NW: int) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :NW].to(torch.bool)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """a with n zero rows appended."""
    return np.concatenate([a, np.zeros((n,) + a.shape[1:], a.dtype)])


def _f32(x: float, device) -> torch.Tensor:
    """x rounded to float32, as a 0-dim tensor on `device`."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _fma_sub_f32(v: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """float32 v - a * b rounded once, as a fused multiply-add rounds it
    (XLA on the CPU contracts the JAX threshold `v - sqrt(v) * sigmas` into
    one). a * b is exact in float64; the float64 difference r and its
    rounding error e (Knuth's TwoSum) hold v - a * b exactly, and r rounds
    to the float32 f unless r lies halfway between f and its neighbour g,
    where the sign of e picks the side."""
    vd = v.to(torch.float64)
    nb = -(a.to(torch.float64) * b.to(torch.float64))
    r = vd + nb
    bb = r - vd
    e = (vd - (r - bb)) + (nb - bb)
    f = r.to(torch.float32)
    d = r - f.to(torch.float64)
    inf = torch.full_like(f, float("inf"))
    g = torch.nextafter(f, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & (2 * r == f.to(torch.float64) + g.to(torch.float64))
    return torch.where(tie & (e != 0) & ((e > 0) == (d > 0)), g, f)


def _sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of max(v, 0), as XLA on
    the CPU computes it: taken in float64 and rounded once more, which for
    a float32 input gives the correctly rounded result. torch.sqrt of a
    float32 tensor need not be: a CPU build and the CUDA build rounded
    some random values otherwise than numpy and than each other."""
    return torch.sqrt(torch.clamp(v, min=0.0).to(torch.float64)).to(
        torch.float32)


def _recip_f32(c: int, device) -> torch.Tensor:
    """The float32 1 / c as a 0-dim tensor on `device`: XLA turns the JAX
    threshold's division by the constant 20 ^ (dist - 1) into a multiply by
    this reciprocal (tests/test_torch_variant_purge.py shows it)."""
    return _f32(float(np.float32(1) / np.float32(c)), device)


def _lanes_less(a: List[torch.Tensor], b: List[torch.Tensor]):
    """Lexicographic a < b over key lanes."""
    lt = a[-1] < b[-1]
    for j in range(len(a) - 2, -1, -1):
        lt = torch.where(a[j] == b[j], lt, a[j] < b[j])
    return lt


def _shell_cols(cols: List[torch.Tensor], k: int) -> List[torch.Tensor]:
    """Hamming-1 shell: W [N] word columns (int64 in [0, 2^32)) -> W [N, 4k]
    columns of the canonical keys of every single-base substitution, the
    identity rows included (the JAX `_shell_cols`, bit for bit)."""
    W = len(cols)
    dev = cols[0].device
    j = torch.arange(4 * k, device=dev)
    pj = j // 4
    nb = j % 4
    shift = 30 - 2 * (pj % 16)
    fwd = []
    for w in range(W):
        in_w = ((pj // 16) == w)[None, :]
        cleared = cols[w][:, None] & (~(3 << shift) & MASK32)[None, :]
        sub = cleared | (nb << shift)[None, :]
        fwd.append(torch.where(in_w, sub, cols[w][:, None]))
    mask = last_word_mask(k)
    fwd[W - 1] = fwd[W - 1] & mask
    rc = [reverse_bases((~fwd[w]) & MASK32) for w in range(W - 1, -1, -1)]
    rc = _shift_left_cols(rc, 16 * W - k)
    rc[W - 1] = rc[W - 1] & mask
    lt = rc[W - 1] < fwd[W - 1]
    for w in range(W - 2, -1, -1):
        lt = torch.where(rc[w] == fwd[w], lt, rc[w] < fwd[w])
    return [torch.where(lt, rc[w], fwd[w]) for w in range(W)]


class MeshStreamingSpectrum:
    """Persistent hash-sharded spectrum built by streaming batches (the JAX
    MeshStreamingSpectrum): D = mesh.size shard tables of `capacity` rows
    each, on mesh.device.

    capacity = rows a shard. Beyond it, a shard's drain purges singletons,
    exactly as the JAX package does (lowest keys kept). max_capacity >
    capacity lets the tables grow on pressure (4x steps up to
    max_capacity), so their memory follows the distinct keys and the purge
    fires only at the ceiling; max_capacity == 0 keeps the capacity fixed.
    capacity_factor sizes the exchange's buckets over a uniform share (0:
    1.0 at D = 1, 2.0 above, as in JAX)."""

    def __init__(self, mesh: Mesh, k: int, capacity: int,
                 drain_threshold: int = 0, max_capacity: int = 0,
                 capacity_factor: float = 0.0):
        check_k(k)
        self.mesh = mesh
        self.device = mesh.device
        self.D = D = mesh.size
        self.k = k
        self.W = nwords(k)
        self.L = nlanes(self.W)
        self.cap = int(capacity)
        self.max_capacity = int(max_capacity)
        self.capacity_factor = capacity_factor or (1.0 if D == 1 else 2.0)
        self._user_threshold = bool(drain_threshold)
        # staged rows a shard that trigger a merge into the table (a
        # shard's drain sorts cap + staged rows)
        self.drain_threshold = int(drain_threshold) or self.cap // 2
        self.table_lanes = [torch.full((D, self.cap), SENTINEL_LANE,
                                       dtype=torch.int64, device=self.device)
                            for _ in range(self.L)]
        self.table_counts = torch.zeros((D, self.cap), dtype=torch.int32,
                                        device=self.device)
        self.table_weights = torch.zeros((D, self.cap), dtype=torch.float32,
                                         device=self.device)
        # received rows of each batch: (L key lanes, weights), [D, D * width]
        self._staged: List[Tuple[List[torch.Tensor], torch.Tensor]] = []
        self._staged_rows = 0   # D * C a batch, as JAX stages its planes
        self._staged_real = 0   # good windows staged, from the host mask
        self._last_filled = 0   # most rows a shard kept in the last drain
        self.purged_singletons = 0
        self.overflow_retries = 0
        self.drains = 0
        # the last variant purge: sources, rounds and candidate rows searched
        self.purge_stats: Dict[str, int] = {}

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _route(self, codes, mask2d, lengths, weights2d=None,
               with_weights: bool = False):
        """One host batch through the exchange: the reads, padded to a
        multiple of D, split into D contiguous blocks (one a source shard);
        each block's windows that are masked-in and valid go to their
        owners in buckets of C rows, C = ceil(N / D * capacity_factor) for
        N windows a block, doubled while a bucket overflows (the JAX
        retry, counted in overflow_retries, up to 64 N); the planes are as
        wide as the largest bucket (`plane_width`, at most C). Returns
        (received key lanes L x [D, D * width], received weights [D, D *
        width] (weights2d, or 1.0 a window when it is None) or None without
        with_weights, win_slot [D, N] into [D, D * width], C)."""
        D = self.D
        codes, mask2d = np.asarray(codes), np.asarray(mask2d)
        pad = (-codes.shape[0]) % D
        if pad:
            codes, mask2d = _pad_rows(codes, pad), _pad_rows(mask2d, pad)
            lengths = _pad_rows(np.asarray(lengths), pad)
            if weights2d is not None:
                weights2d = _pad_rows(np.asarray(weights2d), pad)
        B, L = codes.shape
        NW = L - self.k + 1
        dev_codes = _unpack_codes_dev(self._to_dev(pack_codes_host(codes)), L)
        dev_mask = _unpack_bits_dev(self._to_dev(pack_bits_host(mask2d)), NW)
        cols, _, valid = extract_canonical_cols(
            dev_codes, self._to_dev(np.asarray(lengths)), self.k)
        del dev_codes
        m = (dev_mask & valid).reshape(D, -1)
        del dev_mask, valid
        N = m.shape[1]
        words = [torch.where(m, c.reshape(D, -1), SENTINEL_WORD)
                 for c in cols]
        del cols
        owner = owners(words, D)
        width = plane_width(bucket_loads(owner, m, D))
        C, retries = bucket_capacity(
            width, math.ceil(N / D * self.capacity_factor), 64 * N)
        self.overflow_retries += retries
        win_slot, _ = bucket_slots(owner, m, D, width)
        del owner
        recv = [exchange(scatter_plane(lane, win_slot, D, width,
                                       SENTINEL_LANE))
                for lane in encode_lanes(words)]
        recv_w = None
        if with_weights:
            w = torch.ones((D, N), dtype=torch.float32, device=self.device) \
                if weights2d is None else self._to_dev(
                    np.asarray(weights2d, np.float32)).reshape(D, -1)
            recv_w = exchange(scatter_plane(w, win_slot, D, width, 0.0))
        return recv, recv_w, win_slot, C

    def add_batch(self, codes, good2d, lengths, weights2d=None):
        """codes [B, L] u8, good2d [B, NW] bool (exact goodness incl. the
        min-weight discard), lengths [B] i32, optional weights2d [B, NW]
        f32 (default 1.0 per good window). Routes and stages the received
        rows; counts D * C staged rows a shard, as JAX stages its C-wide
        planes (sentinel padding included), and drains once they reach
        drain_threshold, so that the drains fall on the JAX batches."""
        recv, recv_w, _, C = self._route(codes, good2d, lengths, weights2d,
                                         with_weights=True)
        self._staged.append((recv, recv_w))
        self._staged_rows += self.D * C
        self._staged_real += int(np.asarray(good2d).sum())
        if self._staged_rows >= self.drain_threshold:
            self._drain()

    def _drain(self):
        if not self._staged:
            return
        D = self.D
        # grow first, so this merge cannot purge below the ceiling: at
        # worst every real staged row is a new key, spread over the shards
        # at twice the uniform share (the JAX allowance for hash skew)
        if self.max_capacity > self.cap:
            self._maybe_grow(
                self._last_filled + (2 * self._staged_real) // D + 1,
                headroom=1)
        staged = self._staged
        self._staged = []
        self._staged_rows = 0
        self._staged_real = 0
        filled = []
        for d in range(D):
            rows = [s[1].reshape(D, -1)[d] for s in staged]
            keys = [torch.cat([self.table_lanes[j][d]]
                              + [s[0][j].reshape(D, -1)[d] for s in staged])
                    for j in range(self.L)]
            counts = torch.cat([self.table_counts[d]]
                               + [torch.ones(r.numel(), dtype=torch.int32,
                                             device=self.device)
                                  for r in rows])
            weights = torch.cat([self.table_weights[d]] + rows)
            del rows
            filled.append(self._drain_shard(d, keys, counts, weights))
        self.drains += 1
        self._last_filled = max(filled)
        self._maybe_grow(self._last_filled)

    def _drain_shard(self, d: int, keys, counts, weights) -> int:
        """Shard d's table becomes the runs of (keys, counts, weights) its
        table rows and staged rows: returns the rows it keeps."""
        # 1) sort by key; run totals at run ends from the run-length kernel
        skeys, perm = sort_lanes(keys)
        del keys
        totals = run_length_sums(skeys, counts[perm])
        is_end = torch.ones_like(totals, dtype=torch.bool)
        neq = skeys[0][1:] != skeys[0][:-1]
        for lane in skeys[1:]:
            neq |= lane[1:] != lane[:-1]
        is_end[:-1] = neq
        ends = torch.nonzero(is_end).squeeze(1)
        run_keys = [lane[ends] for lane in skeys]
        run_counts = totals[ends]
        # run weights: a float64 prefix sum differenced at run ends, then
        # rounded to float32 once
        wcum = torch.cumsum(weights[perm], 0, dtype=torch.float64)[ends]
        run_w = (wcum - torch.cat([wcum.new_zeros(1), wcum[:-1]])).to(
            torch.float32)
        del skeys, perm, totals, is_end, ends, neq, wcum
        # 2) priority compaction to cap rows: solid runs first, then
        # singletons, each in key order (the JAX (prio, key) sort); the
        # selection keeps key order, so the table needs no re-sort. The
        # sentinel run is dropped by its key.
        real = ~is_sentinel(run_keys) & (run_counts > 0)
        n_real = int(real.sum())
        keep = real
        if n_real > self.cap:
            solid = real & (run_counts >= 2)
            single = real & ~solid
            n_solid = int(solid.sum())
            keep = ((solid & (torch.cumsum(solid, 0) <= self.cap))
                    | (single & (torch.cumsum(single, 0)
                                 <= self.cap - min(n_solid, self.cap))))
        filled = self._compact(d, run_keys, run_counts, run_w, keep)
        self.purged_singletons += n_real - filled
        return filled

    def _maybe_grow(self, rows: int, headroom: int = 2):
        """Grow every shard table (4x steps) while rows * headroom > cap,
        up to max_capacity: after a drain with the most rows a shard kept
        (headroom 2: stay at most half full), before one with the most rows
        a shard could keep (headroom 1). The drain threshold follows cap
        unless the caller set it."""
        while (self.max_capacity > self.cap
               and rows * headroom > self.cap):
            pad = min(3 * self.cap, self.max_capacity - self.cap)
            grow = (self.D, pad)
            self.table_lanes = [
                torch.cat([t, torch.full(grow, SENTINEL_LANE,
                                         dtype=torch.int64,
                                         device=self.device)], dim=1)
                for t in self.table_lanes]
            self.table_counts = torch.cat([self.table_counts, torch.zeros(
                grow, dtype=torch.int32, device=self.device)], dim=1)
            self.table_weights = torch.cat([self.table_weights, torch.zeros(
                grow, dtype=torch.float32, device=self.device)], dim=1)
            self.cap += pad
            if not self._user_threshold:
                self.drain_threshold = self.cap // 2
            Log.debug(1, "mesh shard table grew to %d rows/device "
                      "(driving rows %d x%d)" % (self.cap, rows, headroom))

    def _compact(self, d: int, lanes, counts, weights, keep) -> int:
        """Shard d's table becomes the `keep` rows of (lanes, counts,
        weights), in their order, then sentinel rows; returns the rows
        kept."""
        sel = torch.nonzero(keep).squeeze(1)
        filled = sel.numel()
        rows = ([lane[sel] for lane in lanes], counts[sel], weights[sel])
        for j in range(self.L):
            self.table_lanes[j][d].fill_(SENTINEL_LANE)
            self.table_lanes[j][d, :filled] = rows[0][j]
        self.table_counts[d].zero_()
        self.table_counts[d, :filled] = rows[1]
        self.table_weights[d].zero_()
        self.table_weights[d, :filled] = rows[2]
        return filled

    def _search(self, d: int, lanes: List[torch.Tensor]):
        """(pos, hit) of each key in shard d's sorted table: the first row
        not below it (`search_lanes`, clamped to cap - 1) and whether that
        row holds it."""
        tk = [t[d] for t in self.table_lanes]
        pos = search_lanes(tk, lanes, right=False).clamp_(0, self.cap - 1)
        hit = tk[0][pos] == lanes[0]
        for j in range(1, self.L):
            hit &= tk[j][pos] == lanes[j]
        return pos, hit

    # -------------------- lookup (pass 2) --------------------

    def lookup_batch(self, codes, good2d, lengths,
                     min_count: int = 2) -> np.ndarray:
        """Per-window counts [B, NW] int32 for one batch against the
        tables (0 if absent or below min_count). good2d marks the windows
        that WANT counts: each goes to its owner through the exchange, the
        owner searches its shard, and the counts come back the same way."""
        self._drain()
        D = self.D
        B, L = np.shape(codes)
        recv, _, win_slot, _ = self._route(codes, good2d, lengths)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        cnt = torch.zeros_like(recv[0], dtype=torch.int32)
        for d in range(D):
            q = [lane[d] for lane in recv]
            pos, hit = self._search(d, q)
            c = torch.where(hit & ~is_sentinel(q), self.table_counts[d][pos],
                            zero)
            cnt[d] = torch.where(c >= min_count, c, zero)
        del recv
        back = exchange(cnt.reshape(D, D, -1))   # [D_src, D_dst * width]
        counts = torch.where(win_slot >= 0,
                             back.gather(1, win_slot.clamp(min=0)), zero)
        NW = L - self.k + 1
        return counts.reshape(-1, NW)[:B].cpu().numpy()

    # -------------------- on-device variant purge --------------------

    def purge_variants_mesh(self, variant_sigmas: float,
                            edit_distance: int = 2,
                            min_variant_kmer_depth: float = 512,
                            use_weighted: bool = True, min_depth: int = 2,
                            chunk_rows: int = 0) -> int:
        """The variant purge on the device (the JAX purge_variants_mesh):
        the hamming shells of every source (a row above
        min_variant_kmer_depth, in any shard) go to the shards that own
        them, and rows there far less abundant than the source are marked;
        sources marked in one round do not purge in the next, and rounds
        repeat (at most 32) until the marks stop changing. Then marked rows
        are zeroed and rows below min_depth dropped, shard by shard.
        Thresholds in float32 as the JAX mesh path has them. chunk_rows
        bounds the candidate rows searched at once (0: by device,
        PURGE_CHUNK_ROWS). Returns the number of rows purged."""
        if variant_sigmas <= 0.0:
            return 0
        self._drain()
        dist = max(int(edit_distance), 1)
        if use_weighted:
            vals0 = self.table_weights
        else:
            vals0 = self.table_counts.to(torch.float32)
        active0 = ((vals0 > _f32(min_variant_kmer_depth, self.device))
                   & (self.table_counts > 0))
        prev = torch.zeros_like(active0)
        chunk_rows = chunk_rows or PURGE_CHUNK_ROWS.get(self.device.type,
                                                        1 << 20)
        self.purge_stats = {"sources": 0, "rounds": 0, "candidates": 0}
        for _ in range(32):
            marks = self._purge_round(vals0, active0 & ~prev,
                                      float(variant_sigmas), dist,
                                      float(min_variant_kmer_depth),
                                      chunk_rows)
            self.purge_stats["rounds"] += 1
            changed = bool((marks != prev).any())
            prev = marks
            if not changed:
                break
        n_purged = int(prev.sum())
        self._apply_purge(prev, max(min_depth, 1))
        return n_purged

    def _purge_round(self, vals0, active, sigmas: float, dist: int,
                     min_var: float, chunk_rows: int) -> torch.Tensor:
        """The marks [D, cap] bool that the `active` sources set: the JAX
        `_purge_round_fn` over every chunk of a round. A candidate is
        searched in the shard that owns it (its owner hash), the one shard
        where the JAX exchange would take it."""
        dev, k, cap, D = self.device, self.k, self.cap, self.D
        flat_lanes = [t.reshape(-1) for t in self.table_lanes]
        src = torch.nonzero(active.reshape(-1)).squeeze(1)
        v = vals0.reshape(-1)[src]
        thr = _fma_sub_f32(v, _sqrt_f32(v), _f32(sigmas, dev))
        d = torch.full_like(src, dist)
        for _ in range(dist - 1):
            lim = _f32(min_var, dev) * (20 ^ d).to(torch.float32)
            d = torch.where((d > 1) & ~(v > lim), d - 1, d)
        self.purge_stats["sources"] += src.numel()
        marks = torch.zeros((D, cap + 1), dtype=torch.bool, device=dev)
        for dd in range(1, dist + 1):
            group = d == dd
            g_src, g_thr = src[group], thr[group]
            per_source = sum((4 * k) ** e for e in range(1, dd + 1))
            step = max(chunk_rows // per_source, 1)
            for s0 in range(0, g_src.numel(), step):
                idx = g_src[s0:s0 + step]
                frontier = decode_lanes([lane[idx] for lane in flat_lanes],
                                        self.W)
                fthr = g_thr[s0:s0 + step]
                for e in range(1, dd + 1):
                    frontier = [c.reshape(-1)
                                for c in _shell_cols(frontier, k)]
                    fthr = fthr.repeat_interleave(4 * k)
                    lanes = encode_lanes(frontier)
                    owner = owners(frontier, D)
                    lim = fthr * _recip_f32(20 ^ (e - 1), dev)
                    for o in range(D):
                        sel = torch.nonzero(owner == o).squeeze(1)
                        q = [lane[sel] for lane in lanes]
                        pos, hit = self._search(o, q)
                        val = vals0[o][pos]
                        victim = (hit & ~is_sentinel(q) & (val > 0.0)
                                  & (val < lim[sel]))
                        marks[o][torch.where(victim, pos, cap)] = True
                    self.purge_stats["candidates"] += lanes[0].numel()
        return marks[:, :cap]

    def _apply_purge(self, marks: torch.Tensor, min_depth: int) -> None:
        """Zero the marked rows and drop rows below min_depth, shard by
        shard (the JAX `_apply_purge_fn`). Its re-sort becomes a compaction
        that keeps key order: table keys are unique and every dropped row
        is the same (sentinel, 0, 0.0), so the two give one table."""
        counts = torch.where(marks, torch.zeros_like(self.table_counts),
                             self.table_counts)
        weights = torch.where(marks, torch.zeros_like(self.table_weights),
                              self.table_weights)
        for d in range(self.D):
            self._compact(d, [t[d] for t in self.table_lanes], counts[d],
                          weights[d], counts[d] >= min_depth)

    def purge_min_depth(self, min_depth: int) -> None:
        """Drop below-min-depth rows from the tables (the mesh analogue of
        KmerSpectrum.purge_min_depth). Runs before purge_variants_mesh, as
        the host purge removes singletons first, so they are never variant
        sources."""
        if min_depth <= 1:
            return
        self._drain()
        self._apply_purge(torch.zeros_like(self.table_counts,
                                           dtype=torch.bool), min_depth)

    # -------------------- state carry --------------------

    def to_numpy_tables(self):
        """The tables as they stand (staged rows not merged), in the JAX
        layout: (key word planes [W, D, cap] u32, counts [D, cap] i32,
        weights [D, cap] f32)."""
        cols = decode_lanes(self.table_lanes, self.W)
        planes = np.stack([c.cpu().numpy().astype(np.uint32) for c in cols])
        return (planes, self.table_counts.cpu().numpy(),
                self.table_weights.cpu().numpy())

    def from_numpy_tables(self, cols, counts, weights):
        """Replace the tables with JAX-layout ones (key word planes
        [W, D, cap] u32, counts [D, cap] i32, weights [D, cap] f32), each
        shard key-sorted with sentinels trailing, as the JAX drain leaves
        it. Staged rows are dropped."""
        cols = np.asarray(cols)
        shape = (self.W, self.D, self.cap)
        if cols.shape != shape:
            raise ValueError("expected key planes of shape %s, got %s"
                             % (shape, cols.shape))
        lanes = encode_lanes([torch.tensor(cols[w].astype(np.int64),
                                           device=self.device)
                              for w in range(self.W)])
        if bool(_lanes_less([x[:, 1:] for x in lanes],
                            [x[:, :-1] for x in lanes]).any()):
            raise ValueError("table keys are not sorted")
        self.table_lanes = lanes
        # torch.tensor copies: the table never aliases the caller's arrays
        self.table_counts = torch.tensor(
            np.asarray(counts, np.int32).reshape(self.D, self.cap),
            device=self.device)
        self.table_weights = torch.tensor(
            np.asarray(weights, np.float32).reshape(self.D, self.cap),
            device=self.device)
        self._staged = []
        self._staged_rows = 0
        self._staged_real = 0

    def set_table(self, keys: np.ndarray, counts: np.ndarray,
                  weights: np.ndarray = None):
        """Replace the tables from a host (keys [M, W] u32, counts [M])
        table (the JAX set_table): each key goes to the shard its owner
        hash names, and each shard is key-sorted with sentinels trailing.
        Weights default to the counts. Raises when a shard overflows its
        capacity. Staged rows are dropped."""
        D, cap, W = self.D, self.cap, self.W
        keys = np.asarray(keys, np.uint32).reshape(-1, W)
        kcols = np.full((W, D, cap), 0xFFFFFFFF, np.uint32)
        ccols = np.zeros((D, cap), np.int32)
        wcols = np.zeros((D, cap), np.float32)
        if len(keys):
            if weights is None:
                weights = np.asarray(counts).astype(np.float32)
            own = owners([torch.from_numpy(keys[:, w].astype(np.int64))
                          for w in range(W)], D).numpy()
            for d in range(D):
                sel = np.flatnonzero(own == d)
                if len(sel) > cap:
                    raise RuntimeError("shard %d overflows capacity" % d)
                sel = sel[np.argsort(pack_keys(keys[sel]), kind="stable")]
                kcols[:, d, :len(sel)] = keys[sel].T
                ccols[d, :len(sel)] = np.asarray(counts)[sel]
                wcols[d, :len(sel)] = np.asarray(weights)[sel]
        self.from_numpy_tables(kcols, ccols, wcols)

    # -------------------- host extraction --------------------

    def finalize(self, min_depth: int = 2, with_weights: bool = False):
        """Tables to host: (keys [M, W] u32 sorted, counts [, weights]).
        The shards laid end to end are not in key order, so the keys are
        sorted on the host, as the JAX finalize sorts them."""
        self._drain()
        cnt = self.table_counts.cpu().numpy().reshape(-1)
        wt = self.table_weights.cpu().numpy().reshape(-1)
        real = cnt >= min_depth
        ks = [c.cpu().numpy().reshape(-1).astype(np.uint32)
              for c in decode_lanes(self.table_lanes, self.W)]
        keys = np.stack([c[real] for c in ks], axis=-1)
        counts = cnt[real]
        weights = wt[real]
        order = np.argsort(pack_keys(keys), kind="stable")
        if with_weights:
            return (keys[order], counts[order].astype(np.int64),
                    weights[order].astype(np.float64))
        return keys[order], counts[order].astype(np.int64)

    def to_host_spectrum(self, min_depth: int = 2):
        keys, counts, weights = self.finalize(min_depth, with_weights=True)
        sp = KmerSpectrum(k=self.k)
        sp.keys = pack_keys(keys) if len(keys) else np.zeros(0, np.uint64)
        sp.counts = counts
        sp.weighted = weights
        return sp
