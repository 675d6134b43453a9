"""Streaming shard table on one device: the port of mesh_stream.py at D=1.

Twin of kmernator_tpu/parallel/mesh_stream.py `MeshStreamingSpectrum` on a
one-device mesh, where the owner hash, bucket scatter and all_to_all are
the identity:

  route:   unpack the 2-bit codes and 1-bit good mask, extract canonical
           keys, pre-mask non-good windows to the sentinel; the N = B * NW
           masked keys of a batch are STAGED (as the JAX package stages its
           D * C = N received rows), no per-batch sort.
  drain:   once staged rows reach drain_threshold, sort (table + staged) on
           the key lanes, take run totals from the run-length kernel, and
           compact to `cap` rows: all solid (count >= 2) runs first, then
           singletons, each in key order, so the table stays sorted
           without the JAX package's two further sorts.
  lookup:  binary search of each window's key in the sorted table
           (device_spectrum.py `search_lanes`: torch.searchsorted on one
           lane; for L > 1 lanes the JAX package's lexicographic search,
           ceil(log2 cap) + 1 probes).
  purge:   the on-device variant purge (`purge_variants_mesh`, with
           `_shell_cols`, the purge rounds and `_apply_purge_fn` of the JAX
           module) and `purge_min_depth`, over the same table; `set_table`
           loads a host table.

The table is L = ceil(W/2) int64 key lanes (ops/kmer.py encode_lanes: one
lane for k <= 32, up to 3 for k <= 96), int32 counts and float32 weights,
each [cap] on the mesh's device. Keys and counts are bit-equal to the JAX
drain's. Run weights are sums of the run's window weights taken from a
float64 prefix sum over the whole sorted drain, differenced at run ends and
rounded to float32 once. The JAX drain (its `_drain_fn`) differences a
float32 prefix instead, whose rounding grows with the drain's total weight:
past a total of 2^23 a float32 ulp is 1, so a run of weight under 1 can
come out as 0 or 1 there. The two agree to a few float32 ulps of the
drain's total weight (the tests hold them to 1e-6 of it); the port's run
weights are the host engine's float64 sums to float32 rounding.

Differences from the JAX purge, none of which changes its marks (a set
union over candidates): the sources of a round are taken in groups of one
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
`_pad_table_fn`): before a drain the table grows until it can take every
real staged row as a new key (headroom 1), after it until it is at most
half full (headroom 2), 4x a step up to max_capacity. A step appends
sentinel rows, which sort last, so the table stays sorted. At D = 1 the
steps are the JAX ones row for row: the same count of real staged rows
(the host good mask, padding included as zeros) and the same rows kept by
a drain.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from kmernator_tpu_torch.ops.kmer import (MASK32, SENTINEL_LANE, check_k,
                                          decode_lanes, encode_lanes,
                                          last_word_mask, nlanes, nwords,
                                          reverse_bases)
from kmernator_tpu_torch.parallel.device_spectrum import (
    _shift_left_cols, extract_canonical_cols, is_sentinel, search_lanes,
    sort_lanes)
from kmernator_tpu_torch.parallel.mesh import Mesh
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
    """Persistent sorted spectrum table on one device, built by streaming
    batches (the JAX MeshStreamingSpectrum on make_mesh(1)).

    capacity = table rows. Beyond it, the drain purges singletons, exactly
    as the JAX package does (lowest keys kept). max_capacity > capacity
    lets the table grow on pressure (4x steps up to max_capacity), so its
    memory follows the distinct keys and the purge fires only at the
    ceiling; max_capacity == 0 keeps the capacity fixed."""

    def __init__(self, mesh: Mesh, k: int, capacity: int,
                 drain_threshold: int = 0, max_capacity: int = 0):
        check_k(k)
        if mesh.size != 1:
            raise NotImplementedError("MeshStreamingSpectrum runs on one "
                                      "device; D > 1 waits for a later PR")
        self.mesh = mesh
        self.device = mesh.device
        self.k = k
        self.W = nwords(k)
        self.L = nlanes(self.W)
        self.cap = int(capacity)
        self.max_capacity = int(max_capacity)
        self._user_threshold = bool(drain_threshold)
        # staged rows that trigger a merge into the table (the drain sorts
        # cap + staged rows)
        self.drain_threshold = int(drain_threshold) or self.cap // 2
        self.table_lanes = [torch.full((self.cap,), SENTINEL_LANE,
                                       dtype=torch.int64, device=self.device)
                            for _ in range(self.L)]
        self.table_counts = torch.zeros(self.cap, dtype=torch.int32,
                                        device=self.device)
        self.table_weights = torch.zeros(self.cap, dtype=torch.float32,
                                         device=self.device)
        self._staged: List[Tuple[List[torch.Tensor], torch.Tensor]] = []
        self._staged_rows = 0
        self._staged_real = 0   # good windows staged, from the host mask
        self._last_filled = 0   # table rows kept by the last drain
        self.purged_singletons = 0
        self.drains = 0
        # the last variant purge: sources, rounds and candidate rows searched
        self.purge_stats: Dict[str, int] = {}

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sentinel(self) -> torch.Tensor:
        return torch.full((), SENTINEL_LANE, dtype=torch.int64,
                          device=self.device)

    def _window_lanes(self, codes, mask2d, lengths):
        """Host batch -> (L key lanes [N], sentinel where the window is not
        both masked-in and valid; in-mask flags [N])."""
        codes = np.asarray(codes)
        B, L = codes.shape
        NW = L - self.k + 1
        dev_codes = _unpack_codes_dev(self._to_dev(pack_codes_host(codes)), L)
        dev_mask = _unpack_bits_dev(
            self._to_dev(pack_bits_host(np.asarray(mask2d))), NW)
        cols, _, valid = extract_canonical_cols(
            dev_codes, self._to_dev(np.asarray(lengths)), self.k)
        m = (dev_mask & valid).reshape(-1)
        sent = self._sentinel()
        return [torch.where(m, lane, sent)
                for lane in encode_lanes([c.reshape(-1) for c in cols])], m

    def add_batch(self, codes, good2d, lengths, weights2d=None):
        """codes [B, L] u8, good2d [B, NW] bool (exact goodness incl. the
        min-weight discard), lengths [B] i32, optional weights2d [B, NW]
        f32 (default 1.0 per good window). Routes and stages; drains once
        staged rows reach drain_threshold."""
        lanes, g = self._window_lanes(codes, good2d, lengths)
        if weights2d is None:
            w = g.to(torch.float32)
        else:
            w = self._to_dev(np.asarray(weights2d, np.float32)).reshape(-1)
            w = torch.where(g, w, torch.zeros_like(w))
        self._staged.append((lanes, w))
        self._staged_rows += lanes[0].numel()
        self._staged_real += int(np.asarray(good2d).sum())
        if self._staged_rows >= self.drain_threshold:
            self._drain()

    def _drain(self):
        if not self._staged:
            return
        # grow first, so this merge cannot purge below the ceiling: at
        # worst every real staged row is a new key (x2, the JAX package's
        # allowance for hash skew between shards, kept so that the steps
        # are its steps)
        if self.max_capacity > self.cap:
            self._maybe_grow(self._last_filled + 2 * self._staged_real + 1,
                             headroom=1)
        keys = [torch.cat([self.table_lanes[j]]
                          + [s[0][j] for s in self._staged])
                for j in range(self.L)]
        counts = torch.cat([self.table_counts]
                           + [torch.ones(s[1].numel(), dtype=torch.int32,
                                         device=self.device)
                              for s in self._staged])
        weights = torch.cat([self.table_weights]
                            + [s[1] for s in self._staged])
        self._staged = []
        self._staged_rows = 0
        self._staged_real = 0
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
        # selection keeps key order, so the table needs no re-sort
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
        filled = self._compact(run_keys, run_counts, run_w, keep)
        self.purged_singletons += n_real - filled
        self.drains += 1
        self._last_filled = filled
        self._maybe_grow(filled)

    def _maybe_grow(self, rows: int, headroom: int = 2):
        """Grow the table (4x steps) while rows * headroom > cap, up to
        max_capacity: after a drain with the rows it kept (headroom 2: stay
        at most half full), before one with the most rows it could keep
        (headroom 1). The drain threshold follows cap unless the caller set
        it."""
        while (self.max_capacity > self.cap
               and rows * headroom > self.cap):
            pad = min(3 * self.cap, self.max_capacity - self.cap)
            self.table_lanes = [
                torch.cat([t, torch.full((pad,), SENTINEL_LANE,
                                         dtype=torch.int64,
                                         device=self.device)])
                for t in self.table_lanes]
            self.table_counts = torch.cat([self.table_counts, torch.zeros(
                pad, dtype=torch.int32, device=self.device)])
            self.table_weights = torch.cat([self.table_weights, torch.zeros(
                pad, dtype=torch.float32, device=self.device)])
            self.cap += pad
            if not self._user_threshold:
                self.drain_threshold = self.cap // 2
            Log.debug(1, "mesh shard table grew to %d rows/device "
                      "(driving rows %d x%d)" % (self.cap, rows, headroom))

    def _compact(self, lanes, counts, weights, keep) -> int:
        """The table becomes the `keep` rows of (lanes, counts, weights), in
        their order, then sentinel rows; returns the rows kept."""
        sel = torch.nonzero(keep).squeeze(1)
        filled = sel.numel()
        for j in range(self.L):
            t = torch.full_like(self.table_lanes[j], SENTINEL_LANE)
            t[:filled] = lanes[j][sel]
            self.table_lanes[j] = t
        self.table_counts = torch.zeros_like(self.table_counts)
        self.table_counts[:filled] = counts[sel]
        self.table_weights = torch.zeros_like(self.table_weights)
        self.table_weights[:filled] = weights[sel]
        return filled

    def _search(self, lanes: List[torch.Tensor]):
        """(pos, hit) of each key in the sorted table: the first row not
        below it (`search_lanes`, clamped to cap - 1) and whether that row
        holds it."""
        tk = self.table_lanes
        pos = search_lanes(tk, lanes, right=False).clamp_(0, self.cap - 1)
        hit = tk[0][pos] == lanes[0]
        for j in range(1, self.L):
            hit &= tk[j][pos] == lanes[j]
        return pos, hit

    # -------------------- lookup (pass 2) --------------------

    def lookup_batch(self, codes, good2d, lengths,
                     min_count: int = 2) -> np.ndarray:
        """Per-window counts [B, NW] int32 for one batch against the table
        (0 if absent or below min_count). good2d marks the windows that
        WANT counts."""
        self._drain()
        codes = np.asarray(codes)
        B, L = codes.shape
        lanes, q = self._window_lanes(codes, good2d, lengths)
        pos, hit = self._search(lanes)
        cnt = torch.where(q & hit, self.table_counts[pos],
                          torch.zeros((), dtype=torch.int32,
                                      device=self.device))
        cnt = torch.where(cnt >= min_count, cnt, torch.zeros_like(cnt))
        return cnt.reshape(B, L - self.k + 1).cpu().numpy()

    # -------------------- on-device variant purge --------------------

    def purge_variants_mesh(self, variant_sigmas: float,
                            edit_distance: int = 2,
                            min_variant_kmer_depth: float = 512,
                            use_weighted: bool = True, min_depth: int = 2,
                            chunk_rows: int = 0) -> int:
        """The variant purge on the device (the JAX purge_variants_mesh at
        D=1): the hamming shells of every source (a row above
        min_variant_kmer_depth) are searched in the table, and rows far
        less abundant than a source are marked; sources marked in one round
        do not purge in the next, and rounds repeat (at most 32) until the
        marks stop changing. Then marked rows are zeroed and rows below
        min_depth dropped. Thresholds in float32 as the JAX mesh path has
        them. chunk_rows bounds the candidate rows searched at once (0: by
        device, PURGE_CHUNK_ROWS). Returns the number of rows purged."""
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
        prev = torch.zeros(self.cap, dtype=torch.bool, device=self.device)
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
        """The marks [cap] bool that the `active` sources set: the JAX
        `_purge_round_fn` over every chunk of a round."""
        dev, k, cap = self.device, self.k, self.cap
        src = torch.nonzero(active).squeeze(1)
        v = vals0[src]
        thr = _fma_sub_f32(v, _sqrt_f32(v), _f32(sigmas, dev))
        d = torch.full_like(src, dist)
        for _ in range(dist - 1):
            lim = _f32(min_var, dev) * (20 ^ d).to(torch.float32)
            d = torch.where((d > 1) & ~(v > lim), d - 1, d)
        self.purge_stats["sources"] += src.numel()
        marks = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        for dd in range(1, dist + 1):
            group = d == dd
            g_src, g_thr = src[group], thr[group]
            per_source = sum((4 * k) ** e for e in range(1, dd + 1))
            step = max(chunk_rows // per_source, 1)
            for s0 in range(0, g_src.numel(), step):
                idx = g_src[s0:s0 + step]
                frontier = decode_lanes([lane[idx] for lane in
                                         self.table_lanes], self.W)
                fthr = g_thr[s0:s0 + step]
                for e in range(1, dd + 1):
                    frontier = [c.reshape(-1)
                                for c in _shell_cols(frontier, k)]
                    fthr = fthr.repeat_interleave(4 * k)
                    lanes = encode_lanes(frontier)
                    pos, hit = self._search(lanes)
                    q = vals0[pos]
                    victim = (hit & ~is_sentinel(lanes) & (q > 0.0)
                              & (q < fthr * _recip_f32(20 ^ (e - 1), dev)))
                    marks[torch.where(victim, pos, cap)] = True
                    self.purge_stats["candidates"] += pos.numel()
        return marks[:cap]

    def _apply_purge(self, marks: torch.Tensor, min_depth: int) -> None:
        """Zero the marked rows and drop rows below min_depth (the JAX
        `_apply_purge_fn`). Its re-sort becomes a compaction that keeps key
        order: table keys are unique and every dropped row is the same
        (sentinel, 0, 0.0), so the two give one table."""
        counts = torch.where(marks, torch.zeros_like(self.table_counts),
                             self.table_counts)
        weights = torch.where(marks, torch.zeros_like(self.table_weights),
                              self.table_weights)
        self._compact(self.table_lanes, counts, weights, counts >= min_depth)

    def purge_min_depth(self, min_depth: int) -> None:
        """Drop below-min-depth rows from the table (the mesh analogue of
        KmerSpectrum.purge_min_depth). Runs before purge_variants_mesh, as
        the host purge removes singletons first, so they are never variant
        sources."""
        if min_depth <= 1:
            return
        self._drain()
        self._apply_purge(torch.zeros(self.cap, dtype=torch.bool,
                                      device=self.device), min_depth)

    # -------------------- state carry --------------------

    def to_numpy_tables(self):
        """The table as it stands (staged rows not merged), in the JAX
        layout: (key word planes [W, 1, cap] u32, counts [1, cap] i32,
        weights [1, cap] f32)."""
        cols = decode_lanes(self.table_lanes, self.W)
        planes = np.stack([c.cpu().numpy().astype(np.uint32)
                           for c in cols])[:, None, :]
        return (planes, self.table_counts.cpu().numpy()[None, :],
                self.table_weights.cpu().numpy()[None, :])

    def from_numpy_tables(self, cols, counts, weights):
        """Replace the table with a JAX-layout one (key word planes
        [W, 1, cap] u32, counts [1, cap] i32, weights [1, cap] f32),
        key-sorted with sentinels trailing, as the JAX drain leaves it.
        Staged rows are dropped."""
        cols = np.asarray(cols)
        if cols.shape != (self.W, 1, self.cap):
            raise ValueError("expected key planes of shape %s, got %s"
                             % ((self.W, 1, self.cap), cols.shape))
        lanes = encode_lanes([torch.tensor(cols[w, 0].astype(np.int64),
                                           device=self.device)
                              for w in range(self.W)])
        if bool(_lanes_less([x[1:] for x in lanes],
                            [x[:-1] for x in lanes]).any()):
            raise ValueError("table keys are not sorted")
        self.table_lanes = lanes
        # torch.tensor copies: the table never aliases the caller's arrays
        self.table_counts = torch.tensor(
            np.asarray(counts, np.int32).reshape(self.cap), device=self.device)
        self.table_weights = torch.tensor(
            np.asarray(weights, np.float32).reshape(self.cap),
            device=self.device)
        self._staged = []
        self._staged_rows = 0
        self._staged_real = 0

    def set_table(self, keys: np.ndarray, counts: np.ndarray,
                  weights: np.ndarray = None):
        """Replace the table from a host (keys [M, W] u32, counts [M])
        table, key-sorted with sentinels trailing (the JAX set_table at
        D=1: every key's owner is the one shard). Weights default to the
        counts. Staged rows are dropped."""
        keys = np.asarray(keys, np.uint32).reshape(-1, self.W)
        if len(keys) > self.cap:
            raise RuntimeError("shard 0 overflows capacity")
        kcols = np.full((self.W, self.cap), 0xFFFFFFFF, np.uint32)
        ccols = np.zeros(self.cap, np.int32)
        wcols = np.zeros(self.cap, np.float32)
        if len(keys):
            if weights is None:
                weights = np.asarray(counts).astype(np.float32)
            order = np.argsort(pack_keys(keys), kind="stable")
            kcols[:, :len(keys)] = keys[order].T
            ccols[:len(keys)] = np.asarray(counts)[order]
            wcols[:len(keys)] = np.asarray(weights)[order]
        self.from_numpy_tables(kcols[:, None, :], ccols, wcols)

    # -------------------- host extraction --------------------

    def finalize(self, min_depth: int = 2, with_weights: bool = False):
        """Table to host: (keys [M, W] u32 sorted, counts [, weights])."""
        self._drain()
        cnt = self.table_counts.cpu().numpy()
        wt = self.table_weights.cpu().numpy()
        real = cnt >= min_depth
        ks = [c.cpu().numpy().astype(np.uint32)
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
