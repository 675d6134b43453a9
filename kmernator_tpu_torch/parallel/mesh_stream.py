"""Streaming shard table on one device: the port of mesh_stream.py at D=1.

Twin of kmernator_tpu/parallel/mesh_stream.py `MeshStreamingSpectrum` on a
one-device mesh, where the owner hash, bucket scatter and all_to_all are
the identity:

  route:   unpack the 2-bit codes and 1-bit good mask, extract canonical
           keys, pre-mask non-good windows to the sentinel; the N = B * NW
           masked keys of a batch are STAGED (as the JAX package stages its
           D * C = N received rows), no per-batch sort.
  drain:   once staged rows reach drain_threshold, sort (table + staged) on
           the int64 key lane, take run totals from the run-length kernel,
           and compact to `cap` rows: all solid (count >= 2) runs first,
           then singletons, each in key order, so the table stays sorted
           without the JAX package's two further sorts.
  lookup:  binary search (torch.searchsorted) of each window's key lane in
           the sorted table.

The table is one int64 key lane, int32 counts and float32 weights, each
[cap] on the mesh's device. Keys and counts are bit-equal to the JAX
drain's. Run weights are taken the JAX drain's way (its mesh_stream.py
`_drain_fn`): a float32 inclusive prefix sum over the whole sorted drain,
the run's prefix at its end less the exclusive prefix at its start. The
prefix sums round in another order than XLA's (torch accumulates a CPU
float32 cumsum in float64 and a CUDA one in a float32 tree scan; the
sorts also order equal keys differently), so a run weight differs from
the JAX one by a few float32 ulps of the drain's total weight: the tests
hold them to 1e-6 of it.

Not ported yet (off both D=1 FilterReads paths): grow-on-pressure
(max_capacity, _maybe_grow), purge_min_depth, purge_variants_mesh and
set_table.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from kmernator_tpu_torch.ops.kmer import (SENTINEL_LANE, check_k,
                                          decode_lane, encode_lane, nwords)
from kmernator_tpu_torch.parallel.device_spectrum import (
    extract_canonical_cols)
from kmernator_tpu_torch.parallel.mesh import Mesh
from kmernator_tpu_torch.parallel.run_length import run_length_sums
from kmernator_tpu_torch.parallel.spectrum import KmerSpectrum, pack_keys


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


class MeshStreamingSpectrum:
    """Persistent sorted spectrum table on one device, built by streaming
    batches (the JAX MeshStreamingSpectrum on make_mesh(1)).

    capacity = table rows. Beyond it, the drain purges singletons, exactly
    as the JAX package does (lowest keys kept)."""

    def __init__(self, mesh: Mesh, k: int, capacity: int,
                 drain_threshold: int = 0):
        check_k(k)
        if mesh.size != 1:
            raise NotImplementedError("MeshStreamingSpectrum runs on one "
                                      "device; D > 1 waits for a later PR")
        self.mesh = mesh
        self.device = mesh.device
        self.k = k
        self.W = nwords(k)
        self.cap = int(capacity)
        # staged rows that trigger a merge into the table (the drain sorts
        # cap + staged rows)
        self.drain_threshold = int(drain_threshold) or self.cap // 2
        self.table_keys = torch.full((self.cap,), SENTINEL_LANE,
                                     dtype=torch.int64, device=self.device)
        self.table_counts = torch.zeros(self.cap, dtype=torch.int32,
                                        device=self.device)
        self.table_weights = torch.zeros(self.cap, dtype=torch.float32,
                                         device=self.device)
        self._staged: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._staged_rows = 0
        self.purged_singletons = 0
        self.drains = 0

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _window_lanes(self, codes, mask2d, lengths):
        """Host batch -> (key lanes [N], sentinel where the window is not
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
        lanes = encode_lane([c.reshape(-1) for c in cols])
        sent = torch.full((), SENTINEL_LANE, dtype=torch.int64,
                          device=self.device)
        return torch.where(m, lanes, sent), m

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
        self._staged_rows += lanes.numel()
        if self._staged_rows >= self.drain_threshold:
            self._drain()

    def _drain(self):
        if not self._staged:
            return
        keys = torch.cat([self.table_keys] + [s[0] for s in self._staged])
        counts = torch.cat([self.table_counts]
                           + [torch.ones(s[0].numel(), dtype=torch.int32,
                                         device=self.device)
                              for s in self._staged])
        weights = torch.cat([self.table_weights]
                            + [s[1] for s in self._staged])
        self._staged = []
        self._staged_rows = 0
        # 1) sort by key; run totals at run ends from the run-length kernel
        skeys, perm = torch.sort(keys)
        del keys
        totals = run_length_sums(skeys, counts[perm])
        is_end = torch.ones_like(skeys, dtype=torch.bool)
        is_end[:-1] = skeys[1:] != skeys[:-1]
        ends = torch.nonzero(is_end).squeeze(1)
        run_keys = skeys[ends]
        run_counts = totals[ends]
        # run weights as the JAX drain takes them: a float32 inclusive
        # prefix sum, at the run's end less the exclusive one at its start
        sw = weights[perm]
        wcum = torch.cumsum(sw, 0, dtype=torch.float32)
        starts = torch.zeros_like(ends)
        starts[1:] = ends[:-1] + 1
        run_w = wcum[ends] - (wcum[starts] - sw[starts])
        del skeys, perm, totals, is_end, ends, starts, sw, wcum
        # 2) priority compaction to cap rows: solid runs first, then
        # singletons, each in key order (the JAX (prio, key) sort); the
        # selection keeps key order, so the table needs no re-sort
        real = (run_keys != SENTINEL_LANE) & (run_counts > 0)
        n_real = int(real.sum())
        keep = real
        if n_real > self.cap:
            solid = real & (run_counts >= 2)
            single = real & ~solid
            n_solid = int(solid.sum())
            keep = ((solid & (torch.cumsum(solid, 0) <= self.cap))
                    | (single & (torch.cumsum(single, 0)
                                 <= self.cap - min(n_solid, self.cap))))
        sel = torch.nonzero(keep).squeeze(1)
        filled = sel.numel()
        self.table_keys = torch.full_like(self.table_keys, SENTINEL_LANE)
        self.table_keys[:filled] = run_keys[sel]
        self.table_counts = torch.zeros_like(self.table_counts)
        self.table_counts[:filled] = run_counts[sel]
        self.table_weights = torch.zeros_like(self.table_weights)
        self.table_weights[:filled] = run_w[sel]
        self.purged_singletons += n_real - filled
        self.drains += 1

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
        pos = torch.searchsorted(self.table_keys, lanes).clamp_(
            max=self.cap - 1)
        hit = q & (self.table_keys[pos] == lanes)
        cnt = torch.where(hit, self.table_counts[pos],
                          torch.zeros((), dtype=torch.int32,
                                      device=self.device))
        cnt = torch.where(cnt >= min_count, cnt, torch.zeros_like(cnt))
        return cnt.reshape(B, L - self.k + 1).cpu().numpy()

    # -------------------- state carry --------------------

    def to_numpy_tables(self):
        """The table as it stands (staged rows not merged), in the JAX
        layout: (key word planes [W, 1, cap] u32, counts [1, cap] i32,
        weights [1, cap] f32)."""
        cols = decode_lane(self.table_keys, self.W)
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
        lanes = encode_lane([torch.tensor(cols[w, 0].astype(np.int64),
                                          device=self.device)
                             for w in range(self.W)])
        if bool((lanes[1:] < lanes[:-1]).any()):
            raise ValueError("table keys are not sorted")
        self.table_keys = lanes
        # torch.tensor copies: the table never aliases the caller's arrays
        self.table_counts = torch.tensor(
            np.asarray(counts, np.int32).reshape(self.cap), device=self.device)
        self.table_weights = torch.tensor(
            np.asarray(weights, np.float32).reshape(self.cap),
            device=self.device)
        self._staged = []
        self._staged_rows = 0

    # -------------------- host extraction --------------------

    def finalize(self, min_depth: int = 2, with_weights: bool = False):
        """Table to host: (keys [M, W] u32 sorted, counts [, weights])."""
        self._drain()
        cnt = self.table_counts.cpu().numpy()
        wt = self.table_weights.cpu().numpy()
        real = cnt >= min_depth
        ks = [c.cpu().numpy().astype(np.uint32)
              for c in decode_lane(self.table_keys, self.W)]
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
