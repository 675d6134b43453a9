"""Streaming spectrum build in PyTorch: FASTQ batches -> a running table on
the device.

Twin of kmernator_tpu/parallel/pipeline.py (the reference's
buildKmerSpectrumInParts and streaming build, ref:
src/KmerSpectrum.h:1818-1902): each batch is extracted, weighted and
counted on the device (`extract_canonical_cols`, `window_good` and
`count_batch`: one sort and one run-length launch a batch), and the batch
tables are staged and merged into a table of `capacity` rows
(`merge_tables`: one sort and one run-length launch a drain), so an input
of any size streams through a fixed device footprint. Past capacity a
drain purges singletons, as the reference does under memory pressure.

Differences from the JAX module besides the torch tensors:
- The device is explicit: `device=`, default cuda (which raises without
  a GPU); a CPU device takes the kernels' plain versions.
- The table is [capacity, W] int64 words (ops/kmer.py), as count_batch
  returns them; `finalize` returns uint32 words, as the JAX one does.
- `window_good` leaves zero-probability bases out of its prefix (ROADMAP
  queue 3, item o): on reads with such bases (N markup, qualities of
  probability 0) the good masks, and so the tables, differ from JAX's
  after a read's first such base, where the JAX mask passes every window.
- The JAX package jits three batch steps (float32 logp, raw qualities
  with a 256-entry table, 2-bit codes with raw qualities); here the table
  lookup and the unpack run first and one `_batch_table` follows.
- `_purge_compact` orders solid rows, then singletons, by a stable
  partition of the merged rows, which merge_tables returns in key order;
  the JAX one sorts by (priority, key).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable

import numpy as np
import torch

from kmernator_tpu_torch.ops.kmer import SENTINEL_WORD, check_k, nwords
from kmernator_tpu_torch.parallel.device_spectrum import (
    count_batch, extract_canonical_cols, merge_tables, window_good)


class StreamingSpectrum:
    """Running (keys, counts) table on `device`, built by merging batch
    tables. capacity: the table's rows; drain_threshold: staged rows that
    trigger a merge (default max(capacity // 2, 65,536): a drain sorts at
    most 1.5x the table)."""

    def __init__(self, k: int, capacity: int, min_weight: float = 0.10,
                 drain_threshold: int = 0, device="cuda"):
        check_k(k)
        self.k = k
        self.capacity = capacity
        self.device = torch.device(device)
        self.drain_threshold = drain_threshold or max(capacity // 2, 1 << 16)
        self.keys = torch.full((capacity, nwords(k)), SENTINEL_WORD,
                               dtype=torch.int64, device=self.device)
        self.counts = torch.zeros(capacity, dtype=torch.int32,
                                  device=self.device)
        self.log2_min_weight = (float(np.log2(min_weight)) if min_weight > 0
                                else -1e30)
        self.total_windows = 0
        self.total_good = 0
        self.purged_singletons = 0
        self.drains = 0
        self._pending_keys: list = []
        self._pending_counts: list = []
        self._pending_rows = 0

    def _to_dev(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def add_batch(self, codes, logp, lengths, qual_table=None):
        """Count one batch (numpy arrays or tensors) and stage its table;
        a merge into the main table follows once drain_threshold rows are
        staged. Three forms: codes [B, L] u8 with logp [B, L] float32
        log2-probabilities; codes with RAW quality bytes [B, L] u8 in place
        of logp and `qual_table`, a 256-entry float32 log2-probability
        table, looked up on the device (a quarter of the bytes to the
        card); or 2-bit packed codes [B, ceil(L/4)] (four bases a byte,
        the first in the high bits) with raw qualities, unpacked on the
        device. Returns None, as the JAX method does."""
        codes, logp, lengths = (self._to_dev(a) for a in (codes, logp,
                                                           lengths))
        if logp.dtype == torch.uint8:
            if qual_table is None:
                raise ValueError("raw-qual batches need qual_table")
            L = logp.shape[1]  # the qualities carry the padded length
            if codes.shape[1] != L:
                codes = unpack_2bit(codes, L)
            logp = self._to_dev(np.asarray(qual_table, np.float32))[
                logp.long()]
        bkeys, bcounts, _ = _batch_table(codes, logp, lengths, self.k,
                                         self.log2_min_weight)
        self._pending_keys.append(bkeys)
        self._pending_counts.append(bcounts)
        self._pending_rows += bkeys.shape[0]
        if self._pending_rows >= self.drain_threshold:
            self._drain()
        self.total_windows += int(codes.shape[0]) * (logp.shape[1]
                                                     - self.k + 1)

    def add_table(self, keys_words: np.ndarray, counts: np.ndarray):
        """Stage a host table (unique keys [N, W] u32 and counts) into the
        running merge. Padded to a power of two rows (at least 64) with the
        sentinel, as the JAX method pads it for XLA's compile cache, so
        that drains fall on the same calls."""
        N, W = keys_words.shape
        Np = 1 << max(int(np.ceil(np.log2(max(N, 1)))), 6)
        pk = np.full((Np, W), SENTINEL_WORD, np.int64)
        pk[:N] = keys_words
        pc = np.zeros(Np, np.int32)
        pc[:N] = counts
        self._pending_keys.append(self._to_dev(pk))
        self._pending_counts.append(self._to_dev(pc))
        self._pending_rows += Np
        if self._pending_rows >= self.drain_threshold:
            self._drain()

    def _drain(self):
        if not self._pending_keys:
            return
        mk, mc = merge_tables(self.keys, self.counts,
                              torch.cat(self._pending_keys),
                              torch.cat(self._pending_counts))
        self._pending_keys, self._pending_counts = [], []
        self._pending_rows = 0
        self.drains += 1
        n_real, n_solid = (int(x) for x in _occupancy(mc))
        if n_solid > self.capacity:
            raise RuntimeError(
                "streaming table overflow: %d kmers with count>=2 exceed "
                "capacity %d — raise capacity" % (n_solid, self.capacity))
        if n_real > self.capacity:
            # singletons past capacity are purged, as the reference does
            # under memory pressure (ref: KmerSpectrum.h:1794 purge cycle);
            # a purged key seen again restarts at 1
            self.purged_singletons += n_real - self.capacity
            self.keys, self.counts, _, _ = _purge_compact(mk, mc,
                                                          self.capacity)
        else:
            # the merge leads with its real rows: truncation keeps them all
            self.keys = mk[:self.capacity]
            self.counts = mc[:self.capacity]

    def finalize(self, min_depth: int = 2):
        """(keys [M, W] u32 in key order, counts [M] int32) of the keys
        counted at least min_depth times, on the host."""
        self._drain()
        keys = self.keys.cpu().numpy()
        counts = self.counts.cpu().numpy()
        real = ~(keys == SENTINEL_WORD).all(axis=1) & (counts >= min_depth)
        return keys[real].astype(np.uint32), counts[real]


def _batch_table(codes, logp, lengths, k: int, log2_min_weight: float):
    """One batch's table: count_batch over the canonical keys of its good
    windows, min_count 1."""
    cols, _, valid = extract_canonical_cols(codes, lengths, k)
    _, good = window_good(logp, lengths, k, log2_min_weight)
    return count_batch([c.reshape(-1) for c in cols],
                       (good & valid).reshape(-1), 1)


def unpack_2bit(codes2: torch.Tensor, L: int) -> torch.Tensor:
    """[B, ceil(L/4)] 2-bit packed codes (the first base in the high bits)
    -> [B, L] u8 codes, on their device."""
    shifts = torch.arange(6, -1, -2, dtype=torch.uint8, device=codes2.device)
    codes = (codes2[:, :, None] >> shifts) & 3
    return codes.reshape(codes2.shape[0], -1)[:, :L]


def _occupancy(counts: torch.Tensor):
    """(rows with a count, rows with a count >= 2)."""
    return (counts > 0).sum(), (counts >= 2).sum()


def _purge_compact(keys: torch.Tensor, counts: torch.Tensor, capacity: int):
    """Keep the count >= 2 rows first, then the singletons, up to
    `capacity` rows, each group in key order, then sentinel rows. keys [N,
    W] and counts [N] are a table in key order (merge_tables' output).
    Returns (keys [capacity, W], counts [capacity], n_real, n_solid), the
    JAX function's table."""
    real = counts > 0
    solid = counts >= 2
    take = torch.cat([torch.nonzero(solid).squeeze(1),
                      torch.nonzero(real & ~solid).squeeze(1)])[:capacity]
    n = take.numel()
    out_keys = torch.full((capacity, keys.shape[1]), SENTINEL_WORD,
                          dtype=keys.dtype, device=keys.device)
    out_keys[:n] = keys[take]
    out_counts = torch.zeros(capacity, dtype=counts.dtype,
                             device=counts.device)
    out_counts[:n] = counts[take]
    return out_keys, out_counts, real.sum(), solid.sum()


def build_streaming(batches: Iterable, k: int, capacity: int,
                    min_weight: float = 0.10, min_depth: int = 2,
                    prefetch: int = 2, device="cuda"):
    """Stream batches into a StreamingSpectrum on `device` and finalize it.
    A thread runs the (host) parse and pack iterator `prefetch` batches
    ahead while the device counts the previous one: the reference's comm
    thread and worker thread split (ref: DistributedFunctions.h:376-382)
    as I/O and compute overlap. A raw-quality stream's `device_table` is
    read once iterating has started."""
    sp = StreamingSpectrum(k, capacity, min_weight, device=device)
    for codes, logp, lengths in _prefetched(batches, prefetch):
        sp.add_batch(codes, logp, lengths,
                     qual_table=getattr(batches, "device_table", None))
    return sp.finalize(min_depth)


def _prefetched(iterable: Iterable, depth: int):
    """The items of iterable, produced by a thread up to `depth` ahead; an
    exception in the thread is raised here after the items before it."""
    if depth <= 0:
        yield from iterable
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    err = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # handed to the consumer, raised there
            err.append(e)
        finally:
            q.put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        yield item
    t.join()
    if err:
        raise err[0]
