"""Out-of-core hash-partitioned k-mer counting (spill + merge).

The reference's buildKmerSpectrumInParts + MmapTempFile pattern
(ref: src/KmerSpectrum.h:1818-1902, src/MmapTempFile.h): observations are
routed by hash into P on-disk spill buckets as they stream past, then each
bucket is counted independently — peak memory is O(chunk + windows/P)
instead of O(total windows), and counts are EXACT (no purge-under-pressure
undercounts).

Spill record: key (u64 or big-endian wide bytes) + f32 weight.

Copied for kmernator_tpu_torch from kmernator_tpu/parallel/spill.py; it
differs from its source only in its package imports.
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import numpy as np

from kmernator_tpu_torch.ops.kmer import nwords
from kmernator_tpu_torch.utils.cleanup import register_path, unregister_path


def key_range_splitters(sample: np.ndarray, num_parts: int) -> np.ndarray:
    """[num_parts-1] key-space splitters from a sorted-or-not key sample.

    Range partition (not hash): because canonical key order is preserved
    across parts, the per-part sorted outputs concatenate into the final
    globally-sorted table with NO final merge sort — the same reason the
    reference's buildKmerSpectrumInParts partitions by the hash's HIGH bits
    (ref: src/KmerSpectrum.h:1840-1861, partitionIdx from msb) so part maps
    append in order."""
    s = np.sort(sample)
    if len(s) == 0:
        return s[:0].copy()
    qi = (np.arange(1, num_parts) * len(s)) // num_parts
    return s[qi]


def _part_of(keys: np.ndarray, splitters: np.ndarray) -> np.ndarray:
    """Range part id per key (equal keys always share a part)."""
    return np.searchsorted(splitters, keys, side="right")


class SpillCounter:
    """Streamed exact counting through P disk spill buckets."""

    def __init__(self, k: int, num_parts: int, tmpdir: Optional[str] = None,
                 track_weights: bool = True,
                 splitters: Optional[np.ndarray] = None, suffix: str = ""):
        """`splitters`/`suffix` support concurrent writers: each worker
        writes part%d-<suffix>.bin files into a shared tmpdir using the
        same range splitters, and count_spill_parts merges them."""
        self.k = k
        self.W = nwords(k)
        self.num_parts = num_parts
        self.track_weights = track_weights
        self.suffix = ("-" + suffix) if suffix else ""
        if tmpdir is None:
            from kmernator_tpu_torch.utils.memory import fast_temp_dir
            # 12 B/record upper bound; SpillCounter callers size num_parts
            # from estimated windows, so num_parts * merge budget bounds it
            tmpdir = fast_temp_dir(num_parts * (64 << 20), "kmtpu-spill-")
        self.tmpdir = tmpdir
        register_path(self.tmpdir)
        self._files = [open(os.path.join(
            self.tmpdir, "part%d%s.bin" % (p, self.suffix)), "wb")
            for p in range(num_parts)]
        self.raw_kmers = 0
        self.raw_good_kmers = 0
        self.key_dtype = None
        self.splitters = splitters

    def close(self):
        for f in self._files:
            f.close()

    def add(self, keys: np.ndarray, good: np.ndarray,
            weights: Optional[np.ndarray] = None):
        """keys: scalar canonical keys (u64 or 'S' wide) for ALL windows;
        good: bool mask of countable observations."""
        self.raw_kmers += int(len(keys))
        gk = keys[good]
        self.raw_good_kmers += int(len(gk))
        if not len(gk):
            return
        self.key_dtype = gk.dtype
        if self.splitters is None:
            # first batch's keys approximate the global key distribution;
            # skew only shifts per-part memory, never correctness
            step = max(1, len(gk) // 65536)
            self.splitters = key_range_splitters(gk[::step], self.num_parts)
        track = weights is not None and self.track_weights
        if gk.dtype == np.uint64:
            from kmernator_tpu_torch.io.native import spill_route
            routed = spill_route(
                gk, weights[good].astype(np.float32) if track else None,
                self.splitters)
        else:
            routed = None
        if routed is not None:
            out, part_off = routed
            rb = 12 if track else 8
            mv = memoryview(out)
            for p in range(self.num_parts):
                s, e = int(part_off[p]) * rb, int(part_off[p + 1]) * rb
                if s != e:
                    self._files[p].write(mv[s:e])
            return
        part = _part_of(gk, self.splitters)
        if track:
            # interleaved (key, weight) records so buckets parse back as a
            # flat record stream
            rec = np.empty(len(gk), dtype=np.dtype([("k", gk.dtype),
                                                    ("w", np.float32)]))
            rec["k"] = gk
            rec["w"] = weights[good].astype(np.float32)
        else:
            rec = gk
        # one boolean-mask split per part beats a stable argsort by part
        # (the per-part counter sorts anyway, so order here is irrelevant)
        counts = np.bincount(part, minlength=self.num_parts)
        for p in np.flatnonzero(counts):
            self._files[p].write(rec[part == p].tobytes())

    def finalize(self, min_depth: int = 1):
        """Merge the spill buckets into one sorted host KmerSpectrum."""
        self.close()
        return count_spill_parts(
            self.tmpdir, self.num_parts, self.k, self.key_dtype,
            self.track_weights, min_depth, self.raw_kmers,
            self.raw_good_kmers)


def _route_agg_to_files(file_of, num_parts: int, splitters: np.ndarray,
                        ko: np.ndarray, co: np.ndarray, wo=None):
    """Range-route aggregated (key, count[, wsum]) records and append
    them to the part files (file_of(p) -> open append handle).  Shared
    by AggSpillCounter flushes and the shared-CAS-table export."""
    if not len(ko):
        return
    from kmernator_tpu_torch.io.native import spill_route_agg
    routed = spill_route_agg(ko, co, wo, splitters)
    if routed is None:  # numpy fallback routing
        part = _part_of(ko, splitters)
        order = np.argsort(part, kind="stable")
        ko, co = ko[order], co[order]
        if wo is not None:
            wo = wo[order]
        counts = np.bincount(part, minlength=num_parts)
        off = np.concatenate([[0], np.cumsum(counts)])
        for p in range(num_parts):
            s, e = int(off[p]), int(off[p + 1])
            if s == e:
                continue
            if wo is not None:
                rec = np.empty(e - s, dtype=np.dtype(
                    [("k", np.uint64), ("c", np.uint32),
                     ("w", np.float64)]))
                rec["w"] = wo[s:e]
            else:
                rec = np.empty(e - s, dtype=np.dtype(
                    [("k", np.uint64), ("c", np.uint32)]))
            rec["k"] = ko[s:e]
            rec["c"] = co[s:e]
            file_of(p).write(rec.tobytes())
        return
    out, part_off = routed
    rb = 20 if wo is not None else 12
    mv = memoryview(out)
    for p in range(num_parts):
        s, e = int(part_off[p]) * rb, int(part_off[p + 1]) * rb
        if s != e:
            file_of(p).write(mv[s:e])


def append_agg_records(tmpdir: str, num_parts: int, splitters: np.ndarray,
                       suffix: str, ko: np.ndarray, co: np.ndarray,
                       wo=None):
    """One-shot append of aggregated records into a spill part dir — the
    parent uses this to merge the shared CAS table's export with any
    worker-spilled partials before count_spill_parts."""
    files = {}

    def file_of(p):
        f = files.get(p)
        if f is None:
            f = open(os.path.join(tmpdir, "part%d-%s.agg.bin" % (p, suffix)),
                     "ab")
            files[p] = f
        return f

    try:
        _route_agg_to_files(file_of, num_parts, splitters, ko, co, wo)
    finally:
        for f in files.values():
            f.close()


class AggSpillCounter:
    """Cross-chunk aggregated spill: observations accumulate in a
    persistent native hash (bounded slots) and flush
    (key, count[, wsum f64]) records to the range-partitioned part files
    only under memory pressure — the reference's spill-under-pressure
    build (ref: src/KmerSpectrum.h:1818-1902) with EXACT final counts
    (flushed partials re-merge at finalize).  Cuts spill IO and finalize
    hashing by the dataset's duplication factor vs raw-observation spills.

    Requires u64 keys (k <= 32) and the native lib; use
    make_spill_counter() to fall back to SpillCounter otherwise."""

    def __init__(self, k: int, num_parts: int,
                 tmpdir: Optional[str] = None,
                 track_weights: bool = True,
                 splitters: Optional[np.ndarray] = None, suffix: str = "",
                 cap_slots: int = 1 << 22):
        from kmernator_tpu_torch.io.native import ObservationAggregator
        self.k = k
        self.W = nwords(k)
        self.num_parts = num_parts
        self.track_weights = track_weights
        self.suffix = ("-" + suffix) if suffix else ""
        # k <= 31 canonical keys are < 2^62, so the zero-empty (key+1)
        # layout is safe and the table needs no eager sentinel fill
        self._zero_empty = k <= 31
        self.agg = ObservationAggregator(cap_slots, track_weights,
                                         zero_empty=self._zero_empty)
        if tmpdir is None:
            from kmernator_tpu_torch.utils.memory import fast_temp_dir
            tmpdir = fast_temp_dir(num_parts * (64 << 20), "kmtpu-spill-")
        self.tmpdir = tmpdir
        register_path(self.tmpdir)
        self._files = {}
        self.raw_kmers = 0
        self.raw_good_kmers = 0
        self.key_dtype = np.dtype(np.uint64)
        self.splitters = splitters
        self._gk_buf = None   # reusable compact_good output buffers
        self._gw_buf = None
        # grow-vs-spill budget: the aggregator may grow (keeping dedup
        # state warm — a full-table flush resets it, and then EVERY later
        # chunk re-floods the table with "new" keys: measured 12.9 core-s
        # of flushes on a 1 GiB run on the JAX package's development
        # host, a CPU machine, not the H100's host) until tables across
        # the worker pool
        # would exceed ~1/4 of MemAvailable-at-start; past that it spills
        # under pressure exactly as before (bounded memory preserved).
        from kmernator_tpu_torch.utils.memory import available_mb
        try:
            import multiprocessing as _mp
            nw = min(_mp.cpu_count(), max(1, num_parts))
        except Exception:
            nw = 4
        slot_b = 20 if track_weights else 16
        # hard cap 16M slots/worker (256 MB): beyond that the table blows
        # the dTLB and page-fault budget and inserts slow more than the
        # saved flushes gain (measured on the same development host:
        # uncapped growth to 64M+ slots took
        # the spill stage 18.7 -> 37.8 core-s on the 1 GiB run)
        self._max_slots = min(
            1 << 24,
            max(cap_slots,
                int(available_mb() * (1 << 20) / 4 / nw / slot_b)))

    def _file(self, p: int):
        f = self._files.get(p)
        if f is None:
            f = open(os.path.join(
                self.tmpdir, "part%d%s.agg.bin" % (p, self.suffix)), "ab")
            self._files[p] = f
        return f

    def _flush(self):
        ko, co, wo = self.agg.export()
        if not self.track_weights and self._flush_sorted_run(ko, co):
            return
        _route_agg_to_files(self._file, self.num_parts, self.splitters,
                            ko, co, wo)

    def _flush_sorted_run(self, ko: np.ndarray, co: np.ndarray) -> bool:
        """Fast flush: radix-sort the export once in this worker, then
        append each part's CONTIGUOUS slice as a sorted run file
        ([n i64][keys u64][counts u32]).  Replaces the per-part
        routing gather here and the per-part hash re-count at finalize
        (runs merge linearly — each run's keys are unique, so a key
        appears at most once per run).  False -> caller falls back to
        the record-routing path."""
        from kmernator_tpu_torch.io.native import radix_sort_kcw
        if not len(ko):
            return True
        ko = np.ascontiguousarray(ko)
        co = np.ascontiguousarray(co)
        if not radix_sort_kcw(ko, co):
            return False
        # part p holds keys in [splitters[p-1], splitters[p]) — equal-to-
        # splitter keys belong to the HIGHER part (_part_of counts
        # splitters <= key), so slice boundaries bind with side="left"
        bounds = np.concatenate(
            [[0], np.searchsorted(ko, self.splitters, side="left"),
             [len(ko)]]).astype(np.int64)
        self._run_no = getattr(self, "_run_no", 0) + 1
        for p in range(self.num_parts):
            s, e = int(bounds[p]), int(bounds[p + 1])
            if s == e:
                continue
            fn = os.path.join(self.tmpdir, "part%d%s.r%d.srun"
                              % (p, self.suffix, self._run_no))
            with open(fn, "wb") as f:
                np.int64(e - s).tofile(f)
                ko[s:e].tofile(f)
                co[s:e].tofile(f)
        return True

    def _grow(self) -> bool:
        """Migrate to a 4x table when the RAM budget allows; False ->
        caller must spill instead."""
        from kmernator_tpu_torch.io.native import ObservationAggregator
        new_cap = self.agg.cap * 4
        if new_cap > self._max_slots:
            return False
        ko, co, wo = self.agg.export()
        self.agg.close()
        self.agg = ObservationAggregator(new_cap, self.track_weights,
                                         zero_empty=self._zero_empty)
        if len(ko):
            self.agg.insert_counted(ko, co, wo)
        return True

    def add(self, keys: np.ndarray, good: np.ndarray,
            weights: Optional[np.ndarray] = None):
        self.raw_kmers += int(len(keys))
        if keys.dtype != np.uint64:
            raise TypeError("AggSpillCounter requires u64 keys")
        track = weights is not None and self.track_weights
        from kmernator_tpu_torch.io.native import compact_good
        got = compact_good(keys, good, weights if track else None,
                           self._gk_buf, self._gw_buf)
        if got is not None:
            gk, gw, self._gk_buf, self._gw_buf = got
        else:
            gk = keys[good]
            gw = weights[good].astype(np.float32) if track else None
        self.raw_good_kmers += int(len(gk))
        if not len(gk):
            return
        if self.splitters is None:
            step = max(1, len(gk) // 65536)
            self.splitters = key_range_splitters(
                np.ascontiguousarray(gk[::step]), self.num_parts)
        if not track and self.agg.cap >= (1 << 23) \
                and os.environ.get("KMTPU_BUCKETED", "0") == "1":
            # MEASURED NEGATIVE at the app level on the JAX package's
            # development host (a CPU machine, not the H100's host),
            # kept opt-in with the
            # numbers: isolated 4-way insert microbench +20% (18.3 vs
            # 14.9 M ins/s, 16M slots), but interleaved 1 GiB A/B runs
            # 18.9-23.6 s bucketed vs 16.2-17.3 s linear — the partition
            # passes' extra bandwidth contends with the co-running parse/
            # observe stages, and the real ~14x-coverage key stream keeps
            # its hot lines L3-resident for the linear path anyway.  gk
            # is a private reused buffer, so the permuting contract is
            # fine.
            rem = self.agg.insert_bucketed(gk)
            while rem > 0:
                if not self._grow():
                    self._flush()
                rem = self.agg.insert_bucketed(gk[:rem])
            if rem == 0:
                return
            # rem < 0: native bucketed unavailable — fall through
        pos = 0
        n = len(gk)
        while pos < n:
            consumed = self.agg.insert(gk[pos:],
                                       gw[pos:] if track else None)
            pos += consumed
            if pos < n and not self._grow():
                self._flush()

    def close(self):
        if self.agg is not None:
            if self.splitters is not None and self.agg.used():
                self._flush()
            self.agg.close()
            self.agg = None
        for f in self._files.values():
            f.close()
        self._files = {}

    def finalize(self, min_depth: int = 1):
        self.close()
        return count_spill_parts(
            self.tmpdir, self.num_parts, self.k, self.key_dtype,
            self.track_weights, min_depth, self.raw_kmers,
            self.raw_good_kmers)


def make_spill_counter(k: int, num_parts: int,
                       tmpdir: Optional[str] = None,
                       track_weights: bool = True,
                       splitters: Optional[np.ndarray] = None,
                       suffix: str = "", cap_slots: int = 1 << 22):
    """AggSpillCounter when the native aggregator applies (u64 keys:
    k <= 32), else the raw-record SpillCounter.  Both spill into the same
    part-file namespace and count_spill_parts merges either (or a mix)."""
    if k <= 32:
        try:
            return AggSpillCounter(k, num_parts, tmpdir, track_weights,
                                   splitters, suffix, cap_slots)
        except Exception:
            pass
    return SpillCounter(k, num_parts, tmpdir, track_weights, splitters,
                        suffix)


def _part_files(tmpdir: str, p: int) -> List[str]:
    pre = "part%d." % p
    pre2 = "part%d-" % p
    return sorted(os.path.join(tmpdir, f) for f in os.listdir(tmpdir)
                  if f.startswith(pre) or f.startswith(pre2))


def count_one_part(tmpdir: str, p: int, key_dt: np.dtype,
                   track_weights: bool, min_depth: int,
                   to_files: bool = False):
    """Sort-count every writer's spill file for part p (poolable).
    `to_files=True` writes the part's (keys, counts[, weights]) to
    out%d.{k,c,w}.bin in tmpdir and returns the row count instead of the
    arrays — raw .tofile/.fromfile beats pickling ~100 MB of results
    through the pool result pipe (which the parent deserializes serially),
    as measured on the JAX package's development host (a CPU machine, not
    the H100's host)."""
    res = _count_one_part_arrays(tmpdir, p, key_dt, track_weights, min_depth)
    if not to_files:
        return res
    if res is None:
        return 0
    sk, cnt, ws_out = res
    sk.tofile(os.path.join(tmpdir, "out%d.k.bin" % p))
    cnt.tofile(os.path.join(tmpdir, "out%d.c.bin" % p))
    if ws_out is not None:
        ws_out.tofile(os.path.join(tmpdir, "out%d.w.bin" % p))
    return len(sk)


def _count_one_part_arrays(tmpdir: str, p: int, key_dt: np.dtype,
                           track_weights: bool, min_depth: int):
    ks, ws = [], []
    cs = []          # per-record pre-summed counts (None => all ones)
    any_agg = False
    runs = []        # sorted unique-keyed (keys, counts) runs (.srun)
    paths = _part_files(tmpdir, p)
    for path in paths:
        if path.endswith(".srun"):
            n = int(np.fromfile(path, np.int64, 1)[0])
            rk = np.fromfile(path, np.uint64, n, offset=8)
            rc = np.fromfile(path, np.uint32, n, offset=8 + 8 * n)
            runs.append((rk, rc))
            os.unlink(path)
            continue
        if path.endswith(".agg.bin"):
            # aggregated records from AggSpillCounter: key + count [+ wsum]
            any_agg = True
            if track_weights:
                rec_dt = np.dtype([("k", np.uint64), ("c", np.uint32),
                                   ("w", np.float64)])
            else:
                rec_dt = np.dtype([("k", np.uint64), ("c", np.uint32)])
            arr = np.fromfile(path, rec_dt)
            ks.append(arr["k"])
            cs.append(arr["c"].astype(np.int64))
            if track_weights:
                ws.append(arr["w"])
        elif track_weights:
            rec_dt = np.dtype([("k", key_dt), ("w", np.float32)])
            arr = np.fromfile(path, rec_dt)
            ks.append(arr["k"])
            cs.append(None)
            ws.append(arr["w"].astype(np.float64))
        else:
            ks.append(np.fromfile(path, key_dt))
            cs.append(None)
        os.unlink(path)
    if runs and not ks:
        # all-sorted-runs fast path: linear merge-sum, no re-hash/re-sort
        from kmernator_tpu_torch.io.native import merge_sum_runs
        res = merge_sum_runs([(rk, rc, None) for rk, rc in runs],
                             min_depth, False)
        if res is not None:
            return res[0], res[1], None
    if runs:
        # mixed with record files (or no native merge): fold runs into
        # the generic pre-summed path
        any_agg = True
        for rk, rc in runs:
            ks.append(rk)
            cs.append(rc.astype(np.int64))
            if track_weights:
                ws.append(np.zeros(len(rk), np.float64))
        runs = []
    if not ks:
        return None
    k_arr = ks[0] if len(ks) == 1 else np.concatenate(ks)
    w = None if not track_weights else \
        (ws[0] if len(ws) == 1 else np.concatenate(ws))
    c_arr = None
    if any_agg:
        c_arr = np.concatenate([
            c if c is not None else np.ones(len(k), np.int64)
            for c, k in zip(cs, ks)])
    del ks, ws, cs
    if not len(k_arr):
        return None
    if w is None:
        # unweighted: grouping is all counting needs — the native
        # hash-count + sorted-uniques path beats a full argsort ~5x (on
        # the JAX package's development host, a CPU machine, not the
        # H100's host)
        from kmernator_tpu_torch.io.native import spill_count, spill_count_agg
        if c_arr is not None:
            res = spill_count_agg(k_arr, c_arr, min_depth)
        else:
            res = spill_count(k_arr, min_depth)
        if res is not None:
            return res[0], res[1], None
    order = np.argsort(k_arr, kind="stable")
    sk = k_arr[order]
    if w is not None:
        w = w[order]
    if c_arr is not None:
        c_arr = c_arr[order]
    del k_arr, order
    boundary = np.concatenate([[True], sk[1:] != sk[:-1]])
    seg = (np.cumsum(boundary, dtype=np.int64) - 1)
    M = int(seg[-1]) + 1
    cnt = (np.bincount(seg, minlength=M) if c_arr is None
           else np.bincount(seg, weights=c_arr.astype(np.float64),
                            minlength=M).astype(np.int64))
    keep = cnt >= min_depth
    ws_out = None
    if w is not None:
        ws_out = np.bincount(seg, weights=w.astype(np.float64),
                             minlength=M)[keep]
    return sk[boundary][keep], cnt[keep].astype(np.int32), ws_out


def count_spill_parts(tmpdir: str, num_parts: int, k: int, key_dtype,
                      track_weights: bool, min_depth: int,
                      raw_kmers: int, raw_good_kmers: int, pool=None):
    """Count all parts (optionally on a worker pool) and concatenate.
    Range partitioning means parts concatenate already globally sorted."""
    from kmernator_tpu_torch.parallel.spectrum import KmerSpectrum
    key_dt = (np.dtype(np.uint64) if key_dtype is None
              else np.dtype(key_dtype))
    sp = KmerSpectrum(k=k)
    if pool is not None:
        # workers leave their outputs as raw files (no pickle IPC)
        args = [(tmpdir, p, key_dt, track_weights, min_depth, True)
                for p in range(num_parts)]
        rows = pool.starmap(count_one_part, args)
        ks, cs, wss = [], [], []
        for p, m in enumerate(rows):
            if not m:
                continue
            kp = os.path.join(tmpdir, "out%d.k.bin" % p)
            cp = os.path.join(tmpdir, "out%d.c.bin" % p)
            wp = os.path.join(tmpdir, "out%d.w.bin" % p)
            ks.append(np.fromfile(kp, key_dt))
            cs.append(np.fromfile(cp, np.int32))
            if track_weights and os.path.exists(wp):
                wss.append(np.fromfile(wp, np.float64))
                os.unlink(wp)
            os.unlink(kp)
            os.unlink(cp)
        if ks:
            sp.keys = np.concatenate(ks)
            sp.counts = np.concatenate(cs)
            if wss:
                sp.weighted = np.concatenate(wss)
    else:
        args = [(tmpdir, p, key_dt, track_weights, min_depth)
                for p in range(num_parts)]
        results = [count_one_part(*a) for a in args]
        results = [r for r in results if r is not None]
        if results:
            sp.keys = np.concatenate([r[0] for r in results])
            sp.counts = np.concatenate([r[1] for r in results])  # int32 fits
            if track_weights and results[0][2] is not None:
                sp.weighted = np.concatenate([r[2] for r in results])
    sp.raw_kmers = raw_kmers
    sp.raw_good_kmers = raw_good_kmers
    try:
        os.rmdir(tmpdir)
        unregister_path(tmpdir)
    except OSError:
        pass
    return sp


def auto_parts(est_windows: int, budget_bytes: int = 48 << 20,
               rec_bytes: int = 12) -> int:
    """Part count so one bucket's observations fit the merge budget."""
    return max(4, int(np.ceil(est_windows * rec_bytes / budget_bytes)))
