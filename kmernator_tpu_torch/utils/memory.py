"""Process memory introspection (ref: src/MemoryUtils.h — RSS/vmem logging
used at ~80 call sites in the reference).

Copied for kmernator_tpu_torch from kmernator_tpu/utils/memory.py; it
differs from its source only in its package imports.
"""
from __future__ import annotations

import os


def get_memory_usage() -> str:
    try:
        with open("/proc/self/status") as f:
            fields = {}
            for line in f:
                if line.startswith(("VmRSS", "VmSize", "VmPeak", "VmHWM")):
                    k, v = line.split(":", 1)
                    fields[k] = v.strip()
        return " ".join("%s: %s" % kv for kv in sorted(fields.items()))
    except OSError:
        return "mem: unavailable"


def available_mb() -> float:
    """MemAvailable from /proc/meminfo (0.0 when unreadable) — gates
    grow-vs-spill decisions in the streaming aggregator."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError):
        pass
    return 0.0


def rss_mb() -> float:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except OSError:
        return 0.0


_MALLOC_TUNED = False


def tune_malloc_for_streaming():
    """Keep big numpy temporaries on the heap instead of mmap/munmap.

    glibc serves allocations above MMAP_THRESHOLD (128 KB default) with a
    fresh mmap and returns them with munmap, so churning chunk-sized numpy
    temporaries costs two syscalls + page faults each — measured ~40% of
    streaming-FilterReads wall time in sys on the JAX package's
    development host (a CPU machine, not the H100's host).  Raising the
    threshold and
    disabling trim keeps pages resident for reuse (the reference gets the
    same effect from long-lived Boost pools, ref: src/MmapTempFile.h).
    Inherited by forked workers when called before the pool spawns."""
    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return
    _MALLOC_TUNED = True
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except OSError:
        pass


def fast_temp_dir(est_bytes: int, prefix: str = "kmtpu-") -> str:
    """mkdtemp on a RAM-backed filesystem when it clearly fits, else the
    default temp dir.  Spill buckets and scan caches are written once and
    read once — on tmpfs that's memcpy instead of disk writeback (measured
    26% off a 1 GiB streaming pass-1 on the JAX package's development
    host, a CPU machine, not the H100's host) — matching the reference's
    default
    of keeping spectra in RAM and spilling to disk only under pressure
    (ref: buildKmerSpectrumInParts is opt-in, src/KmerSpectrum.h:1818)."""
    import tempfile
    for base in ("/dev/shm",):
        try:
            st = os.statvfs(base)
            if st.f_bavail * st.f_frsize > 3 * est_bytes:
                return tempfile.mkdtemp(prefix=prefix, dir=base)
        except OSError:
            continue
    return tempfile.mkdtemp(prefix=prefix)


def l3_cache_bytes() -> int:
    """Last-level cache size from sysfs (shared budget for the streaming
    workers' aggregation tables), 32 MB fallback when unreadable."""
    try:
        base = "/sys/devices/system/cpu/cpu0/cache"
        for idx in sorted(os.listdir(base), reverse=True):
            d = os.path.join(base, idx)
            try:
                with open(os.path.join(d, "level")) as f:
                    if f.read().strip() != "3":
                        continue
                with open(os.path.join(d, "size")) as f:
                    s = f.read().strip()
                if s.endswith("K"):
                    return int(s[:-1]) << 10
                if s.endswith("M"):
                    return int(s[:-1]) << 20
                return int(s)
            except (OSError, ValueError):
                continue
    except OSError:
        pass
    return 32 << 20
