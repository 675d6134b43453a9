"""MeraculousCounter's text files, written from the extension spectrum
where it was counted.

`select(table, k, min_count)` sums, block by block of THREADS keys,
the bytes each kept key (count >= min_count) takes in the two files and the
keys kept, as prefixes over the blocks (`Selection.ends`, on the host).
`write(sel, count_path, graph_path)` writes `<out>.mercount.m<k>` and
`<out>.mergraph.m<k>.D<minDepth>` as the host's `dump_counts` and
`dump_graphs` (apps/meraculous_counter.py) write them from the same keys,
in slabs of whole blocks (`plan_slabs`) of at most `slab_bytes` of text
(more only where one block alone is larger).

On a CUDA device the wrapper launches the hand-written kernels in
csrc/format_mers.cu on the current stream: one `select` launch a table
(the blocks' sums and their scan), then one `write` launch a slab into a
slab buffer on the card, whose text comes back into one of a pair of
pinned host buffers, reused across slabs and calls; the copy of slab i + 1
runs while the host writes slab i to the files. On a CPU device it takes
the plain versions beside them (`block_ends`, `slab_text_plain`). Nothing
else chooses between them, and a failed build or launch raises.

This replaces no TPU kernel: the JAX package brings the table back to the
host and formats its text there.
"""
from __future__ import annotations

import collections
import ctypes
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from kmernator_tpu_torch.ops.kmer import nlanes, nwords
from kmernator_tpu_torch.utils import timers

SLAB_BYTES = 32 << 20     # text a slab, and each pinned buffer's size
THREADS = 256             # keys a block: kmtpu_format_mers_threads()
REVERSE = [9, 8, 7, 6, 10, 11, 3, 2, 1, 0, 4, 5]   # the reverse line's
                                                   # counters
launches = collections.Counter()   # "select" and "write" launches on CUDA

_lib = None
_pinned: List[torch.Tensor] = []   # the pair of pinned host buffers
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


class DeviceTable(NamedTuple):
    """The extension spectrum as parallel/mesh.py extension_spectrum_mesh
    returns it: L [M] int64 key lanes in key order, counts [M] int32 and
    ext [M, 12] int32 (left A C G T N X, then right)."""
    lanes: List[torch.Tensor]
    counts: torch.Tensor
    ext: torch.Tensor


class Selection(NamedTuple):
    table: DeviceTable
    k: int
    min_count: int
    ends: np.ndarray                # [nb + 1, 3] int64: see block_ends
    offs: Optional[torch.Tensor]    # the same on the card (None on the CPU)
    ptrs: Optional[torch.Tensor]    # the lanes' pointers on the card


class Slab(NamedTuple):
    b0: int          # the slab's blocks [b0, b1)
    b1: int
    c0: int          # its first byte in mercount and in mergraph
    g0: int
    c_bytes: int     # its text in each
    g_bytes: int

    @property
    def g_at(self) -> int:
        """Where the mergraph text starts in the slab's buffer."""
        return -(-self.c_bytes // 16) * 16

    @property
    def size(self) -> int:
        return self.g_at + self.g_bytes


def _kernel_lib():
    global _lib
    if _lib is None:
        from kmernator_tpu_torch.kernels.build import load
        lib = load("format_mers")
        lib.kmtpu_format_mers_threads.argtypes = []
        lib.kmtpu_format_mers_threads.restype = ctypes.c_int
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        table = [p, i32, p, p, i64, i32, i32]
        lib.kmtpu_format_mers_select.argtypes = table + [p, p]
        lib.kmtpu_format_mers_select.restype = ctypes.c_int
        lib.kmtpu_format_mers_write.argtypes = table + [
            p, i64, i64, i64, i64, i64, p, p]
        lib.kmtpu_format_mers_write.restype = ctypes.c_int
        if lib.kmtpu_format_mers_threads() != THREADS:
            raise RuntimeError("format_mers.cu has %d keys a block, the "
                               "wrapper %d" % (lib.kmtpu_format_mers_threads(),
                                               THREADS))
        _lib = lib
    return _lib


def _digits(v: np.ndarray) -> np.ndarray:
    """Decimal digits of each value in [0, 2^32)."""
    d = np.ones(v.shape, np.int64)
    for j in range(1, 10):
        d += v >= 10 ** j
    return d


def line_bytes(counts: np.ndarray, ext: np.ndarray, k: int,
               min_count: int):
    """(mercount, mergraph) [M] int64: the bytes of each key's two lines in
    each file, 0 for a key under min_count."""
    c = counts.astype(np.int64)
    keep = c >= min_count
    e = np.maximum(ext.astype(np.int64), 0)
    cb = np.where(keep, 2 * (k + 2 + _digits(c)), 0)
    gb = np.where(keep, 2 * (k + 15 + _digits(e).sum(axis=1)), 0)
    return cb, gb


def block_ends(counts: np.ndarray, ext: np.ndarray, k: int,
               min_count: int) -> np.ndarray:
    """[nb + 1, 3] int64, nb = ceil(M / THREADS): row b holds the mercount
    bytes, the mergraph bytes and the keys kept of the blocks before block
    b; row nb the totals. The plain version of the select kernel."""
    cb, gb = line_bytes(counts, ext, k, min_count)
    nb = -(-len(cb) // THREADS)
    per = np.zeros((nb * THREADS, 3), np.int64)
    per[:len(cb), 0] = cb
    per[:len(cb), 1] = gb
    per[:len(cb), 2] = cb > 0
    ends = np.zeros((nb + 1, 3), np.int64)
    np.cumsum(per.reshape(nb, THREADS, 3).sum(axis=1), axis=0,
              out=ends[1:])
    return ends


def plan_slabs(ends: np.ndarray, slab_bytes: int = SLAB_BYTES) -> List[Slab]:
    """Cut the blocks of `ends` (block_ends) into slabs of consecutive
    blocks, each as long as its buffer (mercount text, padded to 16 bytes,
    then mergraph text) stays within slab_bytes, and at least one block
    long, while text remains: no slab holds no text."""
    C, G = ends[:, 0], ends[:, 1]
    T = C + G
    nb = len(ends) - 1
    slabs = []
    b0 = 0
    while b0 < nb and T[nb] > T[b0]:
        # the slab's size is at least T[b1] - T[b0] and under it + 16
        hi = int(np.searchsorted(T, T[b0] + slab_bytes, side="right")) - 1
        b1 = b0 + 1
        if hi > b0:
            size = (-(-(C[b0 + 1:hi + 1] - C[b0]) // 16) * 16
                    + G[b0 + 1:hi + 1] - G[b0])
            b1 = b0 + max(int(np.searchsorted(size, slab_bytes,
                                              side="right")), 1)
        slabs.append(Slab(b0, b1, int(C[b0]), int(G[b0]),
                          int(C[b1] - C[b0]), int(G[b1] - G[b0])))
        b0 = b1
    return slabs


def _check(table: DeviceTable, k: int) -> None:
    lanes, counts, ext = table
    M = counts.numel()
    L = nlanes(nwords(k))
    if k < 1 or len(lanes) != L:
        raise ValueError("a %d-mer's key has %d lanes, got %d"
                         % (k, L, len(lanes)))
    dev = counts.device
    if counts.dtype != torch.int32 or counts.shape != (M,):
        raise TypeError("counts must be [M] int32")
    if ext.dtype != torch.int32 or tuple(ext.shape) != (M, 12):
        raise TypeError("ext must be [M, 12] int32")
    for t in list(lanes) + [counts, ext]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("the table's tensors must be contiguous, on "
                             "one device")
    for lane in lanes:
        if lane.dtype != torch.int64 or lane.shape != (M,):
            raise TypeError("key lanes must be [M] int64")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("format_mers has no kernel for device %s" % dev)
    if ext.data_ptr() % 16:
        raise ValueError("the kernel reads ext's rows as 16-byte words: "
                         "ext must start 16-byte aligned")


def launch_select(table: DeviceTable, k: int, min_count: int,
                  ptrs: torch.Tensor, offs: torch.Tensor) -> None:
    """One select launch on the current stream: `ptrs` the lanes' pointers
    on the card, `offs` [3 (nb + 1) + 1] int64 to write. Raises if the
    launch fails."""
    lanes, counts, ext = table
    err = _kernel_lib().kmtpu_format_mers_select(
        ptrs.data_ptr(), len(lanes), counts.data_ptr(), ext.data_ptr(),
        counts.numel(), k, min_count, offs.data_ptr(),
        torch.cuda.current_stream(counts.device).cuda_stream)
    if err != 0:
        raise RuntimeError("format_mers select kernel launch failed: CUDA "
                           "error %d" % err)
    launches["select"] += 1


def launch_write(sel: Selection, s: Slab, buf: torch.Tensor) -> None:
    """One write launch on the current stream: slab s's text into buf
    (at least s.size bytes on the card). Raises if the launch fails."""
    lanes, counts, ext = sel.table
    err = _kernel_lib().kmtpu_format_mers_write(
        sel.ptrs.data_ptr(), len(lanes), counts.data_ptr(), ext.data_ptr(),
        counts.numel(), sel.k, sel.min_count, sel.offs.data_ptr(), s.b0,
        s.b1, s.c0, s.g0, s.g_at, buf.data_ptr(),
        torch.cuda.current_stream(counts.device).cuda_stream)
    if err != 0:
        raise RuntimeError("format_mers write kernel launch failed: CUDA "
                           "error %d" % err)
    launches["write"] += 1


def select(table: DeviceTable, k: int, min_count: int) -> Selection:
    """The blocks' prefixes of the kept keys' bytes (see the module's
    note): the select kernel on a CUDA table, block_ends on the CPU."""
    _check(table, k)
    lanes, counts, ext = table
    M = counts.numel()
    dev = counts.device
    offs = ptrs = None
    if dev.type == "cpu" or M == 0:
        ends = block_ends(counts.cpu().numpy(), ext.cpu().numpy(), k,
                          min_count)
    else:
        nb = -(-M // THREADS)
        offs = torch.empty(3 * (nb + 1) + 1, dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            # the pinned block is not reused before the copy has run (the
            # caching host allocator records it on the stream)
            ptrs = torch.tensor([t.data_ptr() for t in lanes],
                                dtype=torch.int64).pin_memory().to(
                                    dev, non_blocking=True)
            launch_select(table, k, min_count, ptrs, offs)
        ends = offs[:3 * (nb + 1)].view(nb + 1, 3).cpu().numpy()
        timers.count("device.d2h_bytes", ends.nbytes)
    kept = int(ends[-1, 2])
    timers.count("table.keys", M)
    timers.count("io.keys_dumped", kept)
    # select reads the counts, and the counters of the kept keys; write
    # the same, the kept keys' lanes, and writes the text
    timers.count("kernel.format_mers_bytes",
                 8 * M + kept * (96 + 8 * len(lanes))
                 + int(ends[-1, 0] + ends[-1, 1]))
    return Selection(table, k, min_count, ends, offs, ptrs)


def slab_text_plain(sel: Selection, slab: Slab) -> bytes:
    """The slab's buffer, the plain version of the write kernel: each kept
    key's lines formatted one key at a time."""
    lanes = [t.cpu().numpy() for t in sel.table.lanes]
    counts = sel.table.counts.cpu().numpy()
    ext = sel.table.ext.cpu().numpy()
    k = sel.k
    i0, i1 = slab.b0 * THREADS, min(slab.b1 * THREADS, len(counts))
    codes = np.zeros((i1 - i0, 32 * len(lanes)), np.int64)
    for l, lane in enumerate(lanes):
        u = lane[i0:i1].view(np.uint64) ^ np.uint64(1 << 63)
        for j in range(32):
            codes[:, 32 * l + j] = (u >> np.uint64(62 - 2 * j)) & np.uint64(3)
    fwd = _ACGT[codes[:, :k]]
    rev = _ACGT[3 - codes[:, :k][:, ::-1]]
    cl, gl = [], []
    for r in range(i1 - i0):
        i = i0 + r
        if counts[i] < sel.min_count:
            continue
        e = [max(int(x), 0) for x in ext[i]]
        f, b = fwd[r].tobytes(), rev[r].tobytes()
        cl.append(b"%s\t%d\n%s\t%d\n" % (f, counts[i], b, counts[i]))
        gl.append(b"%s\t%s0\n%s\t%s0\n"
                  % (f, b"".join(b"%d " % x for x in e), b,
                     b"".join(b"%d " % e[j] for j in REVERSE)))
    text = b"".join(cl)
    return text + bytes(slab.g_at - len(text)) + b"".join(gl)


def _pinned_pair(nbytes: int) -> List[torch.Tensor]:
    """Two pinned host buffers of at least nbytes (SLAB_BYTES, or more for
    a single block of more text), kept for later calls."""
    if not _pinned or _pinned[0].numel() < nbytes:
        size = max(nbytes, SLAB_BYTES)
        _pinned[:] = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                      for _ in range(2)]
    return _pinned


def _write_cuda(sel: Selection, plan: List[Slab], fc, fg) -> None:
    dev = sel.table.counts.device
    size = max(s.size for s in plan)
    pinned = _pinned_pair(size)
    host = [p.numpy() for p in pinned]
    bufs = [torch.empty(size, dtype=torch.uint8, device=dev)
            for _ in range(min(2, len(plan)))]
    done = [torch.cuda.Event() for _ in bufs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)

        def enqueue(j: int) -> None:
            s, b = plan[j], j % 2
            launch_write(sel, s, bufs[b])
            pinned[b][:s.size].copy_(bufs[b][:s.size], non_blocking=True)
            done[b].record(stream)

        enqueue(0)
        for j, s in enumerate(plan):
            if j + 1 < len(plan):   # its buffers' last slab is written out
                enqueue(j + 1)
            done[j % 2].synchronize()
            fc.write(host[j % 2][:s.c_bytes])
            fg.write(host[j % 2][s.g_at:s.size])
    timers.count("device.d2h_bytes", sum(s.size for s in plan))


def write(sel: Selection, count_path: str, graph_path: str,
          slab_bytes: int = SLAB_BYTES) -> List[Slab]:
    """Write the selection's two files (see the module's note); returns
    the slabs, one write launch each on a CUDA table."""
    plan = plan_slabs(sel.ends, slab_bytes)
    with open(count_path, "wb") as fc, open(graph_path, "wb") as fg:
        if sel.offs is None:
            for s in plan:
                text = slab_text_plain(sel, s)
                fc.write(text[:s.c_bytes])
                fg.write(text[s.g_at:])
        elif plan:
            _write_cuda(sel, plan, fc, fg)
    timers.count("io.bytes_written", int(sel.ends[-1, 0] + sel.ends[-1, 1]))
    timers.count("io.slabs", len(plan))
    return plan
