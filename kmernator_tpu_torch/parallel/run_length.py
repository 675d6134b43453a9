"""Run-length sums over sorted key lanes: the port of pallas_count.py.

`run_length_counts(hi, lo, good)` keeps the JAX signature and output
convention of kmernator_tpu/parallel/pallas_count.py: for keys sorted
lexicographically by (hi, lo), the int32 count of good entries in each run
of equal keys, written at the run's LAST element, 0 elsewhere.
`run_length_sums(lanes, vals)` is the body both share, over keys of any
number L of int64 lanes (ops/kmer.py encode_lanes: one tensor for L = 1, or
a list of L tensors, sorted lexicographically) and int32 values.

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/run_length.cu on the current stream; on a CPU tensor it takes the
plain PyTorch version beside it. Nothing else chooses between them, and a
failed build or launch raises. The kernel is one launch, a scan with
decoupled look-back; `run_length_schedule_plain` is its tiling and carry in
plain PyTorch. Keys of L = 1-3 lanes go to the kernel's unrolled instances
with their lane pointers by value; keys of L >= 4 to its run-time instance,
with the L lane pointers copied to the card on the launch's stream from
pinned memory, so the host waits for nothing.
"""
from __future__ import annotations

import collections
import ctypes
from typing import List, Sequence, Union

import torch

from kmernator_tpu_torch.ops.kmer import encode_lane
from kmernator_tpu_torch.utils import timers

Lanes = Union[torch.Tensor, Sequence[torch.Tensor]]

launches = 0          # kernel launches made by run_length_sums on CUDA tensors
launches_by_lanes = collections.Counter()   # the same, by the keys' lanes

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from kmernator_tpu_torch.kernels.build import load
        lib = load("run_length")
        lib.kmtpu_run_length_tile.argtypes = []
        lib.kmtpu_run_length_tile.restype = ctypes.c_int
        lib.kmtpu_run_length_sums.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        lib.kmtpu_run_length_sums.restype = ctypes.c_int
        lib.kmtpu_run_length_sums_lanes.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        lib.kmtpu_run_length_sums_lanes.restype = ctypes.c_int
        _lib = lib
    return _lib


def _as_list(lanes: Lanes) -> List[torch.Tensor]:
    return [lanes] if isinstance(lanes, torch.Tensor) else list(lanes)


def _run_starts(lanes: List[torch.Tensor]) -> torch.Tensor:
    """[N] bool: row i starts a run (differs from row i-1 in some lane)."""
    n = lanes[0].numel()
    start = torch.ones(n, dtype=torch.bool, device=lanes[0].device)
    if n > 1:
        diff = lanes[0][1:] != lanes[0][:-1]
        for lane in lanes[1:]:
            diff |= lane[1:] != lane[:-1]
        start[1:] = diff
    return start


def run_length_sums_plain(lanes: Lanes, vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: prefix sums differenced at run ends."""
    lanes = _as_list(lanes)
    n = lanes[0].numel()
    out = torch.zeros(n, dtype=torch.int32, device=lanes[0].device)
    if n == 0:
        return out
    is_end = torch.ones(n, dtype=torch.bool, device=lanes[0].device)
    is_end[:-1] = _run_starts(lanes)[1:]
    ends = torch.nonzero(is_end).squeeze(1)
    cum = torch.cumsum(vals, 0, dtype=torch.int64)[ends]
    prev = torch.cat([cum.new_zeros(1), cum[:-1]])
    out[ends] = (cum - prev).to(torch.int32)
    return out


def run_length_schedule_plain(lanes: Lanes, vals: torch.Tensor,
                              tile: int) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: tiles of `tile` rows, each
    scanned on its own into run-end partial sums and an aggregate (did a
    run start in the tile, the sum since its last start), then the carry
    into each tile found by looking back over its predecessors' aggregates
    until one holds a run start. Sums wrap at 32 bits as the kernel's do."""
    lanes = _as_list(lanes)
    n = lanes[0].numel()
    out = torch.zeros(n, dtype=torch.int32, device=lanes[0].device)
    if n == 0:
        return out
    start = _run_starts(lanes)
    end = torch.ones(n, dtype=torch.bool, device=out.device)
    end[:-1] = start[1:]
    aggs = []                            # (flag, sum) of each tile
    for t0 in range(0, n, tile):
        s, e = start[t0:t0 + tile], end[t0:t0 + tile]
        x = vals[t0:t0 + tile].to(torch.int64)
        idx = torch.arange(s.numel(), device=out.device)
        last = torch.cummax(torch.where(s, idx, -1), 0).values
        cum = torch.cumsum(x, 0)
        before = torch.where(last >= 0, (cum - x)[last.clamp(min=0)], 0)
        part = cum - before              # sum since the last start in the tile
        carry = 0                        # the look-back
        for flag, total in reversed(aggs):
            carry += total
            if flag:
                break
        aggs.append((bool(s.any()), int(part[-1])))
        part = torch.where(last >= 0, part, part + carry)
        wrapped = (part + (1 << 31)) % (1 << 32) - (1 << 31)
        out[t0:t0 + tile] = torch.where(e, wrapped, 0).to(torch.int32)
    return out


def _run_length_sums_cuda(lanes: List[torch.Tensor],
                          vals: torch.Tensor) -> torch.Tensor:
    global launches
    lib = _kernel_lib()
    n = lanes[0].numel()
    dev = lanes[0].device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    # the tile counter and one descriptor a tile, zeroed by the entry point
    scratch = torch.empty(1 + -(-n // lib.kmtpu_run_length_tile()),
                          dtype=torch.int64, device=dev)
    ptrs = [x.data_ptr() for x in lanes]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if len(lanes) <= 3:
            err = lib.kmtpu_run_length_sums(
                len(lanes), *(ptrs + [None] * (3 - len(ptrs))),
                vals.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
                stream)
        else:
            # the pinned block is not reused before the copy has run (the
            # caching host allocator records it on the stream), and the
            # device array is freed to the same stream after the launch
            dptrs = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
                dev, non_blocking=True)
            err = lib.kmtpu_run_length_sums_lanes(
                len(lanes), dptrs.data_ptr(),
                int(all(p % 16 == 0 for p in ptrs)), vals.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError("run_length kernel launch failed: CUDA error %d"
                           % err)
    launches += 1
    launches_by_lanes[len(lanes)] += 1
    return out


def run_length_sums(lanes: Lanes, vals: torch.Tensor) -> torch.Tensor:
    """lanes: [N] int64, or a list of L >= 1 such lanes, sorted
    (lexicographically over the lanes) so equal keys are adjacent; vals [N]
    int32 -> [N] int32: the sum of vals over each run at the run's last
    index, 0 elsewhere. Any N >= 0 and any L >= 1."""
    lanes = _as_list(lanes)
    if not lanes:
        raise ValueError("run_length_sums takes at least one key lane")
    for lane in lanes:
        if lane.dtype != torch.int64 or vals.dtype != torch.int32:
            raise TypeError("run_length_sums takes int64 lanes and int32 "
                            "values, got %s and %s"
                            % (lane.dtype, vals.dtype))
        if lane.dim() != 1 or lane.shape != vals.shape:
            raise ValueError("run_length_sums takes 1-D tensors of one "
                             "length, got %s and %s"
                             % (tuple(lane.shape), tuple(vals.shape)))
        if lane.device != vals.device:
            raise ValueError("lanes on %s but vals on %s"
                             % (lane.device, vals.device))
        if not (lane.is_contiguous() and vals.is_contiguous()):
            raise ValueError("run_length_sums takes contiguous tensors")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError("run_length_sums has no kernel for device %s"
                         % vals.device)
    # the bytes the work needs: each key lane and value read once, each
    # sum written once
    timers.count("kernel.run_length_bytes", (8 * len(lanes) + 8)
                 * vals.numel())
    with timers.span("kernel.run_length", device=vals.device):
        if vals.device.type == "cpu":
            return run_length_sums_plain(lanes, vals)
        return _run_length_sums_cuda(lanes, vals)


def run_length_counts(hi: torch.Tensor, lo: torch.Tensor,
                      good: torch.Tensor) -> torch.Tensor:
    """counts-at-run-end for (hi, lo) word pairs (int64 words in [0, 2^32))
    sorted lexicographically; good [N] bool. Same convention as the JAX
    pallas_count.run_length_counts, without its block-multiple rule."""
    lanes = encode_lane([hi, lo]).contiguous()
    return run_length_sums(lanes, good.to(torch.int32).contiguous())
