"""Run-length sums over sorted key lanes: the port of pallas_count.py.

`run_length_counts(hi, lo, good)` keeps the JAX signature and output
convention of kmernator_tpu/parallel/pallas_count.py: for keys sorted
lexicographically by (hi, lo), the int32 count of good entries in each run
of equal keys, written at the run's LAST element, 0 elsewhere.
`run_length_sums(lanes, vals)` is the body both share, over int64 key lanes
(ops/kmer.py encode_lane) and int32 values.

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/run_length.cu on the current stream; on a CPU tensor it takes the
plain PyTorch version beside it. Nothing else chooses between them, and a
failed build or launch raises. The kernel is one launch, a scan with
decoupled look-back; `run_length_schedule_plain` is its tiling and carry in
plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from kmernator_tpu_torch.ops.kmer import encode_lane

launches = 0          # kernel launches made by run_length_sums on CUDA tensors

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from kmernator_tpu_torch.kernels.build import load
        lib = load("run_length")
        lib.kmtpu_run_length_tile.argtypes = []
        lib.kmtpu_run_length_tile.restype = ctypes.c_int
        lib.kmtpu_run_length_sums.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.kmtpu_run_length_sums.restype = ctypes.c_int
        _lib = lib
    return _lib


def run_length_sums_plain(lanes: torch.Tensor,
                          vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: prefix sums differenced at run ends."""
    n = lanes.numel()
    out = torch.zeros(n, dtype=torch.int32, device=lanes.device)
    if n == 0:
        return out
    is_end = torch.ones(n, dtype=torch.bool, device=lanes.device)
    is_end[:-1] = lanes[1:] != lanes[:-1]
    ends = torch.nonzero(is_end).squeeze(1)
    cum = torch.cumsum(vals, 0, dtype=torch.int64)[ends]
    prev = torch.cat([cum.new_zeros(1), cum[:-1]])
    out[ends] = (cum - prev).to(torch.int32)
    return out


def run_length_schedule_plain(lanes: torch.Tensor, vals: torch.Tensor,
                              tile: int) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: tiles of `tile` rows, each
    scanned on its own into run-end partial sums and an aggregate (did a
    run start in the tile, the sum since its last start), then the carry
    into each tile found by looking back over its predecessors' aggregates
    until one holds a run start. Sums wrap at 32 bits as the kernel's do."""
    n = lanes.numel()
    out = torch.zeros(n, dtype=torch.int32, device=lanes.device)
    if n == 0:
        return out
    start = torch.ones(n, dtype=torch.bool, device=lanes.device)
    start[1:] = lanes[1:] != lanes[:-1]
    end = torch.ones(n, dtype=torch.bool, device=lanes.device)
    end[:-1] = start[1:]
    aggs = []                            # (flag, sum) of each tile
    for t0 in range(0, n, tile):
        s, e = start[t0:t0 + tile], end[t0:t0 + tile]
        x = vals[t0:t0 + tile].to(torch.int64)
        idx = torch.arange(s.numel(), device=lanes.device)
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


def _run_length_sums_cuda(lanes: torch.Tensor,
                          vals: torch.Tensor) -> torch.Tensor:
    global launches
    lib = _kernel_lib()
    n = lanes.numel()
    out = torch.empty(n, dtype=torch.int32, device=lanes.device)
    # the tile counter and one descriptor a tile, zeroed by the entry point
    scratch = torch.empty(1 + -(-n // lib.kmtpu_run_length_tile()),
                          dtype=torch.int64, device=lanes.device)
    with torch.cuda.device(lanes.device):
        stream = torch.cuda.current_stream(lanes.device).cuda_stream
        err = lib.kmtpu_run_length_sums(lanes.data_ptr(), vals.data_ptr(),
                                        out.data_ptr(), scratch.data_ptr(),
                                        n, stream)
    if err != 0:
        raise RuntimeError("run_length kernel launch failed: CUDA error %d"
                           % err)
    launches += 1
    return out


def run_length_sums(lanes: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """lanes [N] int64 sorted so equal keys are adjacent, vals [N] int32 ->
    [N] int32: the sum of vals over each run at the run's last index, 0
    elsewhere. Any N >= 0."""
    if lanes.dtype != torch.int64 or vals.dtype != torch.int32:
        raise TypeError("run_length_sums takes int64 lanes and int32 values, "
                        "got %s and %s" % (lanes.dtype, vals.dtype))
    if lanes.dim() != 1 or lanes.shape != vals.shape:
        raise ValueError("run_length_sums takes two 1-D tensors of one "
                         "length, got %s and %s"
                         % (tuple(lanes.shape), tuple(vals.shape)))
    if lanes.device != vals.device:
        raise ValueError("lanes on %s but vals on %s"
                         % (lanes.device, vals.device))
    if not (lanes.is_contiguous() and vals.is_contiguous()):
        raise ValueError("run_length_sums takes contiguous tensors")
    if lanes.device.type == "cpu":
        return run_length_sums_plain(lanes, vals)
    if lanes.device.type == "cuda":
        return _run_length_sums_cuda(lanes, vals)
    raise ValueError("run_length_sums has no kernel for device %s"
                     % lanes.device)


def run_length_counts(hi: torch.Tensor, lo: torch.Tensor,
                      good: torch.Tensor) -> torch.Tensor:
    """counts-at-run-end for (hi, lo) word pairs (int64 words in [0, 2^32))
    sorted lexicographically; good [N] bool. Same convention as the JAX
    pallas_count.run_length_counts, without its block-multiple rule."""
    lanes = encode_lane([hi, lo]).contiguous()
    return run_length_sums(lanes, good.to(torch.int32).contiguous())
