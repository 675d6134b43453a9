"""Merge-path sort of int64 key lanes: the port of pallas_sort.py.

Counterpart of kmernator_tpu/parallel/pallas_sort.py, with its contracts:

- `local_sort_blocks(lanes, block)` sorts each aligned `block` of the lanes
  ascending (`block` a power of two, N % block == 0);
- `merge_level(lanes, runs, chunk)` merges adjacent sorted runs pairwise,
  an odd tail run copying through, and returns (lanes, next_runs). `runs`
  is [(offset, length), ...] covering [0, N) in order; `chunk` is a power
  of two >= 1024 that divides N and every run length;
- `merge_sort_lanes(lanes, block, chunk)` pads N with the sentinel to a
  multiple of `block`, sorts the blocks, merges level by level until one
  run is left and slices [:N] back; `merge_sort_2key(hi, lo, block, chunk)`
  is the JAX signature over (hi, lo) int64 words in [0, 2^32).

Keys are the port's single int64 lane, ((hi << 32) | lo) ^ (1 << 63) with
sentinel INT64_MAX (ops/kmer.py), so one signed compare replaces the TPU's
two-word `_le`. Equal keys are equal int64 values, so every correct sort
gives the same bits: ties need no rule for the result, and the merge takes
A first on ties as `_merge_path_splits_desc` does.

On a CUDA tensor each wrapper launches its hand-written kernel in
csrc/merge_sort.cu on the current stream and adds one to its count in
`launches`; on a CPU tensor it takes the plain PyTorch version beside it.
Nothing else chooses between them, and a failed build or launch raises.
The local sort kernel sorts tiles in shared memory and merges them inside
each block with the merge level's code; `launches["local_sort_blocks"]`
counts those levels in its one call, and `launches["merge_level"]` only
the levels across blocks. `local_sort_schedule_plain` is that schedule in
plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from kmernator_tpu_torch.ops.kmer import (SENTINEL_LANE, decode_lane,
                                          encode_lane)

# kernel launches made by each wrapper on CUDA tensors
launches = {"local_sort_blocks": 0, "merge_level": 0}

Runs = List[Tuple[int, int]]

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from kmernator_tpu_torch.kernels.build import load
        lib = load("merge_sort")
        for fn in (lib.kmtpu_merge_tile, lib.kmtpu_sort_tile):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.kmtpu_local_sort_blocks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.kmtpu_local_sort_blocks.restype = ctypes.c_int
        lib.kmtpu_merge_level.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.kmtpu_merge_level.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _check_lanes(lanes: torch.Tensor, what: str) -> None:
    if lanes.dtype != torch.int64 or lanes.dim() != 1:
        raise TypeError("%s takes a 1-D int64 lane tensor, got %s %s"
                        % (what, lanes.dtype, tuple(lanes.shape)))
    if not lanes.is_contiguous():
        raise ValueError("%s takes a contiguous tensor" % what)
    if lanes.device.type not in ("cpu", "cuda"):
        raise ValueError("%s has no kernel for device %s"
                         % (what, lanes.device))


# --------------------------------------------------------------------------
# phase 1: sort each block
# --------------------------------------------------------------------------

def local_sort_blocks_plain(lanes: torch.Tensor, block: int) -> torch.Tensor:
    """Plain PyTorch version: torch.sort over a [N / block, block] view."""
    return torch.sort(lanes.view(-1, block), dim=1).values.reshape(-1)


def local_sort_schedule_plain(lanes: torch.Tensor, block: int,
                              tile: int) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: sort tiles of
    min(tile, block) keys, then merge runs pairwise (`merge_level_plain`)
    until each run is a block. Every level's run pairs lie inside one block,
    because block is a multiple of twice the run."""
    t = min(tile, block)
    s = torch.sort(lanes.view(-1, t), dim=1).values.reshape(-1)
    run = t
    while run < block:
        s = merge_level_plain(s, [(i, run) for i in range(0, s.numel(), run)])
        run *= 2
    return s


def _local_sort_blocks_cuda(lanes: torch.Tensor, block: int,
                            events) -> torch.Tensor:
    lib = _kernel_lib()
    N = lanes.numel()
    out = torch.empty_like(lanes)
    scratch = splits = None
    if block > lib.kmtpu_sort_tile():   # the in-block levels ping-pong here
        scratch = torch.empty_like(lanes)
        splits = torch.empty(N // lib.kmtpu_merge_tile() + 1,
                             dtype=torch.int64, device=lanes.device)
    with torch.cuda.device(lanes.device):
        stream = torch.cuda.current_stream(lanes.device)
        if events is not None:
            # recording creates each event, the first last, right before
            # the call; the call records the middle one again, between its
            # tile pass and its levels
            for ev in events[::-1]:
                ev.record(stream)
        err = lib.kmtpu_local_sort_blocks(
            lanes.data_ptr(), out.data_ptr(), N, block,
            None if scratch is None else scratch.data_ptr(),
            None if splits is None else splits.data_ptr(),
            None if events is None else events[1].cuda_event,
            stream.cuda_stream)
        if err == 0 and events is not None:
            events[2].record(stream)
    if err != 0:
        raise RuntimeError("local_sort_blocks kernel launch failed: CUDA "
                           "error %d" % err)
    launches["local_sort_blocks"] += 1
    return out


def local_sort_blocks(lanes: torch.Tensor, block: int,
                      events=None) -> torch.Tensor:
    """Sort each aligned [block] slice of the lanes ascending. block is a
    power of two and N % block == 0. `events`, three CUDA events or None,
    are recorded on a CUDA tensor's call before the kernel's tile pass,
    after it and after its last in-block merge level, to time the two
    apart."""
    _check_lanes(lanes, "local_sort_blocks")
    if not _is_pow2(block):
        raise ValueError("block must be a power of two, got %d" % block)
    if lanes.numel() % block:
        raise ValueError("N = %d is not a multiple of block = %d"
                         % (lanes.numel(), block))
    if events is not None and len(events) != 3:
        raise ValueError("events takes three CUDA events, got %d"
                         % len(events))
    if lanes.device.type == "cpu":
        return local_sort_blocks_plain(lanes, block)
    if lanes.numel() == 0:
        return lanes.clone()        # nothing to sort: no launch
    return _local_sort_blocks_cuda(lanes, block, events)


# --------------------------------------------------------------------------
# phase 2: one merge level
# --------------------------------------------------------------------------

def _pair_runs(runs):
    """[(off, len)...] -> (pairs [(a0, alen, b0, blen)...], next_runs).
    Odd tail run passes through as a (run, empty) pair (a plain copy)."""
    pairs = []
    nxt = []
    i = 0
    while i < len(runs):
        a0, alen = runs[i]
        if i + 1 < len(runs):
            b0, blen = runs[i + 1]
        else:
            b0, blen = a0 + alen, 0
        pairs.append((a0, alen, b0, blen))
        nxt.append((a0, alen + blen))
        i += 2
    return pairs, nxt


def _check_runs(N: int, runs: Sequence[Tuple[int, int]], chunk: int) -> None:
    if not (_is_pow2(chunk) and chunk >= 1024):
        raise ValueError("chunk must be a power of two >= 1024, got %d"
                         % chunk)
    if N % chunk:
        raise ValueError("N = %d is not a multiple of chunk = %d"
                         % (N, chunk))
    at = 0
    for off, length in runs:
        if off != at or length <= 0 or length % chunk:
            raise ValueError("runs must cover [0, N) in order with lengths "
                             "that are positive multiples of chunk = %d; "
                             "got %s" % (chunk, list(runs)))
        at += length
    if at != N:
        raise ValueError("runs cover [0, %d), not [0, N = %d)" % (at, N))


def merge_level_plain(lanes: torch.Tensor, runs: Runs) -> torch.Tensor:
    """Plain PyTorch version, a real merge: A[i] goes to i +
    searchsorted(B, A[i], left), B[j] to j + searchsorted(A, B[j], right),
    so ties go A-first."""
    out = torch.empty_like(lanes)
    for a0, alen, b0, blen in _pair_runs(runs)[0]:
        a = lanes[a0:a0 + alen]
        b = lanes[b0:b0 + blen]
        ia = torch.arange(alen, device=lanes.device)
        ib = torch.arange(blen, device=lanes.device)
        out[a0 + ia + torch.searchsorted(b, a, right=False)] = a
        out[a0 + ib + torch.searchsorted(a, b, right=True)] = b
    return out


def _merge_level_cuda(lanes: torch.Tensor, runs: Runs) -> torch.Tensor:
    lib = _kernel_lib()
    N = lanes.numel()
    pairs = torch.tensor([(a0, alen, blen) for a0, alen, _, blen
                          in _pair_runs(runs)[0]], dtype=torch.int64,
                         device=lanes.device)
    out = torch.empty_like(lanes)
    splits = torch.empty(N // lib.kmtpu_merge_tile() + 1, dtype=torch.int64,
                         device=lanes.device)
    with torch.cuda.device(lanes.device):
        err = lib.kmtpu_merge_level(lanes.data_ptr(), out.data_ptr(), N,
                                    pairs.data_ptr(), pairs.shape[0],
                                    splits.data_ptr(), _stream(lanes))
    if err != 0:
        raise RuntimeError("merge_level kernel launch failed: CUDA error %d"
                           % err)
    launches["merge_level"] += 1
    return out


def merge_level(lanes: torch.Tensor, runs: Sequence[Tuple[int, int]],
                chunk: int) -> Tuple[torch.Tensor, Runs]:
    """One merge level: adjacent sorted run pairs merge, an odd tail run
    copies through. Returns (lanes, next_runs)."""
    _check_lanes(lanes, "merge_level")
    runs = [(int(o), int(n)) for o, n in runs]
    _check_runs(lanes.numel(), runs, chunk)
    next_runs = _pair_runs(runs)[1]
    if lanes.device.type == "cpu":
        return merge_level_plain(lanes, runs), next_runs
    if lanes.numel() == 0:
        return lanes.clone(), next_runs   # no runs to merge: no launch
    return _merge_level_cuda(lanes, runs), next_runs


# --------------------------------------------------------------------------
# the whole sort
# --------------------------------------------------------------------------

def pad_to_block(lanes: torch.Tensor, block: int) -> torch.Tensor:
    """The lanes with sentinel rows appended up to a multiple of block."""
    pad = -lanes.numel() % block
    if not pad:
        return lanes
    return torch.cat([lanes, torch.full((pad,), SENTINEL_LANE,
                                        dtype=torch.int64,
                                        device=lanes.device)])


def _merge_sort(lanes: torch.Tensor, block: int, chunk: int, local,
                level) -> torch.Tensor:
    _check_lanes(lanes, "merge_sort_lanes")
    if not (_is_pow2(block) and _is_pow2(chunk) and block % chunk == 0):
        raise ValueError("block and chunk must be powers of two with chunk "
                         "| block, got block=%d chunk=%d" % (block, chunk))
    N = lanes.numel()
    lanes = pad_to_block(lanes, block)
    s = local(lanes, block)
    runs = [(i * block, block) for i in range(lanes.numel() // block)]
    while len(runs) > 1:
        s, runs = level(s, runs)
    return s[:N]


def merge_sort_lanes(lanes: torch.Tensor, block: int = 1 << 17,
                     chunk: int = 1 << 15) -> torch.Tensor:
    """Ascending sort of int64 lanes: block sorts, then merge levels. N is
    padded with the sentinel to a multiple of `block` and sliced back (the
    sentinel sorts last, so the padded sort's prefix is the sort)."""
    return _merge_sort(lanes, block, chunk, local_sort_blocks,
                       lambda s, runs: merge_level(s, runs, chunk))


def merge_sort_lanes_plain(lanes: torch.Tensor, block: int = 1 << 17,
                           chunk: int = 1 << 15) -> torch.Tensor:
    """merge_sort_lanes through the plain versions on any device: what the
    kernels are held to on the card."""
    def level(s, runs):
        _check_runs(s.numel(), runs, chunk)
        return merge_level_plain(s, runs), _pair_runs(runs)[1]
    return _merge_sort(lanes, block, chunk, local_sort_blocks_plain, level)


def merge_sort_2key(hi: torch.Tensor, lo: torch.Tensor, block: int = 1 << 17,
                    chunk: int = 1 << 15):
    """Full sort of (hi, lo) key columns (int64 words in [0, 2^32)), the
    JAX merge_sort_2key's signature: returns the sorted (hi, lo)."""
    s = merge_sort_lanes(encode_lane([hi, lo]).contiguous(), block, chunk)
    return tuple(decode_lane(s, 2))
