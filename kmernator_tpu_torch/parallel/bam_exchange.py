"""Distributed BAM record redistribution over torch.distributed.

The MPIReadExchanger analogue (ref: src/SamUtils.h:1266-1421): alignment
records are binned by position splitters and exchanged with ONE
all-to-all of padded byte buckets, and one of their lengths.

Splitters are computed from an allgathered sample of sort keys, so every
process derives identical bins without a coordinator (the reference
gathers per-rank position histograms the same way).

Twin of kmernator_tpu/parallel/bam_exchange.py. `sort_key` is a copy.
Differences from the source:
- D, the number of bins, is the number of processes, one rank each (the
  JAX module's D is the number of devices of its global mesh, which may be
  several a process); `exchange_blobs` takes no mesh and returns one list
  of D received blobs, the JAX return's entry for this process's only
  device.
- `global_splitters` allgathers the sample with the port's
  `multihost.allgather_host` in place of `multihost_utils.process_allgather`.
- `exchange_blobs` sends its [D, C] uint8 buckets and its [D] int32
  lengths with `multihost.all_to_all_rows` (`all_to_all_single` over the
  gloo group that `multihost.initialize` made). The record bytes are host
  data on both sides: the JAX module puts them on its devices only because
  its mesh is the transport, so there is no device here to fall back
  from. NCCL for device tensors comes with the D > 1 k-mer exchange.
"""
from __future__ import annotations

from typing import List

import numpy as np

from kmernator_tpu_torch.parallel import multihost as mh


def sort_key(bd) -> np.ndarray:
    """samtools coordinate key (unmapped last) — must match
    io/bam.py coordinate_sort_order."""
    ref = np.where(bd.ref_id < 0, np.int64(1 << 40),
                   bd.ref_id.astype(np.int64))
    return ref * (1 << 34) + (bd.pos.astype(np.int64) + 2)


def global_splitters(keys: np.ndarray, n_bins: int,
                     sample_per_bin: int = 32) -> np.ndarray:
    """[n_bins-1] splitters from an allgathered key sample; identical on
    every process."""
    S = n_bins * sample_per_bin
    local = np.sort(keys.astype(np.int64))
    if len(local) == 0:
        sample = np.full(S, np.int64((1 << 62) - 1))
    else:
        qi = np.linspace(0, len(local) - 1, S).astype(np.int64)
        sample = local[qi]
    gathered = np.sort(mh.allgather_host(sample))
    qi = (np.arange(1, n_bins) * len(gathered)) // n_bins
    return gathered[qi]


def exchange_blobs(blobs: List[bytes]) -> List[bytes]:
    """blobs[d] = bytes this process sends to rank d (all D ranks).
    Returns the D blobs this process received, in source order. One
    all-to-all of [D, C] u8 + one of the int32 lengths."""
    D = mh.process_count()
    assert len(blobs) == D
    lens = np.array([len(b) for b in blobs], np.int32)
    C = int(mh.allreduce_max_int(int(lens.max()) if len(blobs) else 0))
    C = max(((C + 127) // 128) * 128, 128)
    send = np.zeros((D, C), np.uint8)
    for d, b in enumerate(blobs):
        if b:
            send[d, :len(b)] = np.frombuffer(b, np.uint8)
    rx = mh.all_to_all_rows(send)
    rl = mh.all_to_all_rows(lens)
    return [rx[s, :rl[s]].tobytes() for s in range(D)]
