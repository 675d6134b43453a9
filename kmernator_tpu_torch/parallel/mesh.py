"""The device mesh of the port (one device for now) and the extension
spectrum on it.

Twin of kmernator_tpu/parallel/mesh.py at D = 1: `make_mesh`, and the
MeraculousCounter mesh path, `distributed_extension_fn` with its
`_window_extensions_device` and `_count_received_ext`
(`extension_spectrum_mesh`, `window_extensions_device`,
`count_received_ext`). With one device the owner hash, the bucket scatter
and the all_to_all of the JAX mesh are the identity, so the handle only
names the device. D > 1 (owner_hash_cols, _bucket_scatter_cols and the
exchange over NCCL) is a later PR's work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from kmernator_tpu_torch.ops.extensions import EXT_X
from kmernator_tpu_torch.ops.kmer import check_k, encode_lanes
from kmernator_tpu_torch.parallel.device_spectrum import (
    extract_canonical_cols, is_sentinel, sort_lanes)
from kmernator_tpu_torch.parallel.run_length import run_length_sums


@dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh; `size` devices along axis 'd'."""
    device: torch.device
    size: int = 1


def make_mesh(n_devices: int = 1, device="cuda") -> Mesh:
    if n_devices != 1:
        raise NotImplementedError(
            "kmernator_tpu_torch runs a mesh of one device; --mesh %d "
            "(owner hash, bucket scatter and all_to_all over NCCL) waits "
            "for the D > 1 PR" % n_devices)
    return Mesh(torch.device(device))


def window_extensions_device(codes: torch.Tensor, lengths: torch.Tensor,
                             is_fwd: torch.Tensor, ext_ok: torch.Tensor,
                             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left/right extension codes of every window, on the codes' device
    (the JAX `_window_extensions_device`; ops/extensions.py over ragged
    reads; ref: src/KmerReadUtils.h:200-236). codes [B, L] (0..3), lengths
    [B], is_fwd [B, NW] bool, ext_ok [B, L] bool -> (left, right) [B, NW]
    int32: 0..3 a base, EXT_X off the end of the read, -1 below the
    extension quality; reverse windows swap sides and complement."""
    B, L = codes.shape
    NW = L - k + 1
    dev = codes.device
    pos = torch.arange(NW, dtype=torch.int32, device=dev)[None, :]
    c = codes.to(torch.int32)
    zc = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    zb = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    left_codes = torch.cat([zc, c[:, :NW - 1]], dim=1)
    left_ok = torch.cat([zb, ext_ok[:, :NW - 1]], dim=1)
    left = torch.where(pos == 0, EXT_X,
                       torch.where(left_ok, left_codes, -1))
    del left_codes, left_ok
    # the right neighbour of window i is base i + k
    right_codes = torch.cat([c[:, k:], zc], dim=1)
    right_ok = torch.cat([ext_ok[:, k:], zb], dim=1)
    in_read = (pos + k) < lengths.to(torch.int32)[:, None]
    right = torch.where(~in_read, EXT_X,
                        torch.where(right_ok, right_codes, -1))
    del c, right_codes, right_ok, in_read

    def comp(e):
        return torch.where((e >= 0) & (e < 4), 3 - e, e)

    return (torch.where(is_fwd, left, comp(right)),
            torch.where(is_fwd, right, comp(left)))


def count_received_ext(lanes: List[torch.Tensor], good: torch.Tensor,
                       el: torch.Tensor, er: torch.Tensor, min_count: int):
    """The count and the 2 x 6 extension counters of every key run (the
    JAX `_count_received_ext`). lanes: L [n] int64 key lanes
    (ops/kmer.py encode_lanes); good [n] bool; el, er [n] int32 codes
    (0..5, or -1 untracked). Returns the kept runs in key order: (L [M]
    int64 lanes, counts [M] int32, ext [M, 12] int32, columns left A C G T
    N X then right A C G T N X). A run is kept when its key is not the
    sentinel and its count of good rows is >= min_count. The JAX function
    returns the same runs at their first rows of an [n] table padded with
    the sentinel; here each sum comes from the run-length kernel at the
    run's last row, and the 13 sums are reduced to the kept rows one at a
    time, so that only one [n] sum is held at once. Counts wrap at 32 bits
    as the JAX scans do."""
    s, perm = sort_lanes(lanes)
    sgood = good[perm]
    n = s[0].numel()
    cnt = run_length_sums(s, sgood.to(torch.int32))
    is_end = torch.ones(n, dtype=torch.bool, device=cnt.device)
    if n > 1:
        neq = s[0][1:] != s[0][:-1]
        for lane in s[1:]:
            neq |= lane[1:] != lane[:-1]
        is_end[:-1] = neq
        del neq
    keep = torch.nonzero(is_end & ~is_sentinel(s)
                         & (cnt >= min_count)).squeeze(1)
    counts = cnt[keep]
    del cnt, is_end
    ext = torch.empty((keep.numel(), 12), dtype=torch.int32,
                      device=counts.device)
    for side, col in enumerate((el, er)):
        scol = col[perm]
        for code in range(6):
            ext[:, 6 * side + code] = run_length_sums(
                s, (sgood & (scol == code)).to(torch.int32))[keep]
        del scol
    return [lane[keep] for lane in s], counts, ext


def extension_spectrum_mesh(mesh: Mesh, k: int, codes: torch.Tensor,
                            good2d: torch.Tensor, ext_ok2d: torch.Tensor,
                            lengths: torch.Tensor, min_count: int):
    """The extension-tracking spectrum on the mesh's device (the JAX
    `distributed_extension_fn` step at D = 1). codes [B, L] (0..3), good2d
    [B, NW] bool (the exact host mask), ext_ok2d [B, L] bool, lengths [B];
    all on mesh.device. Returns count_received_ext's (lanes, counts, ext)
    over the good windows, in key order."""
    check_k(k)
    canon, is_fwd, valid = extract_canonical_cols(codes, lengths, k)
    el, er = window_extensions_device(codes, lengths, is_fwd, ext_ok2d, k)
    del is_fwd
    # At D = 1 the JAX bucket scatter is a compaction: its one bucket holds
    # C = ceil(2 N) >= N rows, so it never overflows and the app's retry
    # at a larger capacity cannot fire; the good windows are taken in
    # place and the rest (the sentinel rows it drops) are left out. The
    # owner hash, the scatter and its retry wait for D > 1.
    sel = torch.nonzero((good2d & valid).reshape(-1)).squeeze(1)
    del valid
    lanes = [lane[sel] for lane in encode_lanes(
        [c.reshape(-1) for c in canon])]
    del canon
    el, er = el.reshape(-1)[sel], er.reshape(-1)[sel]
    good = torch.ones(sel.numel(), dtype=torch.bool, device=sel.device)
    del sel
    return count_received_ext(lanes, good, el, er, min_count)
