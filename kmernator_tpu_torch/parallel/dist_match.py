"""The k-mer -> read-id matcher of the assembler's `--mesh` path, on one
torch device.

Twin of kmernator_tpu/parallel/dist_match.py at D = 1: `build_index`
(its `build_index_fn`), `match` (its `match_fn`), `MeshReadIndex` and
`mesh_match_pools` (a copy). The JAX build extracts canonical windows,
routes each (key, read id) row to the shard that owns the key (owner hash,
bucket scatter with an overflow count, all_to_all) and sorts the received
rows by (key words, read id); the JAX match answers each query on its
owner shard and merges the shards with a pmax. With one device the owner
is always this device, all_to_all and pmax are the identity, and the one
bucket of ceil(2N) >= N rows cannot overflow, so the app's retry at a
larger capacity cannot fire: here the good windows are compacted in read
order and sorted, and a query is answered by two searches over the sorted
key lanes. The owner hash, the scatter, its retry and the all-reduce MAX
that stands for pmax wait for D > 1, as in parallel/mesh.py.

Keys are int64 lanes (ops/kmer.py `encode_lanes`: one lane for k <= 32,
up to 3 for k <= 96; `check_k` refuses more). Read ids are the rows of the
padded read set (the JAX `read_global`, which is arange(B) at D = 1).

Differences from the JAX module besides the torch tensors:
- The index holds only the good windows (C rows, possibly 0), not D * C
  rows padded with the sentinel; every query still gets the same ids.
- Within a key's run the ids ascend, as the JAX sort's read-id key makes
  them: the rows enter one stable sort on the key lanes in read order.
- `match_queries` takes any number of queries: the JAX one pads Q to a
  power of two, since XLA compiles one program a shape, and cuts the
  padded rows off its answer. It also compacts the hits on the device
  (one copy to the host) before it builds each query's set from them, in
  the order the JAX code inserts them: ids ascending within a query.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from kmernator_tpu_torch.io.reads import BASE_CODE
from kmernator_tpu_torch.ops.kmer import (check_k, encode_lanes,
                                          extract_kmers_flat, nwords)
from kmernator_tpu_torch.ops.weights import good_kmer_mask, window_weights
from kmernator_tpu_torch.parallel.device_spectrum import (
    extract_canonical_cols, pack_readset, ragged_to_padded, search_lanes,
    sort_lanes)
from kmernator_tpu_torch.parallel.mesh import Mesh


def build_index(mesh: Mesh, k: int, codes: torch.Tensor,
                good2d: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The sorted read index on mesh.device (the JAX `build_index_fn`
    step at D = 1). codes [B, L] (0..3), good2d [B, NW] bool (the exact
    host mask), lengths [B]; all on mesh.device. Returns (L [C] int64 key
    lanes sorted lexicographically, rid [C] int32): one row per good
    window, ids ascending within a key's run."""
    check_k(k)
    canon, _, valid = extract_canonical_cols(codes, lengths, k)
    NW = valid.shape[1]
    # At D = 1 the JAX bucket scatter is a compaction (see the module
    # docstring): the good windows are taken in read order instead
    sel = torch.nonzero((good2d & valid).reshape(-1)).squeeze(1)
    del valid
    lanes = [lane[sel] for lane in encode_lanes(
        [c.reshape(-1) for c in canon])]
    del canon
    # a stable sort keeps the read order of the rows within a key's run:
    # the order the JAX sort gets from its read-id key
    if len(lanes) == 1:
        lanes[0], perm = torch.sort(lanes[0], stable=True)
    else:
        lanes, perm = sort_lanes(lanes)
    rid = torch.div(sel[perm], NW, rounding_mode="floor").to(torch.int32)
    return lanes, rid


def match(index_lanes: List[torch.Tensor], index_rid: torch.Tensor,
          queries: List[torch.Tensor], max_ids: int = 16,
          min_depth: int = 0) -> torch.Tensor:
    """Read ids of each query (the JAX `match_fn` step at D = 1). queries:
    L [Q] int64 key lanes on the index's device. Returns [Q, max_ids]
    int32: the first max_ids ids of the query's run, -1 past its end and
    for every id of a run shorter than max(min_depth, 1) (the KmerMatch
    purgeMinDepth gate, ref: src/KmerMatch.h:100)."""
    eff_min = max(int(min_depth), 1)
    C = index_rid.numel()
    if C == 0:
        return torch.full((queries[0].numel(), max_ids), -1,
                          dtype=torch.int32, device=index_rid.device)
    start = search_lanes(index_lanes, queries, right=False)
    end = search_lanes(index_lanes, queries, right=True)
    pos = start[:, None] + torch.arange(max_ids, dtype=start.dtype,
                                        device=start.device)[None, :]
    valid = pos < end[:, None]
    if eff_min > 1:
        valid &= (end - start >= eff_min)[:, None]
    rid = index_rid[pos.clamp_(max=C - 1)]
    return torch.where(valid, rid, torch.full_like(rid, -1))


class MeshReadIndex:
    """The read index on mesh.device, a drop-in for ops.match.KmerReadIndex
    (the JAX `MeshReadIndex` at D = 1). The host side is the JAX one: the
    exact good mask from window_weights, discarded reads masked out; the
    codes, mask and lengths go to the device once."""

    def __init__(self, mesh: Mesh, rs, k: int, min_depth: int = 2,
                 min_quality: int = 3, output_base: int = 33,
                 min_kmer_quality: float = 0.10,
                 max_ids: int = 4096):
        self.k = k
        self.mesh = mesh
        self.max_ids = max_ids
        self.min_depth = min_depth
        L = max(rs.max_length(), k)
        codes, _, lengths = pack_readset(rs, L, min_quality, output_base)
        NW = L - k + 1
        codes_raw = BASE_CODE[rs.seq]
        markup = codes_raw == 4
        p = rs.base_probabilities(min_quality, output_base)
        w = window_weights(p, rs.offsets, markup, k)
        exact_good = good_kmer_mask(w, min_kmer_quality)
        nw = np.maximum(rs.lengths() - k + 1, 0)
        good2d = ragged_to_padded(exact_good, nw, NW, fill=False)
        good2d &= ~rs.discarded[:, None]
        del codes_raw, markup, p, w, exact_good

        def dev(a):
            return torch.from_numpy(a).to(mesh.device)

        self._lanes, self._rid = build_index(mesh, k, dev(codes),
                                             dev(good2d), dev(lengths))
        self.W = nwords(k)

    def match_queries(self, queries: np.ndarray):
        """queries [Q, W] canonical words -> list of Q python sets."""
        Q = len(queries)
        if Q == 0:
            return []
        cols = [torch.from_numpy(queries[:, w].astype(np.int64)).to(
            self.mesh.device) for w in range(queries.shape[1])]
        ids = match(self._lanes, self._rid, encode_lanes(cols),
                    self.max_ids, self.min_depth)
        hit = ids >= 0
        # one copy to the host: the hits of each query, then the ids of
        # every hit in row-major order (ascending within a query)
        flat = torch.cat([hit.sum(1, dtype=torch.int32), ids[hit]]).cpu()
        counts = flat[:Q].tolist()
        vals = flat[Q:].tolist()
        out, s = [], 0
        for c in counts:
            out.append(set(vals[s:s + c]))
            s += c
        return out


def mesh_match_pools(index: MeshReadIndex, contigs,
                     max_positions_from_edge: int = 500,
                     max_hits: int = 10000):
    """match_pools over the mesh index: one collective query batch for ALL
    contigs' edge kmers (vs per-contig searchsorted on the host)."""
    k = index.k
    qrows, owner_contig = [], []
    for ci in range(contigs.n):
        codes_raw = BASE_CODE[np.frombuffer(contigs.get_seq(ci), np.uint8)]
        codes = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        L = len(codes)
        if L < k:
            continue
        canon, _, _, _ = extract_kmers_flat(codes, np.array([0, L]), k)
        nwq = len(canon)
        max_kmers = max_positions_from_edge - k + 1
        pos = np.arange(nwq)
        sel = (pos <= max_kmers) | (pos >= (nwq - max_kmers if nwq > max_kmers
                                            else 0))
        canon = canon[sel]
        qrows.append(canon)
        owner_contig.extend([ci] * len(canon))
    pools = [set() for _ in range(contigs.n)]
    if not qrows:
        return pools
    queries = np.concatenate(qrows)
    hits = index.match_queries(queries)
    for qi, ci in enumerate(owner_contig):
        pools[ci] |= hits[qi]
    rng = np.random.default_rng(0)
    for ci in range(contigs.n):
        out = pools[ci]
        if max_hits and len(out) > 2 * max_hits:
            frac = (2.0 * max_hits) / len(out)
            pools[ci] = {r for r in out if rng.random() < frac}
    return pools
