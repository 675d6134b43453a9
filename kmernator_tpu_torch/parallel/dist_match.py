"""The k-mer -> read-id matcher of the assembler's `--mesh` path, on the
shards of a mesh on one torch device.

Twin of kmernator_tpu/parallel/dist_match.py: `build_index_fn` and
`match_fn` (the JAX builders' call signatures, over `build_index` and
`match_shards`, which are their steps), `match`, `MeshReadIndex` and
`mesh_match_pools` (a copy). The build extracts
canonical windows from D contiguous blocks of the reads, routes each
(key, read id) row to the shard that owns the key (owner hash, bucket
scatter with an overflow count, the exchange of parallel/mesh.py) and
sorts each shard's received rows by (key, read id); the match answers each
query on its owner shard and merges the shards' answers as the JAX pmax
does (only the owner writes an id, so the merge puts each answer in
place).

Keys are int64 lanes (ops/kmer.py `encode_lanes`: one lane for k <= 32,
ceil(k / 32) lanes at any larger k). Read ids are the rows of the
read set padded to a multiple of D (the JAX `read_global`).

Differences from the JAX module besides the torch tensors:
- A shard's index holds only the rows it received (possibly none), not
  D * C rows padded with the sentinel; every query still gets the same ids.
- Within a key's run the ids ascend, as the JAX sort's read-id key makes
  them: a shard receives its rows in read order (each source is a
  contiguous block of reads, sent in order, and a bucket keeps its rows'
  order), and they go through one stable sort on the key lanes.
- `match_queries` takes any number of queries: the JAX one pads Q to a
  power of two, since XLA compiles one program a shape, and cuts the
  padded rows off its answer. It also compacts the hits on the device
  (one copy to the host) before it builds each query's set from them, in
  the order the JAX code inserts them: ids ascending within a query.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from kmernator_tpu_torch.io.reads import BASE_CODE
from kmernator_tpu_torch.ops.kmer import (SENTINEL_LANE, SENTINEL_WORD,
                                          decode_lanes,
                                          encode_lanes, extract_kmers_flat,
                                          nwords)
from kmernator_tpu_torch.parallel.device_spectrum import (
    extract_canonical_cols, search_lanes, sort_lanes)
from kmernator_tpu_torch.parallel.mesh import (
    Mesh, bucket_loads, bucket_slots, exchange, owners, plane_width,
    scatter_plane)
from kmernator_tpu_torch.parallel.prepare_reads import prepare_reads

Shard = Tuple[List[torch.Tensor], torch.Tensor]


def build_index(mesh: Mesh, k: int, codes: torch.Tensor,
                good2d: torch.Tensor, lengths: torch.Tensor,
                capacity_factor: float = 2.0,
                read_global: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[List[Shard]], int]:
    """The sorted read index of every shard (the JAX `build_index_fn`
    step). codes [B, L] (0..3), good2d [B, NW] bool (the exact host mask),
    lengths [B]; all on mesh.device, B a multiple of D = mesh.size. Each of
    D contiguous blocks of reads routes its good windows' (key, read id)
    rows to their owners in buckets of C = ceil(N / D * capacity_factor)
    rows (N windows a block; the planes as wide as the largest bucket,
    `plane_width`). Returns (shards, 0), shard d being (L [n_d]
    int64 key lanes sorted lexicographically, rid [n_d] int32) with ids
    ascending within a key's run; or (None, the rows past C) when a bucket
    overflows, for the caller to retry at a larger capacity_factor. A
    row's id is its read's row in the batch, or read_global [B] int32 (the
    JAX `read_global`; ids ascend within a run when it ascends)."""
    D = mesh.size
    B = codes.shape[0]
    if B % D:
        raise ValueError("%d reads do not split into %d shards" % (B, D))
    canon, _, valid = extract_canonical_cols(codes, lengths, k)
    NW = valid.shape[1]
    g = (good2d & valid).reshape(D, -1)
    del valid
    N = g.shape[1]
    words = [torch.where(g, c.reshape(D, -1), SENTINEL_WORD) for c in canon]
    del canon
    owner = owners(words, D)
    C = math.ceil(N / D * capacity_factor)
    loads = bucket_loads(owner, g, D)
    width = plane_width(loads)
    if width > C:
        return None, int((loads - C).clamp_(min=0).sum())
    win_slot, _ = bucket_slots(owner, g, D, width)
    del owner, g
    row = torch.div(torch.arange(B * NW, device=codes.device), NW,
                    rounding_mode="floor")
    rid = (row if read_global is None else
           read_global.to(torch.int64)[row]).reshape(D, N)
    recv_rid = exchange(scatter_plane(rid, win_slot, D, width, -1))
    recv = [exchange(scatter_plane(lane, win_slot, D, width, SENTINEL_LANE))
            for lane in encode_lanes(words)]
    del words, win_slot, rid
    shards = []
    for d in range(D):
        keep = torch.nonzero(recv_rid[d] >= 0).squeeze(1)
        lanes = [lane[d][keep] for lane in recv]
        # a stable sort keeps the read order of the rows within a key's
        # run: the order the JAX sort gets from its read-id key
        if len(lanes) == 1:
            lanes[0], perm = torch.sort(lanes[0], stable=True)
        else:
            lanes, perm = sort_lanes(lanes)
        shards.append((lanes, recv_rid[d][keep][perm].to(torch.int32)))
    return shards, 0


def match(index_lanes: List[torch.Tensor], index_rid: torch.Tensor,
          queries: List[torch.Tensor], max_ids: int = 16,
          min_depth: int = 0) -> torch.Tensor:
    """Read ids of each query in one shard's index (the JAX `match_fn`
    step on the owner). queries: L [Q] int64 key lanes on the index's
    device. Returns [Q, max_ids] int32: the first max_ids ids of the
    query's run, -1 past its end and for every id of a run shorter than
    max(min_depth, 1) (the KmerMatch purgeMinDepth gate, ref:
    src/KmerMatch.h:100)."""
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


def match_shards(shards: List[Shard], query_cols: List[torch.Tensor],
                 max_ids: int = 16, min_depth: int = 0) -> torch.Tensor:
    """Read ids of each query over all shards (the JAX `match_fn`):
    query_cols W [Q] int64 canonical words. Each shard answers the queries
    it owns; the others are -1 there, so the JAX pmax over the shards'
    answers is each answer put in its rows. Returns [Q, max_ids] int32."""
    lanes = encode_lanes(query_cols)
    D = len(shards)
    if D == 1:
        return match(*shards[0], lanes, max_ids, min_depth)
    owner = owners(query_cols, D)
    out = torch.full((lanes[0].numel(), max_ids), -1, dtype=torch.int32,
                     device=lanes[0].device)
    for d, (index_lanes, index_rid) in enumerate(shards):
        sel = torch.nonzero(owner == d).squeeze(1)
        out[sel] = match(index_lanes, index_rid, [lane[sel] for lane in lanes],
                         max_ids, min_depth)
    return out


def build_index_fn(mesh: Mesh, k: int, capacity_factor: float = 2.0):
    """The JAX `build_index_fn` call: returns fn(codes [B, L], good [B, NW]
    bool, lengths [B], read_global [B] int32), tensors on mesh.device, B a
    multiple of D -> (index_keys, index_rid, overflow). index_keys is a
    list of D tensors [n_d, W] of int64 words, shard d's keys in key
    order; index_rid the D [n_d] int32 read ids beside them, ascending
    within a run where read_global ascends (the JAX sort orders a run by
    id whatever read_global is); overflow the rows past C over all
    sources. The layout
    keeps the port's difference (module docstring): a shard holds the rows
    it received, where the JAX shard is D * C rows padded with the
    sentinel and id -1, and the shards come as a list, not end to end. On
    overflow the port builds no index (both lists are None); the JAX one
    keeps the rows that fit, chosen by its sort's tie order."""
    def fn(codes, good, lengths, read_global):
        shards, overflow = build_index(mesh, k, codes, good, lengths,
                                       capacity_factor, read_global)
        if shards is None:
            return None, None, overflow
        W = nwords(k)
        return ([torch.stack(decode_lanes(lanes, W), dim=-1)
                 for lanes, _ in shards], [rid for _, rid in shards],
                overflow)
    return fn


def match_fn(mesh: Mesh, k: int, max_ids: int = 16, min_depth: int = 0):
    """The JAX `match_fn` call: returns fn(queries [Q, W] words (uint32
    numpy or int64 tensor), index_keys, index_rid as build_index_fn gives
    them) -> ids [Q, max_ids] int32 on mesh.device: the first max_ids read
    ids of each query's run on its owner shard, -1 past the run's end and
    for every id of a run shorter than max(min_depth, 1); the JAX ids."""
    def fn(queries, index_keys, index_rid):
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.asarray(queries, np.int64))
        q = queries.to(mesh.device)
        shards = [(encode_lanes([keys[:, w] for w in range(keys.shape[1])]),
                   rid) for keys, rid in zip(index_keys, index_rid)]
        return match_shards(shards, [q[:, w] for w in range(q.shape[1])],
                            max_ids, min_depth)
    return fn


class MeshReadIndex:
    """The read index on the mesh's shards, a drop-in for
    ops.match.KmerReadIndex (the JAX `MeshReadIndex`). Its input is the
    JAX one, built by prepare_reads on the mesh's device (its kernel on a
    CUDA device, the host's steps on the CPU): the codes, the exact good
    mask with discarded reads masked out and the lengths, the reads
    padded with empty rows to a multiple of D. A bucket overflow retries
    the build at twice the capacity_factor, up to 32."""

    def __init__(self, mesh: Mesh, rs, k: int, min_depth: int = 2,
                 min_quality: int = 3, output_base: int = 33,
                 min_kmer_quality: float = 0.10,
                 max_ids: int = 4096, capacity_factor: float = 2.0):
        self.k = k
        self.mesh = mesh
        self.max_ids = max_ids
        self.min_depth = min_depth
        codes, good2d, lengths = prepare_reads(
            rs, k, max(rs.max_length(), k), min_quality, output_base,
            min_kmer_quality, rows=-(-rs.n // mesh.size) * mesh.size,
            device=mesh.device)[:3]
        cap = capacity_factor
        while True:
            self._shards, overflow = build_index(mesh, k, codes, good2d,
                                                 lengths, cap)
            if not overflow:
                break
            cap *= 2.0  # hash-skewed reads: double bucket capacity
            if cap > 32.0:
                raise RuntimeError("matcher index bucket overflow even at "
                                   "capacity %g" % cap)
        self.W = nwords(k)

    def match_queries(self, queries: np.ndarray):
        """queries [Q, W] canonical words -> list of Q python sets."""
        Q = len(queries)
        if Q == 0:
            return []
        cols = [torch.from_numpy(queries[:, w].astype(np.int64)).to(
            self.mesh.device) for w in range(queries.shape[1])]
        ids = match_shards(self._shards, cols, self.max_ids, self.min_depth)
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
