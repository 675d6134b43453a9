"""Duplicate (PCR) fragment filter.

Re-implements DuplicateFragmentFilter (ref: src/DuplicateFragmentFilter.h:
156-588): fragments are keyed by the first `dedup-length` bases of read1
concatenated with the reverse complement of the first `dedup-length` bases
of read2 (mode 2 canonicalizes so AB == BA); groups of >= 2 identical keys
collapse to a consensus pair (or a random representative), all members are
discarded, and the consensus reads are artifact-filtered and appended.

Copied for kmernator_tpu_torch from kmernator_tpu/ops/dedup.py; it differs
from its source only in its package imports.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet, BASE_CODE
from kmernator_tpu_torch.ops.consensus import consensus_read
from kmernator_tpu_torch.ops.kmer import (revcomp_words, words_less, nwords,
                                    string_to_words)


def _prefix_words(codes: np.ndarray, nbases: int) -> np.ndarray:
    """Pack the first nbases codes into ceil(nbases/16) u32 words."""
    W = (nbases + 15) // 16
    out = np.zeros(W, dtype=np.uint32)
    for i in range(nbases):
        w, o = divmod(i, 16)
        out[w] |= np.uint32(int(codes[i]) << (30 - 2 * o))
    return out


def _revcomp_prefix(codes: np.ndarray, nbases: int) -> np.ndarray:
    rc = 3 - codes[:nbases][::-1]
    return _prefix_words(rc, nbases)


def first_markup_x_length(rs: ReadSet, i: int) -> int:
    """ref: Sequence::getFirstMarkupXLength — only 'X' markups truncate."""
    s, e = rs.offsets[i], rs.offsets[i + 1]
    seq = rs.seq[s:e]
    w = np.flatnonzero(seq == ord("X"))
    if len(w):
        return int(w[0])
    return int(e - s)


def filter_duplicate_fragments(rs: ReadSet, dedup_length: int = 24,
                               mode: int = 1, consensus: bool = True,
                               dedup_single: bool = False,
                               start_offset: int = 0,
                               min_quality: int = 3, output_base: int = 33,
                               artifact_filter=None,
                               edit_distance: int = 0,
                               rng: np.random.Generator = None) -> int:
    """Returns the number of affected reads; mutates rs (discards + appends
    consensus reads).  ref: filterDuplicateFragments (:561-586)."""
    if mode == 0 or edit_distance == -1:
        return 0
    nbases = max(dedup_length // 4, 1) * 4
    affected = _filter(rs, nbases, mode, consensus, True, start_offset,
                       min_quality, output_base, artifact_filter, rng,
                       edit_distance)
    if dedup_single:
        affected += _filter(rs, nbases * 2, mode, consensus, False,
                            start_offset, min_quality, output_base,
                            artifact_filter, rng, edit_distance)
    return affected


def _merge_within_edit_distance(groups: Dict[Tuple, list], nbases: int,
                                paired: bool, cutoff: int = 2):
    """Merge fragment-key groups within hamming distance 1, strongest first
    (ref: _mergeNodesWithinEditDistance + KmerSpectrum::consolidate).
    Only edit distance 1 is supported (the reference rejects > 1)."""
    from kmernator_tpu_torch.ops.kmer import nwords
    k = nbases * (2 if paired else 1)
    W = nwords(k)
    order = sorted(groups.keys(),
                   key=lambda key: -len(groups[key]))
    for key in order:
        members = groups.get(key)
        if members is None or len(members) < cutoff:
            continue
        words = np.array(key, dtype=np.uint32).reshape(1, W)
        for posn in range(k):
            w, o = divmod(posn, 16)
            shift = np.uint32(30 - 2 * o)
            cur = (words[0, w] >> shift) & np.uint32(3)
            for nb in range(4):
                if nb == cur:
                    continue
                nkey = list(key)
                nkey[w] = int((words[0, w] & ~(np.uint32(3) << shift))
                              | (np.uint32(nb) << shift))
                nkey = tuple(nkey)
                other = groups.get(nkey)
                if other is not None and nkey != key:
                    members.extend(other)
                    del groups[nkey]


def _filter(rs: ReadSet, nbases: int, mode: int, consensus: bool,
            paired: bool, start_offset: int, min_quality: int,
            output_base: int, artifact_filter, rng,
            edit_distance: int = 0) -> int:
    use_rc = mode == 2
    groups: Dict[Tuple, List[Tuple[int, bool]]] = {}
    n_pairs = len(rs.pairs)
    codes_flat = np.where(BASE_CODE[rs.seq] == 4, 0, BASE_CODE[rs.seq])

    for pair_idx, (r1, r2) in enumerate(rs.pairs):
        if paired:
            if r1 < 0 or r2 < 0:
                continue
            if rs.discarded[r1] or rs.discarded[r2]:
                continue
            if first_markup_x_length(rs, r1) < nbases + start_offset:
                continue
            if first_markup_x_length(rs, r2) < nbases + start_offset:
                continue
            c1 = codes_flat[rs.offsets[r1] + start_offset:
                            rs.offsets[r1] + start_offset + nbases]
            c2 = codes_flat[rs.offsets[r2] + start_offset:
                            rs.offsets[r2] + start_offset + nbases]
            # fragment key = read1 prefix + revcomp(read2 prefix), packed
            # contiguously as one 2*nbases kmer (the reference memcpys the
            # packed bytes back to back, ref: :217,226)
            combined = np.concatenate([c1, 3 - c2[::-1]])
            fwd = _prefix_words(combined, 2 * nbases)
            flipped = False
            if use_rc:
                k = 2 * nbases
                rc = revcomp_words(np, fwd[None, :], k)[0]
                if words_less(np, rc[None, :], fwd[None, :])[0]:
                    fwd = rc
                    flipped = True
            groups.setdefault(tuple(fwd.tolist()), []).append((pair_idx, flipped))
        else:
            r = r1 if r1 >= 0 else r2
            if r < 0 or (r1 >= 0 and r2 >= 0):
                continue  # only singles in this pass
            if rs.discarded[r]:
                continue
            if first_markup_x_length(rs, r) < nbases + start_offset:
                continue
            c = codes_flat[rs.offsets[r] + start_offset:
                           rs.offsets[r] + start_offset + nbases]
            groups.setdefault(tuple(_prefix_words(c, nbases).tolist()),
                              []).append((pair_idx, False))

    if edit_distance > 0:
        _merge_within_edit_distance(groups, nbases, paired)

    affected = 0
    new_reads: List[Tuple[bytes, bytes, np.ndarray]] = []
    if rng is None:
        rng = np.random.default_rng(0)
    for key, members in groups.items():
        if len(members) < 2:
            continue
        if paired:
            affected += 2 * len(members)
            if consensus:
                idx1 = []
                idx2 = []
                for pi, flipped in members:
                    r1, r2 = rs.pairs[pi]
                    idx1.append(r2 if flipped else r1)
                    idx2.append(r1 if flipped else r2)
                new_reads.append(consensus_read(rs, idx1, min_quality, output_base))
                new_reads.append(consensus_read(rs, idx2, min_quality, output_base))
                keep = None
            else:
                keep = int(rng.integers(0, len(members)))
            for mi, (pi, _) in enumerate(members):
                if keep is not None and mi == keep:
                    continue
                r1, r2 = rs.pairs[pi]
                rs.discarded[r1] = True
                rs.discarded[r2] = True
        else:
            affected += len(members)
            idxs = [rs.pairs[pi][0] if rs.pairs[pi][0] >= 0 else rs.pairs[pi][1]
                    for pi, _ in members]
            if consensus:
                new_reads.append(consensus_read(rs, idxs, min_quality, output_base))
                keep = None
            else:
                keep = int(rng.integers(0, len(members)))
            for mi, r in enumerate(idxs):
                if keep is not None and mi == keep:
                    continue
                rs.discarded[r] = True

    if new_reads:
        sub = ReadSet()
        sub.input_qual_base = output_base
        sub.append_reads_batch([r[0] for r in new_reads],
                               [b""] * len(new_reads),
                               [r[1] for r in new_reads],
                               [r[2] for r in new_reads])
        sub.identify_pairs()
        if artifact_filter is not None:
            from kmernator_tpu_torch.ops.artifact import apply_artifact_filter
            apply_artifact_filter(sub, artifact_filter)
        base = rs.n
        rs.append_reads_batch(
            sub.names, sub.comments,
            [sub.get_seq(i) for i in range(sub.n)],
            [sub.get_phred(i) if sub.has_quals[i] else None
             for i in range(sub.n)])
        rs.discarded[base:] = sub.discarded
        # pair up appended consensus reads (identifyPairs on new reads,
        # ref: _buildConsensusPairedReads tail)
        if paired:
            for j in range(0, sub.n - 1, 2):
                rs.pairs.append((base + j, base + j + 1))
        else:
            for j in range(sub.n):
                rs.pairs.append((base + j, -1))
    return affected
