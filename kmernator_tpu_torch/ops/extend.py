"""Greedy contig extension over quality-weighted k-mer spectra.

Re-implements KmerSpectrum::extendContig (ref: src/KmerSpectrum.h:2311-2373)
and ContigExtender (ref: src/ContigExtender.h:132-282): per contig, per
direction, try ascending odd k until one spectrum supports calling the next
base (total extension coverage >= minimumCoverage, winning base consensus >=
minimumConsensus, total/edge > maximumDeltaRatio), recording used kmers to
block repeats.

Deviation: weighted counts accumulate in float64 (the reference sums float32
in insertion order); thresholds are coarse so decisions agree.

Copied for kmernator_tpu_torch from kmernator_tpu/ops/extend.py; it
differs from its source only in its package imports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kmernator_tpu_torch.io.reads import ReadSet, BASE_CODE
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat, revcomp_words, words_less, nwords
from kmernator_tpu_torch.ops.weights import window_weights, good_kmer_mask
from kmernator_tpu_torch.parallel.spectrum import KmerSpectrum, pack_keys

_COMP = {65: 84, 67: 71, 71: 67, 84: 65}  # A<->T C<->G


def _canon_key(seq: bytes):
    """Canonical sortable key of an ACGT bytes kmer (u64 or byte-string)."""
    k = len(seq)
    codes = BASE_CODE[np.frombuffer(seq, np.uint8)]
    codes = np.where(codes == 4, 0, codes)
    words = np.zeros((1, nwords(k)), dtype=np.uint32)
    for i in range(k):
        w, o = divmod(i, 16)
        words[0, w] |= np.uint32(int(codes[i]) << (30 - 2 * o))
    rc = revcomp_words(np, words, k)
    canon = rc if words_less(np, rc, words)[0] else words
    return pack_keys(canon)[0]


def build_weighted_spectrum(rs: ReadSet, k: int, min_quality: int,
                            output_base: int, min_kmer_quality: float) -> KmerSpectrum:
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    canon, is_fwd, read_id, _ = extract_kmers_flat(codes, rs.offsets, k)
    keys = pack_keys(canon)
    p = rs.base_probabilities(min_quality, output_base)
    w = window_weights(p, rs.offsets, markup, k)
    good = good_kmer_mask(w, min_kmer_quality) & ~rs.discarded[read_id]
    return KmerSpectrum.from_observations(k, keys, good,
                                          weights=w.astype(np.float32))


class WeightedLookup:
    """Weighted-count lookup over a spectrum's weak map (count >= 2)."""

    def __init__(self, sp: KmerSpectrum):
        keep = sp.counts >= 2
        self.keys = sp.keys[keep]
        self.weighted = (sp.weighted[keep] if sp.weighted is not None
                         else sp.counts[keep].astype(np.float64))

    def value(self, key) -> float:
        if len(self.keys) == 0:
            return 0.0
        i = np.searchsorted(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return float(self.weighted[i])
        return 0.0


@dataclass
class ExtendParams:
    """ref: _ContigExtenderBaseOptions defaults."""
    minimum_consensus: float = 0.85
    minimum_coverage: float = 4.8
    maximum_delta_ratio: float = 0.33
    max_extend: int = 50


def extend_contig_once(fasta: bytearray, to_right: bool, lookup: WeightedLookup,
                       k: int, params: ExtendParams,
                       exclude: Optional[set]) -> bool:
    """One base of extension at one k (ref: extendContig)."""
    if len(fasta) <= k:
        return False
    edge = bytes(fasta[-k:] if to_right else fasta[:k])
    edge_val = lookup.value(_canon_key(edge))
    if edge_val == 0.0:
        return False
    core = edge[1:] if to_right else edge[:-1]
    vals = []
    keys = []
    for base in b"ACGT":
        cand = core + bytes([base]) if to_right else bytes([base]) + core
        key = _canon_key(cand)
        keys.append(key)
        vals.append(lookup.value(key))
    total = sum(vals)
    if total >= params.minimum_coverage and (total / edge_val) > params.maximum_delta_ratio:
        for i, base in enumerate(b"ACGT"):
            consensus = vals[i] / total
            if consensus >= params.minimum_consensus:
                if exclude is not None and keys[i] in exclude:
                    return False  # repeat detected (ref: :2355-2358 break)
                if to_right:
                    fasta.append(base)
                else:
                    fasta.insert(0, base)
                return True
    return False


def _record_kmers(exclude_sets: Dict[int, set], to_right: bool, fasta: bytes,
                  ksizes: List[int]):
    """ref: ContigExtender::recordKmer — the new edge kmer at every size."""
    for k in ksizes:
        if len(fasta) < k:
            break
        sub = fasta[-k:] if to_right else fasta[:k]
        exclude_sets[k].add(_canon_key(sub))


def get_min_max_kmer_size(rs: ReadSet, min_kmer: int, max_steps: int = 6):
    """ref: ContigExtender::getMinMaxKmerSize."""
    if rs.n == 0:
        return min_kmer, min_kmer, 2
    max_len = min(int(rs.max_length()), int(rs.lengths().sum() // rs.n))
    max_kmer = min(int(max_len * 0.95), max_len - 1)
    max_kmer = max(min_kmer, max_kmer)
    step = (max_kmer - min_kmer) // max_steps
    if step & 1:
        step += 1
    step = max(2, step)
    return min_kmer, max_kmer, step


def new_contig_name(old: bytes, left: int, right: int) -> bytes:
    """ref: ContigExtender::getNewName — accumulate -l<n>r<m> suffixes."""
    if left + right == 0:
        return old
    pre_l = pre_r = 0
    name = old
    pos = old.rfind(b"-l")
    if pos >= 0:
        pos2 = old.find(b"r", pos)
        if pos2 >= 0:
            try:
                pre_l = int(old[pos + 2:pos2])
                pre_r = int(old[pos2 + 1:])
                name = old[:pos]
            except ValueError:
                pass
    return name + b"-l%dr%d" % (left + pre_l, right + pre_r)


def extend_contigs(contigs: ReadSet, reads: ReadSet, params: ExtendParams,
                   min_kmer: int, max_kmer: Optional[int] = None,
                   kmer_step: Optional[int] = None, min_quality: int = 3,
                   output_base: int = 33, min_kmer_quality: float = 0.10
                   ) -> ReadSet:
    """ref: ContigExtender::extendContigs (:157-247).  Returns new contigs
    (REF_QUAL quality, names suffixed -l<n>r<m>)."""
    if max_kmer is None or kmer_step is None:
        min_kmer, max_kmer, kmer_step = get_min_max_kmer_size(reads, min_kmer)
    ksizes = list(range(min_kmer, max_kmer + 1, kmer_step))
    lookups: Dict[int, WeightedLookup] = {}
    for k in ksizes:
        lookups[k] = WeightedLookup(
            build_weighted_spectrum(reads, k, min_quality, output_base,
                                    min_kmer_quality))

    out = ReadSet()
    out.input_qual_base = output_base
    for ci in range(contigs.n):
        fasta = bytearray(contigs.get_seq(ci))
        exclude: Dict[int, set] = {k: set() for k in ksizes}
        # seed with the contig's own kmers (ref: contigSpectrums build)
        codes = np.where(BASE_CODE[np.frombuffer(bytes(fasta), np.uint8)] == 4, 0,
                         BASE_CODE[np.frombuffer(bytes(fasta), np.uint8)]).astype(np.uint8)
        for k in ksizes:
            if len(fasta) >= k:
                canon, _, _, _ = extract_kmers_flat(codes, np.array([0, len(fasta)]), k)
                exclude[k].update(pack_keys(canon).tolist())
        left_total = right_total = 0
        extend_left = extend_right = True
        iteration = 0
        while iteration < params.max_extend and (extend_left or extend_right):
            iteration += 1
            if len(fasta) < min_kmer:
                break
            if extend_left:
                extend_left = False
                for k in ksizes:
                    if extend_contig_once(fasta, False, lookups[k], k, params,
                                          exclude[k]):
                        _record_kmers(exclude, False, bytes(fasta), ksizes)
                        left_total += 1
                        extend_left = True
                        break
            if extend_right:
                extend_right = False
                for k in ksizes:
                    if extend_contig_once(fasta, True, lookups[k], k, params,
                                          exclude[k]):
                        _record_kmers(exclude, True, bytes(fasta), ksizes)
                        right_total += 1
                        extend_right = True
                        break
        name = new_contig_name(contigs.names[ci], left_total, right_total)
        out.append_read(name, b"", bytes(fasta), None)
    return out
