"""Frozen for the benchmark's plain reference from kmernator_tpu_torch/ops/kmer.py
and cut to the NumPy host functions the reference reaches.

Packed-word k-mers: a k-mer is W = ceil(k/16) 32-bit words, 16 bases a
word, base 0 in the two most significant bits; its canonical form is the
lesser of it and its reverse complement in lexicographic word order.
"""
from __future__ import annotations

import numpy as np


def nwords(k: int) -> int:
    return (k + 15) // 16


def _mask32(x):
    return x & np.uint32(0xFFFFFFFF)


def pack16(codes):
    """codes: int array [..., L] with values 0..3 -> u32 [..., L] where
    out[..., p] packs bases p..p+15 (positions beyond L contribute zeros).

    Built from 16 shifted adds — vectorized equivalent of the reference's
    shiftLeftMatrix sub-byte shifting (ref: src/TwoBitSequence.h:146,183).
    """
    c = codes.astype(np.uint32)
    L = c.shape[-1]
    out = np.zeros_like(c)
    for t in range(min(16, L)):
        np.bitwise_or(out[..., :L - t] if t else out,
                      c[..., t:] << np.uint32(30 - 2 * t),
                      out=out[..., :L - t] if t else out)
    return out


def _reverse_bases_u32(x):
    """Reverse the 16 2-bit groups within each u32 lane."""
    for mask, s in ((np.uint32(0x33333333), np.uint32(2)),
                    (np.uint32(0x0F0F0F0F), np.uint32(4)),
                    (np.uint32(0x00FF00FF), np.uint32(8))):
        lo = np.bitwise_and(x, mask)
        np.left_shift(lo, s, out=lo)
        hi = np.right_shift(x, s)
        np.bitwise_and(hi, mask, out=hi)
        np.bitwise_or(lo, hi, out=lo)
        x = lo
    hi = np.right_shift(x, np.uint32(16))
    lo = np.left_shift(x, np.uint32(16))
    np.bitwise_or(lo, hi, out=lo)
    return lo


def shift_left_words(words, s_bases: int):
    """Shift a [..., W] big-endian word vector left by s_bases bases,
    zero-filling from the right."""
    word_shift, bit = divmod(s_bases, 16)
    if word_shift:
        pad = np.zeros(words.shape[:-1] + (word_shift,), dtype=np.uint32)
        words = np.concatenate([words[..., word_shift:], pad], axis=-1)
    if bit:
        nxt = np.concatenate(
            [words[..., 1:], np.zeros(words.shape[:-1] + (1,), dtype=np.uint32)], axis=-1)
        words = _mask32(words << np.uint32(2 * bit)) | (nxt >> np.uint32(32 - 2 * bit))
    return words


def last_word_mask(k: int) -> int:
    """Mask zeroing the pad bases of the last word (ref: src/Kmer.h:1343-1355
    masks the trailing byte the same way)."""
    used = k - 16 * (nwords(k) - 1)
    if used == 16:
        return 0xFFFFFFFF
    return (0xFFFFFFFF << (2 * (16 - used))) & 0xFFFFFFFF


def revcomp_words(words, k: int):
    """Reverse complement of [..., W]-word kmers."""
    rev = _reverse_bases_u32(_mask32(~words))  # 2-bit complement == NOT
    rev = np.flip(rev, axis=-1)
    rev = shift_left_words(rev, 16 * nwords(k) - k).copy()
    rev[..., -1] &= np.uint32(last_word_mask(k))
    return rev


def words_less(a, b):
    """Lexicographic a < b over word vectors [..., W]."""
    W = a.shape[-1]
    lt = a[..., W - 1] < b[..., W - 1]
    for w in range(W - 2, -1, -1):
        lt = np.where(a[..., w] == b[..., w], lt, a[..., w] < b[..., w])
    return lt


def extract_kmers_flat(codes_flat: np.ndarray, offsets: np.ndarray, k: int):
    """Every window of ragged concatenated reads.

    Returns (canon [N, W] u32, is_fwd [N] bool, read_id [N] int64,
    pos [N] int64) for every window of every read (reads shorter than k
    contribute none).
    """
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    nw = np.maximum(lens - k + 1, 0)
    N = int(nw.sum())
    W = nwords(k)
    if N == 0:
        return (np.zeros((0, W), np.uint32), np.zeros(0, bool),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    read_id = np.repeat(np.arange(len(lens)), nw)
    pos = np.arange(N) - np.repeat(np.concatenate([[0], np.cumsum(nw)[:-1]]), nw)
    flat_start = offsets[:-1][read_id] + pos  # window start in flat codes
    # pack16 over flat codes (a window never reaches past its read's end,
    # and the pad bases of the last word are masked below)
    p16 = pack16(codes_flat[None, :].astype(np.uint32))[0]
    fwd = np.zeros((N, W), dtype=np.uint32)
    for w in range(W):
        idx = flat_start + 16 * w
        ok = idx < len(codes_flat)
        fwd[:, w] = np.where(ok, p16[np.minimum(idx, len(codes_flat) - 1)], 0)
    fwd[:, W - 1] &= np.uint32(last_word_mask(k))
    rc = revcomp_words(fwd, k)
    fwd_le = ~words_less(rc, fwd)
    canon = np.where(fwd_le[:, None], fwd, rc)
    return canon, fwd_le, read_id, pos
