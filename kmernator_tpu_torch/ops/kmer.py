"""Packed-word k-mer ops: the numpy host functions and their torch twins.

Two halves:

- The host functions (`nwords` to `string_to_words`) are copied from
  kmernator_tpu/ops/kmer.py unchanged. They take an array namespace `xp`;
  the port's host code passes numpy only.
- The torch twins below them work over int64 lanes. A k-mer is W =
  ceil(k/16) 32-bit words, 16 bases a word, base 0 in the two most
  significant bits. Torch on the CPU has no `<<`, `>>`, `<` or `where` for
  uint32, so every word lives in an int64 tensor and is kept in [0, 2^32):
  `>>` is then a logical shift, and each `<<` and `~` is masked back to 32
  bits. `pack16_torch` is the host `pack16` (renamed: the host one keeps
  its name and signature for the copied host modules).

A key of W words is held in L = ceil(W/2) int64 "lanes"; lane j packs
words 2j and 2j+1:

    lane_j = ((w[2j] << 32) | w[2j+1]) ^ (1 << 63)

so a lexicographic signed int64 compare over the lanes equals the JAX
package's unsigned lexicographic word order, and the all-ones sentinel
becomes INT64_MAX in every lane, which still sorts last. When W is odd the
last lane fills its low word with ones (as W = 1 does), which keeps the
order and maps the sentinel word to the same INT64_MAX. For W <= 2 (k <=
32) the key is one lane (`encode_lane`, `decode_lane`); up to W = 6 (k <=
96) it is at most 3 lanes (`encode_lanes`, `decode_lanes`).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


# ---- host functions (numpy), copied from kmernator_tpu/ops/kmer.py ----

def nwords(k: int) -> int:
    return (k + 15) // 16


def _mask32(xp, x):
    return x & xp.uint32(0xFFFFFFFF)


def pack16(xp, codes):
    """codes: int array [..., L] with values 0..3 -> u32 [..., L] where
    out[..., p] packs bases p..p+15 (positions beyond L contribute zeros).

    Built from 16 shifted adds — vectorized equivalent of the reference's
    shiftLeftMatrix sub-byte shifting (ref: src/TwoBitSequence.h:146,183).
    """
    c = codes.astype(xp.uint32)
    L = c.shape[-1]
    if xp is np:
        # in-place accumulation (no per-shift temporaries)
        out = np.zeros_like(c)
        for t in range(16):
            if t >= L:
                break
            np.bitwise_or(out[..., :L - t] if t else out,
                          c[..., t:] << np.uint32(30 - 2 * t),
                          out=out[..., :L - t] if t else out)
        return out
    out = xp.zeros_like(c)
    for t in range(16):
        shift = xp.uint32(30 - 2 * t)
        if t == 0:
            sl = c
        else:
            pad = xp.zeros(c.shape[:-1] + (t,), dtype=xp.uint32)
            sl = xp.concatenate([c[..., t:], pad], axis=-1)
        out = out | _mask32(xp, sl << shift)
    return out


def _reverse_bases_u32(xp, x):
    """Reverse the 16 2-bit groups within each u32 lane."""
    if xp is np:
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
    x = _mask32(xp, ((x & xp.uint32(0x33333333)) << xp.uint32(2))) | ((x >> xp.uint32(2)) & xp.uint32(0x33333333))
    x = _mask32(xp, ((x & xp.uint32(0x0F0F0F0F)) << xp.uint32(4))) | ((x >> xp.uint32(4)) & xp.uint32(0x0F0F0F0F))
    x = _mask32(xp, ((x & xp.uint32(0x00FF00FF)) << xp.uint32(8))) | ((x >> xp.uint32(8)) & xp.uint32(0x00FF00FF))
    x = _mask32(xp, (x << xp.uint32(16))) | (x >> xp.uint32(16))
    return x


def shift_left_words(xp, words, s_bases: int):
    """Shift a [..., W] big-endian word vector left by s_bases bases,
    zero-filling from the right."""
    W = words.shape[-1]
    word_shift, bit = divmod(s_bases, 16)
    if word_shift:
        pad = xp.zeros(words.shape[:-1] + (word_shift,), dtype=xp.uint32)
        words = xp.concatenate([words[..., word_shift:], pad], axis=-1)
    if bit:
        nxt = xp.concatenate(
            [words[..., 1:], xp.zeros(words.shape[:-1] + (1,), dtype=xp.uint32)], axis=-1)
        words = _mask32(xp, words << xp.uint32(2 * bit)) | (nxt >> xp.uint32(32 - 2 * bit))
    return words


def last_word_mask(k: int) -> int:
    """Mask zeroing the pad bases of the last word (ref: src/Kmer.h:1343-1355
    masks the trailing byte the same way)."""
    used = k - 16 * (nwords(k) - 1)
    if used == 16:
        return 0xFFFFFFFF
    return (0xFFFFFFFF << (2 * (16 - used))) & 0xFFFFFFFF


def revcomp_words(xp, words, k: int):
    """Reverse complement of [..., W]-word kmers."""
    W = nwords(k)
    comp = ~words  # 2-bit complement == bitwise NOT
    rev = _reverse_bases_u32(xp, _mask32(xp, comp))
    rev = xp.flip(rev, axis=-1)
    rev = shift_left_words(xp, rev, 16 * W - k)
    mask = np.uint32(last_word_mask(k))
    rev = rev.at[..., W - 1].set(rev[..., W - 1] & mask) if hasattr(rev, "at") else _set_last(rev, mask)
    return rev


def _set_last(arr, mask):
    arr = arr.copy()
    arr[..., -1] &= mask
    return arr


def words_less(xp, a, b):
    """Lexicographic a < b over word vectors [..., W]."""
    W = a.shape[-1]
    lt = a[..., W - 1] < b[..., W - 1]
    for w in range(W - 2, -1, -1):
        lt = xp.where(a[..., w] == b[..., w], lt, a[..., w] < b[..., w])
    return lt


def extract_kmers_batch(xp, codes, lengths, k: int):
    """Canonical kmers of every window of a padded batch.

    codes:   [B, L] int (0..3; markup positions must already be 0=A, matching
             the reference encoding of invalid bases)
    lengths: [B] actual read lengths
    k:       kmer size
    Returns (canon [B, NW, W] u32, is_fwd [B, NW] bool, valid [B, NW] bool)
    where NW = L - k + 1.
    """
    B, L = codes.shape
    W = nwords(k)
    NW = L - k + 1
    if NW <= 0:
        raise ValueError("reads shorter than k")
    p16 = pack16(xp, codes)  # [B, L]
    parts = []
    for w in range(W):
        start = 16 * w
        sl = p16[..., start:start + NW]
        if sl.shape[-1] < NW:
            pad = xp.zeros((B, NW - sl.shape[-1]), dtype=xp.uint32)
            sl = xp.concatenate([sl, pad], axis=-1)
        parts.append(sl)
    fwd = xp.stack(parts, axis=-1)  # [B, NW, W]
    mask = np.uint32(last_word_mask(k))
    if hasattr(fwd, "at"):
        fwd = fwd.at[..., W - 1].set(fwd[..., W - 1] & mask)
    else:
        fwd[..., W - 1] &= mask
    rc = revcomp_words(xp, fwd, k)
    fwd_le = ~words_less(xp, rc, fwd)   # fwd <= rc
    canon = xp.where(fwd_le[..., None], fwd, rc)
    pos = xp.arange(NW)[None, :]
    valid = pos <= (lengths[:, None] - k)
    return canon, fwd_le, valid


def extract_kmers_flat(codes_flat: np.ndarray, offsets: np.ndarray, k: int):
    """Host/numpy path over ragged concatenated reads.

    Returns (canon [N, W] u32, is_fwd [N] bool, read_id [N] int64,
    pos [N] int64) for every window of every read (reads shorter than k
    contribute none).
    """
    xp = np
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
    # pack16 over flat codes (cross-read contamination is masked away below)
    p16 = pack16(np, codes_flat[None, :].astype(np.uint32))[0]
    fwd = np.zeros((N, W), dtype=np.uint32)
    for w in range(W):
        idx = flat_start + 16 * w
        ok = idx < len(codes_flat)
        fwd[:, w] = np.where(ok, p16[np.minimum(idx, len(codes_flat) - 1)], 0)
    fwd[:, W - 1] &= np.uint32(last_word_mask(k))
    # mask bases that fall beyond the window's read (only matters when a word
    # crosses into the next read: impossible because window end <= read end
    # and pad bases are already masked by last_word_mask)
    rc = revcomp_words(np, fwd, k)
    fwd_le = ~words_less(np, rc, fwd)
    canon = np.where(fwd_le[:, None], fwd, rc)
    return canon, fwd_le, read_id, pos


def kmer_to_string(words: np.ndarray, k: int) -> str:
    """Decode one [W] word vector to an ACGT string (debug/goldens)."""
    bases = "ACGT"
    out = []
    for i in range(k):
        w, o = divmod(i, 16)
        code = (int(words[w]) >> (30 - 2 * o)) & 3
        out.append(bases[code])
    return "".join(out)


def string_to_words(s: str) -> np.ndarray:
    k = len(s)
    W = nwords(k)
    out = np.zeros(W, dtype=np.uint32)
    m = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i, ch in enumerate(s.upper()):
        w, o = divmod(i, 16)
        out[w] |= np.uint32(m.get(ch, 0) << (30 - 2 * o))
    return out


# ---- torch twins over int64 lanes ----

MASK32 = 0xFFFFFFFF
SENTINEL_WORD = 0xFFFFFFFF
SIGN = -(1 << 63)                      # the int64 with only bit 63 set
SENTINEL_LANE = (1 << 63) - 1          # INT64_MAX: all-ones key ^ SIGN
MAX_LANES = 3
MAX_K = 32 * MAX_LANES                 # 96: the reference's MAX_KMER_SIZE is 95


def nlanes(W: int) -> int:
    """int64 key lanes of a W-word key."""
    return (W + 1) // 2


def check_k(k: int) -> None:
    """The key layout holds at most MAX_LANES lanes: W <= 6 words (k <=
    96)."""
    if not 0 < k <= MAX_K:
        raise NotImplementedError(
            "kmernator_tpu_torch supports 1 <= k <= %d (keys in at most %d "
            "int64 lanes); k=%d (W=%d words) is past the port's key layout"
            % (MAX_K, MAX_LANES, k, nwords(k)))


def pack16_torch(codes: torch.Tensor) -> torch.Tensor:
    """codes [..., L] (values 0..3) -> int64 [..., L], out[..., p] packing
    bases p..p+15 (positions beyond L contribute zeros)."""
    c = codes.to(torch.int64)
    L = c.shape[-1]
    out = torch.zeros_like(c)
    for t in range(min(16, L)):
        out[..., :L - t] |= (c[..., t:] << (30 - 2 * t)) & MASK32
    return out


def reverse_bases(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit groups of each 32-bit word held in an int64."""
    x = (((x & 0x33333333) << 2) & MASK32) | ((x >> 2) & 0x33333333)
    x = (((x & 0x0F0F0F0F) << 4) & MASK32) | ((x >> 4) & 0x0F0F0F0F)
    x = (((x & 0x00FF00FF) << 8) & MASK32) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK32) | (x >> 16)


def encode_lane(cols: List[torch.Tensor]) -> torch.Tensor:
    """W <= 2 word columns (int64 in [0, 2^32)) -> one order-preserving
    int64 key lane. Sentinel words map to SENTINEL_LANE."""
    if len(cols) == 1:
        packed = (cols[0] << 32) | MASK32
    elif len(cols) == 2:
        packed = (cols[0] << 32) | cols[1]
    else:
        raise NotImplementedError("key lanes hold at most 2 words (k <= 32)")
    return packed ^ SIGN


def decode_lane(lane: torch.Tensor, W: int) -> List[torch.Tensor]:
    """Inverse of encode_lane: int64 lane -> W word columns."""
    if W not in (1, 2):
        raise NotImplementedError("key lanes hold at most 2 words (k <= 32)")
    u = lane ^ SIGN
    hi = (u >> 32) & MASK32
    return [hi] if W == 1 else [hi, u & MASK32]


def encode_lanes(cols: List[torch.Tensor]) -> List[torch.Tensor]:
    """W word columns (int64 in [0, 2^32)) -> L = ceil(W/2) order-preserving
    int64 key lanes: a lexicographic signed compare over them equals the
    unsigned word order. One column pair a lane, encoded by encode_lane
    (an odd last word fills its lane's low word with ones)."""
    if not 0 < len(cols) <= 2 * MAX_LANES:
        raise NotImplementedError("keys hold 1 to %d words, got %d"
                                  % (2 * MAX_LANES, len(cols)))
    return [encode_lane(cols[j:j + 2]) for j in range(0, len(cols), 2)]


def decode_lanes(lanes: List[torch.Tensor], W: int) -> List[torch.Tensor]:
    """Inverse of encode_lanes: L int64 lanes -> W word columns."""
    if len(lanes) != nlanes(W):
        raise ValueError("a %d-word key has %d lanes, got %d"
                         % (W, nlanes(W), len(lanes)))
    cols = []
    for j, lane in enumerate(lanes):
        cols += decode_lane(lane, min(2, W - 2 * j))
    return cols
