"""Packed-word k-mer ops over int64 lanes (twins of kmernator_tpu/ops/kmer.py).

A k-mer is W = ceil(k/16) 32-bit words, 16 bases a word, base 0 in the two
most significant bits. Torch on the CPU has no `<<`, `>>`, `<` or `where`
for uint32, so every word lives in an int64 tensor and is kept in
[0, 2^32): `>>` is then a logical shift, and each `<<` and `~` is masked
back to 32 bits.

For W <= 2 (k <= 32) the canonical key of a window fits one int64 "lane":

    lane = ((hi << 32) | lo) ^ (1 << 63)

so signed int64 order equals the JAX package's unsigned lexicographic
(hi, lo) order, and the all-ones sentinel becomes INT64_MAX, which still
sorts last. For W = 1 the low word is filled with ones, which keeps the
order and maps the sentinel word to the same INT64_MAX.
"""
from __future__ import annotations

from typing import List

import torch

from kmernator_tpu.ops.kmer import last_word_mask, nwords  # noqa: F401

MASK32 = 0xFFFFFFFF
SENTINEL_WORD = 0xFFFFFFFF
SIGN = -(1 << 63)                      # the int64 with only bit 63 set
SENTINEL_LANE = (1 << 63) - 1          # INT64_MAX: all-ones key ^ SIGN
MAX_K = 32


def check_k(k: int) -> None:
    """The one-lane key layout holds W <= 2 words (k <= 32)."""
    if not 0 < k <= MAX_K:
        raise NotImplementedError(
            "kmernator_tpu_torch supports 1 <= k <= %d (keys in one int64 "
            "lane); k=%d (W=%d words) waits for the multi-lane key layout "
            "of a later PR" % (MAX_K, k, nwords(k)))


def pack16(codes: torch.Tensor) -> torch.Tensor:
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
