"""Per-window left/right extension observation codes.

Mirrors the extension bookkeeping of buildWeightedKmers
(ref: src/KmerReadUtils.h:200-236) + ExtensionTracking::trackExtension
(ref: src/KmerTrackingData.h:190-196): the base immediately left/right of
each k-window, oriented to the stored (canonical) strand, counted only when
its quality is >= 20 — the 'X' off-the-end sentinel is always counted.

Codes: 0..3 = A,C,G,T; 4 = N (unused on this path — the reference reads the
unmasked 2-bit sequence so markup bases appear as 'A'); 5 = X; -1 = below
the extension quality threshold (not tracked).

Copied for kmernator_tpu_torch from kmernator_tpu/ops/extensions.py; it is
the source unchanged but for this paragraph.
"""
from __future__ import annotations

import numpy as np

EXT_X = 5
EXT_MIN_QUALITY = 20  # ref: ExtensionTracking::getMinQuality()


def _complement_ext(e: np.ndarray) -> np.ndarray:
    """A<->T, C<->G; N/X/untracked unchanged (ref: Extension::getReverseComplement)."""
    return np.where(e < 4, np.where(e >= 0, 3 - e, e), e)


def window_extensions(codes: np.ndarray, ext_ok: np.ndarray,
                      offsets: np.ndarray, k: int, is_fwd: np.ndarray):
    """codes: [total] 0..3 (markups already 0); ext_ok: [total] bool
    (phred >= 20, or no-qual read); is_fwd: [N] window orientation.
    Returns (ext_left [N] int8, ext_right [N] int8)."""
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    nw = np.maximum(lens - k + 1, 0)
    N = int(nw.sum())
    if N == 0:
        return np.zeros(0, np.int8), np.zeros(0, np.int8)
    read_id = np.repeat(np.arange(len(lens)), nw)
    first_w = np.concatenate([[0], np.cumsum(nw)[:-1]])
    pos = np.arange(N) - first_w[read_id]
    base0 = offsets[:-1][read_id] + pos

    li = np.maximum(base0 - 1, 0)
    left = np.where(pos == 0, EXT_X,
                    np.where(ext_ok[li], codes[li].astype(np.int64), -1)).astype(np.int8)
    ri = np.minimum(base0 + k, len(codes) - 1)
    in_read = (pos + k) < lens[read_id]
    right = np.where(~in_read, EXT_X,
                     np.where(ext_ok[ri], codes[ri].astype(np.int64), -1)).astype(np.int8)

    # canonical-reverse windows swap & complement (ref: KmerReadUtils.h:231-234)
    swap = ~is_fwd
    new_left = np.where(swap, _complement_ext(right.astype(np.int64)), left).astype(np.int8)
    new_right = np.where(swap, _complement_ext(left.astype(np.int64)), right).astype(np.int8)
    return new_left, new_right
