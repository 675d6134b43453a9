"""MeraculousCounter in plain NumPy: every canonical k-mer of the good
windows with its count and its 2 x 6 extension counters, dumped as
`<out>.mercount.m<k>` and `<out>.mergraph.m<k>.D<min depth>` in key order,
each k-mer's line followed by its reverse complement's.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from kbench.reference import spectrum
from kbench.reference.frozen.io.reads import load_reads
from kbench.reference.frozen.ops.extensions import (EXT_MIN_QUALITY,
                                                    window_extensions)
from kbench.reference.frozen.ops.kmer import nwords, revcomp_words

FLAGS = {"kmer-size": "0", "min-depth": "2", "out": ""}
MIN_QUALITY = 2        # the app's own --min-quality-score default
MIN_KMER_QUALITY = 0.0  # and --min-kmer-quality
BASE = 33
_BASES = np.frombuffer(b"ACGT", np.uint8)
_DECIMALS = np.arange(1 << 16).astype("S5")  # the decimals of small counts


def strands(keys: np.ndarray, k: int) -> np.ndarray:
    """[2M, k] ASCII rows: each key's bases, then its reverse complement's."""
    W = nwords(k)
    words = np.zeros((len(keys), W), np.uint32)
    words[:, 0] = (keys >> np.uint64(32)).astype(np.uint32)
    if W == 2:
        words[:, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out = np.zeros((len(keys), 2, k), np.uint8)
    for s, ws in enumerate((words, revcomp_words(words, k))):
        for i in range(k):
            wi, o = divmod(i, 16)
            out[:, s, i] = _BASES[(ws[:, wi] >> np.uint32(30 - 2 * o))
                                  & np.uint32(3)]
    return out.reshape(2 * len(keys), k)


def lines(rows: np.ndarray, cols: np.ndarray, sep: bytes,
          tail: bytes) -> bytes:
    """One line a row: its k-mer, a tab, each column's decimal followed by
    `sep`, then `tail`. The fields are laid side by side NUL-padded and the
    NULs dropped, which leaves each line's fields end to end."""
    M = len(rows)

    def const(b: bytes) -> np.ndarray:
        return np.tile(np.frombuffer(b, np.uint8), (M, 1))

    parts = [rows, const(b"\t")]
    for c in cols.T:
        if M and c.max() < len(_DECIMALS):
            digits = _DECIMALS[c]
        else:
            digits = c.astype("S20")
        parts.append(digits.view(np.uint8).reshape(M, -1))
        if sep:
            parts.append(const(sep))
    parts.append(const(tail))
    flat = np.concatenate(parts, axis=1).reshape(-1)
    return flat[flat != 0].tobytes()


def outputs(argv: List[str], control: bool = False) -> Dict[str, bytes]:
    a = spectrum.parse(argv, FLAGS, ["input-file"])
    k = int(a["kmer-size"])
    min_depth = int(a["min-depth"])
    rs = load_reads(a["input-file"], BASE)
    codes, keys, is_fwd, good = spectrum.windows(rs, k, MIN_QUALITY, BASE,
                                                 MIN_KMER_QUALITY)
    hq = np.repeat(rs.has_quals, rs.lengths())
    ext_ok = (rs.phred() >= EXT_MIN_QUALITY) | ~hq
    left, right = window_extensions(codes.astype(np.int64), ext_ok,
                                    rs.offsets, k, is_fwd)
    uniq, cnt, inv = spectrum.count(keys, good, control)
    ext = np.zeros((len(uniq), 12), np.int64)
    gi = inv[good]
    for side, e in enumerate((left[good], right[good])):
        for code in range(6):
            ext[:, 6 * side + code] = np.bincount(gi[e == code],
                                                  minlength=len(uniq))
    keep = cnt >= max(min_depth, 2)
    uniq, cnt, ext = uniq[keep], cnt[keep], ext[keep]
    # the reverse complement's counters: directions swapped, bases
    # complemented
    rev = ext[:, [9, 8, 7, 6, 10, 11, 3, 2, 1, 0, 4, 5]]
    rows = strands(uniq, k)
    out = os.path.basename(a["out"])
    return {
        "%s.mercount.m%d" % (out, k):
            lines(rows, np.repeat(cnt, 2)[:, None], b"", b"\n"),
        "%s.mergraph.m%d.D%d" % (out, k, min_depth):
            lines(rows, np.stack([ext, rev], 1).reshape(-1, 12), b" ",
                  b"0\n"),
    }
