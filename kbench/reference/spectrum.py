"""The k-mer spectrum in plain NumPy, and the flags both apps share.

`count` is the exact count of every canonical key among the good windows.
With `control=True` it breaks that guarantee the way a table that drops
rare keys under pressure would (the program's own capacity purge, which
warns that counts "may undercount by 1"): the keys seen once in the first
half of the windows are dropped before the second half is added. That is
the benchmark's control: a run of it has to come out as not correct.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from kbench.reference.frozen.io.reads import BASE_CODE, ReadSet
from kbench.reference.frozen.ops.kmer import extract_kmers_flat, nwords
from kbench.reference.frozen.ops.weights import good_kmer_mask, window_weights

# flags that choose an engine or a layout, never the bytes written
ENGINE_FLAGS = {"--device": 1, "--mesh": 1, "--mesh-batch": 1,
                "--streaming": 0, "--streaming-chunk-mb": 1,
                "--distributed": 1, "--nprocs": 1, "--procid": 1}


def parse(argv: List[str], known: Dict[str, str],
          positional: List[str]) -> Dict[str, str]:
    """argv -> {flag name: value} for the flags in `known` (name -> default)
    and the positional names in order. Engine flags are dropped; any other
    flag is refused, so the reference never runs a configuration it does
    not model."""
    got = dict(known)
    pos = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ENGINE_FLAGS:
            i += 1 + ENGINE_FLAGS[a]
        elif a.startswith("--"):
            name = a[2:]
            if name not in known:
                raise ValueError("the reference does not model %s" % a)
            got[name] = argv[i + 1]
            i += 2
        else:
            pos.append(a)
            i += 1
    if len(pos) != len(positional):
        raise ValueError("expected %s, got %s" % (positional, pos))
    got.update(zip(positional, pos))
    return got


def file_prefix(path: str) -> str:
    """The input's base name up to its last '.' (output file names)."""
    base = os.path.basename(path)
    dot = base.rfind(".")
    return base[:dot] if dot >= 0 else base[:-1]


def pack_u64(canon: np.ndarray) -> np.ndarray:
    """[N, W <= 2] uint32 words -> uint64 keys in the words' order."""
    out = canon[:, 0].astype(np.uint64) << np.uint64(32)
    if canon.shape[1] == 2:
        out |= canon[:, 1].astype(np.uint64)
    return out


def windows(rs: ReadSet, k: int, min_quality: int, output_base: int,
            min_kmer_quality: float):
    """Every window of every read: (codes, uint64 canonical key, forward?,
    good?) — good as the spectrum counts it: its quality weight above the
    floor, in a read that is not discarded."""
    if nwords(k) > 2:
        raise ValueError("the reference counts k <= 32")
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    codes = np.where(markup, 0, codes_raw).astype(np.uint8)
    canon, is_fwd, read_id, _ = extract_kmers_flat(codes, rs.offsets, k)
    keys = pack_u64(canon)
    w = window_weights(rs.base_probabilities(min_quality, output_base),
                       rs.offsets, markup, k)
    good = good_kmer_mask(w, min_kmer_quality) & ~rs.discarded[read_id]
    return codes, keys, is_fwd, good


def count(keys: np.ndarray, good: np.ndarray, control: bool = False
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sorted unique keys of every window, each key's count of good
    windows, each window's index into them)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    cnt = np.bincount(inv[good], minlength=len(uniq))
    if control:
        gi = inv[good]
        first = np.bincount(gi[:len(gi) // 2], minlength=len(uniq))
        cnt = cnt - (first == 1)
    return uniq, cnt.astype(np.int64), inv
