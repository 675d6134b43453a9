"""Tables for the format_mers tests, and the host dumps they are held to.

`random_table(k, M, seed)` is a sorted table of M distinct keys as
extension_spectrum_mesh returns it (parallel/format_mers.py DeviceTable, on
the CPU): a fifth of the keys palindromes at even k; counts 0-4 on half
the keys (around every threshold) and of 1 to 10 digits on the rest, a few
at the int32 maximum; counters of 1 to 10 digits, a third of them 0.
`host_dumps` writes what MeraculousCounter writes on the CPU: the table
carried to the host (`spectrum_from_device`), purged at depth 2, then
`dump_counts` and `dump_graphs`.
"""
import os

import numpy as np
import torch

from kmernator_tpu_torch.apps import meraculous_counter as app
from kmernator_tpu_torch.ops.kmer import encode_lanes, nwords, pack16
from kmernator_tpu_torch.parallel.format_mers import DeviceTable

INT32_MAX = (1 << 31) - 1


def _digits_values(rng, shape):
    """Values of 1 to 10 digits, at most INT32_MAX."""
    d = rng.integers(1, 11, shape)
    lo = np.where(d == 1, 0, 10 ** (d - 1).astype(np.float64))
    hi = np.minimum(10.0 ** d, INT32_MAX + 1.0)
    return (lo + rng.random(shape) * (hi - lo)).astype(np.int64)


def random_table(k: int, M: int, seed: int) -> DeviceTable:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (M, k))
    if k % 2 == 0:
        pal = codes[::5]
        pal[:, k // 2:] = 3 - pal[:, :k // 2][:, ::-1]
        codes[::5] = pal
    W = nwords(k)
    words = pack16(np, codes)[:, ::16][:, :W].astype(np.int64)
    words = np.unique(words, axis=0)
    M = len(words)
    lanes = encode_lanes([torch.from_numpy(words[:, w].copy())
                          for w in range(W)])
    counts = _digits_values(rng, M)
    small = rng.random(M) < 0.5
    counts[small] = rng.integers(0, 5, int(small.sum()))
    counts[::97] = INT32_MAX
    ext = _digits_values(rng, (M, 12))
    ext[rng.random((M, 12)) < 0.33] = 0
    return DeviceTable(lanes, torch.from_numpy(counts.astype(np.int32)),
                       torch.from_numpy(ext.astype(np.int32)))


def host_dumps(table: DeviceTable, k: int, min_depth: int, d: str):
    """(mercount, mergraph) bytes as the host path writes them."""
    sp = app.spectrum_from_device(k, [t.cpu() for t in table.lanes],
                                  table.counts.cpu(), table.ext.cpu())
    sp.purge_min_depth(app.PURGE_DEPTH)
    c, g = os.path.join(d, "host.mercount"), os.path.join(d, "host.mergraph")
    app.dump_counts(sp, c, min_depth)
    app.dump_graphs(sp, g, min_depth)
    with open(c, "rb") as fc, open(g, "rb") as fg:
        return fc.read(), fg.read()


def read_pair(c: str, g: str):
    with open(c, "rb") as fc, open(g, "rb") as fg:
        return fc.read(), fg.read()
