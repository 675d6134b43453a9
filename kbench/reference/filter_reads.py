"""FilterReads in plain NumPy: the in-memory host flow of the app, for the
flags the benchmark's configurations use, over one input file.

Parse the reads, screen artifacts, count the good canonical k-mers, score
and trim each read by the depth of its k-mers, and format the passing
reads into `<out>-MinDepth<d>-<input>.fastq`.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from kbench.reference import spectrum
from kbench.reference.frozen.io.reads import format_reads_batch, load_reads
from kbench.reference.frozen.ops.artifact import (ArtifactFilter,
                                                  apply_artifact_filter)
from kbench.reference.frozen.ops.trim import pick_all_passing, score_and_trim

FLAGS = {"kmer-scoring-type": "MAX", "mask-simple-repeats": "0",
         "artifact-edit-distance": "2", "min-read-length": "0.40",
         "min-depth": "2", "out": ""}
MIN_QUALITY = 3          # the app's --min-quality-score default
MIN_KMER_QUALITY = 0.10  # its --min-kmer-quality default
BASE = 33


def first_markup(seq: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """1-based position of each read's first N or X base, 0 for none."""
    n = len(offsets) - 1
    out = np.zeros(n, np.int64)
    pos = np.flatnonzero((seq == ord("N")) | (seq == ord("X")))
    if len(pos):
        rid = np.searchsorted(offsets, pos, side="right") - 1
        first = np.unique(rid, return_index=True)
        out[first[0]] = pos[first[1]] - offsets[first[0]] + 1
    return out


def outputs(argv: List[str], control: bool = False) -> Dict[str, bytes]:
    a = spectrum.parse(argv, FLAGS, ["kmer-size", "input-file"])
    k = int(a["kmer-size"])
    min_depth = int(a["min-depth"])
    min_read_length = float(a["min-read-length"])
    path = a["input-file"]
    if a["mask-simple-repeats"] not in ("0", "false"):
        raise ValueError("the reference does not model simple repeats")
    rs = load_reads(path, BASE)
    filt = ArtifactFilter(edit_distance=int(a["artifact-edit-distance"]),
                          min_quality=MIN_QUALITY,
                          min_read_length=min_read_length)
    n_input = rs.n
    apply_artifact_filter(rs, filt)
    _, keys, _, good = spectrum.windows(rs, k, MIN_QUALITY, BASE,
                                        MIN_KMER_QUALITY)
    _, cnt, inv = spectrum.count(keys, good, control)
    counts = np.where(cnt >= max(min_depth, 2), cnt, 0)[inv]
    nw = np.maximum(rs.lengths() - k + 1, 0)
    woff = np.concatenate([[0], np.cumsum(nw)])
    trims = score_and_trim(rs, counts, woff, k, float(min_depth),
                           a["kmer-scoring-type"],
                           first_markup(rs.seq, rs.offsets))
    picks = pick_all_passing(rs, trims, float(min_depth), min_read_length,
                             n_input)
    name = "%s-MinDepth%d-%s.fastq" % (os.path.basename(a["out"]), min_depth,
                                       spectrum.file_prefix(path))
    if not len(picks):
        return {}
    labels = [trims.label[i] for i in picks]
    return {name: format_reads_batch(rs, picks, labels, trims.offset[picks],
                                     trims.length[picks], BASE)}
