"""Frozen for the benchmark's plain reference from kmernator_tpu_torch/io/reads.py
and cut to the NumPy paths the benchmark's configurations reach: one
uncompressed FASTQ file of single reads in, FASTQ records out.

Host-side read model and FASTQ IO.

Columnar replacement for the reference's Read/ReadSet object model
(ref: src/Sequence.h:64-557, src/ReadSet.h:64-655): reads live in flat numpy
byte arrays with offset indexing.  Semantics preserved exactly:

 - base normalization: acgt -> ACGT; '.' -> 'N'; any other non-ACGT byte is
   kept verbatim and treated as a markup (ref: src/TwoBitSequence.cpp:243-267)
 - FASTQ quality-base autodetection state machine over the first 20000 reads
   (ref: src/ReadSet.h:171-215)
 - output formatting incl. the single-'N' placeholder for zero-length or
   discarded reads (ref: src/Sequence.cpp:290-328,729-779)

A second mate (a name ending /2, /B or /R, or a Casava 1.8 comment of
read 2) is refused: without one every read is a single, and the pair logic
of the program's module never applies.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

REF_QUAL = 127            # ref: src/config.h:141
PRINT_REF_QUAL = 103      # ref: src/config.h:140 (33 + 70)

_BASE_NORM = np.arange(256, dtype=np.uint8)
for _c, _u in [(ord('a'), ord('A')), (ord('c'), ord('C')), (ord('g'), ord('G')),
               (ord('t'), ord('T')), (ord('.'), ord('N'))]:
    _BASE_NORM[_c] = _u

# ACGT -> 0..3, everything else -> 4 (markup; encodes as A=0 in 2-bit space,
# ref: src/TwoBitSequence.cpp:255-260 stores cbase=0 for invalid bases)
BASE_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    BASE_CODE[_c] = _i


def _is_casava18(comment: bytes) -> bool:
    """ref: src/Utils.h SequenceRecordParser::isCommentCasava18."""
    if len(comment) < 6:
        return False
    return (comment[1:2] == b":" and comment[3:4] == b":" and comment[5:6] == b":"
            and comment[0:1] in (b"1", b"2") and comment[2:3] in (b"Y", b"N"))


def _is_second_mate(name: bytes, comment: bytes) -> bool:
    """readNum == 2 (ref: src/Utils.h readNum)."""
    if _is_casava18(comment):
        return comment[0:1] == b"2"
    return len(name) >= 2 and name[-2:-1] == b"/" and name[-1:] in (b"2", b"B", b"R")


class ReadSet:
    """Columnar read container: seq/qual are concatenated per-read byte
    arrays addressed by offsets; qual holds the raw input characters."""

    def __init__(self):
        self.names: List[bytes] = []
        self.comments: List[bytes] = []
        self.seq = np.zeros(0, dtype=np.uint8)     # normalized base bytes
        self.qual = np.zeros(0, dtype=np.uint8)    # raw quality chars (input scale)
        self.offsets = np.zeros(1, dtype=np.int64)
        self.discarded = np.zeros(0, dtype=bool)
        self.has_quals = np.zeros(0, dtype=bool)
        self.input_qual_base = 33
        self._phred: Optional[np.ndarray] = None
        self._lengths: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        if self._lengths is None or len(self._lengths) != self.n:
            self._lengths = (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)
        return self._lengths

    def phred(self) -> np.ndarray:
        """Integer phred per base (REF_QUAL reads keep sentinel 127-base)."""
        if self._phred is None:
            self._phred = self.qual.astype(np.int16) - np.int16(self.input_qual_base)
        return self._phred

    def append_arrays(self, names, comments, seq, qual, offsets, has_quals):
        base = self.offsets[-1]
        self.names.extend(names)
        self.comments.extend(comments)
        self.seq = np.concatenate([self.seq, seq])
        self.qual = np.concatenate([self.qual, qual])
        self.offsets = np.concatenate([self.offsets, offsets[1:] + base])
        nnew = len(offsets) - 1
        self.discarded = np.concatenate([self.discarded, np.zeros(nnew, dtype=bool)])
        self.has_quals = np.concatenate([self.has_quals, has_quals])
        self._phred = None
        self._lengths = None

    def detect_quality_base(self, initial_base: int, limit: int = 20000):
        """Replicates the per-read switch state machine of
        ReadSet::validateFastqStart (ref: src/ReadSet.h:171-209): belief B
        switches 33->64 when a read's min qual char exceeds B+40 and 64->33
        when below B; only the first `limit` reads are examined.  The final
        belief applies to all reads (the reference rescales retroactively).
        """
        B = initial_base
        n = min(self.n, limit)
        if n == 0 or not self.has_quals.any():
            self.input_qual_base = B
            return B
        lens = self.lengths()[:n]
        hq = self.has_quals[:n]
        for i in range(n):
            if not hq[i] or lens[i] == 0:
                continue
            q = self.qual[self.offsets[i]:self.offsets[i + 1]]
            if q[0] == REF_QUAL:
                continue
            m = int(q.min())
            if m < B:
                B = 33
            elif m > B + 40:
                B = 64
        self.input_qual_base = B
        self._phred = None
        self._lengths = None
        return B

    # ---------- mutation (artifact filter) ----------
    def apply_trims(self, trim_off: np.ndarray, trim_len: np.ndarray,
                    which: np.ndarray, labels: List[bytes]):
        """Replace reads[which[j]] with the [off, off+len) substring, appending
        label to the comment (ref: Read::getTrimRead, src/Sequence.h:485-496).
        """
        if len(which) == 0:
            return
        new_off = np.zeros(self.n, dtype=np.int64)
        new_len = self.lengths().copy()
        new_off[which] = trim_off
        new_len[which] = trim_len
        idx = _ragged_indices(self.offsets[:-1] + new_off, new_len)
        self.seq = self.seq[idx]
        self.qual = self.qual[idx]
        self.offsets = np.concatenate([[0], np.cumsum(new_len)])
        for j, i in enumerate(which):
            lab = labels[j]
            c = self.comments[i]
            self.comments[i] = lab if not c else c + b"\t" + lab
        self._phred = None
        self._lengths = None

    def base_probabilities(self, min_quality: int, output_base: int) -> np.ndarray:
        """P(base correct) per base, float64, replicating the
        qualityToProbability table (ref: src/Sequence.cpp:522-540):
        index char = phred + output_base; char < output_base+minQ -> 0.0;
        char >= PRINT_REF_QUAL (103) -> 1.0; else 1-10^(-phred/10).
        REF_QUAL (127) sentinel quals are 1.0 via the >=103 rule.
        """
        from kbench.reference.frozen.ops.weights import phred_probability
        p = phred_probability(self.phred(), min_quality, output_base)
        # reads without quals at all behave as REF (prob 1.0)
        hq = np.repeat(self.has_quals, self.lengths())
        return np.where(hq, p, 1.0)


def _ragged_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of ranges [starts[i], starts[i]+lens[i])."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = np.ones(total, dtype=np.int64)
    idx[0] = starts[0]
    nz = lens > 0
    firsts = out_off[nz]
    idx[firsts[1:]] = starts[nz][1:] - (starts[nz][:-1] + lens[nz][:-1]) + 1
    return np.cumsum(idx)


# ============================ parsing ============================

def _split_name_line(line: bytes) -> Tuple[bytes, bytes, bool]:
    """ref: SequenceRecordParser::trimName (src/Utils.h), comments stored.
    Returns (name, comment, keep)."""
    sp = -1
    for i, ch in enumerate(line):
        if ch in (0x20, 0x09, 0x0d):
            sp = i
            break
    if sp < 0:
        return line, b"", True
    comment = line[sp + 1:] if len(line) >= sp + 2 else b""
    name = line[:sp]
    keep = not (_is_casava18(comment)
                and (sp <= 2 or line[sp - 2:sp - 1] != b"/")
                and comment[2:3] == b"Y")
    return name, comment, keep


def parse_fastq_bytes(data: bytes):
    """Vectorized 4-line FASTQ record parsing."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) and buf[-1] != 0x0a:
        buf = np.concatenate([buf, np.array([0x0a], dtype=np.uint8)])
    nl = np.flatnonzero(buf == 0x0a)
    nlines = len(nl) - len(nl) % 4
    starts = np.concatenate([[0], nl[:-1] + 1])[:nlines]
    ends = nl[:nlines]
    name_s, name_e = starts[0::4], ends[0::4]
    seq_s, seq_e = starts[1::4], ends[1::4]
    qual_s, qual_e = starts[3::4], ends[3::4]
    lens = (seq_e - seq_s).astype(np.int64)
    seq = _BASE_NORM[buf[_ragged_indices(seq_s, lens)]]
    qual = buf[_ragged_indices(qual_s, (qual_e - qual_s).astype(np.int64))]
    if len(qual) != len(seq):
        raise ValueError("FASTQ seq/qual length mismatch")
    # all name lines (with their '\n') in one ragged gather, split at C
    # speed; per-line Python only for lines holding a separator
    R = len(name_s)
    nlen = (name_e - name_s - 1).astype(np.int64)  # skip '@'
    nchars = buf[_ragged_indices(name_s + 1, nlen + 1)]  # +1 grabs the '\n'
    names = nchars.tobytes().split(b"\n")[:R]
    has_sep = (nchars == 0x20) | (nchars == 0x09) | (nchars == 0x0d)
    comments = [b""] * R
    keeps = np.ones(R, dtype=bool)
    if has_sep.any():
        for i in np.unique(np.repeat(np.arange(R), nlen + 1)[has_sep]):
            names[i], comments[i], keeps[i] = _split_name_line(names[i])
    offsets = np.concatenate([[0], np.cumsum(lens)])
    has_quals = np.ones(R, dtype=bool)
    if not keeps.all():
        sel = np.flatnonzero(keeps)
        idx = _ragged_indices(offsets[sel], lens[sel])
        seq, qual = seq[idx], qual[idx]
        names = [names[i] for i in sel]
        comments = [comments[i] for i in sel]
        offsets = np.concatenate([[0], np.cumsum(lens[sel])])
        has_quals = has_quals[sel]
    return names, comments, seq, qual, offsets, has_quals


def load_reads(path: str, output_base_quality: int = 33) -> ReadSet:
    """Load one FASTQ file of single reads into a ReadSet, autodetecting the
    quality base (ref: ReadSet::appendAllFiles, src/ReadSet.cpp:186-218)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] != b"@":
        raise ValueError("the reference reads FASTQ only: %s" % path)
    rs = ReadSet()
    rs.append_arrays(*parse_fastq_bytes(data))
    if any(_is_second_mate(nm, cm) for nm, cm in zip(rs.names, rs.comments)):
        raise ValueError("the reference reads single reads only: %s" % path)
    # initial belief: the output base (the ReadSet ctor calls
    # setFastqStart(outputFastqBaseQuality), ref: src/ReadSet.h:233-244)
    rs.detect_quality_base(output_base_quality)
    return rs


# ============================ writing ============================

def format_reads_batch(rs: ReadSet, idxs: np.ndarray, labels: List[bytes],
                       trim_offset: np.ndarray, trim_length: np.ndarray,
                       output_base: int) -> bytes:
    """FASTQ records of the picked reads, comments stored, each trimmed to
    [offset, offset+length), in a few vectorized passes; replicates
    Read::toFastq (ref: src/Sequence.cpp:761-779) including the 'N' +
    qual(base+1) placeholder for discarded/zero-length reads."""
    idxs = np.asarray(idxs, dtype=np.int64)
    n = len(idxs)
    if n == 0:
        return b""
    hdrs = [(nm if not c else nm + b" " + c) if not lb
            else (nm if not c else nm + b" " + c) + b" " + lb
            for nm, c, lb in zip((rs.names[i] for i in idxs),
                                 (rs.comments[i] for i in idxs), labels)]
    off0 = rs.offsets[idxs]
    L = (rs.offsets[idxs + 1] - off0).astype(np.int64)
    to = np.asarray(trim_offset, np.int64)
    tl0 = np.asarray(trim_length, np.int64)
    tl = np.minimum(tl0, L - to)
    use_n = rs.discarded[idxs] | (tl0 <= 1) | (tl <= 1)
    blen = np.where(use_n, 1, tl)
    rows = np.repeat(np.arange(n), blen)
    un = use_n[rows]
    if len(rs.seq):
        bidx = _ragged_indices(np.where(use_n, 0, off0 + to), blen)
        body = rs.seq[bidx].copy()
        qual = (rs.phred()[bidx].astype(np.int32)
                + output_base).astype(np.uint8)
        qual = np.where(rs.has_quals[idxs][rows], qual,
                        np.uint8(PRINT_REF_QUAL))
    else:
        body = np.empty(len(rows), np.uint8)
        qual = np.empty(len(rows), np.uint8)
    body[un] = 0x4e  # 'N'
    qual[un] = np.uint8(output_base + 1)
    hlen = np.fromiter((len(h) for h in hdrs), np.int64, n)
    hflat = np.frombuffer(b"".join(hdrs), np.uint8)
    rec_len = 1 + hlen + 1 + blen + 3 + blen + 1
    starts = np.concatenate([[0], np.cumsum(rec_len)[:-1]])
    out = np.empty(int(rec_len.sum()), np.uint8)
    out[starts] = 0x40  # '@'
    out[_ragged_indices(starts + 1, hlen)] = hflat
    p = starts + 1 + hlen
    out[p] = 0x0a
    out[_ragged_indices(p + 1, blen)] = body
    p2 = p + 1 + blen
    out[p2] = 0x0a
    out[p2 + 1] = 0x2b  # '+'
    out[p2 + 2] = 0x0a
    out[_ragged_indices(p2 + 3, blen)] = qual
    out[p2 + 3 + blen] = 0x0a
    return out.tobytes()
