"""Host-side read model and FASTQ/FASTA IO.

Columnar replacement for the reference's Read/ReadSet object model
(ref: src/Sequence.h:64-557, src/ReadSet.h:64-655): reads live in flat numpy
byte arrays with offset indexing, ready to be packed into dense device
tensors.  Semantics preserved exactly:

 - base normalization: acgt -> ACGT; '.' -> 'N'; any other non-ACGT byte is
   kept verbatim and treated as a markup (ref: src/TwoBitSequence.cpp:243-267)
 - FASTQ quality-base autodetection state machine over the first 20000 reads
   (ref: src/ReadSet.h:171-215)
 - pair identification by name (/1,/2,/A,/B,/F,/R suffixes or Casava 1.8
   comments) with the sequential fast path (ref: src/ReadSet.cpp:86-260,
   src/Utils.h SequenceRecordParser)
 - output formatting incl. the single-'N' placeholder for zero-length or
   discarded reads (ref: src/Sequence.cpp:290-328,729-779)

Copied for kmernator_tpu_torch from kmernator_tpu/io/reads.py; it differs
from its source in its package imports and in `identify_pairs`, which
matches the names the sequential pass leaves with array passes, in place of
a loop over the reads, and records the tracer's span `io.pairs`.
"""
from __future__ import annotations

import io as _io
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from kmernator_tpu_torch.utils import timers

REF_QUAL = 127            # ref: src/config.h:141
PRINT_REF_QUAL = 103      # ref: src/config.h:140 (33 + 70)
MAX_READ_IDX = np.iinfo(np.int64).max

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


def read_num(name: bytes, comment: bytes) -> int:
    """1/2 for paired reads, 0 otherwise. ref: src/Utils.h readNum."""
    if _is_casava18(comment):
        return 2 if comment[0:1] == b"2" else 1
    if len(name) < 2 or name[-2:-1] != b"/":
        return 0
    c = name[-1:]
    if c in (b"1", b"A", b"F"):
        return 1
    if c in (b"2", b"B", b"R"):
        return 2
    return 0


def common_name(name: bytes) -> bytes:
    """ref: src/Utils.h commonName."""
    if len(name) <= 2:
        return name
    if name[-2:-1] == b"/":
        return name[:-1]
    return name


class ReadSet:
    """Columnar read container.

    seq/qual are concatenated per-read byte arrays addressed by offsets;
    qual stores raw input characters until `finalize_quality()` converts them
    to integer phred given the detected input base.
    """

    def __init__(self):
        self.names: List[bytes] = []
        self.comments: List[bytes] = []
        self.seq = np.zeros(0, dtype=np.uint8)     # normalized base bytes
        self.qual = np.zeros(0, dtype=np.uint8)    # raw quality chars (input scale)
        self.offsets = np.zeros(1, dtype=np.int64)
        self.discarded = np.zeros(0, dtype=bool)
        self.has_quals = np.zeros(0, dtype=bool)
        self.file_idx = np.zeros(0, dtype=np.int32)  # which input file each read came from
        self.input_qual_base = 33
        self.pairs: List[Tuple[int, int]] = []      # (read1, read2) with -1 = invalid
        # per-read trim state applied by the artifact filter (AFTrim)
        self._phred: Optional[np.ndarray] = None
        self._lengths: Optional[np.ndarray] = None
        # fixed-width 'S' caches of names/comments (size-checked on use;
        # in-place comment mutation invalidates explicitly)
        self._names_S: Optional[np.ndarray] = None
        self._comments_S: Optional[np.ndarray] = None

    # ---------- basic accessors ----------
    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        if self._lengths is None or len(self._lengths) != self.n:
            self._lengths = (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)
        return self._lengths

    def get_seq(self, i: int) -> bytes:
        return self.seq[self.offsets[i]:self.offsets[i + 1]].tobytes()

    def get_phred(self, i: int) -> np.ndarray:
        return self.phred()[self.offsets[i]:self.offsets[i + 1]]

    def phred(self) -> np.ndarray:
        """Integer phred per base (REF_QUAL reads keep sentinel 127-base)."""
        if self._phred is None:
            self._phred = self.qual.astype(np.int16) - np.int16(self.input_qual_base)
        return self._phred

    def max_length(self) -> int:
        if self.n == 0:
            return 0
        return int(self.lengths().max())

    def names_S(self) -> np.ndarray:
        """Fixed-width 'S' array of read names (one C conversion, cached;
        size-checked so appends invalidate implicitly)."""
        if (getattr(self, "_names_S", None) is None
                or len(self._names_S) != self.n):
            a = np.array(self.names, dtype=bytes) if self.names \
                else np.zeros(0, "S1")
            if a.dtype.itemsize == 0:
                a = a.astype("S1")
            self._names_S = a
        return self._names_S

    def comments_S(self) -> np.ndarray:
        if (getattr(self, "_comments_S", None) is None
                or len(self._comments_S) != self.n):
            a = np.array(self.comments, dtype=bytes) if self.comments \
                else np.zeros(0, "S1")
            if a.dtype.itemsize == 0:
                a = a.astype("S1")
            self._comments_S = a
        return self._comments_S

    # ---------- construction ----------
    def append_arrays(self, names, comments, seq, qual, offsets, has_quals, file_idx=0):
        base = self.offsets[-1]
        self.names.extend(names)
        self.comments.extend(comments)
        self.seq = np.concatenate([self.seq, seq])
        self.qual = np.concatenate([self.qual, qual])
        self.offsets = np.concatenate([self.offsets, offsets[1:] + base])
        nnew = len(offsets) - 1
        self.discarded = np.concatenate([self.discarded, np.zeros(nnew, dtype=bool)])
        self.has_quals = np.concatenate([self.has_quals, has_quals])
        self.file_idx = np.concatenate(
            [self.file_idx, np.full(nnew, file_idx, dtype=np.int32)])
        self._phred = None
        self._lengths = None

    def append_read(self, name: bytes, comment: bytes, seq: bytes, phred: Optional[np.ndarray]):
        """Append one read whose quality is already in phred units."""
        self.names.append(name)
        self.comments.append(comment)
        s = np.frombuffer(seq, dtype=np.uint8)
        s = _BASE_NORM[s]
        self.seq = np.concatenate([self.seq, s])
        if phred is None:
            q = np.full(len(s), REF_QUAL, dtype=np.uint8)
            hq = False
        else:
            q = (np.asarray(phred, dtype=np.int16) + self.input_qual_base).astype(np.uint8)
            hq = True
        self.qual = np.concatenate([self.qual, q])
        self.offsets = np.concatenate([self.offsets, [self.offsets[-1] + len(s)]])
        self.discarded = np.concatenate([self.discarded, [False]])
        self.has_quals = np.concatenate([self.has_quals, [hq]])
        self.file_idx = np.concatenate([self.file_idx, [0]])
        self._phred = None
        self._lengths = None

    def append_reads_batch(self, names: List[bytes], comments: List[bytes],
                           seqs: List[bytes],
                           phreds: List[Optional[np.ndarray]]):
        """Append many reads with ONE concatenate per column (append_read
        in a loop is O(total^2))."""
        if not names:
            return
        self.names.extend(names)
        self.comments.extend(comments)
        svecs = [_BASE_NORM[np.frombuffer(s, dtype=np.uint8)] for s in seqs]
        qvecs = []
        hqs = np.zeros(len(names), dtype=bool)
        for j, ph in enumerate(phreds):
            if ph is None:
                qvecs.append(np.full(len(svecs[j]), REF_QUAL, dtype=np.uint8))
            else:
                qvecs.append((np.asarray(ph, dtype=np.int16) +
                              self.input_qual_base).astype(np.uint8))
                hqs[j] = True
        self.seq = np.concatenate([self.seq] + svecs)
        self.qual = np.concatenate([self.qual] + qvecs)
        new_lens = np.array([len(s) for s in svecs], dtype=np.int64)
        self.offsets = np.concatenate(
            [self.offsets, self.offsets[-1] + np.cumsum(new_lens)])
        self.discarded = np.concatenate(
            [self.discarded, np.zeros(len(names), dtype=bool)])
        self.has_quals = np.concatenate([self.has_quals, hqs])
        self.file_idx = np.concatenate(
            [self.file_idx, np.zeros(len(names), dtype=np.int32)])
        self._phred = None
        self._lengths = None

    # ---------- quality-base autodetection ----------
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

    # ---------- pairing ----------
    def _read_nums_vec(self, nm=None) -> np.ndarray:
        """Vectorized read_num over all reads (1/2 for paired, 0 otherwise).
        `nm` may pass a precomputed np.array(self.names) to share the
        (O(total name bytes)) conversion with the caller."""
        n = self.n
        rn = np.zeros(n, dtype=np.int8)
        if n == 0:
            return rn
        if nm is None:
            nm = np.array(self.names, dtype=bytes)
        w = nm.dtype.itemsize
        if w >= 2:
            ch = nm.view(np.uint8).reshape(n, w)
            ln = (ch != 0).argmin(axis=1)
            ln[ch[:, -1] != 0] = w  # full-width names have no NUL pad
            has2 = ln >= 2
            last = ch[np.arange(n), np.maximum(ln - 1, 0)]
            slash = np.zeros(n, dtype=bool)
            slash[has2] = ch[np.flatnonzero(has2), ln[has2] - 2] == 0x2f
            rn = np.where(slash & np.isin(last, (0x31, 0x41, 0x46)), 1, rn)
            rn = np.where(slash & np.isin(last, (0x32, 0x42, 0x52)), 2, rn)
        cm = np.array(self.comments, dtype=bytes)
        cw = cm.dtype.itemsize
        if cw >= 6:
            cc = cm.view(np.uint8).reshape(n, cw)
            cas = ((cc[:, 1] == 0x3a) & (cc[:, 3] == 0x3a) & (cc[:, 5] == 0x3a)
                   & ((cc[:, 0] == 0x31) | (cc[:, 0] == 0x32))
                   & ((cc[:, 2] == 0x59) | (cc[:, 2] == 0x4e)))
            rn = np.where(cas, np.where(cc[:, 0] == 0x32, 2, 1), rn)
        return rn.astype(np.int64)

    def identify_pairs(self) -> int:
        """ref: src/ReadSet.cpp:186-260 identifyPairs(): the sequential
        pass pairs neighbours, then the reads it left are matched by common
        name. Both are array passes; the entries come in the reference's
        order: the sequential pairs, then one entry a read that opens or
        stays alone, in read order."""
        with timers.span("io.pairs"):
            first, second = self._pair_columns()
            self.pairs = list(zip(first.tolist(), second.tolist()))
        return len(self.pairs)

    def _pair_columns(self) -> Tuple[np.ndarray, np.ndarray]:
        """The two columns of the pairs list (-1: no read)."""
        n = self.n
        nm = self.names_S() if n else None
        rn = self._read_nums_vec(nm)
        if not n or not rn.any():
            # unpaired data (no read numbers anywhere): every read is its
            # own single entry
            timers.count("io.pairs_by_name", 0)
            timers.count("io.mates_joined_by_name", 0)
            return np.arange(n), np.full(n, -1)
        # sequential fast path: consecutive reads (i-1, i) are pair
        # candidates when both have nonzero read numbers that differ and
        # their common names match; the loop's prev-reset semantics are
        # exactly "alternating selection within each run of candidates"
        w = nm.dtype.itemsize   # names_S() is at least S1
        ch = nm.view(np.uint8).reshape(n, w)
        ln = (ch != 0).argmin(axis=1)
        ln[ch[:, -1] != 0] = w
        # common_name: drop trailing char when name[-2] == '/'
        slash = np.zeros(n, dtype=bool)
        has2 = ln >= 2
        slash[has2] = ch[np.flatnonzero(has2), ln[has2] - 2] == 0x2f
        # reference keeps names of length <= 2 whole
        slash &= ln > 2
        cln = np.where(slash, ln - 1, ln)
        mask = np.arange(w)[None, :] < cln[:, None]
        prefix_eq = np.zeros(n, dtype=bool)  # name i-1 vs i
        eq = (ch[:-1] == ch[1:]) | ~mask[1:]
        prefix_eq[1:] = eq.all(axis=1) & (cln[:-1] == cln[1:])
        cand = np.zeros(n, dtype=bool)
        cand[1:] = (rn[1:] != 0) & (rn[:-1] != 0) & (rn[1:] != rn[:-1])
        cand &= prefix_eq
        sel = _alternate(np.flatnonzero(cand))
        paired = np.zeros(n, dtype=bool)
        paired[sel] = True
        paired[sel - 1] = True
        # name path for the rest, in read order: a read of read number 0
        # stays alone; the others group by common name, and within a group
        # the reads at even ranks open an entry that the next read joins
        # where the read numbers differ (the reference's unmatched map)
        rest = np.flatnonzero(~paired)
        rr = rn[rest]
        first = np.where(rr == 2, -1, rest)
        second = np.where(rr == 2, rest, -1)
        g = rest[rr != 0]
        # common names of the whole names (a NUL byte, where ln stops, may
        # sit inside a name): the bytes, then 1 at the common name's end
        lg = np.fromiter(map(len, self.names), np.int64, n)[g]
        cl = lg - ((lg > 2) & (ch[g, np.maximum(lg - 2, 0)] == 0x2f))
        key = np.zeros((len(g), w + 1), np.uint8)
        key[:, :w] = np.where(np.arange(w)[None, :] < cl[:, None], ch[g], 0)
        key[np.arange(len(g)), cl] = 1
        key = key.view("S%d" % (w + 1)).ravel()
        order = np.argsort(key, kind="stable")
        ks = key[order]
        start = np.ones(len(g), dtype=bool)
        start[1:] = ks[1:] != ks[:-1]
        # a group's closer: odd rank, the same group as its opener
        closer = np.zeros(len(g), dtype=bool)
        closer[_alternate(np.flatnonzero(~start))] = True
        r = rn[g[order]]
        join = np.flatnonzero(closer[1:] & (r[1:] != r[:-1])) + 1
        opener, mate = g[order[join - 1]], g[order[join]]
        at = np.searchsorted(rest, opener)
        two = rn[opener] == 2
        first[at[two]] = mate[two]
        second[at[~two]] = mate[~two]
        keep = np.ones(len(rest), dtype=bool)
        keep[np.searchsorted(rest, mate)] = False
        timers.count("io.pairs_by_name", len(rest))
        timers.count("io.mates_joined_by_name", len(join))
        return (np.concatenate([sel - 1, first[keep]]),
                np.concatenate([sel, second[keep]]))

    @staticmethod
    def _is_pair(name_a, comment_a, name_b, comment_b) -> bool:
        if common_name(name_a) != common_name(name_b):
            return False
        na, nb = read_num(name_a, comment_a), read_num(name_b, comment_b)
        return na != 0 and nb != 0 and na != nb

    def has_pairs(self) -> bool:
        """ref: src/ReadSet.h:526-528."""
        return len(self.pairs) != 0 and len(self.pairs) < self.n

    # ---------- mutation (artifact filter) ----------
    def apply_trims(self, trim_off: np.ndarray, trim_len: np.ndarray,
                    which: np.ndarray, labels: List[bytes]):
        """Replace reads[which[j]] with the [off, off+len) substring, appending
        label to the comment (ref: Read::getTrimRead, src/Sequence.h:485-496).
        """
        if len(which) == 0:
            return
        sel = np.zeros(self.n, dtype=bool)
        sel[which] = True
        new_off = np.zeros(self.n, dtype=np.int64)
        new_len = self.lengths().copy()
        new_off[which] = trim_off
        new_len[which] = trim_len
        # rebuild flat arrays (native ragged memcpy when available)
        starts = self.offsets[:-1] + new_off
        from kmernator_tpu_torch.io import native
        sg = native.gather_ragged(self.seq, starts, new_len)
        if sg is not None:
            self.seq = sg
            self.qual = native.gather_ragged(self.qual, starts, new_len)
        else:
            idx = _ragged_indices(starts, new_len)
            self.seq = self.seq[idx]
            self.qual = self.qual[idx]
        self.offsets = np.concatenate([[0], np.cumsum(new_len)])
        for j, i in enumerate(which):
            lab = labels[j]
            c = self.comments[i]
            self.comments[i] = lab if not c else c + b"\t" + lab
        self._phred = None
        self._lengths = None
        self._comments_S = None

    # ---------- probabilities ----------
    def base_probabilities(self, min_quality: int, output_base: int) -> np.ndarray:
        """P(base correct) per base, float64, replicating the
        qualityToProbability table (ref: src/Sequence.cpp:522-540):
        index char = phred + output_base; char < output_base+minQ -> 0.0;
        char >= PRINT_REF_QUAL (103) -> 1.0; else 1-10^(-phred/10).
        REF_QUAL (127) sentinel quals are 1.0 via the >=103 rule.
        """
        from kmernator_tpu_torch.ops.weights import phred_probability
        p = phred_probability(self.phred(), min_quality, output_base)
        # reads without quals at all behave as REF (prob 1.0)
        hq = np.repeat(self.has_quals, self.lengths())
        p = np.where(hq, p, 1.0)
        return p


def _alternate(idx: np.ndarray) -> np.ndarray:
    """The 1st, 3rd, 5th, ... of each run of consecutive integers in the
    sorted idx."""
    if not len(idx):
        return idx
    pos = np.arange(len(idx))
    run_start = np.concatenate([[True], np.diff(idx) != 1])
    return idx[(pos - np.maximum.accumulate(np.where(run_start, pos, 0)))
               % 2 == 0]


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

def _split_name_line(line: bytes, comment_stored: bool) -> Tuple[bytes, bytes, bool]:
    """ref: SequenceRecordParser::trimName (src/Utils.h).  Returns
    (name, comment, keep)."""
    sp = -1
    for i, ch in enumerate(line):
        if ch in (0x20, 0x09, 0x0d):
            sp = i
            break
    if sp < 0:
        return line, b"", True
    comment = line[sp + 1:] if len(line) >= sp + 2 else b""
    name = line[:sp]
    keep = True
    if _is_casava18(comment) and (sp <= 2 or line[sp - 2:sp - 1] != b"/"):
        if not comment_stored:
            name = name + b"/" + comment[0:1]
            if len(comment) > 4 and comment[4:5] == b"Y":
                keep = False
        else:
            if comment[2:3] == b"Y":
                keep = False
    return name, comment, keep


def parse_fastq_bytes(data: bytes, comment_stored: bool = True):
    """Vectorized 4-line FASTQ record parsing."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) and buf[-1] != 0x0a:
        buf = np.concatenate([buf, np.array([0x0a], dtype=np.uint8)])
    from kmernator_tpu_torch.io import native
    nl = native.find_newlines(buf)
    if nl is None:
        nl = np.flatnonzero(buf == 0x0a)
    nlines = len(nl)
    if nlines % 4 != 0:
        nlines -= nlines % 4
    starts = np.concatenate([[0], nl[:-1] + 1])[:nlines]
    ends = nl[:nlines]
    name_s, name_e = starts[0::4], ends[0::4]
    seq_s, seq_e = starts[1::4], ends[1::4]
    qual_s, qual_e = starts[3::4], ends[3::4]
    lens = (seq_e - seq_s).astype(np.int64)
    seq = native.gather_ragged_map(buf, seq_s, lens, _BASE_NORM)
    if seq is not None:
        qual = native.gather_ragged(buf, qual_s,
                                    (qual_e - qual_s).astype(np.int64))
    elif (sg := native.gather_ragged(buf, seq_s, lens)) is not None:
        seq = _BASE_NORM[sg]
        qual = native.gather_ragged(buf, qual_s,
                                    (qual_e - qual_s).astype(np.int64))
    else:
        seq = _BASE_NORM[buf[_ragged_indices(seq_s, lens)]]
        qual = buf[_ragged_indices(qual_s,
                                   (qual_e - qual_s).astype(np.int64))]
    if len(qual) != len(seq):
        raise ValueError("FASTQ seq/qual length mismatch")
    # extract all name lines (incl. trailing '\n') in one ragged gather and
    # split at C speed; per-line Python runs only for lines that actually
    # contain a separator (space/tab/CR — the casava/comment cases)
    R = len(name_s)
    nlen = (name_e - name_s - 1).astype(np.int64)  # skip '@'
    nidx = _ragged_indices(name_s + 1, nlen + 1)   # +1 grabs the '\n'
    nchars = buf[nidx]
    names = nchars.tobytes().split(b"\n")[:R]
    has_sep = (nchars == 0x20) | (nchars == 0x09) | (nchars == 0x0d)
    comments = [b""] * R
    keeps = np.ones(R, dtype=bool)
    if has_sep.any():
        sep_rows = np.unique(np.repeat(np.arange(R), nlen + 1)[has_sep])
        for i in sep_rows:
            nm, cm, keep = _split_name_line(names[i], comment_stored)
            names[i] = nm
            comments[i] = cm
            keeps[i] = keep
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


def parse_fasta_bytes(data: bytes, comment_stored: bool = True,
                      qual_data: Optional[bytes] = None):
    """FASTA (multi-line) parsing; quals become REF_QUAL sentinels."""
    names, comments, seqs = [], [], []
    cur = None
    for line in data.split(b"\n"):
        line = line.rstrip(b"\r")
        if not line:
            continue
        if line.startswith(b">"):
            nm, cm, _ = _split_name_line(line[1:], comment_stored)
            names.append(nm)
            comments.append(cm)
            seqs.append(bytearray())
            cur = seqs[-1]
        elif cur is not None:
            cur.extend(line)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    seq = _BASE_NORM[np.frombuffer(b"".join(bytes(s) for s in seqs), dtype=np.uint8)] \
        if seqs else np.zeros(0, dtype=np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    if qual_data is not None:
        # FASTA+qual pair: whitespace-separated integer phreds per record
        # (ref: SequenceRecordParser::convertQualIntsToChars — values are
        # clamped below REF_QUAL)
        qvals = []
        cur = None
        for line in qual_data.split(b"\n"):
            line = line.rstrip(b"\r")
            if not line:
                continue
            if line.startswith(b">"):
                cur = []
                qvals.append(cur)
            elif cur is not None:
                cur.extend(int(x) for x in line.split())
        flat = []
        for i, qv in enumerate(qvals[:len(names)]):
            qv = [min(q, REF_QUAL - 33 - 1) for q in qv]
            if len(qv) != lens[i]:
                raise ValueError("fasta and qual lengths do not match")
            flat.extend(qv)
        qual = (np.array(flat, dtype=np.int16) + 33).astype(np.uint8)
        has_quals = np.ones(len(names), dtype=bool)
        return names, comments, seq, qual, offsets, has_quals
    qual = np.full(len(seq), REF_QUAL, dtype=np.uint8)
    has_quals = np.zeros(len(names), dtype=bool)
    return names, comments, seq, qual, offsets, has_quals


def open_maybe_gzip(path: str, use_mmap: bool = False) -> bytes:
    if path.endswith(".gz"):
        import gzip
        with gzip.open(path, "rb") as f:
            return f.read()
    if use_mmap:
        # zero-copy view; page faults overlap with the (threaded) consumer
        # instead of a blocking up-front read (the reference mmaps too,
        # ref: src/ReadFileReader.h mmap path)
        import mmap
        f = open(path, "rb")
        try:
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        finally:
            f.close()
    with open(path, "rb") as f:
        return f.read()


def load_reads(paths: List[str], fastq_base_quality: int = 33,
               output_base_quality: int = 33, comment_stored: bool = True,
               byte_range: Optional[Tuple[int, int]] = None) -> ReadSet:
    """Load one or more FASTQ/FASTA files into a ReadSet, autodetecting the
    quality base (ref: ReadSet::appendAllFiles, src/ReadSet.cpp:186-218)."""
    rs = ReadSet()
    for fi, path in enumerate(paths):
        data = open_maybe_gzip(path)
        if byte_range is not None:
            data = extract_partition(data, byte_range[0], byte_range[1])
        if data[:1] == b">":
            qual_data = None
            qpath = path.rsplit(".", 1)[0] + ".qual"
            if os.path.exists(qpath):
                qual_data = open_maybe_gzip(qpath)
            parsed = parse_fasta_bytes(data, comment_stored, qual_data)
        else:
            parsed = parse_fastq_bytes(data, comment_stored)
        rs.append_arrays(*parsed, file_idx=fi)
    # initial belief: the output base (ReadSet ctor calls
    # setFastqStart(outputFastqBaseQuality), ref: src/ReadSet.h:233-244);
    # note getDefaultInputQualityBase is the --fastq-base-quality option but
    # the constructor immediately overrides with the output base.
    rs.detect_quality_base(output_base_quality)
    return rs


# ---------- byte-range partitioning for multi-host input ----------

def partition_ranges(file_size: int, rank: int, size: int) -> Tuple[int, int]:
    """ref: ReadFileReader::seekToPartition (src/ReadFileReader.h:379-397)."""
    block = file_size // size
    start = block * rank
    end = file_size if rank == size - 1 else block * (rank + 1)
    return start, end


def find_next_record(data: bytes, pos: int, by_pair: bool = True) -> int:
    """Scan forward from pos to the next record boundary, keeping interleaved
    pairs together (ref: ReadFileReader::seekToNextRecord,
    src/ReadFileReader.h:657-740).  FASTQ-only heuristic: a line starting
    with '@' that is followed 2 lines later by '+' is a record start; for
    by_pair, additionally require the record name to not be a /2 mate of the
    preceding record."""
    if pos == 0:
        return 0
    i = data.find(b"\n", pos)
    while i >= 0 and i + 1 < len(data):
        j = i + 1
        if data[j:j + 1] == b"@":
            # verify: line j is a name line iff line j+2 starts with '+'
            e1 = data.find(b"\n", j)
            if e1 < 0:
                return len(data)
            e2 = data.find(b"\n", e1 + 1)
            if e2 < 0:
                return len(data)
            if data[e2 + 1:e2 + 2] == b"+":
                if not by_pair:
                    return j
                # check pair: is this record the /2 of the previous record?
                name_line = data[j + 1:e1]
                nm, cm, _ = _split_name_line(name_line, True)
                if read_num(nm, cm) == 2:
                    # skip the whole /2 record so the pair stays upstream
                    e3 = data.find(b"\n", e2 + 1)   # end of '+' line
                    e4 = data.find(b"\n", e3 + 1) if e3 >= 0 else -1  # end of quals
                    if e4 < 0:
                        return len(data)
                    prev = _prev_record_name(data, j)
                    if prev is not None and ReadSet._is_pair(prev[0], prev[1], nm, cm):
                        return e4 + 1
                return j
        i = data.find(b"\n", j)
    return len(data)


def _prev_record_name(data: bytes, pos: int):
    # find the start of the record before pos (4 lines back)
    k = pos - 1
    lines = []
    while k > 0 and len(lines) < 4:
        p = data.rfind(b"\n", 0, k)
        lines.append(data[p + 1:k])
        k = p
        if p < 0:
            break
    if len(lines) >= 4 and lines[3][:1] == b"@":
        nm, cm, _ = _split_name_line(lines[3][1:], True)
        return nm, cm
    return None


def extract_partition(data: bytes, rank: int, size: int) -> bytes:
    start, end = partition_ranges(len(data), rank, size)
    s = find_next_record(data, start)
    e = find_next_record(data, end) if end < len(data) else len(data)
    return data[s:e]


# ============================ writing ============================

def format_read(name: bytes, comment: bytes, seq: bytes, phred: np.ndarray,
                label: bytes, fmt: int, output_base: int,
                trim_offset: int, trim_length: int, discarded: bool,
                has_quals: bool, comment_stored: bool = True) -> bytes:
    """Format one (possibly trimmed) read; replicates Read::toFastq/toFasta
    (ref: src/Sequence.cpp:761-779) including the 'N' + qual(base+1)
    placeholder for discarded/zero-length reads."""
    L = len(seq)
    if discarded or trim_length <= 1:
        body = b"N"
        quals = bytes([output_base + 1])
    else:
        tl = min(trim_length, L - trim_offset)
        if tl <= 1:
            body = b"N"
            quals = bytes([output_base + 1])
        else:
            body = seq[trim_offset:trim_offset + tl]
            if has_quals:
                q = phred[trim_offset:trim_offset + tl].astype(np.int32) + output_base
                quals = q.astype(np.uint8).tobytes()
            else:
                quals = bytes([PRINT_REF_QUAL]) * tl
    hdr = name
    if comment_stored and comment:
        hdr = hdr + b" " + comment
    if label:
        hdr = hdr + b" " + label
    if fmt in (0, 2):
        return b"@" + hdr + b"\n" + body + b"\n+\n" + quals + b"\n"
    else:
        return b">" + hdr + b"\n" + body + b"\n"


def format_reads_batch(rs, idxs: np.ndarray, labels: List[bytes],
                       trim_offset: np.ndarray, trim_length: np.ndarray,
                       fmt: int, output_base: int,
                       comment_stored: bool = True) -> bytes:
    """Batched format_read: identical bytes for a whole pick list in a few
    vectorized passes (ragged scatter of bodies/quals into one buffer)
    instead of one Python call per read."""
    idxs = np.asarray(idxs, dtype=np.int64)
    n = len(idxs)
    if n == 0:
        return b""
    fastq = fmt in (0, 2)
    from kmernator_tpu_torch.io import native
    if isinstance(labels, native.ByteRows):
        # columnar fast path: one fixed-width conversion per column, header
        # assembly and record formatting fully native (no per-read Python)
        nm = rs.names_S()
        nm2d = nm.view(np.uint8).reshape(rs.n, nm.dtype.itemsize)
        nlen = np.char.str_len(nm).astype(np.int64)
        cm2d = clen = None
        if comment_stored:
            cm = rs.comments_S()
            cm2d = cm.view(np.uint8).reshape(rs.n, cm.dtype.itemsize)
            clen = np.char.str_len(cm).astype(np.int64)
        hb = native.build_headers(idxs, nm2d, nlen, cm2d, clen, labels)
        if hb is not None:
            rec = native.format_fastq(rs, idxs, trim_offset, trim_length,
                                      hb, output_base, fastq)
            if rec is not None:
                return rec
        labels = list(labels)  # numpy fallback below needs a list
    if comment_stored:
        hdrs = [(nm if not c else nm + b" " + c) if not lb
                else (nm if not c else nm + b" " + c) + b" " + lb
                for nm, c, lb in zip((rs.names[i] for i in idxs),
                                     (rs.comments[i] for i in idxs), labels)]
    else:
        hdrs = [nm if not lb else nm + b" " + lb
                for nm, lb in zip((rs.names[i] for i in idxs), labels)]
    rec = native.format_fastq(rs, idxs, trim_offset, trim_length, hdrs,
                              output_base, fastq)
    if rec is not None:
        return rec

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
    rec_len = (1 + hlen + 1 + blen + 3 + blen + 1) if fastq \
        else (1 + hlen + 1 + blen + 1)
    starts = np.concatenate([[0], np.cumsum(rec_len)[:-1]])
    out = np.empty(int(rec_len.sum()), np.uint8)
    out[starts] = 0x40 if fastq else 0x3e  # '@' / '>'
    out[_ragged_indices(starts + 1, hlen)] = hflat
    p = starts + 1 + hlen
    out[p] = 0x0a
    out[_ragged_indices(p + 1, blen)] = body
    p2 = p + 1 + blen
    out[p2] = 0x0a
    if fastq:
        out[p2 + 1] = 0x2b  # '+'
        out[p2 + 2] = 0x0a
        out[_ragged_indices(p2 + 3, blen)] = qual
        out[p2 + 3 + blen] = 0x0a
    return out.tobytes()
