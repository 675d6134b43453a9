"""BGZF + BAM/SAM IO.

Replaces the reference's samtools-0.1.19-based BamManager/BgzfStream stack
(ref: src/SamUtils.h, src/BgzfStream.h) with a clean-room implementation of
the public BAM/BGZF specifications: BGZF blocks are gzip members with a BC
extra field; BAM records are parsed into columnar numpy arrays for sorting
and filtering at scale.

Copied for kmernator_tpu_torch from kmernator_tpu/io/bam.py. The module
is numpy and the standard library, with no import of either package. It
differs from its source only in `bgzf_decompress`, which inflates BGZF
blocks one at a time by their BSIZE field. The source hands the whole
stream to `gzip.decompress`, which copies the rest of the stream at each
of its members, so its time grows with the square of the member count
(ROADMAP fault 3l). The bytes are the same.
"""
from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

BAM_MAGIC = b"BAM\x01"
SEQ_CODE = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"


# ----------------------------- BGZF -----------------------------

def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a BGZF (or plain gzip) stream; multi-member aware.
    BGZF blocks are inflated one at a time from their BSIZE field, each
    checked against its CRC32 and ISIZE, in time linear in the stream; a
    member without the BC field, and all that follows it, goes to
    gzip.decompress."""
    mv = memoryview(data)
    out, off = [], 0
    while off < len(data):
        size = _bgzf_block_size(data, off)
        if size is None:
            rest = bytes(mv[off:]).lstrip(b"\x00")
            if rest:
                out.append(gzip.decompress(rest))
            break
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        chunk = zlib.decompress(mv[off + 12 + xlen:off + size - 8], -15)
        crc, isize = struct.unpack_from("<II", data, off + size - 8)
        if zlib.crc32(chunk) != crc or len(chunk) != isize:
            raise gzip.BadGzipFile("BGZF block at %d fails its CRC32 or "
                                   "ISIZE check" % off)
        out.append(chunk)
        off += size
    return b"".join(out)


def bgzf_compress(data: bytes, level: int = 6, eof: bool = True) -> bytes:
    """Compress into BGZF blocks (<=64KB payload each) + EOF marker.
    eof=False omits the terminator so per-rank compressed sections can be
    concatenated (BGZF members concatenate into a valid stream — how the
    distributed sort assembles one BAM from rank blocks,
    ref: SamUtils::writePartialSortedBamVector, src/SamUtils.h:985)."""
    out = []
    MAXP = 0xFF00
    for i in range(0, len(data), MAXP):
        chunk = data[i:i + MAXP]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12)+extra(6)+comp+crc(4)+isize(4)
        header = struct.pack("<4BI2BH", 0x1f, 0x8b, 0x08, 0x04, 0, 0, 0xff,
                             6) + b"BC" + struct.pack("<HH", 2, bsize - 1)
        out.append(header + comp +
                   struct.pack("<II", zlib.crc32(chunk), len(chunk)))
    if eof:
        out.append(BGZF_EOF)
    return b"".join(out)


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


# ----------------------------- BAM model -----------------------------

@dataclass
class BamData:
    header_text: bytes = b""
    ref_names: List[bytes] = field(default_factory=list)
    ref_lens: List[int] = field(default_factory=list)
    # columnar record fields
    records: List[bytes] = field(default_factory=list)  # raw BAM record bodies
    ref_id: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    pos: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    flag: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def n(self) -> int:
        return len(self.records)

    def name(self, i: int) -> bytes:
        body = self.records[i]
        l_read_name = body[8]
        return body[32:32 + l_read_name - 1]

    def seq_qual(self, i: int) -> Tuple[bytes, bytes]:
        body = self.records[i]
        l_read_name = body[8]
        n_cigar = struct.unpack_from("<H", body, 12)[0]
        l_seq = struct.unpack_from("<i", body, 16)[0]
        off = 32 + l_read_name + 4 * n_cigar
        packed = body[off:off + (l_seq + 1) // 2]
        seq = bytearray(l_seq)
        for j in range(l_seq):
            b = packed[j // 2]
            code = (b >> 4) if j % 2 == 0 else (b & 0xF)
            seq[j] = ord(SEQ_CODE[code])
        qual = body[off + (l_seq + 1) // 2:off + (l_seq + 1) // 2 + l_seq]
        return bytes(seq), qual


def parse_bam(data: bytes) -> BamData:
    raw = bgzf_decompress(data)
    if raw[:4] != BAM_MAGIC:
        raise ValueError("not a BAM stream")
    bd = BamData()
    off = 4
    l_text = struct.unpack_from("<i", raw, off)[0]
    off += 4
    bd.header_text = raw[off:off + l_text].rstrip(b"\x00")
    off += l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, off)[0]
        off += 4
        bd.ref_names.append(raw[off:off + l_name - 1])
        off += l_name
        bd.ref_lens.append(struct.unpack_from("<i", raw, off)[0])
        off += 4
    refs, poss, flags = [], [], []
    N = len(raw)
    while off < N:
        block_size = struct.unpack_from("<i", raw, off)[0]
        off += 4
        body = raw[off:off + block_size]
        off += block_size
        ref_id, pos = struct.unpack_from("<ii", body, 0)
        flag = struct.unpack_from("<H", body, 14)[0]
        bd.records.append(body)
        refs.append(ref_id)
        poss.append(pos)
        flags.append(flag)
    bd.ref_id = np.array(refs, np.int32)
    bd.pos = np.array(poss, np.int32)
    bd.flag = np.array(flags, np.int32)
    return bd


def write_bam(bd: BamData, order: Optional[np.ndarray] = None) -> bytes:
    out = [BAM_MAGIC]
    text = bd.header_text
    if text and not text.endswith(b"\n"):
        text += b"\n"
    out.append(struct.pack("<i", len(text)))
    out.append(text)
    out.append(struct.pack("<i", len(bd.ref_names)))
    for nm, ln in zip(bd.ref_names, bd.ref_lens):
        out.append(struct.pack("<i", len(nm) + 1))
        out.append(nm + b"\x00")
        out.append(struct.pack("<i", ln))
    idx = order if order is not None else range(bd.n)
    for i in idx:
        body = bd.records[int(i)]
        out.append(struct.pack("<i", len(body)))
        out.append(body)
    return bgzf_compress(b"".join(out))


def header_bytes(bd: BamData) -> bytes:
    """The uncompressed BAM header section (magic + text + refs)."""
    out = [BAM_MAGIC]
    text = bd.header_text
    if text and not text.endswith(b"\n"):
        text += b"\n"
    out.append(struct.pack("<i", len(text)))
    out.append(text)
    out.append(struct.pack("<i", len(bd.ref_names)))
    for nm, ln in zip(bd.ref_names, bd.ref_lens):
        out.append(struct.pack("<i", len(nm) + 1))
        out.append(nm + b"\x00")
        out.append(struct.pack("<i", ln))
    return b"".join(out)


def records_blob(bd: BamData, order) -> bytes:
    """Size-prefixed raw record bodies (the BAM record wire format, no
    header) — the serialization unit of the record exchange
    (ref: MPIReadExchanger packs idInfo+records the same way,
    src/SamUtils.h:1266-1421)."""
    out = []
    for i in order:
        body = bd.records[int(i)]
        out.append(struct.pack("<i", len(body)))
        out.append(body)
    return b"".join(out)


def parse_records_blob(blob: bytes, template: BamData) -> BamData:
    """Inverse of records_blob; header/refs copied from template."""
    bd = BamData(header_text=template.header_text,
                 ref_names=list(template.ref_names),
                 ref_lens=list(template.ref_lens))
    off = 0
    refs, poss, flags = [], [], []
    N = len(blob)
    while off + 4 <= N:
        block_size = struct.unpack_from("<i", blob, off)[0]
        off += 4
        body = blob[off:off + block_size]
        off += block_size
        ref_id, pos = struct.unpack_from("<ii", body, 0)
        flag = struct.unpack_from("<H", body, 14)[0]
        bd.records.append(body)
        refs.append(ref_id)
        poss.append(pos)
        flags.append(flag)
    bd.ref_id = np.array(refs, np.int32)
    bd.pos = np.array(poss, np.int32)
    bd.flag = np.array(flags, np.int32)
    return bd


# --------------- byte-range partitioned BAM input ---------------
#
# The reference byte-range-partitions each BAM across ranks and resyncs to
# the next record boundary past each split point, so every rank reads and
# parses only ~1/size of the compressed input
# (ref: SamUtils::readBamFile + findNextRecord, src/SamUtils.h:509-648).
# Same design here: snap the raw split offset to the next BGZF block
# (validated magic + consistent following block), decompress a bounded
# window, and resync to the first offset where a chain of records
# validates.  Both neighbours compute the same cut deterministically, so
# coverage is exact and disjoint.

_BGZF_MAGIC = b"\x1f\x8b\x08\x04"


def _bgzf_block_size(data, off: int):
    """Compressed size of the BGZF block at off, or None."""
    if bytes(data[off:off + 4]) != _BGZF_MAGIC or off + 18 > len(data):
        return None
    xlen = struct.unpack_from("<H", data, off + 10)[0]
    p, end = off + 12, off + 12 + xlen
    if end > len(data):
        return None
    while p + 4 <= end:
        slen = struct.unpack_from("<H", data, p + 2)[0]
        if data[p] == 0x42 and data[p + 1] == 0x43 and slen == 2:
            return struct.unpack_from("<H", data, p + 4)[0] + 1
        p += 4 + slen
    return None


def next_bgzf_block(data, off: int) -> int:
    """File offset of the first BGZF block at/after off (validated by a
    consistent following block), or len(data)."""
    N = len(data)
    while off < N:
        idx = bytes(data[off:min(off + (1 << 20), N)]).find(_BGZF_MAGIC)
        if idx < 0:
            off += (1 << 20) - 4
            continue
        idx += off
        bs = _bgzf_block_size(data, idx)
        if bs is not None:
            nxt = idx + bs
            if nxt >= N or _bgzf_block_size(data, nxt) is not None:
                return idx
        off = idx + 1
    return N


def _valid_record_chain(buf, off: int, n_ref: int, depth: int = 4) -> int:
    """1 if a chain of plausible BAM records starts at buf[off], 0 if
    disproven, -1 if the window is too short to decide."""
    N = len(buf)
    for _ in range(depth):
        if off == N:
            return 1
        if off + 36 > N:
            return -1
        block_size = struct.unpack_from("<i", buf, off)[0]
        if block_size < 32 or block_size > (1 << 22):
            return 0
        ref_id, pos = struct.unpack_from("<ii", buf, off + 4)
        if ref_id < -1 or ref_id >= n_ref or pos < -1:
            return 0
        l_read_name = buf[off + 12]
        if l_read_name < 1:
            return 0
        n_cigar = struct.unpack_from("<H", buf, off + 16)[0]
        l_seq = struct.unpack_from("<i", buf, off + 20)[0]
        if l_seq < 0 or l_seq > (1 << 20):
            return 0
        body_min = 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        if body_min > block_size:
            return 0
        nul = off + 4 + 32 + l_read_name - 1
        if nul >= N:
            return -1
        if buf[nul] != 0:
            return 0
        off += 4 + block_size
    return 1


class _BlockReader:
    """Streamed BGZF decompression with (file offset, in-block offset)
    addressing and a compressed-bytes-consumed counter."""

    def __init__(self, data):
        self.data = data
        self.blocks: List[Tuple[int, int]] = []  # (file_off, decomp_start)
        self.buf = bytearray()
        self.next_off = 0
        self.bytes_read = 0

    def start_at(self, file_off: int):
        self.blocks = []
        self.buf = bytearray()
        self.next_off = file_off

    def grow(self) -> bool:
        """Decompress one more block into the buffer."""
        bs = _bgzf_block_size(self.data, self.next_off)
        if bs is None:
            return False
        raw = gzip.decompress(bytes(self.data[self.next_off:
                                              self.next_off + bs]))
        self.blocks.append((self.next_off, len(self.buf)))
        self.buf.extend(raw)
        self.next_off += bs
        self.bytes_read += bs
        return True

    def vaddr(self, decomp_off: int) -> Tuple[int, int]:
        """(file offset of block, offset within its payload) of a
        decompressed position; end-of-buffer maps to (next block, 0)."""
        if decomp_off >= len(self.buf):
            return (self.next_off, 0)
        lo, hi = 0, len(self.blocks) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.blocks[mid][1] <= decomp_off:
                lo = mid
            else:
                hi = mid - 1
        foff, dstart = self.blocks[lo]
        return (foff, decomp_off - dstart)


def _read_bam_header_stream(data):
    """(header-only BamData, header-end vaddr, reader) from a BGZF BAM."""
    r = _BlockReader(data)
    r.start_at(0)
    while True:
        if not r.grow():
            raise ValueError("truncated BAM header")
        buf = bytes(r.buf)
        if len(buf) < 12 or buf[:4] != BAM_MAGIC:
            if len(buf) >= 4 and buf[:4] != BAM_MAGIC:
                raise ValueError("not a BAM stream")
            continue
        l_text = struct.unpack_from("<i", buf, 4)[0]
        off = 8 + l_text
        if len(buf) < off + 4:
            continue
        n_ref = struct.unpack_from("<i", buf, off)[0]
        off += 4
        bd = BamData()
        bd.header_text = buf[8:8 + l_text].rstrip(b"\x00")
        ok = True
        for _ in range(n_ref):
            if len(buf) < off + 4:
                ok = False
                break
            l_name = struct.unpack_from("<i", buf, off)[0]
            off += 4
            if len(buf) < off + l_name + 4:
                ok = False
                break
            bd.ref_names.append(buf[off:off + l_name - 1])
            off += l_name
            bd.ref_lens.append(struct.unpack_from("<i", buf, off)[0])
            off += 4
        if ok:
            return bd, r.vaddr(off), r
        # need more blocks for the ref list
        continue


def _bam_cut(data, target: int, n_ref: int,
             counter) -> Tuple[int, int]:
    """Virtual (block file offset, in-block offset) of the first record
    boundary at/after raw file offset `target`."""
    N = len(data)
    if target >= N:
        return (N, 0)
    blk = next_bgzf_block(data, target)
    if blk >= N:
        return (N, 0)
    r = _BlockReader(data)
    r.start_at(blk)
    r.grow()
    # adaptive resync window: grow only while the verdict at the first
    # undisproven offset is "window too short" (records are usually tiny,
    # so one block decides; deterministic regardless of reader cadence)
    try:
        while True:
            buf = bytes(r.buf)
            unknown = None
            for off in range(len(buf)):
                v = _valid_record_chain(buf, off, n_ref)
                if v == 1:
                    return r.vaddr(off)
                if v == -1:
                    unknown = off
                    break
            if not r.grow():
                # truncated tail: accept the undecidable offset (EOF-cut)
                if unknown is not None:
                    return r.vaddr(unknown)
                return (r.next_off, 0)
    finally:
        counter[0] += r.bytes_read


def load_alignments_partitioned(path: str, rank: int, size: int,
                                stats: Optional[dict] = None) -> BamData:
    """Parse only this rank's byte range of a BAM file: records whose start
    lies in [cut(rank), cut(rank+1)) of the virtual (block, offset) space.
    Every rank reads the header; record blocks are read only within the
    range (plus the cut-resync windows and any final straddling record).
    `stats`, when given, receives bytes_read/file_bytes.
    ref: SamUtils::readBamFile, src/SamUtils.h:509-648."""
    import mmap as _mmap
    if not path.endswith(".bam"):
        # SAM text: no compressed-block structure; record-range fallback
        bd = load_alignments(path)
        lo, hi = rank * bd.n // size, (rank + 1) * bd.n // size
        sel = np.arange(lo, hi)
        out = BamData(header_text=bd.header_text,
                      ref_names=bd.ref_names, ref_lens=bd.ref_lens)
        out.records = [bd.records[i] for i in sel]
        out.ref_id, out.pos, out.flag = (bd.ref_id[sel], bd.pos[sel],
                                         bd.flag[sel])
        return out
    with open(path, "rb") as f:
        data = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    counter = [0]
    template, hdr_end, hreader = _read_bam_header_stream(data)
    counter[0] += hreader.bytes_read
    n_ref = len(template.ref_names)
    fsize = len(data)

    def cut(b: int) -> Tuple[int, int]:
        if b <= 0:
            return hdr_end
        if b >= size:
            return (fsize, 0)
        c = _bam_cut(data, fsize * b // size, n_ref, counter)
        return max(c, hdr_end)

    lo, hi = cut(rank), cut(rank + 1)
    bd = BamData(header_text=template.header_text,
                 ref_names=template.ref_names, ref_lens=template.ref_lens)
    refs, poss, flags = [], [], []
    if lo < hi:
        r = _BlockReader(data)
        r.start_at(lo[0])
        pos_d = lo[1]
        while True:
            # ensure the record header is in the buffer
            while len(r.buf) < pos_d + 4:
                if not r.grow():
                    break
            if len(r.buf) < pos_d + 4:
                break
            va = r.vaddr(pos_d)
            if va >= hi:
                break
            block_size = struct.unpack_from("<i", r.buf, pos_d)[0]
            while len(r.buf) < pos_d + 4 + block_size:
                if not r.grow():
                    break
            if len(r.buf) < pos_d + 4 + block_size:
                break  # truncated tail
            body = bytes(r.buf[pos_d + 4:pos_d + 4 + block_size])
            ref_id, p = struct.unpack_from("<ii", body, 0)
            flag = struct.unpack_from("<H", body, 14)[0]
            bd.records.append(body)
            refs.append(ref_id)
            poss.append(p)
            flags.append(flag)
            pos_d += 4 + block_size
        counter[0] += r.bytes_read
    bd.ref_id = np.array(refs, np.int32)
    bd.pos = np.array(poss, np.int32)
    bd.flag = np.array(flags, np.int32)
    if stats is not None:
        stats["bytes_read"] = counter[0]
        stats["file_bytes"] = fsize
    data.close()
    return bd


# ----------------------------- SAM -----------------------------

def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def parse_sam(data: bytes) -> BamData:
    bd = BamData()
    header_lines = []
    ref_index = {}
    refs, poss, flags = [], [], []
    for line in data.split(b"\n"):
        if not line:
            continue
        if line.startswith(b"@"):
            header_lines.append(line)
            if line.startswith(b"@SQ"):
                nm = ln = None
                for f in line.split(b"\t")[1:]:
                    if f.startswith(b"SN:"):
                        nm = f[3:]
                    elif f.startswith(b"LN:"):
                        ln = int(f[3:])
                if nm is not None:
                    ref_index[nm] = len(bd.ref_names)
                    bd.ref_names.append(nm)
                    bd.ref_lens.append(ln or 0)
            continue
        f = line.split(b"\t")
        name, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq, qual = f[:11]
        flag = int(flag)
        ref_id = ref_index.get(rname, -1)
        pos0 = int(pos) - 1
        next_ref = ref_index.get(rnext if rnext != b"=" else rname, -1)
        next_pos = int(pnext) - 1
        cigar_ops = []
        if cigar != b"*":
            num = 0
            for ch in cigar:
                if 48 <= ch <= 57:
                    num = num * 10 + ch - 48
                else:
                    cigar_ops.append((num << 4) | _CIGAR_OPS.index(chr(ch)))
                    num = 0
        l_seq = 0 if seq == b"*" else len(seq)
        packed = bytearray((l_seq + 1) // 2)
        for j in range(l_seq):
            code = SEQ_CODE.find(chr(seq[j]).upper())
            if code < 0:
                code = 15
            if j % 2 == 0:
                packed[j // 2] |= code << 4
            else:
                packed[j // 2] |= code
        q = (bytes(l_seq) if qual == b"*" else
             bytes((c - 33) for c in qual))
        end = pos0 + max(1, sum((op >> 4) for op in cigar_ops
                                if (op & 0xF) in (0, 2, 3, 7, 8)) or 1)
        body = struct.pack("<iiBBHHHiiii", ref_id, pos0, len(name) + 1,
                           int(mapq), _reg2bin(max(pos0, 0), max(end, 1)),
                           len(cigar_ops), flag, l_seq, next_ref, next_pos,
                           int(tlen))
        body += name + b"\x00"
        body += b"".join(struct.pack("<I", op) for op in cigar_ops)
        body += bytes(packed) + q
        # aux fields pass through as raw SAM text is lossy; re-encode common tags
        bd.records.append(body)
        refs.append(ref_id)
        poss.append(pos0)
        flags.append(flag)
    bd.header_text = b"\n".join(header_lines) + (b"\n" if header_lines else b"")
    bd.ref_id = np.array(refs, np.int32)
    bd.pos = np.array(poss, np.int32)
    bd.flag = np.array(flags, np.int32)
    return bd


def load_alignments(path: str) -> BamData:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        return parse_bam(data)
    return parse_sam(data)


def merge(bds: List[BamData]) -> BamData:
    out = bds[0]
    for bd in bds[1:]:
        if bd.ref_names != out.ref_names:
            raise ValueError("mismatched BAM headers")
        out.records.extend(bd.records)
        out.ref_id = np.concatenate([out.ref_id, bd.ref_id])
        out.pos = np.concatenate([out.pos, bd.pos])
        out.flag = np.concatenate([out.flag, bd.flag])
    return out


def record_to_sam(bd: BamData, i: int) -> bytes:
    """One SAM text line (samtools-view equivalent) incl. aux tags."""
    body = bd.records[i]
    ref_id, pos = struct.unpack_from("<ii", body, 0)
    l_read_name = body[8]
    mapq = body[9]
    n_cigar = struct.unpack_from("<H", body, 12)[0]
    flag = struct.unpack_from("<H", body, 14)[0]
    l_seq = struct.unpack_from("<i", body, 16)[0]
    next_ref, next_pos, tlen = struct.unpack_from("<iii", body, 20)
    name = body[32:32 + l_read_name - 1]
    off = 32 + l_read_name
    cigar_ops = struct.unpack_from("<%dI" % n_cigar, body, off)
    off += 4 * n_cigar
    seq, qual = bd.seq_qual(i)
    cigar = b"".join(b"%d%c" % (op >> 4, _CIGAR_OPS[op & 0xF].encode())
                     for op in cigar_ops) or b"*"
    rname = bd.ref_names[ref_id] if ref_id >= 0 else b"*"
    if next_ref < 0:
        rnext = b"*"
    elif next_ref == ref_id:
        rnext = b"="
    else:
        rnext = bd.ref_names[next_ref]
    qual_txt = bytes(c + 33 for c in qual) if l_seq else b"*"
    fields = [name, b"%d" % flag, rname, b"%d" % (pos + 1), b"%d" % mapq,
              cigar, rnext, b"%d" % (next_pos + 1), b"%d" % tlen,
              seq or b"*", qual_txt]
    # aux tags
    aux_off = off + (l_seq + 1) // 2 + l_seq
    aux = body[aux_off:]
    j = 0
    while j + 3 <= len(aux):
        tag = aux[j:j + 2]
        typ = aux[j + 2:j + 3]
        j += 3
        if typ == b"A":
            fields.append(tag + b":A:" + aux[j:j + 1]); j += 1
        elif typ in b"cC":
            v = aux[j] if typ == b"C" else struct.unpack_from("<b", aux, j)[0]
            fields.append(tag + b":i:%d" % v); j += 1
        elif typ in b"sS":
            fmt = "<h" if typ == b"s" else "<H"
            fields.append(tag + b":i:%d" % struct.unpack_from(fmt, aux, j)[0]); j += 2
        elif typ in b"iI":
            fmt = "<i" if typ == b"i" else "<I"
            fields.append(tag + b":i:%d" % struct.unpack_from(fmt, aux, j)[0]); j += 4
        elif typ == b"f":
            fields.append(tag + b":f:%g" % struct.unpack_from("<f", aux, j)[0]); j += 4
        elif typ in b"ZH":
            end = aux.index(b"\x00", j)
            fields.append(tag + b":" + typ + b":" + aux[j:end]); j = end + 1
        elif typ == b"B":
            sub = aux[j:j + 1]; j += 1
            cnt = struct.unpack_from("<i", aux, j)[0]; j += 4
            sizes = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}
            fmts = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H",
                    b"i": "<i", b"I": "<I", b"f": "<f"}
            vals = [struct.unpack_from(fmts[sub], aux, j + t * sizes[sub])[0]
                    for t in range(cnt)]
            j += cnt * sizes[sub]
            body_txt = b",".join((b"%g" if sub == b"f" else b"%d") % v for v in vals)
            fields.append(tag + b":B:" + sub + b"," + body_txt)
        else:
            break  # unknown tag type; stop rather than emit garbage
    return b"\t".join(fields)


def to_sam_text(bd: BamData, order=None) -> bytes:
    out = [bd.header_text if bd.header_text.endswith(b"\n")
           else bd.header_text + b"\n"]
    idx = order if order is not None else range(bd.n)
    for i in idx:
        out.append(record_to_sam(bd, int(i)) + b"\n")
    return b"".join(out)


def coordinate_sort_order(bd: BamData) -> np.ndarray:
    """samtools-sort order: refID ascending (unmapped -1 last), pos asc."""
    ref = np.where(bd.ref_id < 0, np.int64(1 << 40), bd.ref_id.astype(np.int64))
    key = ref * (1 << 34) + (bd.pos.astype(np.int64) + 2)
    return np.argsort(key, kind="stable")
