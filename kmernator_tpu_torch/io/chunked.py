"""Chunked ReadSet streaming: bounded-memory iteration over FASTQ files.

The host-side analogue of the reference's ReadSetStream
(ref: src/ReadSet.h:656-748): the file is mmap'd and consumed in
chunk_bytes windows cut at pair-preserving record boundaries
(ref: ReadFileReader::seekToNextRecord, src/ReadFileReader.h:657-740), so
peak host memory is O(chunk) regardless of input size.  The quality base
is detected once on the first chunk and forced for the rest (the reference
examines only the first 20000 reads too, ref: src/ReadSet.h:171-209).

gz inputs stream through zlib sequentially (no random access), cut at the
same pair-preserving boundaries — bounded memory either way.  The parallel
worker-pool engine needs byte ranges, so gz inputs use the sequential
engine (apps/filter_reads gates on the extension).

Copied for kmernator_tpu_torch from kmernator_tpu/io/chunked.py; it differs
from its source only in its package imports.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from kmernator_tpu_torch.io.reads import (ReadSet, find_next_record, open_maybe_gzip,
                                    parse_fastq_bytes, partition_ranges)


def chunk_ranges(paths: List[str], chunk_bytes: int):
    """Record-aligned (file_idx, path, start, end) ranges — the exact
    boundaries stream_readsets would cut, computable up front so a worker
    pool can own chunks independently."""
    out = []
    for fi, path in enumerate(paths):
        data = open_maybe_gzip(path, use_mmap=not path.endswith(".gz"))
        if bytes(data[:1]) == b">":
            raise ValueError("chunk_ranges supports FASTQ only")
        size = len(data)
        pos = 0
        while pos < size:
            end = min(pos + chunk_bytes, size)
            if end < size:
                end = find_next_record(data, end, by_pair=True)
            out.append((fi, path, pos, end))
            pos = end
        del data
    return out


def read_chunk(path: str, start: int, end: int, base: int,
               comment_stored: bool, file_idx: int) -> ReadSet:
    """Parse one chunk_ranges() range into a ReadSet (quality base forced)."""
    data = open_maybe_gzip(path, use_mmap=not path.endswith(".gz"))
    chunk = bytes(data[start:end])
    del data
    rs = ReadSet()
    rs.append_arrays(*parse_fastq_bytes(chunk, comment_stored),
                     file_idx=file_idx)
    rs.detect_quality_base(base, limit=0)
    return rs


def detect_base_from_head(paths: List[str], chunk_bytes: int,
                          output_base_quality: int,
                          comment_stored: bool = True) -> int:
    """Quality base detected from the HEAD chunk of the first file — the
    same bytes the single-process streaming engine's first chunk sees, so
    every rank of a partitioned run agrees with it and with each other
    (ref: ReadSet::validateFastqStart examines only the input head,
    src/ReadSet.h:171-209)."""
    data = open_maybe_gzip(paths[0], use_mmap=not paths[0].endswith(".gz"))
    end = min(chunk_bytes, len(data))
    if end < len(data):
        end = find_next_record(data, end, by_pair=True)
    rs = ReadSet()
    rs.append_arrays(*parse_fastq_bytes(bytes(data[:end]), comment_stored),
                     file_idx=0)
    return rs.detect_quality_base(output_base_quality)


def stream_partition_readsets(paths: List[str], rank: int, size: int,
                              chunk_bytes: int = 32 << 20,
                              output_base_quality: int = 33,
                              comment_stored: bool = True,
                              forced_base: int = 0) -> Iterator[ReadSet]:
    """Stream THIS rank's byte-range partition of each FASTQ file in
    record-aligned chunks — the rank-partitioned ReadSetStream
    (ref: src/ReadSet.h:656-748 streaming + ReadFileReader::seekToPartition
    resync, src/ReadFileReader.h:379-397).  Partition boundaries use the
    same pair-preserving resync as io.reads.extract_partition, so the
    union over ranks is exactly the file and pairs never split across
    ranks.  gz inputs have no random access and are rejected."""
    base = forced_base or None
    for fi, path in enumerate(paths):
        if path.endswith(".gz"):
            raise ValueError("partitioned streaming needs random access; "
                             "decompress gz inputs first")
        data = open_maybe_gzip(path, use_mmap=True)
        if bytes(data[:1]) == b">":
            raise ValueError("stream_partition_readsets supports FASTQ "
                             "only; use load_reads for FASTA(+qual)")
        if base is None:
            base = detect_base_from_head(paths, chunk_bytes,
                                         output_base_quality, comment_stored)
        start, end = partition_ranges(len(data), rank, size)
        s = find_next_record(data, start)
        e = find_next_record(data, end) if end < len(data) else len(data)
        pos = s
        while pos < e:
            pe = min(pos + chunk_bytes, e)
            if pe < e:
                pe = find_next_record(data, pe, by_pair=True)
            rs = ReadSet()
            rs.append_arrays(*parse_fastq_bytes(bytes(data[pos:pe]),
                                                comment_stored), file_idx=fi)
            rs.detect_quality_base(base, limit=0)  # force the agreed base
            yield rs
            pos = pe
        del data


def _count_fastq_records(chunk: bytes) -> int:
    """Record count of a record-aligned FASTQ slice (4 lines/record)."""
    nl = chunk.count(b"\n")
    if nl % 4:
        raise ValueError("chunk is not record-aligned (%d lines)" % nl)
    return nl // 4


def _skip_fastq_records(data, pos: int, n: int) -> int:
    """Offset just past the n-th FASTQ record starting at pos (4 lines
    each), scanning forward in bounded windows."""
    need = 4 * n
    size = len(data)
    while need > 0:
        if pos >= size:
            raise ValueError("mate file ends %d records early"
                             % ((need + 3) // 4))
        win = np.frombuffer(bytes(data[pos:min(pos + (8 << 20), size)]),
                            np.uint8)
        nls = np.flatnonzero(win == 10)
        if len(nls) >= need:
            return pos + int(nls[need - 1]) + 1
        if pos + len(win) >= size:
            raise ValueError("mate file ends %d records early"
                             % ((need - len(nls) + 3) // 4))
        pos += len(win)
        need -= len(nls)
    return pos


def paired_chunk_ranges(p1: str, p2: str, chunk_bytes: int):
    """Aligned (start1, end1, start2, end2) chunk ranges over a mate-file
    PAIR: file 1 is cut at record boundaries every ~chunk_bytes/2, and
    file 2 advances by exactly the same RECORD count, so positionally
    aligned mates (the standard R1/R2 layout) always land in the same
    chunk — the two-file byPair resync of the reference
    (ref: src/ReadFileReader.h:657-740 semantics applied to split pair
    files, src/ReadSet.cpp:186-218).  Computable up front so the worker
    pool can own chunks independently.  Trailing unmatched records of
    either file become their own tail ranges."""
    d1 = open_maybe_gzip(p1, use_mmap=True)
    d2 = open_maybe_gzip(p2, use_mmap=True)
    if bytes(d1[:1]) == b">" or bytes(d2[:1]) == b">":
        raise ValueError("paired_chunk_ranges supports FASTQ only")
    out = []
    half = max(chunk_bytes // 2, 1 << 12)
    pos1 = pos2 = 0
    while pos1 < len(d1):
        end1 = min(pos1 + half, len(d1))
        if end1 < len(d1):
            end1 = find_next_record(d1, end1, by_pair=False)
        n1 = _count_fastq_records(bytes(d1[pos1:end1]))
        end2 = _skip_fastq_records(d2, pos2, n1)
        out.append((pos1, end1, pos2, end2))
        pos1, pos2 = end1, end2
    if pos2 < len(d2):  # mate file longer: tail reads stream unpaired
        out.append((pos1, pos1, pos2, len(d2)))
    del d1, d2
    return out


def read_chunk_paired(p1: str, p2: str, rng, base: int,
                      comment_stored: bool) -> ReadSet:
    """Parse one paired_chunk_ranges() range into a ReadSet: file-1 reads
    first (file_idx 0), then their mates (file_idx 1) — identify_pairs
    matches them by name within the chunk."""
    s1, e1, s2, e2 = rng
    rs = ReadSet()
    if e1 > s1:
        d1 = open_maybe_gzip(p1, use_mmap=True)
        rs.append_arrays(*parse_fastq_bytes(bytes(d1[s1:e1]), comment_stored),
                         file_idx=0)
        del d1
    if e2 > s2:
        d2 = open_maybe_gzip(p2, use_mmap=True)
        rs.append_arrays(*parse_fastq_bytes(bytes(d2[s2:e2]), comment_stored),
                         file_idx=1)
        del d2
    rs.detect_quality_base(base, limit=0)
    return rs


def stream_paired_readsets(paths: List[str], chunk_bytes: int = 32 << 20,
                           output_base_quality: int = 33,
                           comment_stored: bool = True) -> Iterator[ReadSet]:
    """Bounded-memory streaming over a two-file mate PAIR: both files
    advance in record-count lockstep so mates share a chunk (the
    reference's paired two-file streaming, ref: src/ReadSet.cpp:186-218
    with the byPair resync of src/ReadFileReader.h:657-740)."""
    p1, p2 = paths
    base = detect_base_from_head([p1], chunk_bytes, output_base_quality,
                                 comment_stored)
    for rng in paired_chunk_ranges(p1, p2, chunk_bytes):
        yield read_chunk_paired(p1, p2, rng, base, comment_stored)


def paired_files_aligned(p1: str, p2: str, n: int = 1000) -> bool:
    """True when the heads of two FASTQ files pair positionally (record i
    of each file shares a common name) — the gate for engaging the
    paired streaming engine on the standard R1/R2 layout."""
    from kmernator_tpu_torch.io.reads import common_name
    try:
        d1 = open_maybe_gzip(p1, use_mmap=not p1.endswith(".gz"))
        d2 = open_maybe_gzip(p2, use_mmap=not p2.endswith(".gz"))
    except (OSError, ValueError):
        return False
    try:
        try:
            e1 = _skip_fastq_records(d1, 0, n)
        except ValueError:
            e1 = len(d1)  # head shorter than n records: use the whole file
        r1 = ReadSet()
        r1.append_arrays(*parse_fastq_bytes(bytes(d1[:e1]), False))
        try:
            e2 = _skip_fastq_records(d2, 0, r1.n)
        except ValueError:
            e2 = len(d2)
        r2 = ReadSet()
        r2.append_arrays(*parse_fastq_bytes(bytes(d2[:e2]), False))
    except (ValueError, IndexError):
        return False
    if r1.n == 0 or r2.n < min(r1.n, n):
        return False
    m = min(r1.n, r2.n)
    return all(common_name(r1.names[i]) == common_name(r2.names[i])
               for i in range(m))


def _gz_chunks(path: str, chunk_bytes: int) -> Iterator[bytes]:
    """Record-aligned decompressed chunks of a gz FASTQ, one sequential
    pass in bounded memory (gz has no random access, so the file streams
    through zlib while the cut points follow the same pair-preserving
    record-boundary rule as the mmap path)."""
    import gzip
    carry = b""
    with gzip.open(path, "rb") as f:
        while True:
            data = f.read(chunk_bytes)
            if not data:
                if carry:
                    yield carry
                return
            buf = carry + data
            if len(buf) < chunk_bytes:
                carry = buf
                continue
            cut = find_next_record(buf, max(len(buf) - (64 << 10), 0),
                                   by_pair=True)
            if cut <= 0 or cut >= len(buf):
                carry = buf  # no boundary near the tail: grow the chunk
                continue
            yield buf[:cut]
            carry = buf[cut:]


def stream_readsets(paths: List[str], chunk_bytes: int = 32 << 20,
                    output_base_quality: int = 33,
                    comment_stored: bool = True,
                    forced_base: int = 0) -> Iterator[ReadSet]:
    """Yield ReadSet chunks of ~chunk_bytes each, pairs kept intact.
    Each yielded ReadSet carries .file_idx of its source path."""
    base = forced_base or None
    for fi, path in enumerate(paths):
        if path.endswith(".gz"):
            first = True
            for chunk in _gz_chunks(path, chunk_bytes):
                if first and chunk[:1] == b">":
                    raise ValueError("stream_readsets supports FASTQ only; "
                                     "use load_reads for FASTA(+qual)")
                first = False
                rs = ReadSet()
                rs.append_arrays(*parse_fastq_bytes(chunk, comment_stored),
                                 file_idx=fi)
                if base is None:
                    base = rs.detect_quality_base(output_base_quality)
                else:
                    rs.detect_quality_base(base, limit=0)
                yield rs
            continue
        data = open_maybe_gzip(path, use_mmap=True)
        if bytes(data[:1]) == b">":
            raise ValueError("stream_readsets supports FASTQ only; "
                             "use load_reads for FASTA(+qual)")
        size = len(data)
        pos = 0
        while pos < size:
            end = min(pos + chunk_bytes, size)
            if end < size:
                end = find_next_record(data, end, by_pair=True)
            chunk = bytes(data[pos:end])
            rs = ReadSet()
            rs.append_arrays(*parse_fastq_bytes(chunk, comment_stored),
                             file_idx=fi)
            if base is None:
                base = rs.detect_quality_base(output_base_quality)
            else:
                rs.detect_quality_base(base, limit=0)  # force known base
            yield rs
            pos = end
