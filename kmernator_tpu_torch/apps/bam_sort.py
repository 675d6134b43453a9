"""BamSort: merge + coordinate-sort SAM/BAM files, with unmapped-read
extraction to fastq.gz (ref: apps/BamSort-P.cpp + src/SamUtils.h).

Usage: bam_sort [--unmapped-reads out.fastq.gz]
               [--unmapped-read-pairs out.fastq.gz]
               [--keep-unmapped-paired-read true|false]
               output.bam input1.[sb]am [input2 ...]

Copied for kmernator_tpu_torch from kmernator_tpu/apps/bam_sort.py. It
differs from its source in its package imports and in:
- `--device cuda|cpu` is accepted, as the port's other apps accept it,
  and ignored (utils/device.py `drop_device`) in place of
  `--jax-platform`: the app runs on the host whichever device is named,
  with or without a visible GPU.
- `run_distributed` takes its rank and size from the port's
  `parallel/multihost.py` (torch.distributed over gloo, made by
  `multihost.initialize` from the same `--distributed HOST:PORT --nprocs N
  --procid i`), and its bins from parallel/bam_exchange.py: one bin a
  process, where the JAX app bins by the devices of its global mesh. With
  one device a process the two give the same bytes. At `--nprocs 1` the
  host engine runs, as in the source.
"""
from __future__ import annotations

import gzip
import sys
from typing import List

import numpy as np

from kmernator_tpu_torch.io.bam import (BamData, coordinate_sort_order,
                                        load_alignments, merge, write_bam)
from kmernator_tpu_torch.utils.device import drop_device
from kmernator_tpu_torch.utils.logging import Log

COMP = bytes.maketrans(b"ACGTacgtN", b"TGCAtgcaN")

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80


def to_fastq(bd: BamData, i: int) -> bytes:
    name = bd.name(i)
    flag = int(bd.flag[i])
    seq, qual = bd.seq_qual(i)
    if flag & FLAG_REVERSE:
        seq = seq.translate(COMP)[::-1]
        qual = qual[::-1]
    suffix = b""
    if flag & FLAG_READ1:
        suffix = b"/1"
    elif flag & FLAG_READ2:
        suffix = b"/2"
    q = bytes(c + 33 for c in qual)
    return b"@" + name + suffix + b"\n" + seq + b"\n+\n" + q + b"\n"


def run_distributed(out_path, inputs, unmapped_reads, unmapped_pairs,
                    keep_unmapped_paired) -> int:
    """Multi-process BamSort-P: record-range partition, position-splitter
    binning, one all_to_all record exchange, per-rank local sorts, and a
    rank-ordered gathered write of concatenated BGZF sections
    (ref: apps/BamSort-P.cpp + MPIReadExchanger, src/SamUtils.h:1266-1421).
    """
    import gzip as _gz
    from kmernator_tpu_torch.io.bam import (bgzf_compress, header_bytes,
                                            records_blob, parse_records_blob,
                                            BGZF_EOF)
    from kmernator_tpu_torch.parallel import multihost as mh
    from kmernator_tpu_torch.parallel.bam_exchange import (
        sort_key, global_splitters, exchange_blobs)
    rank, size = mh.process_index(), mh.process_count()
    # byte-range partitioned input: every rank parses only its share of
    # each file's BGZF blocks (header + resync windows aside), matching
    # the reference's partitioned read (ref: src/SamUtils.h:509-648)
    from kmernator_tpu_torch.io.bam import load_alignments_partitioned
    stats: dict = {}
    parts = []
    for p in inputs:
        st: dict = {}
        parts.append(load_alignments_partitioned(p, rank, size, stats=st))
        for key, v in st.items():
            stats[key] = stats.get(key, 0) + v
    bd_all = merge(parts)
    if stats.get("file_bytes"):
        Log.debug(1, "rank %d parsed %d/%d compressed bytes (%.0f%%)"
                  % (rank, stats["bytes_read"], stats["file_bytes"],
                     100.0 * stats["bytes_read"] / stats["file_bytes"]))
    sel = np.arange(bd_all.n)
    unmapped = (bd_all.flag[sel] & FLAG_UNMAPPED) != 0
    placed = bd_all.ref_id[sel] >= 0
    fastq_singles, fastq_pairs = [], []
    keep = np.ones(len(sel), dtype=bool)
    if unmapped_reads or unmapped_pairs:
        for j in np.flatnonzero(unmapped):
            rec = to_fastq(bd_all, int(sel[j]))
            if unmapped_pairs and not placed[j]:
                fastq_pairs.append(rec)
            else:
                fastq_singles.append(rec)
        keep = ~unmapped | (placed & keep_unmapped_paired)
    sel = sel[keep]

    D = size  # one bin a rank
    keys = sort_key(bd_all)[sel]
    splitters = global_splitters(keys, D)
    dest = np.searchsorted(splitters, keys, side="right")
    blobs = [records_blob(bd_all, sel[dest == d]) for d in range(D)]
    received = exchange_blobs(blobs)
    bd = parse_records_blob(b"".join(received), bd_all)
    order = coordinate_sort_order(bd)
    body = bgzf_compress(records_blob(bd, order), eof=False)
    if rank == 0:
        body = bgzf_compress(header_bytes(bd_all), eof=False) + body
    if rank == size - 1:
        body += BGZF_EOF
    mh.write_gathered(out_path, body)
    if unmapped_reads:
        mh.write_gathered(unmapped_reads,
                          _gz.compress(b"".join(fastq_singles)))
    if unmapped_pairs:
        mh.write_gathered(unmapped_pairs,
                          _gz.compress(b"".join(fastq_pairs)))
    return 0


def run(argv: List[str]) -> int:
    argv = drop_device(argv)
    unmapped_reads = None
    unmapped_pairs = None
    keep_unmapped_paired = True
    out_flag = None
    in_flag: List[str] = []
    args = []
    dist_coord, dist_nprocs, dist_procid = None, 1, 0
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--distributed":
            dist_coord = argv[i + 1]
            i += 2
        elif a == "--nprocs":
            dist_nprocs = int(argv[i + 1])
            i += 2
        elif a == "--procid":
            dist_procid = int(argv[i + 1])
            i += 2
        elif a == "--unmapped-reads":
            unmapped_reads = argv[i + 1]
            i += 2
        elif a == "--unmapped-read-pairs":
            unmapped_pairs = argv[i + 1]
            i += 2
        elif a == "--keep-unmapped-paired-read":
            keep_unmapped_paired = argv[i + 1].lower() not in ("0", "false")
            i += 2
        elif a == "--output-bam":
            out_flag = argv[i + 1]
            i += 2
        elif a == "--input-bams":
            in_flag.append(argv[i + 1])
            i += 2
        elif a == "--num-partitions":
            i += 2  # MPI redistribution partition count — single-image sort
        else:
            args.append(a)
            i += 1
    if out_flag is not None:
        out_path, inputs = out_flag, in_flag + args
    else:
        if len(args) < 2:
            print("usage: bam_sort [options] output.bam input...",
                  file=sys.stderr)
            return 1
        out_path, inputs = args[0], args[1:]

    if dist_nprocs > 1:
        from kmernator_tpu_torch.parallel import multihost
        multihost.initialize(dist_coord, dist_nprocs, dist_procid)
        return run_distributed(out_path, inputs, unmapped_reads,
                               unmapped_pairs, keep_unmapped_paired)

    bd = merge([load_alignments(p) for p in inputs])
    unmapped = (bd.flag & FLAG_UNMAPPED) != 0
    placed = bd.ref_id >= 0

    fastq_singles = []
    fastq_pairs = []
    keep = np.ones(bd.n, dtype=bool)
    if unmapped_reads or unmapped_pairs:
        for i in np.flatnonzero(unmapped):
            rec = to_fastq(bd, int(i))
            if unmapped_pairs and not placed[i]:
                fastq_pairs.append(rec)
            else:
                fastq_singles.append(rec)
        # BAM retention (ref: SamUtilsTest.sh contracts):
        #  - unplaced unmapped reads always leave the BAM
        #  - placed-but-unmapped reads stay iff keep-unmapped-paired-read
        keep = ~unmapped | (placed & keep_unmapped_paired)

    order = coordinate_sort_order(bd)
    order = order[keep[order]]
    if out_path.endswith(".sam"):
        from kmernator_tpu_torch.io.bam import to_sam_text
        with open(out_path, "wb") as f:
            f.write(to_sam_text(bd, order))
    else:
        with open(out_path, "wb") as f:
            f.write(write_bam(bd, order))

    if unmapped_reads:
        with gzip.open(unmapped_reads, "wb") as f:
            f.write(b"".join(fastq_singles))
    if unmapped_pairs:
        with gzip.open(unmapped_pairs, "wb") as f:
            f.write(b"".join(fastq_pairs))
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
