"""Seeded SAM text for the port's BAM tests: paired reads on a few
references, both strands, read1 and read2, MAPQ 0-60, indels, clips and
N bases in CIGARs and sequences, '*' qualities, mates on other
references, and unmapped records, half of them placed (reference and
position of their mate) and half unplaced."""
import numpy as np

CIGARS = (b"%dM", b"5S%dM", b"%dM2I", b"%dM3D2M", b"%dM4N1M")


def make_sam(path, n: int, seed: int, n_refs: int = 3,
             read_len: int = 60, unmapped: float = 0.1) -> None:
    rng = np.random.default_rng(seed)
    lens = rng.integers(2_000, 8_000, n_refs)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    lines = [b"@HD\tVN:1.6\tSO:unsorted"]
    lines += [b"@SQ\tSN:chr%d\tLN:%d" % (i, L) for i, L in enumerate(lens)]
    lines.append(b"@PG\tID:sam_input\tPN:make_sam")
    ref = rng.integers(0, n_refs, n)
    pos = rng.integers(1, lens[ref] - read_len - 10)
    unm = rng.random(n) < unmapped
    placed = rng.random(n) < 0.5
    mate = np.where(rng.random(n) < 0.5, 0x40, 0x80)
    rev = np.where(rng.random(n) < 0.5, 0x10, 0)
    mapq = rng.integers(0, 61, n)
    cig = rng.integers(0, len(CIGARS), n)
    mate_ref = np.where(rng.random(n) < 0.1, rng.integers(0, n_refs, n), ref)
    seqs = bases[rng.choice(5, (n, read_len), p=[0.24] * 4 + [0.04])]
    quals = (rng.integers(2, 41, (n, read_len)) + 33).astype(np.uint8)
    no_qual = rng.random(n) < 0.02
    for i in range(n):
        flag = 0x1 | int(mate[i]) | int(rev[i])
        rname, p, mq = b"chr%d" % ref[i], int(pos[i]), int(mapq[i])
        clip = 5 if cig[i] == 1 else (2 if cig[i] == 2 else 0)
        tail = {3: 2, 4: 1}.get(int(cig[i]), 0)
        cigar = CIGARS[cig[i]] % (read_len - clip - tail)
        rnext = b"=" if mate_ref[i] == ref[i] else b"chr%d" % mate_ref[i]
        if unm[i]:
            flag |= 0x4
            cigar, mq = b"*", 0
            if not placed[i]:
                rname, p, rnext = b"*", 0, b"*"
        qual = b"*" if no_qual[i] else quals[i].tobytes()
        lines.append(b"\t".join([
            b"r%06d" % (i // 2), b"%d" % flag, rname, b"%d" % p, b"%d" % mq,
            cigar, rnext, b"%d" % p, b"%d" % (read_len if i % 2 else
                                             -read_len),
            seqs[i].tobytes(), qual, b"NM:i:0"]))
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
