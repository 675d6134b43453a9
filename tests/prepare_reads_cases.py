"""Test inputs and the window chain of the prepare_reads kernel.

`schedule_plain` replays the kernel's per-read chain (rolling counts of
bad bases, the recompute points) in Python floats, which tests hold
bit-equal to the host's `window_weights` and `good_kmer_mask`;
`edge_cases` makes a ReadSet of the cases the kernel must get right.
tests/test_torch_prepare_reads.py (CPU) and tests/test_torch_cuda.py (the
card) share them.
"""
import numpy as np

from kmernator_tpu_torch.io.reads import BASE_CODE, ReadSet
from kmernator_tpu_torch.parallel import prepare_reads as pr

RESYNC = 1024         # window_weights' recompute period


def schedule_plain(rs, k: int, L: int, min_quality: int, output_base: int,
                   min_kmer_quality: float):
    """The kernel's window chain in Python floats (IEEE float64, as
    __dmul_rn and __ddiv_rn round): (good2d [n, NW] bool, weights2d [n, NW]
    f32). Slow."""
    NW = L - k + 1
    ptab = pr.quality_table(rs.input_qual_base, min_quality, output_base)
    ctab = BASE_CODE
    min_kq = np.float32(min_kmer_quality)
    good2d = np.zeros((rs.n, NW), dtype=bool)
    weights2d = np.zeros((rs.n, NW), dtype=np.float32)
    for r in range(rs.n):
        o, e = int(rs.offsets[r]), int(rs.offsets[r + 1])
        s, q = rs.seq[o:e], rs.qual[o:e]
        hq, dis = bool(rs.has_quals[r]), bool(rs.discarded[r])
        p = [0.0 if ctab[s[j]] == 4 else float(ptab[q[j]]) if hq else 1.0
             for j in range(e - o)]
        nbad = sum(x == 0.0 for x in p[:k - 1])
        w, prev_bad = 0.0, False
        for i in range(max(e - o - k + 1, 0)):
            nbad += p[i + k - 1] == 0.0
            if i > 0:
                nbad -= p[i - 1] == 0.0
            bad = nbad > 0
            wo = 0.0
            if not bad:
                if prev_bad or i % RESYNC == 0:
                    w = 1.0
                    for j in range(k):
                        w = w * p[i + j]
                else:
                    w = w * (p[i + k - 1] / p[i - 1])
                wo = w
            prev_bad = bad
            weights2d[r, i] = np.float32(wo)
            good2d[r, i] = not dis and weights2d[r, i] > min_kq
    return good2d, weights2d


def edge_cases(k: int, seed: int = 0, input_qual_base: int = 33,
               long_read: int = 0, max_length: int = 0):
    """A ReadSet of some 700 reads for the tests: lengths from 0 to past k
    and past 1,024 windows (and one of `long_read` bases, past a block's
    stage, when given; none past `max_length`, when given), bases of every
    ACGT, N, other markup bytes and lower case, qualities from 0 to 93
    with runs under any minimum quality of 2 or more (base probability 0),
    reads without qualities and discarded reads. The reads past 1,024
    windows and every fifth read hold no markup and qualities of 20 or
    more, so that their weights roll over long chains of windows."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, k - 1, k, k + 1, 2 * k, RESYNC + k - 1, RESYNC + k,
            RESYNC + k + 1, 2 * RESYNC + k + 5]
    lens += list(rng.integers(k, k + 160, 690))
    if long_read:
        lens.insert(300, long_read)
    if max_length:
        lens = [min(n, max_length) for n in lens]
    alphabet = np.frombuffer(b"ACGTACGTACGTACGTNnacgtR.-", dtype=np.uint8)
    seqs, phreds = [], []
    for i, n in enumerate(lens):
        b = alphabet[rng.integers(0, 16, n)]
        clean = n > RESYNC or i % 5 == 2   # long incremental chains
        if i % 3 == 0 and n and not clean:  # markup bases, a few a read
            at = rng.integers(0, n, rng.integers(1, 4))
            b[at] = alphabet[rng.integers(16, len(alphabet), len(at))]
        seqs.append(b.tobytes())
        if i % 7 == 3:
            phreds.append(None)    # no qualities: probability 1.0
            continue
        q = rng.integers(20, 42, n) if clean else rng.integers(2, 42, n)
        if i % 4 == 1 and n and not clean:   # a run of low qualities
            a = int(rng.integers(0, n))
            q[a:a + int(rng.integers(1, 8))] = rng.integers(0, 2)
        if i % 11 == 5 and n:      # the top of the scale
            q[rng.integers(0, n, 3)] = 93 if input_qual_base == 33 else 62
        phreds.append(q)
    rs = ReadSet()
    rs.input_qual_base = input_qual_base
    rs.append_reads_batch([b"r%d" % i for i in range(len(lens))],
                          [b""] * len(lens), seqs, phreds)
    rs.discarded[rng.random(rs.n) < 0.05] = True
    return rs
