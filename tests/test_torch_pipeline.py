"""kmernator_tpu_torch.parallel.pipeline against the JAX module:
StreamingSpectrum through build_streaming at k = 31 on a seeded FASTQ
made here (qualities of phred 5-40, no N, so no base has probability 0
and the two window_good agree: ROADMAP 3o), in its three add_batch forms
(float32 logp, raw qualities with the stream's table, 2-bit codes with
raw qualities) at batches of 128 and 333 reads; the singleton purge under
capacity pressure; add_table. Tables, counts and purged_singletons
bit-equal (tolerance: none)."""
import numpy as np
import pytest
import torch

from kmernator_tpu.io.stream import FastqBatchStream as JStream
from kmernator_tpu.parallel import pipeline as J
from kmernator_tpu_torch.io.stream import FastqBatchStream as TStream
from kmernator_tpu_torch.parallel import pipeline as T

import torch_threads  # noqa: F401

K = 31


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """1,200 reads of 80-150 bp from an 8 kb genome with 0.5%
    substitutions, qualities phred 5-40 (base 33)."""
    rng = np.random.default_rng(12)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 8000, dtype=np.uint8)
    path = tmp_path_factory.mktemp("pipeline") / "in.fastq"
    with open(path, "wb") as f:
        for i in range(1200):
            n = int(rng.integers(80, 151))
            s = int(rng.integers(0, 8000 - n))
            c = genome[s:s + n].copy()
            err = rng.random(n) < 0.005
            c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
            q = (rng.integers(5, 41, n) + 33).astype(np.uint8)
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, acgt[c].tobytes(),
                                             q.tobytes()))
    return str(path)


def _stream(cls, path, batch_reads, mode):
    return cls([path], batch_reads=batch_reads,
               raw_qual=(mode == "raw_qual"), pack2=(mode == "pack2"))


@pytest.mark.parametrize("mode", ["logp", "raw_qual", "pack2"])
@pytest.mark.parametrize("batch_reads,capacity", [(128, 65536),
                                                  (333, 16384)])
def test_build_streaming_bit_equal(fastq, mode, batch_reads, capacity):
    want = J.build_streaming(_stream(JStream, fastq, batch_reads, mode), K,
                             capacity, min_depth=2)
    got = T.build_streaming(_stream(TStream, fastq, batch_reads, mode), K,
                            capacity, min_depth=2, device="cpu")
    assert got[0].dtype == np.uint32 and len(got[0]) > 5000
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b)


def test_streaming_drains_and_add_table_bit_equal(fastq):
    """Batches and a host table through add_table, with drains every few
    batches (drain_threshold 20,000 rows): the tables after each step and
    the final one bit-equal."""
    jsp = J.StreamingSpectrum(K, 30000, drain_threshold=20000)
    tsp = T.StreamingSpectrum(K, 30000, drain_threshold=20000, device="cpu")
    batches = list(_stream(TStream, fastq, 100, "logp"))
    rng = np.random.default_rng(3)
    table = np.unique(rng.integers(0, 2**31, (300, 2)).astype(np.uint32),
                      axis=0)
    counts = rng.integers(1, 4, len(table)).astype(np.int32)
    for i, (codes, logp, lengths) in enumerate(batches):
        jsp.add_batch(codes, logp, lengths)
        tsp.add_batch(codes, logp, lengths)
        if i == 3:
            jsp.add_table(table, counts)
            tsp.add_table(table, counts)
        assert np.array_equal(np.asarray(jsp.keys).astype(np.int64),
                              tsp.keys.numpy())
        assert np.array_equal(np.asarray(jsp.counts), tsp.counts.numpy())
    assert tsp.drains >= 3 and tsp.total_windows == jsp.total_windows
    for a, b in zip(jsp.finalize(1), tsp.finalize(1)):
        assert np.array_equal(a, b)


def test_streaming_singleton_purge_bit_equal():
    """The JAX purge test's input: 12 batches of 256 reads of 64 bp, half
    random, half from a 2 kb genome, at capacity 8,192: singletons are
    purged, and the table and purged_singletons are the JAX ones."""
    rng = np.random.default_rng(5)
    L, B = 64, 256
    genome = rng.integers(0, 4, 2000, dtype=np.uint8)
    jsp = J.StreamingSpectrum(K, capacity=8192)
    tsp = T.StreamingSpectrum(K, capacity=8192, device="cpu")
    logp = np.full((B, L), np.float32(-0.000144), np.float32)
    lengths = np.full(B, L, np.int32)
    for _ in range(12):
        codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
        starts = rng.integers(0, 2000 - L, B // 2)
        codes[:B // 2] = genome[starts[:, None] + np.arange(L)[None, :]]
        jsp.add_batch(codes, logp, lengths)
        tsp.add_batch(codes, logp, lengths)
    want, got = jsp.finalize(2), tsp.finalize(2)
    assert tsp.purged_singletons == jsp.purged_singletons > 0
    assert len(got[0]) > 1000
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def test_unpack_2bit_matches_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 256, (7, 13), dtype=np.uint8)
    want = np.asarray(J.unpack_2bit(jnp.asarray(packed), 50))
    assert np.array_equal(want, T.unpack_2bit(torch.from_numpy(packed),
                                              50).numpy())


def test_prefetched_raises_after_the_items_before_the_fault():
    def items():
        yield 1
        yield 2
        raise OSError("read failed")

    got = []
    with pytest.raises(OSError, match="read failed"):
        for x in T._prefetched(items(), 2):
            got.append(x)
    assert got == [1, 2]
