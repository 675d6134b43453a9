"""k > 96 in kmernator_tpu_torch: FilterReads' and MeraculousCounter's
device engines, distributed_count_fn, spectrum_step and StreamingSpectrum
at keys of four and five int64 lanes, against the JAX package (which takes
any k). The other k > 96 cases are inputs of the tests of their functions
(test_torch_wide_keys.py, test_torch_variant_purge.py,
test_torch_device_library.py and the apps' test files).

Inputs are made from numpy seeds here, with reads of at least k + 20
bases. Tolerance: none for keys, counts, lookups and app output (bit- or
byte-identical). JAX oracle runs of the apps use --threads 1 and run in
this process, on the conftest's CPU devices (two for --mesh 2).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmernator_tpu.apps import filter_reads as jax_fr
from kmernator_tpu.apps import meraculous_counter as jax_mer
from kmernator_tpu.io.stream import FastqBatchStream as JStream
from kmernator_tpu.parallel import device_spectrum as JS
from kmernator_tpu.parallel import mesh as JM
from kmernator_tpu.parallel import pipeline as JP
from kmernator_tpu_torch.apps import filter_reads as torch_fr
from kmernator_tpu_torch.apps import meraculous_counter as torch_mer
from kmernator_tpu_torch.io.stream import FastqBatchStream as TStream
from kmernator_tpu_torch.parallel import device_spectrum as TS
from kmernator_tpu_torch.parallel import mesh as TM
from kmernator_tpu_torch.parallel import pipeline as TP

import torch_threads  # noqa: F401

BASE = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
        "--artifact-edit-distance", "1", "--min-read-length", "25"]


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _write_reads(path, seed, n_reads=400, read_len=150, genome_len=5000,
                 min_len=None):
    """Reads of a random genome with 1% substitutions and phred 12-40
    qualities; lengths from min_len to read_len (all read_len by
    default)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    recs = []
    for i in range(n_reads):
        n = int(rng.integers(min_len, read_len + 1)) if min_len \
            else read_len
        s = int(rng.integers(0, genome_len - n))
        read = genome[s:s + n].copy()
        err = rng.random(n) < 0.01
        read[err] = (read[err] + 1) % 4
        q = bytes(rng.integers(45, 74, n).astype(np.uint8))
        recs.append(b"@w%04d\n%s\n+\n%s\n" % (i, acgt[read].tobytes(), q))
    with open(path, "wb") as f:
        f.write(b"".join(recs))


def _outputs(d, prefix):
    return {n[len(prefix):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix)}


def _same(want, got):
    assert want and set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(len(v) > 1000 for v in got.values())


@pytest.mark.parametrize("k,extra", [
    (127, ["--streaming", "--mesh", "2", "--streaming-chunk-mb", "0.01",
           "--mesh-batch", "64"]),
    (145, ["--mesh", "1", "--mesh-batch", "64"])],
    ids=["streaming-mesh2-k127", "in-memory-mesh1-k145"])
def test_filter_reads_byte_identical(tmp_path, k, extra):
    """FilterReads at four (k = 127, two shards) and five (k = 145) key
    lanes: every output file byte-identical to the JAX app's on the same
    flags; at k = 127 the one-process distributed engine too."""
    d = str(tmp_path)
    inp = os.path.join(d, "in.fastq")
    _write_reads(inp, k)
    assert jax_fr.run(["--threads", "1"] + extra
                      + ["--out", os.path.join(d, "jax")] + BASE
                      + [str(k), inp]) == 0
    assert torch_fr.run(["--device", "cpu"] + extra
                        + ["--out", os.path.join(d, "torch")] + BASE
                        + [str(k), inp]) == 0
    want = _outputs(d, "jax")
    _same(want, _outputs(d, "torch"))
    if "--streaming" in extra:
        assert torch_fr.run(["--device", "cpu", "--streaming",
                             "--streaming-chunk-mb", "0.01",
                             "--distributed", "127.0.0.1:1", "--nprocs",
                             "1", "--mesh-batch", "64", "--out",
                             os.path.join(d, "dist")] + BASE
                            + [str(k), inp]) == 0
        _same(want, _outputs(d, "dist"))


def test_meraculous_mesh2_k101_byte_identical(tmp_path):
    """MeraculousCounter --mesh 2 at k = 101 (four lanes): mercount and
    mergraph byte-identical to the JAX app at --mesh 2."""
    d = str(tmp_path)
    inp = os.path.join(d, "in.fastq")
    _write_reads(inp, 101, n_reads=300, min_len=110)
    assert jax_mer.run(["--jax-platform", "cpu", "--mesh", "2",
                        "--kmer-size", "101", "--out",
                        os.path.join(d, "jax"), inp]) == 0
    assert torch_mer.run(["--device", "cpu", "--mesh", "2", "--kmer-size",
                          "101", "--out", os.path.join(d, "torch"),
                          inp]) == 0
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert set(want) == {".mercount.m101", ".mergraph.m101.D2"}
    _same(want, got)


def _batch(k, B=48, seed=0, genome_bp=600):
    """B reads of k + 40 bases from a small genome (keys repeat), some
    random, one empty and one shorter than k; a random good mask."""
    L = k + 40
    rng = np.random.default_rng(seed + k)
    genome = rng.integers(0, 4, genome_bp).astype(np.uint8)
    starts = rng.integers(0, genome_bp - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[:B // 4] = rng.integers(0, 4, (B // 4, L))
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    lengths[[1, 2]] = (0, k - 3)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    good = rng.random((B, L - k + 1)) < 0.85
    return codes.astype(np.uint8), lengths, good


@pytest.mark.parametrize("D", [1, 2])
def test_distributed_count_fn_k127(D):
    """distributed_count_fn at k = 127 on D shards: counts, shard tables
    and overflow bit-equal to the JAX function on D CPU devices."""
    k = 127
    codes, lengths, good = _batch(k, seed=D)
    want = JM.distributed_count_fn(JM.make_mesh(D), k, min_count=1)(
        jnp.asarray(codes), jnp.asarray(good), jnp.asarray(lengths))
    got = TM.distributed_count_fn(TM.make_mesh(D, "cpu"), k, min_count=1)(
        _t(codes), _t(good), _t(lengths))
    for a, b in zip(want, got):
        assert a.shape == tuple(b.shape) and np.array_equal(_np(a), _np(b))
    assert _np(got[0]).max() >= 2


def test_spectrum_step_k127():
    """spectrum_step at k = 127 on reads of a small genome with
    log2-probabilities of 0 to -3 * 2^-9 a base (window sums exact in
    float32, so both good masks agree, and most windows good): outputs
    bit-equal."""
    k = 127
    codes, lengths, _ = _batch(k, B=64, seed=6)
    rng = np.random.default_rng(6)
    logp = (-rng.integers(0, 4, codes.shape) / 512).astype(np.float32)
    want = JS.spectrum_step(jnp.asarray(codes), jnp.asarray(logp),
                            jnp.asarray(lengths), k)
    got = TS.spectrum_step(_t(codes), _t(logp), _t(lengths), k)
    for a, b in zip(want, got):
        assert np.array_equal(_np(a), _np(b))
    assert _np(got[0]).max() >= 2


def test_streaming_spectrum_k127(tmp_path):
    """pipeline.StreamingSpectrum through build_streaming at k = 127, with
    drains: the table, counts and weights bit-equal to the JAX one."""
    path = str(tmp_path / "in.fastq")
    _write_reads(path, 12, n_reads=600, read_len=180, genome_len=4000,
                 min_len=147)
    want = JP.build_streaming(JStream([path], batch_reads=128), 127, 16384,
                              min_depth=2)
    got = TP.build_streaming(TStream([path], batch_reads=128), 127, 16384,
                             min_depth=2, device="cpu")
    assert got[0].shape[1] == 8 and len(got[0]) > 1000
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b)
