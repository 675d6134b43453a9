"""The port's MeraculousCounter (`--device cpu`) against the JAX app, and
its `--mesh 1` device functions against the JAX ones they replace.

Inputs are built here: a small `generate_metagenome` read set and
hand-made reads (N bases, low qualities, reads shorter than k, even-k
palindromes, a FASTA without qualities), and seeded numpy arrays for the
functions. Tolerance: none anywhere. Extension codes, keys, counts and the
12 extension counters are exact, and every `mercount`/`mergraph` file is
byte-identical to the JAX app's matching engine (its in-memory engine
where its streaming engine fails, k > 32). JAX runs on the CPU, in this
process.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmernator_tpu.apps import meraculous_counter as jax_app
from kmernator_tpu.apps.generate_metagenome import run as generate
from kmernator_tpu.parallel.mesh import (
    _count_received_ext as jax_count_received_ext,
    _window_extensions_device as jax_window_extensions)
from kmernator_tpu.parallel.spectrum import pack_keys as jax_pack_keys
from kmernator_tpu_torch.apps import meraculous_counter as torch_app
from kmernator_tpu_torch.ops import kmer as tk
from kmernator_tpu_torch.ops.extensions import window_extensions
from kmernator_tpu_torch.parallel import run_length as rl
from kmernator_tpu_torch.parallel.device_spectrum import padded_to_ragged
from kmernator_tpu_torch.parallel.mesh import (count_received_ext,
                                               window_extensions_device)

import torch_threads  # noqa: F401

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


# --------------------------------------------------------------------------
# the device functions
# --------------------------------------------------------------------------

def _extension_inputs(rng, B, L, k):
    """Padded codes [B, L] u8 (0..3) with lengths from 1 to L, a quarter of
    them shorter than k; ext_ok [B, L] from phred >= 20 over random
    qualities 2-40, all True on every fifth read (a read without
    qualities); is_fwd [B, NW] random."""
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    lengths[::4] = rng.integers(1, k, len(lengths[::4]))
    lengths[1] = L
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    ext_ok = rng.integers(2, 41, (B, L)) >= 20
    ext_ok[::5] = True
    ext_ok[np.arange(L)[None, :] >= lengths[:, None]] = False
    is_fwd = rng.random((B, L - k + 1)) < 0.5
    return codes, lengths, ext_ok, is_fwd


@pytest.mark.parametrize("k,L", [(21, 60), (45, 60), (30, 30)],
                         ids=["k21", "k45", "k_eq_L"])
def test_window_extensions_device_matches_jax_and_numpy(k, L):
    """Every window of the padded batch equals the JAX function, and the
    valid windows equal the numpy host function over the ragged reads."""
    rng = np.random.default_rng(k * 100 + L)
    codes, lengths, ext_ok, is_fwd = _extension_inputs(rng, 64, L, k)
    want = jax_window_extensions(jnp.asarray(codes), jnp.asarray(lengths),
                                 jnp.asarray(is_fwd), jnp.asarray(ext_ok), k)
    got = window_extensions_device(
        torch.from_numpy(codes), torch.from_numpy(lengths),
        torch.from_numpy(is_fwd), torch.from_numpy(ext_ok), k)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the host function over the same reads, ragged
    nw = np.maximum(lengths - k + 1, 0)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    flat_codes = padded_to_ragged(codes, lengths).astype(np.int64)
    flat_ok = padded_to_ragged(ext_ok, lengths)
    el, er = window_extensions(flat_codes, flat_ok, offsets, k,
                               padded_to_ragged(is_fwd, nw))
    assert len(el) == int(nw.sum()) > 0
    assert np.array_equal(padded_to_ragged(got[0].numpy(), nw), el)
    assert np.array_equal(padded_to_ragged(got[1].numpy(), nw), er)
    assert set(np.unique(el)) <= {-1, 0, 1, 2, 3, 5}
    # a window of the whole read has X on both sides
    assert (el == -1).any() if L > k else (el == 5).all()


def _received(rng, n, k, sentinel_share):
    """n received rows as the JAX scatter hands them over: keys [n, W] u32
    from a pool of keys that share leading words (runs that differ in the
    last word only), sentinel rows (good 0, codes -1) at the given share,
    good int32 0/1, extension codes -1..5."""
    W = tk.nwords(k)
    pool = rng.integers(0, 1 << 32, (max(n // 6, 2), W), dtype=np.uint64)
    pool = pool.astype(np.uint32)
    pool[1::2, :W - 1] = pool[0::2, :W - 1][:len(pool[1::2])]
    pool[:, W - 1] &= np.uint32(tk.last_word_mask(k))
    keys = pool[rng.integers(0, len(pool), n)]
    good = (rng.random(n) < 0.9).astype(np.int32)
    el = rng.integers(-1, 6, n).astype(np.int32)
    er = rng.integers(-1, 6, n).astype(np.int32)
    sent = rng.random(n) < sentinel_share
    keys[sent] = 0xFFFFFFFF
    good[sent], el[sent], er[sent] = 0, -1, -1
    return keys, good, el, er


def _jax_table(keys, good, el, er, min_count):
    """The JAX `_count_received_ext`, then the JAX app's conversion to the
    host table (apps/meraculous_counter.py:330-338)."""
    sk, sc, se = (np.asarray(x) for x in jax_count_received_ext(
        jnp.asarray(keys), jnp.asarray(good), jnp.asarray(el),
        jnp.asarray(er), min_count))
    real = (sc > 0) & ~np.all(sk == 0xFFFFFFFF, axis=1)
    packed = jax_pack_keys(sk[real])
    order = np.argsort(packed, kind="stable")
    return (packed[order], sc[real][order].astype(np.int64),
            se[real][order].astype(np.int64))


@pytest.mark.parametrize("case", ["mixed", "sentinel_heavy"])
@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("k", [21, 45])
def test_count_received_ext_matches_jax(k, min_count, case):
    """The port's count_received_ext (plain run sums on the CPU: L = 1 at
    k = 21, L = 2 at k = 45), carried to the host table by the app's
    spectrum_from_device, equals the JAX function carried by the JAX app's
    conversion: keys, counts and all 12 counters."""
    rng = np.random.default_rng(k + min_count)
    n = 5000
    keys, good, el, er = _received(
        rng, n, k, 0.8 if case == "sentinel_heavy" else 0.05)
    want = _jax_table(keys, good, el, er, min_count)
    cols = [torch.from_numpy(keys[:, w].astype(np.int64))
            for w in range(keys.shape[1])]
    lanes = tk.encode_lanes(cols)
    assert len(lanes) == (1 if k <= 32 else 2)
    got = count_received_ext(lanes, torch.from_numpy(good.astype(bool)),
                             torch.from_numpy(el), torch.from_numpy(er),
                             min_count)
    sp = torch_app.spectrum_from_device(k, *got)
    assert len(sp.keys) == len(want[0]) > 100
    assert sp.keys.dtype == want[0].dtype
    assert np.array_equal(sp.keys, want[0])
    assert np.array_equal(sp.counts, want[1])
    assert np.array_equal(sp.extensions, want[2])
    assert (sp.extensions[:, [4, 10]] > 0).any()   # code 4 taken as given


def test_count_received_ext_empty():
    """No rows, and only sentinel rows: an empty table of width 12."""
    for n in (0, 7):
        lanes = [torch.full((n,), tk.SENTINEL_LANE, dtype=torch.int64)] * 2
        z = torch.zeros(n, dtype=torch.int32)
        out_lanes, counts, ext = count_received_ext(
            lanes, torch.ones(n, dtype=torch.bool), z, z, 1)
        assert [x.numel() for x in out_lanes] == [0, 0]
        assert counts.numel() == 0 and tuple(ext.shape) == (0, 12)
        sp = torch_app.spectrum_from_device(45, out_lanes, counts, ext)
        assert len(sp.keys) == 0 and sp.extensions.shape == (0, 12)


# --------------------------------------------------------------------------
# the app, on its three engines
# --------------------------------------------------------------------------

def _revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))


def _hand_reads(rng, n_reads=300, genome_len=3000):
    """Reads of a random genome (1% substitutions) on both strands, with
    two even-k palindromes (k = 20 and 32) planted in the genome so that
    reads cross them many times, N bases in every seventh read, low
    qualities (phred 2-19) on a fifth of the bases, and reads of 5 to 14
    bases (shorter than every k tested). Returns [(seq, phred)]."""
    genome = ACGT[rng.integers(0, 4, genome_len)].tobytes()
    for pos, half in ((400, 10), (1500, 16)):
        h = ACGT[rng.integers(0, 4, half)].tobytes()
        pal = h + _revcomp(h)
        genome = genome[:pos] + pal + genome[pos + len(pal):]
    out = []
    for i in range(n_reads):
        if i % 25 == 0:
            n = int(rng.integers(5, 15))
        else:
            n = int(rng.integers(60, 120))
        s = int(rng.integers(0, genome_len - n))
        if i % 3 == 0:      # reads at the palindromes
            s = [380, 1480][i % 2]
        seq = bytearray(genome[s:s + n])
        err = np.nonzero(rng.random(n) < 0.01)[0]
        for e in err:
            seq[e] = ACGT[(b"ACGT".index(seq[e]) + 1) % 4]
        if i % 7 == 0:
            seq[int(rng.integers(0, n))] = ord("N")
        seq = bytes(seq)
        if i % 2:
            seq = _revcomp(seq)
        phred = rng.integers(20, 41, n)
        low = rng.random(n) < 0.2
        phred[low] = rng.integers(2, 20, int(low.sum()))
        out.append((seq, phred))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mer")
    meta = str(d / "meta.fastq")
    assert generate(["--genomes", "5", "--total-genome-mb", "0.02",
                     "--coverage", "10", "--read-length", "150",
                     "--seed", "7", "--out", meta]) in (0, None)
    reads = _hand_reads(np.random.default_rng(11))
    fq = str(d / "hand.fastq")
    with open(fq, "wb") as f:
        for i, (seq, phred) in enumerate(reads):
            f.write(b"@h%03d\n%s\n+\n%s\n"
                    % (i, seq, bytes((phred + 33).astype(np.uint8))))
    fa = str(d / "hand.fa")
    with open(fa, "wb") as f:
        for i, (seq, _) in enumerate(reads):
            f.write(b">h%03d\n%s\n" % (i, seq))
    assert os.path.getsize(meta) < (1 << 20)
    return {"meta": meta, "fastq": fq, "fasta": fa}


ENGINES = {"host": [], "streaming": ["--streaming", "--streaming-chunk-mb",
                                     "0.05"],
           "mesh1": ["--mesh", "1"]}


def _outputs(d, prefix):
    return {n[len(prefix):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(prefix)}


def _palindromes(path, k):
    """Number of distinct palindromic k-mers in a mercount file."""
    found = set()
    with open(path, "rb") as f:
        for line in f:
            mer = line.split(b"\t")[0]
            if mer == _revcomp(mer):
                found.add(mer)
    return len(found)


@pytest.mark.parametrize("name,k,engine", [
    (name, k, engine)
    for name, k in (("meta", 21), ("meta", 32), ("meta", 45), ("fastq", 20),
                    ("fastq", 21), ("fastq", 32), ("fastq", 45),
                    ("fasta", 21))
    for engine in sorted(ENGINES)
    if not (name == "fasta" and engine == "streaming")])
def test_engines_byte_identical(tmp_path, inputs, name, k, engine):
    """mercount and mergraph byte-identical to the JAX app's engine of the
    same name (its in-memory engine for streaming at k > 32: the JAX
    streaming engine fails there, see the next test). The streaming
    engines read FASTQ only, so the FASTA runs on the other two."""
    inp = inputs[name]
    d = str(tmp_path)
    jax_engine = "host" if engine == "streaming" and k > 32 else engine
    assert jax_app.run(["--jax-platform", "cpu"] + ENGINES[jax_engine]
                       + ["--kmer-size", str(k), "--out",
                          os.path.join(d, "jax"), inp]) == 0
    before = rl.launches
    assert torch_app.run(["--device", "cpu"] + ENGINES[engine]
                         + ["--kmer-size", str(k), "--out",
                            os.path.join(d, "torch"), inp]) == 0
    assert rl.launches == before      # the CPU takes the plain versions
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert set(want) == {".mercount.m%d" % k, ".mergraph.m%d.D2" % k}
    assert set(got) == set(want)
    for suffix in want:
        assert got[suffix] == want[suffix], suffix
        assert len(got[suffix]) > 1000
    if name != "meta" and k in (20, 32):
        assert _palindromes(os.path.join(d, "torch.mercount.m%d" % k), k)


def test_jax_streaming_fails_past_k32(tmp_path, inputs):
    """The JAX streaming engine stores every key of its spill record as a
    u64 (kmernator_tpu/apps/meraculous_counter.py:92), so at k > 32, where
    pack_keys makes byte strings, it raises; the port's streaming engine
    (test above) matches the JAX in-memory engine there."""
    with pytest.raises(ValueError):
        jax_app.run(["--jax-platform", "cpu"] + ENGINES["streaming"]
                    + ["--kmer-size", "45", "--out",
                       str(tmp_path / "jax"), inputs["meta"]])


def test_host_engine_past_the_key_lanes(tmp_path, inputs):
    """The host engines take any k, as the JAX app does; --mesh 1 refuses
    k > 96 (keys of at most 3 int64 lanes) before it reads the input."""
    d = str(tmp_path)
    inp = inputs["meta"]
    assert jax_app.run(["--jax-platform", "cpu", "--kmer-size", "97",
                        "--out", os.path.join(d, "jax"), inp]) == 0
    assert torch_app.run(["--device", "cpu", "--kmer-size", "97", "--out",
                          os.path.join(d, "torch"), inp]) == 0
    want, got = _outputs(d, "jax"), _outputs(d, "torch")
    assert want and got == want
    with pytest.raises(NotImplementedError, match="k=97"):
        torch_app.run(["--device", "cpu", "--mesh", "1", "--kmer-size",
                       "97", "--out", os.path.join(d, "m"), "missing.fq"])


def test_refusals(tmp_path):
    """k > 96 is refused at --mesh 2 as at --mesh 1, before the input is
    read (--mesh N itself runs N shards), and --device cuda without a
    visible GPU raises (nothing falls back to the CPU)."""
    out = str(tmp_path / "o")
    with pytest.raises(NotImplementedError, match="k=97"):
        torch_app.run(["--device", "cpu", "--mesh", "2", "--kmer-size",
                       "97", "--out", out, "missing.fq"])
    with pytest.raises(ValueError, match="--device"):
        torch_app.run(["--device", "tpu", "--kmer-size", "21", "--out", out,
                       "missing.fq"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_app.run(["--kmer-size", "21", "--out", out, "missing.fq"])
