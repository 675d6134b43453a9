"""The device spectrum library of kmernator_tpu_torch.parallel.device_spectrum
against the JAX package's functions, on the same seeded numpy inputs:
extract_canonical, count_and_score, compact_spectrum (on a state both
agree on), merge_tables, lookup_join, spectrum_step, pow2_aligned_batch
and the KMTPU_SORT1 experiment's sort bit-equal (tolerance: none); window_good's
weights within its stated bound, 4 * L * 2^-24 times the row's largest
finite |prefix|, and its good mask equal outside that band of the
threshold, on every window that the JAX prefix does not absorb. Two
tests keep the JAX faults this library does not copy visible (ROADMAP
queue 3, items o and p). auto_mesh_batch's KMTPU_MESH_BATCH reaches the
three FilterReads engines that take a device batch."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmernator_tpu.parallel import device_spectrum as J
from kmernator_tpu_torch.parallel import device_spectrum as T

import torch_threads  # noqa: F401

LOG2_MIN = float(np.log2(0.10))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    """A JAX or torch array as numpy, uint32 words widened to int64."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _reads(k, B=48, L=0, seed=0, genome_bp=500):
    """Reads of L bases (default k + 40) sampled from a small genome (keys
    repeat) and random reads, with a padding row, a read shorter than k
    and one of exactly k."""
    L = L or k + 40
    rng = np.random.default_rng(seed + k)
    genome = rng.integers(0, 4, genome_bp).astype(np.uint8)
    starts = rng.integers(0, genome_bp - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[B - 8:] = rng.integers(0, 4, (8, L))
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    lengths[:4] = (L, 0, k - 1, k)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return codes.astype(np.uint8), lengths


def _phred_logp(rng, shape, zero_frac=0.0):
    """log2 P(correct) of phred 2-40 qualities, float32, with zero_frac of
    the bases at -1e30 (probability 0)."""
    q = rng.integers(2, 41, shape)
    logp = np.log2(1.0 - 10.0 ** (-q / 10.0)).astype(np.float32)
    logp[rng.random(shape) < zero_frac] = np.float32(-1e30)
    return logp


@pytest.mark.parametrize("k", [21, 31, 33, 64, 95])
def test_extract_canonical_bit_equal(k):
    codes, lengths = _reads(k, L=120, seed=1)
    want = J.extract_canonical(jnp.asarray(codes), jnp.asarray(lengths), k)
    got = T.extract_canonical(_t(codes), _t(lengths), k)
    assert got[0].dtype == torch.int64 and got[0].shape[-1] == -(-k // 16)
    for a, b in zip(want, got):
        assert np.array_equal(_np(a), _np(b))


def _absorbed(logp, k):
    """[B, NW] bool: windows that start after the row's first
    zero-probability base, where the JAX float32 prefix is absorbed."""
    B, L = logp.shape
    zero = logp <= -1e29
    first = np.where(zero.any(1), zero.argmax(1), L)
    return np.arange(L - k + 1)[None, :] > first[:, None]


@pytest.mark.parametrize("k,zero_frac", [(21, 0.0), (31, 0.0), (31, 0.01),
                                         (64, 0.005)])
def test_window_good_within_bound(k, zero_frac):
    rng = np.random.default_rng(k)
    B, L = 512, 150
    logp = _phred_logp(rng, (B, L), zero_frac)
    lengths = rng.integers(k - 2, L + 1, B).astype(np.int32)
    jw, jg = (np.asarray(x) for x in J.window_good(
        jnp.asarray(logp), jnp.asarray(lengths), k, LOG2_MIN))
    tw, tg = T.window_good(_t(logp), _t(lengths), k, LOG2_MIN)
    tw, tg = tw.numpy(), tg.numpy()
    bound = T.window_good_bound(_t(logp)).numpy()[:, None]
    assert bound.max() <= 4 * L * 2.0 ** -24 * 6.0 * L
    seen = ~_absorbed(logp, k)
    covering = tw <= -1e29
    zero = logp <= -1e29
    cz = np.concatenate([np.zeros((B, 1), int), np.cumsum(zero, 1)], 1)
    assert np.array_equal(covering, (cz[:, k:] - cz[:, :-k]) > 0)
    assert (jw[seen & covering] <= -1e29).all()
    finite = seen & ~covering
    gap = np.abs(tw.astype(np.float64) - jw.astype(np.float64))
    assert (gap[finite] <= np.broadcast_to(bound, gap.shape)[finite]).all()
    band = np.abs(tw.astype(np.float64) - LOG2_MIN) <= bound
    assert np.array_equal(tg[seen & ~band], jg[seen & ~band])
    assert not tg[covering].any()
    assert tg.sum() > 0 and (~tg).sum() > 0
    if zero_frac:
        assert (~seen).sum() > 0 and covering.sum() > 0


def test_jax_window_good_passes_windows_after_a_zero_probability_base():
    """ROADMAP 3o: one read of 60 bases at logp -0.5 (every window weighs
    2^-10.5 < 0.1) with a zero-probability base at 5, k = 21. JAX passes
    windows 6-39 with weight exactly 0; the port passes none."""
    logp = np.full((1, 60), np.float32(-0.5), np.float32)
    logp[0, 5] = np.float32(-1e30)
    lengths = np.array([60], np.int32)
    jw, jg = (np.asarray(x)[0] for x in J.window_good(
        jnp.asarray(logp), jnp.asarray(lengths), 21, LOG2_MIN))
    assert np.array_equal(np.flatnonzero(jg), np.arange(6, 40))
    assert (jw[6:] == 0.0).all()
    tw, tg = (x.numpy()[0] for x in T.window_good(
        _t(logp), _t(lengths), 21, LOG2_MIN))
    assert not tg.any()
    assert (tw[:6] <= -1e29).all()
    assert np.allclose(tw[6:], -10.5)


def _state(k, seed, min_count=2):
    codes, lengths = _reads(k, seed=seed)
    canon, _, valid = J.extract_canonical(jnp.asarray(codes),
                                          jnp.asarray(lengths), k)
    rng = np.random.default_rng(seed)
    good = np.asarray(valid) & (rng.random(valid.shape) < 0.8)
    want = J.count_and_score(canon, jnp.asarray(good), k, min_count)
    got = T.count_and_score(_t(_np(canon)), _t(good), k, min_count)
    return want, got, _np(canon), good


@pytest.mark.parametrize("k,min_count", [(16, 2), (21, 1), (31, 2), (33, 2),
                                         (95, 3)])
def test_count_and_score_bit_equal(k, min_count):
    """Fed JAX's good mask: the counts and (skeys, boundary, seg,
    seg_counts) bit-equal; the JAX `sidx` is not returned (its order
    within a run is the sort's)."""
    (jc, jstate), (tc, tstate), _, _ = _state(k, 2, min_count)
    assert np.array_equal(_np(jc), _np(tc)) and _np(tc).max() >= 2
    for a, b in zip(jstate, tstate):
        assert np.array_equal(_np(a), _np(b))


def _unique_good(canon, good):
    keys = canon.reshape(-1, canon.shape[-1])[good.reshape(-1)]
    return np.unique(keys, axis=0, return_counts=True)


@pytest.mark.parametrize("k", [21, 31, 33])
def test_compact_spectrum_is_np_unique(k):
    _, (_, tstate), canon, good = _state(k, 3)
    keys, counts, n = T.compact_spectrum(*tstate)
    u, c = _unique_good(canon, good)
    n = int(n)
    assert n == len(u)
    assert np.array_equal(_np(keys)[:n], u) and np.array_equal(
        counts.numpy()[:n], c)
    assert (_np(keys)[n:] == 0xFFFFFFFF).all() and (counts.numpy()[n:] == 0
                                                     ).all()


def test_jax_compact_spectrum_miscounts_count_and_score_state():
    """ROADMAP 3p: 64 reads of 60 bp from a 200 bp genome, k = 21, min
    count 1, every window good. JAX's compact_spectrum of its own
    count_and_score state reads seg_counts at the run's index and
    miscounts; the port's is np.unique."""
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 200).astype(np.uint8)
    starts = rng.integers(0, 200 - 60, 64)
    codes = genome[starts[:, None] + np.arange(60)[None, :]].astype(np.uint8)
    lengths = np.full(64, 60, np.int32)
    canon, _, valid = J.extract_canonical(jnp.asarray(codes),
                                          jnp.asarray(lengths), 21)
    good = np.asarray(valid)
    u, c = _unique_good(_np(canon), good)
    _, jstate = J.count_and_score(canon, jnp.asarray(good), 21, 1)
    jk, jc, jn = (np.asarray(x) for x in J.compact_spectrum(*jstate))
    assert int(jn) != len(u) or not np.array_equal(jc[:len(u)], c)
    _, tstate = T.count_and_score(_t(_np(canon)), _t(good), 21, 1)
    tk, tc, tn = T.compact_spectrum(*tstate)
    assert int(tn) == len(u)
    assert np.array_equal(_np(tk)[:len(u)], u)
    assert np.array_equal(tc.numpy()[:len(u)], c)


@pytest.mark.parametrize("k", [16, 31, 33, 95])
def test_merge_tables_bit_equal(k):
    """Two batch tables from the JAX count_batch (their sentinel padding
    included), merged by both; then a merge with an empty second table,
    as the streaming drain calls it."""
    tables = []
    for seed in (4, 5):
        codes, lengths = _reads(k, seed=seed)
        cols, _, valid = J.extract_canonical_cols(jnp.asarray(codes),
                                                  jnp.asarray(lengths), k)
        keys, counts, _ = J.count_batch([c.reshape(-1) for c in cols],
                                        valid.reshape(-1), 1)
        tables += [keys, counts]
    want = J.merge_tables(*tables)
    got = T.merge_tables(*(_t(_np(x)) for x in tables))
    for a, b in zip(want, got):
        assert np.array_equal(_np(a), _np(b))
    assert int((_np(got[1]) >= 2).sum()) > 0
    again = J.merge_tables(want[0], want[1], want[0][:0], want[1][:0])
    got2 = T.merge_tables(got[0], got[1], got[0][:0], got[1][:0])
    for a, b in zip(again, got2):
        assert np.array_equal(_np(a), _np(b))


def test_lookup_join_bit_equal():
    """The JAX test's shape: M = 1,000 sorted unique keys, Q = 500 queries,
    half of them hits; a table padded with sentinel rows and queries at
    the sentinel as well."""
    rng = np.random.default_rng(0)
    M, Q, W = 1000, 500, 2
    tkeys = np.unique(rng.integers(0, 2**32 - 2, (M, W)).astype(np.uint32),
                      axis=0)
    M = len(tkeys)
    tcounts = rng.integers(1, 100, M).astype(np.int32)
    qsel = rng.integers(0, M, Q // 2)
    qkeys = np.concatenate([tkeys[qsel], rng.integers(
        0, 2**32 - 2, (Q - Q // 2, W)).astype(np.uint32)])
    pad = np.full((24, W), 0xFFFFFFFF, np.uint32)
    tkeys = np.concatenate([tkeys, pad])
    tcounts = np.concatenate([tcounts, np.zeros(24, np.int32)])
    qkeys = np.concatenate([qkeys, pad[:3]])
    want = np.asarray(J.lookup_join(jnp.asarray(tkeys), jnp.asarray(tcounts),
                                    jnp.asarray(qkeys)))
    got = T.lookup_join(_t(tkeys.astype(np.int64)), _t(tcounts),
                        _t(qkeys.astype(np.int64)))
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    assert (want[:Q // 2] > 0).all()


@pytest.mark.parametrize("batch", ["entry", "repeats"])
def test_spectrum_step_bit_equal(batch):
    """entry()'s batch (B = 256, L = 100, k = 31, seed 0) and a batch of
    reads from a small genome, where counts reach min_count."""
    import __graft_entry__ as G
    if batch == "entry":
        codes, logp, lengths = G._example_batch(256, 100)
    else:
        codes, lengths = _reads(31, B=256, L=100, seed=6)
        logp = _phred_logp(np.random.default_rng(6), codes.shape)
    want = J.spectrum_step(jnp.asarray(codes), jnp.asarray(logp),
                           jnp.asarray(lengths), 31)
    got = T.spectrum_step(_t(codes), _t(logp), _t(lengths), 31)
    for a, b in zip(want, got):
        assert np.array_equal(_np(a), _np(b))
    if batch == "repeats":
        assert _np(got[0]).max() >= 2


def test_pow2_aligned_batch():
    """The JAX test's three cases."""
    assert T.pow2_aligned_batch(100, 31, 8192) == J.pow2_aligned_batch(
        100, 31, 8192) == 7489
    b = T.pow2_aligned_batch(100, 31, 500)
    assert b == J.pow2_aligned_batch(100, 31, 500)
    assert b <= 500 and b * 70 <= 1 << 15
    assert T.pow2_aligned_batch(31, 31, 1) == 1


def test_auto_mesh_batch(monkeypatch):
    monkeypatch.delenv("KMTPU_MESH_BATCH", raising=False)
    assert T.auto_mesh_batch(100, 31) == 2048 == T.DEFAULT_BATCH_READS
    assert T.auto_mesh_batch(100, 31, 64) == 64
    monkeypatch.setenv("KMTPU_MESH_BATCH", "123")
    assert T.auto_mesh_batch(100, 31) == 123


@pytest.mark.parametrize("engine", [
    ["--mesh", "1"], ["--streaming", "--mesh", "1"],
    ["--streaming", "--distributed", "127.0.0.1:1", "--nprocs", "1"]])
def test_filter_reads_takes_kmtpu_mesh_batch(engine, tmp_path, monkeypatch,
                                             capfd):
    """The three FilterReads engines that batch reads on the device take
    their batch from auto_mesh_batch, so KMTPU_MESH_BATCH sets it, as it
    does in the JAX app."""
    from kmernator_tpu_torch.apps.filter_reads import run
    rng = np.random.default_rng(9)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 3000, dtype=np.uint8)
    inp = tmp_path / "in.fastq"
    with open(inp, "wb") as f:
        for i in range(150):
            s = int(rng.integers(0, 3000 - 72))
            f.write(b"@r%03d\n%s\n+\n%s\n"
                    % (i, acgt[genome[s:s + 72]].tobytes(), b"H" * 72))
    monkeypatch.setenv("KMTPU_MESH_BATCH", "37")
    assert run(["--device", "cpu", "--verbose", "1", "--min-read-length",
                "25"] + engine + ["--out", str(tmp_path / "o"), "31",
                                  str(inp)]) == 0
    err = capfd.readouterr().err
    assert "mesh batch auto-selected: 37 reads" in err, err[-2000:]
    assert os.path.getsize(tmp_path / "o-MinDepth2-in.fastq") > 0


def test_sort1_adversarial_collisions():
    """test_sort1.py's case: 2^14 keys whose hi word takes 40 values."""
    rng = np.random.default_rng(0)
    N = 1 << 14
    hi = rng.integers(0, 40, N).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    want = jax.lax.sort([jnp.asarray(hi), jnp.asarray(lo)], num_keys=2,
                        is_stable=False)
    jgot = J._sort2_via_1key(jnp.asarray(hi), jnp.asarray(lo))
    got = T._sort2_via_1key(_t(hi.astype(np.int64)), _t(lo.astype(np.int64)))
    for a, b, c in zip(want, jgot, got):
        assert np.array_equal(_np(a), _np(c)) and np.array_equal(_np(b),
                                                                 _np(c))


def test_sort2_via_1key_is_the_one_lane_sort():
    """_sort2_via_1key on test_sort1.py's parity case, with dense hi
    collisions added, equals the JAX function and the port's one-lane sort
    of the same keys (so count_batch has no KMTPU_SORT1 gate to route)."""
    from kmernator_tpu_torch.ops.kmer import decode_lane, encode_lane
    rng = np.random.default_rng(7)
    N = 1 << 15
    hi = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    hi[: N // 4] = rng.integers(0, 16, N // 4)
    lo = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    jgot = J._sort2_via_1key(jnp.asarray(hi), jnp.asarray(lo))
    cols = [_t(hi.astype(np.int64)), _t(lo.astype(np.int64))]
    got = T._sort2_via_1key(*cols)
    one_lane = decode_lane(torch.sort(encode_lane(cols)).values, 2)
    for a, b, c in zip(jgot, got, one_lane):
        assert np.array_equal(_np(a), _np(b)) and np.array_equal(_np(b),
                                                                 _np(c))
