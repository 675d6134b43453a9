"""kmernator_tpu_torch.parallel.merge_sort against the Pallas merge-path
sort (kmernator_tpu/parallel/pallas_sort.py) run in interpret mode on the
CPU, where the port's wrappers take their plain PyTorch versions. The same
numpy keys go through both. Tolerance: none, the outputs are integer keys
and must be bit-equal. The CUDA kernels are held to the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.parallel import device_spectrum as jax_ds
from kmernator_tpu.parallel import pallas_sort as J
from kmernator_tpu_torch.ops.kmer import decode_lane, encode_lane
from kmernator_tpu_torch.parallel import device_spectrum as T_ds
from kmernator_tpu_torch.parallel import merge_sort as T


def _keys(N, seed, wide=False):
    """(hi, lo) u32 keys: heavy duplicates and 5% sentinels, as
    tests/test_pallas_sort.py draws them, or random full-width keys."""
    rng = np.random.default_rng(seed)
    if wide:
        hi = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
        lo = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
        return hi, lo
    hi = rng.integers(0, 30, N).astype(np.uint32)
    lo = rng.integers(0, 3, N).astype(np.uint32)
    hi[N // 3] |= np.uint32(0x80000000)     # the sign bit of the lane
    m = rng.random(N) < 0.05
    hi[m] = 0xFFFFFFFF
    lo[m] = 0xFFFFFFFF
    return hi, lo


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def _lanes(hi, lo):
    return encode_lane([_t(hi), _t(lo)])


def _words(lanes):
    return [c.numpy() for c in decode_lane(lanes, 2)]


@pytest.mark.parametrize("N,block,chunk,seed,wide", [
    (1 << 14, 4096, 1024, 2, False),          # power-of-two blocks
    (4096 * 7, 4096, 1024, 2, False),         # odd run count at several levels
    (4096 * 7 - 1000, 4096, 1024, 2, False),  # N not a block multiple
    (70 * 2048, 2048, 1024, 2, False),        # the bench's 70 blocks, scaled
    (30000, 4096, 1024, 7, True),             # random full-width keys
])
def test_merge_sort_2key_matches_jax(N, block, chunk, seed, wide):
    hi, lo = _keys(N, seed, wide)
    jh, jl = J.merge_sort_2key(jnp.asarray(hi), jnp.asarray(lo), block=block,
                               chunk=chunk, interpret=True)
    th, tl = T.merge_sort_2key(_t(hi), _t(lo), block=block, chunk=chunk)
    assert th.dtype == tl.dtype == torch.int64
    assert np.array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    assert np.array_equal(tl.numpy(), np.asarray(jl).astype(np.int64))
    # and the lane form is torch.sort's result
    assert torch.equal(T.merge_sort_lanes(_lanes(hi, lo), block, chunk),
                       torch.sort(_lanes(hi, lo)).values)


def test_local_sort_blocks_matches_jax():
    hi, lo = _keys(4096 * 3, 5)
    jh, jl = J.local_sort_blocks(jnp.asarray(hi), jnp.asarray(lo), 4096,
                                 interpret=True)
    got = _words(T.local_sort_blocks(_lanes(hi, lo), 4096))
    assert np.array_equal(got[0], np.asarray(jh).astype(np.int64))
    assert np.array_equal(got[1], np.asarray(jl).astype(np.int64))


@pytest.mark.parametrize("tile", [1024, 2048])
@pytest.mark.parametrize("blocks_of_tile", [1, 2, 8])
def test_local_sort_schedule_matches_jax(tile, blocks_of_tile):
    """The card's schedule (tile sorts, then merge levels inside each
    block) in plain PyTorch, bit-equal to the JAX bitonic block sort and to
    the plain version, at block = tile, 2 tile and 8 tile."""
    block = tile * blocks_of_tile
    hi, lo = _keys(2 * block, tile + blocks_of_tile)
    jh, jl = J.local_sort_blocks(jnp.asarray(hi), jnp.asarray(lo), block,
                                 interpret=True)
    lanes = _lanes(hi, lo)
    got = T.local_sort_schedule_plain(lanes, block, tile)
    assert torch.equal(got, T.local_sort_blocks_plain(lanes, block))
    words = _words(got)
    assert np.array_equal(words[0], np.asarray(jh).astype(np.int64))
    assert np.array_equal(words[1], np.asarray(jl).astype(np.int64))


def test_merge_level_matches_jax():
    """Three sorted runs: the first two merge, the odd tail copies, and
    next_runs agree."""
    hi, lo = _keys(2048 * 3, 6)
    sh, sl = J.local_sort_blocks(jnp.asarray(hi), jnp.asarray(lo), 2048,
                                 interpret=True)
    runs = [(0, 2048), (2048, 2048), (4096, 2048)]
    jh, jl, jruns = J.merge_level(sh, sl, runs, 1024, interpret=True)
    s = _lanes(np.asarray(sh), np.asarray(sl))
    got, truns = T.merge_level(s, runs, 1024)
    assert truns == jruns == [(0, 4096), (4096, 2048)]
    words = _words(got)
    assert np.array_equal(words[0], np.asarray(jh).astype(np.int64))
    assert np.array_equal(words[1], np.asarray(jl).astype(np.int64))
    assert torch.equal(got[4096:], s[4096:])


@pytest.mark.parametrize("lengths", [[3072, 1024, 2048], [3072, 2048, 1024],
                                     [5120, 1024, 2048, 3072, 1024]])
def test_merge_level_non_uniform_runs_match_jax(lengths):
    """Runs of unequal lengths, chunk 1024: the pair table the card's
    wrapper builds (pairs, tile starts) agrees with the JAX `_pair_runs`,
    next_runs agree, and the merge, the kernel's tile schedule at 2,048-
    and 4,096-row tiles (short last tiles) and all levels to one run are
    bit-equal to JAX."""
    N = sum(lengths)
    hi, lo = _keys(N, len(lengths))
    runs, at = [], 0
    for n in lengths:
        runs.append((at, n))
        at += n
    lanes = _lanes(hi, lo)
    for off, n in runs:
        lanes[off:off + n] = lanes[off:off + n].sort().values
    sh, sl = (jnp.asarray(w.astype(np.uint32)) for w in _words(lanes))
    jh, jl, jruns = J.merge_level(sh, sl, runs, 1024, interpret=True)
    jpairs, _ = J._pair_runs(runs)
    for tile in (2048, 4096):
        table, ntiles = T.pair_table(runs, tile)
        assert [(a0, alen, a0 + alen, blen) for a0, alen, blen, _ in table] \
            == jpairs
        assert [t0 for *_, t0 in table] == list(np.cumsum(
            [0] + [-(-(alen + blen) // tile) for _, alen, _, blen in jpairs]
        )[:-1])
        assert ntiles == sum(-(-(alen + blen) // tile)
                             for _, alen, _, blen in jpairs)
        got = T.merge_level_schedule_plain(lanes, runs, tile)
        words = _words(got)
        assert np.array_equal(words[0], np.asarray(jh).astype(np.int64))
        assert np.array_equal(words[1], np.asarray(jl).astype(np.int64))
    got, truns = T.merge_level(lanes, runs, 1024)
    assert truns == jruns
    assert torch.equal(got, T.merge_level_schedule_plain(lanes, runs, 2048))
    got, truns = T.merge_levels(lanes, runs, 1024)
    assert truns == [(0, N)]
    assert torch.equal(got, torch.sort(lanes).values)


@pytest.mark.parametrize("call,match", [
    (lambda s: T.local_sort_blocks(s, 3000), "power of two"),
    (lambda s: T.local_sort_blocks(s[:5000], 4096), "multiple"),
    (lambda s: T.merge_level(s, [(0, 4096), (4096, 4096)], 512), ">= 1024"),
    (lambda s: T.merge_level(s, [(0, 4096), (6144, 2048)], 1024), "cover"),
    (lambda s: T.merge_level(s, [(0, 3072), (3072, 5120)], 2048), "cover"),
    (lambda s: T.merge_levels(s, [(0, 4096), (4096, 2048)], 1024), "cover"),
    (lambda s: T.local_sort_blocks(s.to(torch.int32), 4096), "int64"),
    (lambda s: T.local_sort_blocks(s[::2], 2048), "contiguous"),
    (lambda s: T.local_sort_blocks(s, 4096, events=[None]), "three"),
])
def test_contracts_refused(call, match):
    s = torch.arange(8192, dtype=torch.int64)
    with pytest.raises((ValueError, TypeError), match=match):
        call(s)


def test_use_merge_sort_mirrors_the_jax_gate(monkeypatch):
    """The port's gate is the JAX one with a CUDA tensor standing where the
    TPU backend stands: on the CPU both are off."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for env in (None, "0", "1", "on", "true", "yes"):
        if env is None:
            monkeypatch.delenv("KMTPU_MERGE_SORT", raising=False)
        else:
            monkeypatch.setenv("KMTPU_MERGE_SORT", env)
        for N in (1 << 19, (1 << 20) - 1, 1 << 20, 9175040):
            for W in (1, 2, 3):
                with monkeypatch.context() as m:
                    m.setattr(jax, "default_backend", lambda: "tpu")
                    on_tpu = jax_ds._use_merge_sort(N, W)
                assert T_ds._use_merge_sort(N, W, cuda) == on_tpu
                assert T_ds._use_merge_sort(N, W, cpu) is False
                assert jax_ds._use_merge_sort(N, W) is False
                assert on_tpu == (W == 2 and N >= 1 << 20
                                  and env in ("1", "on", "true"))
