"""kmernator_tpu_torch on the card: each test is marked `cuda` and skips
without a GPU. This file imports no jax, so it also runs where jax is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CUDA results are held to the same function on CPU tensors, which takes
the plain PyTorch versions. Tolerance: none for keys, counts, lookups and
sorted lanes; table weights to 1e-6 of the total weight the table has
taken in (both are differences of float64 prefix sums over a drain, which
the card's scan rounds in another order than the CPU's, rounded to
float32). The variant purge's marks and tables are bit-equal. The hash insert
places keys in an order that depends on timing, so it is held to its plain
version through the order-free invariants of `check_invariants`, exactly.
"""
import os

import numpy as np
import pytest
import torch

from kmernator_tpu_torch.ops import kmer as tk
from kmernator_tpu_torch.ops.kmer import SENTINEL_LANE, encode_lane
from kmernator_tpu_torch.parallel import device_spectrum as ds
from kmernator_tpu_torch.parallel import hash_insert as hi
from kmernator_tpu_torch.parallel import merge_sort as ms
from kmernator_tpu_torch.parallel import prepare_reads as pr
from kmernator_tpu_torch.parallel import run_length as rl
from kmernator_tpu_torch.parallel.mesh import make_mesh
from kmernator_tpu_torch.parallel import mesh_stream as mst
from kmernator_tpu_torch.parallel.mesh_stream import MeshStreamingSpectrum

import prepare_reads_cases as cases
import torch_threads  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rl_tile():
    return rl._kernel_lib().kmtpu_run_length_tile()


@pytest.mark.cuda
@pytest.mark.parametrize("size", [lambda t: 0, lambda t: 1,
                                  lambda t: t - 1, lambda t: t,
                                  lambda t: t + 1, lambda t: 3 * t + 5,
                                  lambda t: 1 << 20])
def test_kernel_matches_plain(cuda_device, size):
    """Lengths around the kernel's tile."""
    N = size(_rl_tile())
    rng = np.random.default_rng(N)
    keys = np.sort(rng.integers(0, max(N // 3, 1), N)).astype(np.int64)
    lanes = encode_lane([torch.from_numpy(keys >> 32),
                         torch.from_numpy(keys & 0xFFFFFFFF)])
    vals = torch.from_numpy(rng.integers(0, 3, N).astype(np.int32))
    want = rl.run_length_sums(lanes, vals)          # CPU: plain version
    before = rl.launches
    got = rl.run_length_sums(lanes.to(cuda_device), vals.to(cuda_device))
    torch.cuda.synchronize()
    assert rl.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _sorted_lane_keys(rng, n, L, n_keys):
    """n keys of L int64 lanes from n_keys distinct ones, sorted
    lexicographically; many keys differ in their last lane only, and the
    sentinel key (every lane INT64_MAX) and keys with one lane INT64_MAX
    are among them."""
    base = rng.integers(-(1 << 63), (1 << 63) - 1, (max(n_keys, 1), L),
                        dtype=np.int64)
    base[1::2, :L - 1] = base[0::2, :L - 1][:len(base[1::2])]
    base[0] = SENTINEL_LANE
    if len(base) > 2:
        base[1, 0] = SENTINEL_LANE
    keys = base[rng.integers(0, len(base), n)]
    keys = keys[np.lexsort(keys.T[::-1])] if n else keys
    return [torch.from_numpy(np.ascontiguousarray(keys[:, j]))
            for j in range(L)]


SIZES = [lambda t: 0, lambda t: 1, lambda t: t - 1, lambda t: t + 1,
         lambda t: 3 * t + 5, lambda t: 5000 * t + 3]


@pytest.mark.cuda
@pytest.mark.parametrize("L,size", [(L, size) for L in (2, 3, 4, 5)
                                    for size in SIZES]
                         + [(10, size) for size in SIZES[:5]])
def test_kernel_lanes_match_plain(cuda_device, L, size):
    """The L-lane instances (L = 2, 3 unrolled; L >= 4 the run-time lane
    loop, its lane pointers in a device array): lengths around the tile
    and a grid far beyond the resident CTAs; runs that split on the last
    lane only; the same rows through the scalar path (an 8-byte-offset
    view)."""
    N = size(_rl_tile())
    rng = np.random.default_rng(N + L)
    lanes = _sorted_lane_keys(rng, N + 1, L, max(N // 5, 1))
    vals = torch.from_numpy(rng.integers(0, 5, N + 1).astype(np.int32))
    for view in (slice(0, N), slice(1, N + 1)):
        cpu = [x[view].contiguous() for x in lanes]
        want = rl.run_length_sums(cpu, vals[view].contiguous())
        dev = [x.to(cuda_device)[view] for x in lanes]
        before = rl.launches
        got = rl.run_length_sums(dev, vals.to(cuda_device)[view])
        torch.cuda.synchronize()
        assert rl.launches == before + 1
        assert torch.equal(got.cpu(), want)
        assert torch.equal(want, rl.run_length_sums_plain(cpu, vals[view]))


@pytest.mark.cuda
def test_one_run_across_every_tile(cuda_device):
    n = 40 * _rl_tile() + 17
    lanes = torch.full((n,), 7, dtype=torch.int64, device=cuda_device)
    vals = torch.ones(n, dtype=torch.int32, device=cuda_device)
    got = rl.run_length_sums(lanes, vals).cpu()
    assert int(got[-1]) == n and int(got[:-1].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["runs", "giant_run", "misaligned"])
def test_run_length_grid_beyond_resident_ctas(cuda_device, case):
    """Thousands of tiles more than the card holds at once, so tiles wait
    on tiles of CTAs that started long before them; runs ending on a
    tile's first and last rows; a view 8 bytes off a 16-byte boundary
    (the scalar load path)."""
    tile = _rl_tile()
    n = 5000 * tile + 3
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(8)
    if case == "giant_run":
        lanes = torch.full((n,), SENTINEL_LANE, dtype=torch.int64,
                           device=cuda_device)
        lanes[:tile + 1] = -9
    else:
        lanes = torch.sort(torch.randint(0, n // 50, (n,), generator=gen,
                                         device=cuda_device)).values
        lanes[tile - 1] = lanes[tile - 2]       # a run ends on a last row
        lanes[tile:2 * tile] = lanes[tile]      # and one on a first row
        lanes[2 * tile] = lanes[2 * tile - 1] + 1
        lanes = torch.sort(lanes).values
    vals = torch.randint(0, 7, (n,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    if case == "misaligned":
        lanes, vals = lanes[1:], vals[1:]
    got = rl.run_length_sums(lanes, vals)
    assert torch.equal(got, rl.run_length_sums_plain(lanes, vals))


@pytest.mark.cuda
def test_no_host_sync_on_the_main_path(cuda_device):
    """merge_sort_lanes (3 merge levels across blocks) and run_length_sums
    never make the host wait for the card."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    lanes = torch.randint(-(1 << 62), 1 << 62, (5 * (1 << 17) + 3,),
                          generator=gen, device=cuda_device)
    ones = torch.ones_like(lanes, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = ms.merge_sort_lanes(lanes)
        out = rl.run_length_sums(s, ones)
        out4 = rl.run_length_sums([s >> 3, s >> 2, s >> 1, s], ones)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(s, torch.sort(lanes).values)
    assert torch.equal(out, rl.run_length_sums_plain(s, ones))
    assert torch.equal(out4, out)


@pytest.mark.cuda
def test_count_batch_matches_cpu(cuda_device):
    rng = np.random.default_rng(1)
    words = rng.integers(0, 50, (40000, 2)).astype(np.int64)
    words[:, 0] |= 0x80000000          # the sign bit of the lane
    good = rng.random(40000) < 0.9
    cols = [torch.from_numpy(words[:, w].copy()) for w in range(2)]
    want = ds.count_batch(cols, torch.from_numpy(good), min_count=2)
    got = ds.count_batch([c.to(cuda_device) for c in cols],
                         torch.from_numpy(good).to(cuda_device), min_count=2)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [3, 4, 6, 7, 10])
def test_count_batch_wide_matches_cpu(cuda_device, W):
    rng = np.random.default_rng(W)
    words = rng.integers(0, 4, (40000, W)).astype(np.int64)
    words[:, 0] |= 0x80000000
    words[:500] = 0xFFFFFFFF
    good = rng.random(40000) < 0.9
    cols = [torch.from_numpy(words[:, w].copy()) for w in range(W)]
    want = ds.count_batch(cols, torch.from_numpy(good), min_count=2)
    got = ds.count_batch([c.to(cuda_device) for c in cols],
                         torch.from_numpy(good).to(cuda_device), min_count=2)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 63, 95, 97, 145])
def test_mesh_stream_matches_cpu(cuda_device, k):
    rng = np.random.default_rng(2 + k)
    B, L = 64, k + 69
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    NW = L - k + 1
    spectra = [MeshStreamingSpectrum(make_mesh(1, dev), k, capacity=3000,
                                     drain_threshold=2 * B * NW)
               for dev in ("cpu", cuda_device)]
    batches = []
    w_in = 0.0
    for _ in range(6):
        codes = genome[rng.integers(0, 3000 - L, B)[:, None]
                       + np.arange(L)[None, :]]
        codes[B // 2:] = rng.integers(0, 4, (B - B // 2, L))
        lengths = rng.integers(k - 1, L + 1, B).astype(np.int32)
        good = rng.random((B, NW)) < 0.9
        weights = rng.random((B, NW)).astype(np.float32)
        w_in += float(weights[good].sum())
        batches.append((codes, good, lengths))
        for sp in spectra:
            sp.add_batch(codes, good, lengths, weights2d=weights)
        cpu, dev = (sp.to_numpy_tables() for sp in spectra)
        assert np.array_equal(cpu[0], dev[0])
        assert np.array_equal(cpu[1], dev[1])
        np.testing.assert_allclose(dev[2], cpu[2], rtol=0, atol=1e-6 * w_in)
    assert spectra[1].drains >= 2
    assert spectra[1].purged_singletons == spectra[0].purged_singletons > 0
    assert all(x.device.type == "cuda" for x in spectra[1].table_lanes)
    for codes, good, lengths in batches:
        want = np.ones_like(good)
        assert np.array_equal(
            spectra[0].lookup_batch(codes, want, lengths, min_count=2),
            spectra[1].lookup_batch(codes, want, lengths, min_count=2))


@pytest.mark.cuda
@pytest.mark.parametrize("D,k", [(2, 31), (4, 31), (2, 63), (4, 95),
                                 (4, 127), (2, 145)])
def test_mesh_stream_shards_match_cpu(cuda_device, D, k):
    """D shard tables on the card: the owner hash, the bucket scatter and
    the exchange route each batch as on the CPU; after every batch the
    shards' keys and counts are equal and their weights within 1e-6 of the
    total weight taken in; the same singletons purged under pressure, the
    same overflow retries (a capacity_factor of 0.5 forces some), one
    run-length launch a shard a drain, and the same lookups."""
    rng = np.random.default_rng(7 * D + k)
    B, L = 64, k + 69
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    NW = L - k + 1
    spectra = [MeshStreamingSpectrum(make_mesh(D, dev), k, capacity=1500,
                                     drain_threshold=B * NW // 2,
                                     capacity_factor=0.5)
               for dev in ("cpu", cuda_device)]
    batches = []
    w_in = 0.0
    before = rl.launches
    for _ in range(6):
        codes = genome[rng.integers(0, 3000 - L, B)[:, None]
                       + np.arange(L)[None, :]]
        codes[B // 2:] = rng.integers(0, 4, (B - B // 2, L))
        lengths = rng.integers(k - 1, L + 1, B).astype(np.int32)
        good = rng.random((B, NW)) < 0.9
        weights = rng.random((B, NW)).astype(np.float32)
        w_in += float(weights[good].sum())
        batches.append((codes, good, lengths))
        for sp in spectra:
            sp.add_batch(codes, good, lengths, weights2d=weights)
        cpu, dev = (sp.to_numpy_tables() for sp in spectra)
        assert np.array_equal(cpu[0], dev[0])
        assert np.array_equal(cpu[1], dev[1])
        np.testing.assert_allclose(dev[2], cpu[2], rtol=0, atol=1e-6 * w_in)
    torch.cuda.synchronize()
    assert spectra[1].drains >= 2
    assert rl.launches - before == D * spectra[1].drains
    assert spectra[1].purged_singletons == spectra[0].purged_singletons > 0
    assert spectra[1].overflow_retries == spectra[0].overflow_retries > 0
    assert spectra[1].table_counts.shape == (D, 1500)
    assert all(x.device.type == "cuda" for x in spectra[1].table_lanes)
    for codes, good, lengths in batches:
        want = np.ones_like(good)
        assert np.array_equal(
            spectra[0].lookup_batch(codes, want, lengths, min_count=2),
            spectra[1].lookup_batch(codes, want, lengths, min_count=2))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_shard_exchange_matches_cpu(cuda_device, D):
    """The owner hash, bucket slots, send planes and exchange on the card
    equal the CPU's at an overflowing C."""
    from kmernator_tpu_torch.parallel import mesh as tm
    rng = np.random.default_rng(D)
    N = 100_000
    words = [torch.from_numpy(rng.integers(0, 1 << 32, (D, N)))
             for _ in range(3)]
    real = torch.from_numpy(rng.random((D, N)) < 0.8)
    out = []
    for dev in ("cpu", cuda_device):
        w = [x.to(dev) for x in words]
        owner = tm.owner_hash_cols(w) % D
        C = N // (2 * D)       # half a uniform share: buckets overflow
        slot, overflow = tm.bucket_slots(owner, real.to(dev), D, C)
        recv = tm.exchange(tm.scatter_plane(w[0], slot, D, C, -1))
        out.append([owner, slot, overflow, recv])
    for a, b in zip(out[1], out[0]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert int(out[0][2].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("D,k", [(2, 21), (4, 51)])
def test_extension_spectrum_shards_match_cpu(cuda_device, D, k):
    """extension_spectrum_mesh at D shards on the card equals the CPU's:
    13 run-length launches a shard."""
    from kmernator_tpu_torch.parallel.mesh import extension_spectrum_mesh
    rng = np.random.default_rng(D + k)
    B, L = 400, 150
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    codes = genome[rng.integers(0, 20_000 - L, B)[:, None]
                   + np.arange(L)[None, :]]
    lengths = rng.integers(k - 5, L + 1, B).astype(np.int32)
    args = [torch.from_numpy(a) for a in (
        codes, rng.random((B, L - k + 1)) < 0.9, rng.random((B, L)) < 0.9,
        lengths)]
    want = extension_spectrum_mesh(make_mesh(D, "cpu"), k, *args,
                                   min_count=1)
    before = rl.launches
    got = extension_spectrum_mesh(make_mesh(D, cuda_device), k,
                                  *[a.to(cuda_device) for a in args],
                                  min_count=1)
    torch.cuda.synchronize()
    assert rl.launches - before == 13 * D and got[3] == want[3] == 0
    for a, b in zip(got[0] + list(got[1:3]), want[0] + list(want[1:3])):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("D,k", [(2, 31), (4, 45)])
def test_read_index_shards_match_cpu(cuda_device, D, k):
    """The assembler's read index at D shards on the card: every shard's
    lanes and ids, and match_shards, equal the CPU's."""
    from kmernator_tpu_torch.parallel import dist_match as dm
    rng = np.random.default_rng(D * k)
    B, L = 3000, 150
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    codes = genome[rng.integers(0, 20_000 - L, B)[:, None]
                   + np.arange(L)[None, :]]
    lengths = rng.integers(k - 5, L + 1, B).astype(np.int32)
    args = [torch.from_numpy(a) for a in (
        codes, rng.random((B, L - k + 1)) < 0.9, lengths)]
    cpu, _ = dm.build_index(make_mesh(D, "cpu"), k, *args)
    gpu, _ = dm.build_index(make_mesh(D, cuda_device), k,
                            *[a.to(cuda_device) for a in args])
    for (gl, gr), (cl, cr) in zip(gpu, cpu):
        for a, b in zip(gl + [gr], cl + [cr]):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    W = tk.nwords(k)
    queries = [torch.from_numpy(rng.integers(0, 1 << 32, 2000))
               for _ in range(W)]
    lanes = tk.decode_lanes(cpu[0][0], W)
    pick = torch.from_numpy(rng.integers(0, lanes[0].numel(), 2000))
    queries = [torch.cat([q, c[pick]]) for q, c in zip(queries, lanes)]
    want = dm.match_shards(cpu, queries, 16, 2)
    got = dm.match_shards(gpu, [q.to(cuda_device) for q in queries], 16, 2)
    assert (want >= 0).sum() > 1000
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 63])
def test_grown_table_matches_cpu(cuda_device, k):
    """Grow-on-pressure on the card (the `--streaming --distributed`
    engine's table): from 1,024 rows, the same growth steps as on the CPU,
    the same table after every batch and the same lookups; the grown lanes
    stay on the card."""
    rng = np.random.default_rng(40 + k)
    B, L = 256, k + 40
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    NW = L - k + 1
    spectra = [MeshStreamingSpectrum(make_mesh(1, dev), k, capacity=1024,
                                     max_capacity=1 << 20)
               for dev in ("cpu", cuda_device)]
    caps = []
    batches = []
    w_in = 0.0
    for _ in range(12):
        codes = genome[rng.integers(0, 5000 - L, B)[:, None]
                       + np.arange(L)[None, :]]
        codes[B // 2:] = rng.integers(0, 4, (B - B // 2, L))
        lengths = rng.integers(k - 1, L + 1, B).astype(np.int32)
        good = rng.random((B, NW)) < 0.8
        weights = rng.random((B, NW)).astype(np.float32)
        w_in += float(weights[good].sum())
        batches.append((codes, good, lengths))
        for sp in spectra:
            sp.add_batch(codes, good, lengths, weights2d=weights)
        assert spectra[0].cap == spectra[1].cap
        caps.append(spectra[1].cap)
        cpu, dev = (sp.to_numpy_tables() for sp in spectra)
        assert np.array_equal(cpu[0], dev[0])
        assert np.array_equal(cpu[1], dev[1])
        np.testing.assert_allclose(dev[2], cpu[2], rtol=0, atol=1e-6 * w_in)
    assert caps[0] == 65536 and caps[-1] == 262144
    assert spectra[1].drains >= 2
    assert spectra[1].purged_singletons == spectra[0].purged_singletons == 0
    assert all(x.device.type == "cuda" for x in spectra[1].table_lanes)
    assert spectra[1].table_counts.device.type == "cuda"
    for codes, good, lengths in batches[:4]:
        want = np.ones_like(good)
        assert np.array_equal(
            spectra[0].lookup_batch(codes, want, lengths, min_count=2),
            spectra[1].lookup_batch(codes, want, lengths, min_count=2))


def _purge_table(rng, k, n_sources=40):
    """A host table of sources (counts 600-5000), hamming-1 and -2 variants
    of them (some deep enough to be sources in turn) and noise: keys [M, W]
    u32, counts [M] i32."""
    W = tk.nwords(k)
    codes = rng.integers(0, 4, (n_sources + 300, k), dtype=np.uint8)
    words = np.stack([tk.pack16(np, codes)[:, 16 * w] for w in range(W)], -1)
    words[:, W - 1] &= np.uint32(tk.last_word_mask(k))
    table = {}
    for i, sw in enumerate(words):
        row = sw[None, :]
        rc = tk.revcomp_words(np, row, k)
        row = rc if tk.words_less(np, rc, row)[0] else row
        table[row.tobytes()] = (int(rng.integers(600, 5000))
                                if i < n_sources else int(rng.integers(2, 60)))
        if i >= n_sources:
            continue
        for v in range(8):
            mut = row.copy()
            for p in rng.choice(k, 1 + v % 2, replace=False):
                w, o = divmod(int(p), 16)
                shift = np.uint32(30 - 2 * o)
                mut[0, w] = ((mut[0, w] & ~(np.uint32(3) << shift))
                             | (np.uint32(rng.integers(0, 4)) << shift))
            rc = tk.revcomp_words(np, mut, k)
            mut = rc if tk.words_less(np, rc, mut)[0] else mut
            table.setdefault(mut.tobytes(), int(rng.integers(600, 900))
                             if v == 0 else int(rng.integers(2, 60)))
    keys = np.frombuffer(b"".join(table), np.uint32).reshape(-1, W)
    return keys, np.array(list(table.values()), np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k,ed", [(21, 2), (31, 1), (33, 2), (95, 1),
                                  (127, 1)])
def test_purge_matches_cpu(cuda_device, k, ed):
    """set_table, purge_min_depth and purge_variants_mesh on the card: the
    purged count and the table bit-equal to the same on the CPU, with
    weights that are not the counts and chunks of a few sources."""
    rng = np.random.default_rng(k + ed)
    keys, counts = _purge_table(rng, k)
    weights = (counts * rng.uniform(0.5, 1.0, len(counts))).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        sp = MeshStreamingSpectrum(make_mesh(1, dev), k, capacity=1 << 14)
        sp.set_table(keys, counts, weights)
        sp.purge_min_depth(3)
        n = sp.purge_variants_mesh(2.5, ed, 400.0, min_depth=2,
                                   chunk_rows=4 * k * 7)
        out.append((n, sp.to_numpy_tables(), dict(sp.purge_stats)))
    assert out[0][0] == out[1][0] > 0
    assert out[0][2] == out[1][2]
    for a, b in zip(out[0][1], out[1][1]):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_purge_thresholds_match_cpu(cuda_device):
    """The float32 threshold steps on the card: the square root (numpy's,
    correctly rounded), the once-rounded v - sqrt(v) * s and the reciprocal
    multiply give the CPU's bits (torch.sqrt of these float32 values on
    the card and on the CPU need not agree)."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy((rng.random(1 << 22) * 1e6).astype(np.float32))
    assert torch.equal(mst._sqrt_f32(v.to(cuda_device)).cpu(),
                       torch.from_numpy(np.sqrt(v.numpy())))
    for s in (2.0, 2.5, 3.1):
        outs = []
        for dev in ("cpu", cuda_device):
            x = v.to(dev)
            thr = mst._fma_sub_f32(x, mst._sqrt_f32(x), mst._f32(s, dev))
            outs.append([thr.cpu()] + [(thr * mst._recip_f32(c, dev)).cpu()
                                       for c in (20, 21)])
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def _sort_case(name, n, rng):
    """int64 lanes for the sort kernels' edge cases."""
    if name == "all_equal":
        return np.full(n, 42, np.int64)
    if name == "sign_bit":
        return -rng.integers(1, 1 << 62, n)
    keys = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    if name == "dups_sentinels":
        keys = rng.integers(-40, 40, n).astype(np.int64)
        keys[rng.random(n) < 0.05] = SENTINEL_LANE
    return keys


@pytest.mark.cuda
@pytest.mark.parametrize("N,block,chunk", [
    (1000, 4096, 1024),            # below one block
    (1 << 14, 4096, 1024),
    (4096 * 7 - 1000, 4096, 1024),  # sentinel padding, odd run counts
    (70 * 2048, 2048, 1024),
    (3 * (1 << 17) + 5, 1 << 17, 1 << 15),   # blocks above the CTA tile
    (3 * 8192, 8192, 1024),        # block == the default tile
    (2 * 16384 + 700, 16384, 1024),  # block == 2 tiles, ragged N
    (3 * 32768 - 500, 32768, 1024),  # 2 levels inside each block
    (1 << 17, 1 << 17, 1 << 15),   # one block of 2^17
    (3 << 17, 1 << 17, 1 << 15),   # three blocks of 2^17
])
@pytest.mark.parametrize("case", ["random", "dups_sentinels", "all_equal",
                                  "sign_bit"])
def test_merge_sort_kernels_match_plain(cuda_device, N, block, chunk, case):
    rng = np.random.default_rng(N)
    lanes = torch.from_numpy(_sort_case(case, N, rng))
    want = ms.merge_sort_lanes(lanes, block, chunk)      # CPU: plain
    assert torch.equal(want, torch.sort(lanes).values)
    before = dict(ms.launches)
    got = ms.merge_sort_lanes(lanes.to(cuda_device), block, chunk)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert ms.launches["local_sort_blocks"] == before["local_sort_blocks"] + 1
    levels = max(-(-N // block) - 1, 0).bit_length()
    assert ms.launches["merge_level"] == before["merge_level"] + levels


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 4, 16, 2048, 8192, 16384, 32768,
                                   1 << 17])
@pytest.mark.parametrize("case", ["dups_sentinels", "sign_bit"])
@pytest.mark.parametrize("timed", [False, True])
def test_local_sort_tiles_match_plain(cuda_device, block, case, timed):
    """Blocks below, at and above the 16384-key tile: one launch each, the
    in-block levels counted in it and not as merge levels, with and without
    the events that time the tile pass and the levels apart."""
    N = max(3 * block, 64)
    lanes = torch.from_numpy(_sort_case(case, N, np.random.default_rng(N)))
    want = ms.local_sort_blocks_plain(lanes, block)
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if timed else None)
    before = dict(ms.launches)
    got = ms.local_sort_blocks(lanes.to(cuda_device), block, events=events)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert ms.launches == dict(before, local_sort_blocks=before[
        "local_sort_blocks"] + 1)


@pytest.mark.cuda
def test_merge_sort_empty_on_the_card(cuda_device):
    before = dict(ms.launches)
    empty = torch.empty(0, dtype=torch.int64, device=cuda_device)
    got = ms.merge_sort_lanes(empty, 4096, 1024)
    assert got.device.type == "cuda" and got.numel() == 0
    assert ms.merge_level(empty, [], 1024)[1] == []
    assert ms.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("lengths", [
    [3072] * 5,
    [3072, 1024, 2048],                 # non-uniform runs
    [3072, 2048, 1024],                 # short last tiles in both pairs
    [5120, 17408, 1024, 9216, 31744, 4096, 13312],
])
@pytest.mark.parametrize("case", ["dups_sentinels", "all_equal"])
def test_merge_level_kernel_matches_plain(cuda_device, timed, lengths, case):
    """Runs whose pairs are not multiples of the CTA tile: one level, then
    every level to one run in one call, with and without the events that
    time the levels apart."""
    rng = np.random.default_rng(len(lengths))
    lanes = torch.from_numpy(_sort_case(case, sum(lengths), rng))
    runs, at = [], 0
    for n in lengths:
        runs.append((at, n))
        lanes[at:at + n] = lanes[at:at + n].sort().values
        at += n
    want, want_runs = ms.merge_level(lanes, runs, 1024)
    before = ms.launches["merge_level"]
    got, got_runs = ms.merge_level(lanes.to(cuda_device), runs, 1024)
    torch.cuda.synchronize()
    assert ms.launches["merge_level"] == before + 1
    assert got_runs == want_runs
    assert torch.equal(got.cpu(), want)
    nlevels = (len(runs) - 1).bit_length()
    if timed:
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(nlevels)]
        got, got_runs = ms._merge_levels_cuda(lanes.to(cuda_device), runs,
                                              nlevels, events)
    else:
        got, got_runs = ms.merge_levels(lanes.to(cuda_device), runs, 1024)
    torch.cuda.synchronize()
    assert got_runs == [(0, lanes.numel())]
    assert torch.equal(got.cpu(), torch.sort(lanes).values)
    assert ms.launches["merge_level"] == before + 1 + nlevels


@pytest.mark.cuda
def test_count_batch_merge_sort_route(cuda_device, monkeypatch):
    rng = np.random.default_rng(4)
    n = (1 << 20) + 12345
    words = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.int64)
    words[n // 2:] = words[:n - n // 2]               # every key twice
    good = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    cols = [torch.from_numpy(words[:, w].copy()).to(cuda_device)
            for w in range(2)]
    monkeypatch.delenv("KMTPU_MERGE_SORT", raising=False)
    before = dict(ms.launches)
    want = ds.count_batch(cols, good, min_count=1)
    assert ms.launches == before
    monkeypatch.setenv("KMTPU_MERGE_SORT", "1")
    got = ds.count_batch(cols, good, min_count=1)
    assert ms.launches["merge_level"] > before["merge_level"]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(hi.edge_cases()))
def test_hash_insert_kernel_matches_plain(cuda_device, name):
    keys, cap = hi.edge_cases()[name]
    want = hi.hash_insert(torch.from_numpy(keys), cap)     # CPU: plain
    before = hi.launches
    got = hi.hash_insert(torch.from_numpy(keys).to(cuda_device), cap)
    torch.cuda.synchronize()
    assert hi.launches == before + 1
    assert all(t.device.type == "cuda" and t.dtype == torch.int64
               for t in got)
    assert hi.check_invariants(keys, cap, *want) == 0
    assert hi.check_invariants(keys, cap, *got) == 0
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[0].cpu() != hi.EMPTY, want[0] != hi.EMPTY)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(hi.large_cases()))
def test_hash_insert_large_cases(cuda_device, name):
    """One key on every thread, and a table at load 0.9, through the
    invariants."""
    keys, cap = hi.large_cases()[name]
    before = hi.launches
    got = hi.hash_insert(torch.from_numpy(keys).to(cuda_device), cap)
    assert hi.launches == before + 1
    assert hi.check_invariants(keys, cap, *got) == 0


@pytest.mark.cuda
def test_hash_insert_raises_on_the_card(cuda_device):
    before = hi.launches
    with pytest.raises(ValueError, match=r"10 keys .* cap = 8"):
        hi.hash_insert(torch.arange(10, device=cuda_device), 8)
    with pytest.raises(ValueError, match=r"\[0, 2\^32\)"):
        hi.hash_insert(torch.tensor([1, -1, 1 << 32], device=cuda_device), 8)
    assert hi.launches == before + 2
    # the sentinel after a full table: counted, written nowhere
    tk, tc, n = hi.hash_insert(torch.tensor([3, hi.EMPTY],
                                            device=cuda_device), 1)
    assert tk.tolist() == [3] and tc.tolist() == [1] and n.tolist() == [2]


@pytest.mark.cuda
def test_hash_bench_on_the_card(cuda_device):
    before = hi.launches
    r = hi.bench(device="cuda", steps=4)
    assert hi.launches == before + 1 + 2 * 4
    assert r["unique0"] > 0 and r["mkeys_per_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_count_received_ext_matches_cpu(cuda_device, L):
    """MeraculousCounter's run sums on the card: 13 launches of the
    run-length kernel at L lanes, equal to the CPU's plain run sums."""
    from kmernator_tpu_torch.parallel.mesh import count_received_ext
    rng = np.random.default_rng(40 + L)
    n = 200_003
    lanes = _sorted_lane_keys(rng, n, L, 30_000)
    perm = torch.from_numpy(rng.permutation(n))
    lanes = [x[perm].contiguous() for x in lanes]      # arrival order
    good = torch.from_numpy(rng.random(n) < 0.9)
    el = torch.from_numpy(rng.integers(-1, 6, n).astype(np.int32))
    er = torch.from_numpy(rng.integers(-1, 6, n).astype(np.int32))
    want = count_received_ext(lanes, good, el, er, 2)
    before = rl.launches_by_lanes[L]
    got = count_received_ext([x.to(cuda_device) for x in lanes],
                             good.to(cuda_device), el.to(cuda_device),
                             er.to(cuda_device), 2)
    torch.cuda.synchronize()
    assert rl.launches_by_lanes[L] == before + 13
    assert want[1].numel() > 1000
    for a, b in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 51])
def test_window_extensions_device_matches_cpu(cuda_device, k):
    from kmernator_tpu_torch.parallel.mesh import window_extensions_device
    rng = np.random.default_rng(k)
    B, L = 500, 150
    codes = torch.from_numpy(rng.integers(0, 4, (B, L)).astype(np.uint8))
    lengths = torch.from_numpy(rng.integers(1, L + 1, B).astype(np.int32))
    is_fwd = torch.from_numpy(rng.random((B, L - k + 1)) < 0.5)
    ext_ok = torch.from_numpy(rng.random((B, L)) < 0.7)
    want = window_extensions_device(codes, lengths, is_fwd, ext_ok, k)
    got = window_extensions_device(codes.to(cuda_device),
                                   lengths.to(cuda_device),
                                   is_fwd.to(cuda_device),
                                   ext_ok.to(cuda_device), k)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 45])
def test_read_index_and_match_match_cpu(cuda_device, k):
    """The assembler's --mesh 1 read index and matcher on the card: the
    sorted key lanes, the read ids and the [Q, max_ids] answers (hits,
    runs cut at max_ids, runs under min_depth, misses) bit-equal to the
    same functions on the CPU."""
    from kmernator_tpu_torch.parallel import dist_match as dm
    rng = np.random.default_rng(k)
    B, L = 3000, 150
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    lengths = rng.integers(k - 5, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    good2d = rng.random((B, L - k + 1)) < 0.9
    cpu = dm.build_index(make_mesh(1, "cpu"), k, torch.from_numpy(codes),
                         torch.from_numpy(good2d),
                         torch.from_numpy(lengths))[0][0]
    gpu = dm.build_index(make_mesh(1, "cuda"), k,
                         torch.from_numpy(codes).to(cuda_device),
                         torch.from_numpy(good2d).to(cuda_device),
                         torch.from_numpy(lengths).to(cuda_device))[0][0]
    assert cpu[1].numel() > 100_000
    for a, b in zip(gpu[0] + [gpu[1]], cpu[0] + [cpu[1]]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    pick = torch.from_numpy(rng.integers(0, cpu[1].numel(), 5000))
    queries = [torch.cat([lane[pick], torch.from_numpy(rng.integers(
        -(1 << 62), 1 << 62, 100))]) for lane in cpu[0]]
    for max_ids, min_depth in ((64, 0), (4, 3)):
        want = dm.match(cpu[0], cpu[1], queries, max_ids, min_depth)
        got = dm.match(gpu[0], gpu[1], [q.to(cuda_device) for q in queries],
                       max_ids, min_depth)
        assert (want >= 0).sum() > 10_000 and (want[-100:] == -1).all()
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def _wide_reads(path, seed, n_reads=600, read_len=150, genome_bp=3000):
    """Error-free reads of read_len bases from a random genome, phred 40;
    returns the genome's bases."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, genome_bp)].tobytes()
    with open(path, "wb") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome_bp - read_len))
            f.write(b"@r%04d\n%s\n+\n%s\n"
                    % (i, genome[s:s + read_len], b"I" * read_len))
    return genome


@pytest.mark.cuda
def test_assembler_device_flag(cuda_device, tmp_path):
    """--device cuda with no visible GPU raises (a program with
    CUDA_VISIBLE_DEVICES=""), and k = 97 (four-lane keys) runs at --mesh 2
    on the card, its contigs byte-identical to --device cpu's, and some
    seed grows."""
    import os
    import subprocess
    import sys
    from kmernator_tpu_torch.apps import nucleating_assembler as asm
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seeds = str(tmp_path / "s.fa")
    with open(seeds, "w") as f:
        f.write(">s\nACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT\n")
    args = ["--contig-file", seeds, "--out", str(tmp_path / "o.fa")]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-m", "kmernator_tpu_torch.apps.nucleating_assembler",
         "--device", "cuda", "--mesh", "1"] + args + ["31", "missing.fq"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    fq = str(tmp_path / "r.fastq")
    genome = _wide_reads(fq, 97)
    with open(seeds, "wb") as f:
        for i, s in enumerate((400, 1300, 2200)):
            f.write(b">seed%d\n%s\n" % (i, genome[s:s + 120]))
    outs = {}
    for dev in ("cpu", "cuda"):
        outs[dev] = str(tmp_path / ("%s.fa" % dev))
        assert asm.run(["--device", dev, "--mesh", "2", "--contig-file",
                        seeds, "--minimum-coverage", "2",
                        "--max-iterations", "2", "--out", outs[dev], "97",
                        fq]) == 0
    got = open(outs["cuda"], "rb").read()
    assert got == open(outs["cpu"], "rb").read() and b"-l" in got


@pytest.mark.cuda
def test_filter_reads_k97_on_the_card(cuda_device, tmp_path):
    """FilterReads --mesh 1 at k = 97 (four-lane keys) on the card: every
    output byte-identical to --device cpu's, the run-length kernel
    launched at L = 4 only."""
    from kmernator_tpu_torch.apps import filter_reads as app
    fq = str(tmp_path / "r.fastq")
    _wide_reads(fq, 98, n_reads=2000, genome_bp=20000)
    flags = ["--mesh", "1", "--kmer-scoring-type", "MEDIAN",
             "--mask-simple-repeats", "0", "--min-read-length", "25"]
    before = dict(rl.launches_by_lanes)
    for dev in ("cpu", "cuda"):
        assert app.run(["--device", dev] + flags
                       + ["--out", str(tmp_path / dev), "97", fq]) == 0
    torch.cuda.synchronize()
    grew = {L: n - before.get(L, 0) for L, n in rl.launches_by_lanes.items()
            if n != before.get(L, 0)}
    assert list(grew) == [4] and grew[4] >= 1
    names = sorted(n[len("cpu"):] for n in os.listdir(tmp_path)
                   if n.startswith("cpu"))
    assert names
    for name in names:
        a = open(str(tmp_path / ("cpu" + name)), "rb").read()
        b = open(str(tmp_path / ("cuda" + name)), "rb").read()
        assert a == b and len(a) > 1000, name


@pytest.mark.cuda
def test_tnf_distances_on_the_card(cuda_device, tmp_path):
    """TnfDistance's distance matrix on the card against the CPU: within
    4.0e-3 (float32 sums of 136 unit-norm products in another order, near
    g = 1) and within 1.0e-4 off the diagonal (sound float32 runs differ
    by about 1e-5 there, TF32 by about 4.6e-3), with TF32 off and the float32 matmul precision "highest" at
    the call, and refused with either changed; the app at --device cuda
    writes the --device cpu vectors table byte for byte."""
    from kmernator_tpu_torch.apps import tnf_distance as tnf
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    rng = np.random.default_rng(14)
    gc = rng.uniform(0.3, 0.7, 2048)
    probs = np.stack([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2], 1)
    counts = rng.poisson(40 * probs.repeat(34, axis=1)).astype(np.float64)
    got = tnf.distances(counts, "EUCLIDEAN", cuda_device)
    want = tnf.distances(counts, "EUCLIDEAN", torch.device("cpu"))
    assert got.dtype == want.dtype == np.float32
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= 4.0e-3
    np.fill_diagonal(diff, 0.0)
    assert diff.max() <= 1.0e-4
    for turn_on in (lambda: setattr(torch.backends.cuda.matmul,
                                    "allow_tf32", True),
                    lambda: torch.set_float32_matmul_precision("high")):
        turn_on()
        try:
            with pytest.raises(RuntimeError, match="without TF32"):
                tnf.distances(counts, "EUCLIDEAN", cuda_device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    fa = tmp_path / "c.fa"
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fa.write_bytes(b"".join(
        b">c%d\n%s\n" % (i, acgt[rng.choice(4, 3000, p=probs[i])].tobytes())
        for i in range(64)))
    out = {}
    for dev in ("cuda", "cpu"):
        p = str(tmp_path / dev)
        assert tnf.run(["--device", dev, "--inter-distance-file",
                        p + ".inter", "--out", p + ".vec", str(fa)]) == 0
        out[dev] = [open(p + s, "rb").read() for s in (".vec", ".inter")]
    assert out["cuda"][0] == out["cpu"][0]
    rows = [[r.split(b"\t") for r in out[d][1].splitlines()]
            for d in ("cuda", "cpu")]
    assert max(abs(float(a) - float(b)) for x, y in zip(*rows)
               for a, b in zip(x[1:], y[1:])) <= 1.0e-4   # no diagonal


def _library_batch(k, B=512, L=120, seed=0):
    """Reads of a 20 kb genome, some short, logp in multiples of 2^-9
    (window sums exact in float32, so the card's and the CPU's good masks
    are one), a few zero-probability bases."""
    rng = np.random.default_rng(seed + k)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    lengths = rng.integers(k - 3, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    logp = (-rng.integers(0, 80, (B, L)) / 512).astype(np.float32)
    logp[rng.random((B, L)) < 0.002] = np.float32(-1e30)
    return codes, logp, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 45])
def test_spectrum_step_matches_cpu(cuda_device, k):
    """spectrum_step, compact_spectrum and lookup_join on the card against
    the same calls on CPU tensors: bit-equal; one run-length launch a
    count_and_score, one a merge_tables."""
    args = [torch.from_numpy(a) for a in _library_batch(k)]
    want = ds.spectrum_step(*args, k)
    before = rl.launches
    got = ds.spectrum_step(*(a.to(cuda_device) for a in args), k)
    torch.cuda.synchronize()
    assert rl.launches == before + 1
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert int(want[0].max()) >= 2
    state_cpu = ds.count_and_score(want[1], want[2], k, 1)[1]
    state = ds.count_and_score(got[1], got[2], k, 1)[1]
    table_cpu = ds.compact_spectrum(*state_cpu)
    table = ds.compact_spectrum(*state)
    for a, b in zip(table, table_cpu):
        assert torch.equal(a.cpu(), b)
    keys = want[1].reshape(-1, want[1].shape[-1])
    assert torch.equal(
        ds.lookup_join(table[0], table[1], keys.to(cuda_device)).cpu(),
        ds.lookup_join(table_cpu[0], table_cpu[1], keys))
    merged = ds.merge_tables(table[0], table[1], table[0], table[1])
    merged_cpu = ds.merge_tables(table_cpu[0], table_cpu[1], table_cpu[0],
                                 table_cpu[1])
    for a, b in zip(merged, merged_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_window_good_phred_matches_cpu_outside_the_band(cuda_device):
    """Phred log-probabilities: the card's float64 scan and the CPU's
    sequential prefix give one good mask but within the stated bound of
    the threshold."""
    rng = np.random.default_rng(4)
    q = rng.integers(2, 41, (4096, 150))
    logp = torch.from_numpy(np.log2(1.0 - 10.0 ** (-q / 10.0)).astype(
        np.float32))
    lengths = torch.full((4096,), 150, dtype=torch.int32)
    lmw = float(np.log2(0.1))
    w_cpu, g_cpu = ds.window_good(logp, lengths, 31, lmw)
    w, g = ds.window_good(logp.to(cuda_device), lengths.to(cuda_device), 31,
                          lmw)
    band = ((w_cpu.double() - lmw).abs()
            <= ds.window_good_bound(logp)[:, None])
    assert torch.equal(g.cpu()[~band], g_cpu[~band])
    assert ((w.cpu().double() - w_cpu.double()).abs()
            <= ds.window_good_bound(logp)[:, None]).all()


@pytest.mark.cuda
def test_streaming_spectrum_matches_cpu(cuda_device):
    """StreamingSpectrum on the card against the CPU run of the same
    batches at a capacity under the distinct keys: the tables and
    purged_singletons bit-equal; one run-length launch a batch and one a
    drain."""
    from kmernator_tpu_torch.parallel.pipeline import StreamingSpectrum
    batches = [_library_batch(31, seed=s) for s in range(6)]
    cpu = StreamingSpectrum(31, 40_000, device="cpu")
    gpu = StreamingSpectrum(31, 40_000, device=cuda_device)
    before = rl.launches
    for b in batches:
        cpu.add_batch(*b)
        gpu.add_batch(*b)
    want, got = cpu.finalize(2), gpu.finalize(2)
    assert gpu.purged_singletons == cpu.purged_singletons > 0
    assert rl.launches == before + len(batches) + gpu.drains
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 4])
def test_distributed_count_fn_matches_cpu(cuda_device, D):
    """distributed_count_fn over D shards on the card against D shards on
    the CPU: counts and overflow bit-equal, one run-length launch a
    shard; and at D > 1 the counts are D = 1's."""
    from kmernator_tpu_torch.parallel.mesh import distributed_count_fn
    codes, _, lengths = _library_batch(31, B=1024)
    good = np.random.default_rng(D).random((1024, 90)) < 0.9
    args = [torch.from_numpy(a) for a in (codes, good, lengths)]
    want = distributed_count_fn(make_mesh(D, "cpu"), 31)(*args)
    before = rl.launches
    got = distributed_count_fn(make_mesh(D, cuda_device), 31)(
        *(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert rl.launches == before + D
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    one = distributed_count_fn(make_mesh(1, "cpu"), 31)(*args)[0]
    assert torch.equal(want[0], one) and int(one.max()) >= 2


def _prepared_equal(got, want):
    """Two Prepared tuples: every array bit-equal (weights as float32
    bits), the card's on the card."""
    for name in ("codes", "good2d", "lengths", "weights2d", "ext_ok2d",
                 "totals"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.device.type == "cuda" and g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        g = g.cpu()
        if name == "weights2d":
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 31, 63, 127])
@pytest.mark.parametrize("shape", ["short", "long"])
@pytest.mark.parametrize("outputs", ["cells", "all"])
def test_prepare_reads_kernel_matches_plain(cuda_device, k, shape,
                                            outputs):
    """The kernel against the host's NumPy steps, bit for bit, on reads
    with N and other markup, qualities under the minimum (the recompute
    after a bad window), no qualities, discarded reads and reads shorter
    than k. "short": reads of at most 150 bases, every block staged in
    shared memory (good rows, and weights rows where 128 of them fit);
    "long": reads past 1,024 and 2,048 windows and one of 40,000 bases,
    whose blocks read and write device memory directly. "cells" builds
    what the benchmark's jobs take, "all" the weights and extension masks
    too; both pad with empty rows."""
    long_ = shape == "long"
    rs = cases.edge_cases(k, seed=k, input_qual_base=64 if long_ else 33,
                       long_read=40_000 if long_ else 0,
                       max_length=0 if long_ else 150)
    L = -(-max(rs.max_length(), k) // 32) * 32
    full = outputs == "all"
    args = (rs, k, L, 3, 33, 0.10)
    kw = dict(rows=rs.n + 5, weights=full, ext_ok=full)
    want = pr.prepare_reads(*args, device="cpu", **kw)
    before = pr.launches
    got = pr.prepare_reads(*args, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert pr.launches == before + 1
    _prepared_equal(got, want)
    assert 0 < int(want.totals[1]) < int(want.totals[0])


@pytest.mark.cuda
@pytest.mark.parametrize("min_quality,min_kmer_quality", [(2, 0.0),
                                                          (20, 0.5)])
def test_prepare_reads_kernel_thresholds(cuda_device, min_quality,
                                         min_kmer_quality):
    """Other minimum qualities and k-mer qualities (MeraculousCounter's 2
    and 0.0), at k = 21 and 127."""
    for k in (21, 127):
        rs = cases.edge_cases(k, seed=min_quality)
        L = max(rs.max_length(), k)
        args = (rs, k, L, min_quality, 64, min_kmer_quality)
        kw = dict(weights=True, ext_ok=True)
        _prepared_equal(pr.prepare_reads(*args, device=cuda_device, **kw),
                        pr.prepare_reads(*args, device="cpu", **kw))


@pytest.mark.cuda
def test_prepare_reads_no_reads(cuda_device):
    """No reads, and only the shards' padding rows: empty rows (the host
    steps take no empty read set)."""
    from kmernator_tpu_torch.io.reads import ReadSet
    for rows in (0, 3):
        want = pr.Prepared(torch.zeros((rows, 32), dtype=torch.uint8),
                           torch.zeros((rows, 12), dtype=torch.bool),
                           torch.zeros(rows, dtype=torch.int32),
                           torch.zeros((rows, 12), dtype=torch.float32),
                           torch.zeros((rows, 32), dtype=torch.bool),
                           torch.zeros(2, dtype=torch.int64))
        got = pr.prepare_reads(ReadSet(), 21, 32, 3, 33, 0.1,
                               device=cuda_device, rows=rows, weights=True,
                               ext_ok=True)
        torch.cuda.synchronize()
        _prepared_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("track_weights", [False, True])
def test_chunk_padded_on_the_card(cuda_device, subtract, track_weights):
    """FilterReads' chunk arrays from the kernel, copied back, against the
    CPU's; with --subtract keys ANDed in on the host after the copy."""
    from kmernator_tpu_torch.apps import filter_reads
    from kmernator_tpu_torch.io.reads import BASE_CODE
    from kmernator_tpu_torch.parallel.spectrum import pack_keys
    k = 31
    rs = cases.edge_cases(k, seed=6, max_length=150)
    L = -(-max(rs.max_length(), k) // 32) * 32
    sub = None
    if subtract:
        codes_raw = BASE_CODE[rs.seq]
        cds = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        sub = np.unique(pack_keys(tk.extract_kmers_flat(
            cds, rs.offsets, k)[0])[::5])
    args = (rs, k, L, 3, 33, 0.10, sub, track_weights)
    want = filter_reads._chunk_padded(*args, device=torch.device("cpu"))
    before = pr.launches
    got = filter_reads._chunk_padded(*args, device=cuda_device)
    assert pr.launches == before + 1
    for g, w in zip(got[:4], want[:4]):
        if w is None:
            assert g is None
        else:
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
    assert got[4:] == want[4:]


@pytest.mark.cuda
@pytest.mark.parametrize("n_devices", [1, 3])
def test_padded_inputs_on_the_card(cuda_device, n_devices):
    """MeraculousCounter's inputs built on the card, left there, against
    the CPU's."""
    from kmernator_tpu_torch.apps import meraculous_counter
    rs = cases.edge_cases(21, seed=8, input_qual_base=64)
    want = meraculous_counter._padded_inputs(rs, 21, 2, 33, 0.0, n_devices,
                                             device=torch.device("cpu"))
    got = meraculous_counter._padded_inputs(rs, 21, 2, 33, 0.0, n_devices,
                                            device=cuda_device)
    _prepared_equal(got, want)
