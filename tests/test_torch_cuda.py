"""kmernator_tpu_torch on the card: each test is marked `cuda` and skips
without a GPU. This file imports no jax, so it also runs where jax is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CUDA results are held to the same function on CPU tensors, which takes
the plain PyTorch versions. Tolerance: none for keys, counts, lookups and
sorted lanes; table weights to 1e-6 of the total weight the table has
taken in (both are differences of float32 prefix sums over a drain, which
the card's scan rounds in another order than the CPU's). The hash insert
places keys in an order that depends on timing, so it is held to its plain
version through the order-free invariants of `check_invariants`, exactly.
"""
import numpy as np
import pytest
import torch

from kmernator_tpu_torch.ops.kmer import SENTINEL_LANE, encode_lane
from kmernator_tpu_torch.parallel import device_spectrum as ds
from kmernator_tpu_torch.parallel import hash_insert as hi
from kmernator_tpu_torch.parallel import merge_sort as ms
from kmernator_tpu_torch.parallel import run_length as rl
from kmernator_tpu_torch.parallel.mesh import make_mesh
from kmernator_tpu_torch.parallel.mesh_stream import MeshStreamingSpectrum


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [0, 1, 2047, 2048, 2049, 3 * 2048 + 5,
                               1 << 20])
def test_kernel_matches_plain(cuda_device, N):
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


@pytest.mark.cuda
def test_one_run_across_every_tile(cuda_device):
    n = 40 * 2048 + 17
    lanes = torch.full((n,), 7, dtype=torch.int64, device=cuda_device)
    vals = torch.ones(n, dtype=torch.int32, device=cuda_device)
    got = rl.run_length_sums(lanes, vals).cpu()
    assert int(got[-1]) == n and int(got[:-1].abs().sum()) == 0


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
def test_mesh_stream_matches_cpu(cuda_device):
    rng = np.random.default_rng(2)
    k, B, L = 31, 64, 100
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
    assert spectra[1].table_keys.device.type == "cuda"
    for codes, good, lengths in batches:
        want = np.ones_like(good)
        assert np.array_equal(
            spectra[0].lookup_batch(codes, want, lengths, min_count=2),
            spectra[1].lookup_batch(codes, want, lengths, min_count=2))


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
def test_merge_level_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    lanes = torch.from_numpy(_sort_case("dups_sentinels", 5 * 3072, rng))
    runs = [(i * 3072, 3072) for i in range(5)]
    s = lanes.view(5, 3072).sort(dim=1).values.reshape(-1)
    want, want_runs = ms.merge_level(s, runs, 1024)
    got, got_runs = ms.merge_level(s.to(cuda_device), runs, 1024)
    assert got_runs == want_runs == [(0, 6144), (6144, 6144), (12288, 3072)]
    assert torch.equal(got.cpu(), want)


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
