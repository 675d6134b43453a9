"""kmernator_tpu_torch on the card: each test is marked `cuda` and skips
without a GPU. This file imports no jax, so it also runs where jax is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CUDA results are held to the same function on CPU tensors, which takes
the plain PyTorch versions. Tolerance: none for keys, counts and lookups;
weights to 1e-6 relative (float64 prefix sums taken in another order).
"""
import numpy as np
import pytest
import torch

from kmernator_tpu_torch.ops.kmer import encode_lane
from kmernator_tpu_torch.parallel import device_spectrum as ds
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
    for _ in range(6):
        codes = genome[rng.integers(0, 3000 - L, B)[:, None]
                       + np.arange(L)[None, :]]
        codes[B // 2:] = rng.integers(0, 4, (B - B // 2, L))
        lengths = rng.integers(k - 1, L + 1, B).astype(np.int32)
        good = rng.random((B, NW)) < 0.9
        weights = rng.random((B, NW)).astype(np.float32)
        batches.append((codes, good, lengths))
        for sp in spectra:
            sp.add_batch(codes, good, lengths, weights2d=weights)
        cpu, dev = (sp.to_numpy_tables() for sp in spectra)
        assert np.array_equal(cpu[0], dev[0])
        assert np.array_equal(cpu[1], dev[1])
        np.testing.assert_allclose(dev[2], cpu[2], rtol=1e-6, atol=0)
    assert spectra[1].drains >= 2
    assert spectra[1].purged_singletons == spectra[0].purged_singletons > 0
    assert spectra[1].table_keys.device.type == "cuda"
    for codes, good, lengths in batches:
        want = np.ones_like(good)
        assert np.array_equal(
            spectra[0].lookup_batch(codes, want, lengths, min_count=2),
            spectra[1].lookup_batch(codes, want, lengths, min_count=2))
