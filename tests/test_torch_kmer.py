"""kmernator_tpu_torch.ops.kmer: int64-lane word ops against the JAX
package's ops (tolerance: none, every result is bit-equal)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.ops import kmer as jk
from kmernator_tpu_torch.ops import kmer as tk


def test_pack16_matches_jax():
    rng = np.random.default_rng(0)
    for L in (1, 5, 16, 17, 70):
        codes = rng.integers(0, 4, (6, L)).astype(np.uint8)
        want = jk.pack16(np, codes)   # the host oracle takes any L
        if L >= 16:
            assert np.array_equal(np.asarray(jk.pack16(jnp, codes)), want)
        got = tk.pack16_torch(torch.from_numpy(codes)).numpy()
        assert np.array_equal(got, want.astype(np.int64))
        assert (got >= 0).all() and (got <= 0xFFFFFFFF).all()


def test_reverse_bases_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 0xFFFFFFFF, 0x80000001]
    want = np.asarray(jk._reverse_bases_u32(jnp, jnp.asarray(x)))
    got = tk.reverse_bases(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("k", [1, 15, 16, 21, 31, 32])
def test_word_helpers_are_the_jax_ones(k):
    assert tk.nwords(k) == jk.nwords(k)
    assert tk.last_word_mask(k) == jk.last_word_mask(k)


@pytest.mark.parametrize("W", [1, 2])
def test_lane_order_equals_unsigned_lexicographic(W):
    """Signed int64 lane order == unsigned (hi, lo) order, high bits and
    the sentinel included; the sentinel maps to INT64_MAX."""
    rng = np.random.default_rng(2)
    words = rng.integers(0, 1 << 32, (2000, W), dtype=np.uint64)
    words[:4] = 0xFFFFFFFF          # sentinel rows
    words[4:8, 0] = 0x80000000      # sign bit of the packed key
    words[8:12] = 0
    words = words.astype(np.uint32)
    cols = [torch.from_numpy(words[:, w].astype(np.int64)) for w in range(W)]
    lanes = tk.encode_lane(cols)
    assert int(lanes[0]) == tk.SENTINEL_LANE == torch.iinfo(torch.int64).max
    order_t = torch.sort(lanes, stable=True).indices.numpy()
    order_n = np.lexsort([words[:, w] for w in range(W - 1, -1, -1)])
    assert np.array_equal(words[order_t], words[order_n])
    back = tk.decode_lane(lanes, W)
    for w in range(W):
        assert np.array_equal(back[w].numpy(), words[:, w].astype(np.int64))


def test_wide_k_refused():
    """Keys hold at most 3 lanes: k = 96 passes, k = 97 is refused; one
    lane holds at most 2 words."""
    tk.check_k(32)
    tk.check_k(33)
    tk.check_k(96)
    with pytest.raises(NotImplementedError, match="key layout"):
        tk.check_k(97)
    with pytest.raises(NotImplementedError):
        tk.encode_lane([torch.zeros(1, dtype=torch.int64)] * 3)
    with pytest.raises(NotImplementedError):
        tk.encode_lanes([torch.zeros(1, dtype=torch.int64)] * 7)
