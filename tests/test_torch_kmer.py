"""kmernator_tpu_torch.ops.kmer: int64-lane word ops against the JAX
package's ops (tolerance: none, every result is bit-equal)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.ops import kmer as jk
from kmernator_tpu_torch.ops import kmer as tk

import torch_threads  # noqa: F401


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


def test_wide_k_keys_match_jax():
    """k = 97 (W = 7 words, L = 4 lanes, an odd last word): the JAX
    package's canonical k-mers of seeded reads, encoded into lanes and
    back, are the same words, and a lexicographic sort of the lanes orders
    them as the JAX words_less does. One lane still holds at most 2
    words."""
    k = 97
    rng = np.random.default_rng(97)
    codes = rng.integers(0, 4, 12 * 130).astype(np.uint8)
    offsets = np.arange(0, 13 * 130, 130)
    words = jk.extract_kmers_flat(codes, offsets, k)[0]
    assert words.shape == (12 * 34, tk.nwords(k)) == (408, 7)
    cols = [torch.from_numpy(words[:, w].astype(np.int64)) for w in range(7)]
    lanes = tk.encode_lanes(cols)
    assert len(lanes) == tk.nlanes(7) == 4
    back = np.stack([c.numpy() for c in tk.decode_lanes(lanes, 7)], -1)
    assert np.array_equal(back, words.astype(np.int64))
    order = np.lexsort([lane.numpy() for lane in lanes[::-1]])
    s = words[order]
    assert not np.asarray(jk.words_less(np, s[1:], s[:-1])).any()
    with pytest.raises(NotImplementedError):
        tk.encode_lane([torch.zeros(1, dtype=torch.int64)] * 3)
