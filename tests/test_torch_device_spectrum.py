"""kmernator_tpu_torch.parallel.device_spectrum against the JAX package:
canonical extraction and count_batch, bit-equal (tolerance: none) at
k in {15, 21, 31, 32}; k=32 fills the whole 64-bit lane."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmernator_tpu.parallel import device_spectrum as J
from kmernator_tpu_torch.parallel import device_spectrum as T

import torch_threads  # noqa: F401

KS = [15, 21, 31, 32]


def _batch(k, B=24, L=80, seed=0):
    """Reads sampled from a small genome (so keys repeat) plus random
    reads, with padding rows (length 0) and reads shorter than k."""
    rng = np.random.default_rng(seed + k)
    genome = rng.integers(0, 4, 400).astype(np.uint8)
    starts = rng.integers(0, 400 - L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[B // 2:] = rng.integers(0, 4, (B - B // 2, L))
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    lengths[0] = L
    lengths[1] = k - 1          # no window
    lengths[2] = 0              # padding row
    lengths[3] = k              # one window
    for i in range(B):
        codes[i, lengths[i]:] = 0
    return codes, lengths


def _as_np(cols):
    return [c.numpy() for c in cols]


@pytest.mark.parametrize("k", KS)
def test_extract_canonical_cols_bit_equal(k):
    codes, lengths = _batch(k)
    jc, jf, jv = J.extract_canonical_cols(jnp.asarray(codes),
                                          jnp.asarray(lengths), k)
    tc, tf, tv = T.extract_canonical_cols(torch.from_numpy(codes),
                                          torch.from_numpy(lengths), k)
    assert len(tc) == len(jc)
    for a, b in zip(jc, _as_np(tc)):
        assert b.dtype == np.int64
        assert np.array_equal(np.asarray(a).astype(np.int64), b)
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("min_count", [1, 2])
def test_count_batch_bit_equal(k, min_count):
    codes, lengths = _batch(k, seed=1)
    jc, _, jv = J.extract_canonical_cols(jnp.asarray(codes),
                                         jnp.asarray(lengths), k)
    cols = [np.asarray(c).reshape(-1) for c in jc]
    rng = np.random.default_rng(k)
    good = (rng.random(cols[0].shape[0]) < 0.85) & np.asarray(jv).reshape(-1)
    jkeys, jcnt, jn = J.count_batch([jnp.asarray(c) for c in cols],
                                    jnp.asarray(good), min_count=min_count)
    tkeys, tcnt, tn = T.count_batch(
        [torch.from_numpy(c.astype(np.int64)) for c in cols],
        torch.from_numpy(good), min_count=min_count)
    assert np.array_equal(np.asarray(jkeys).astype(np.int64), tkeys.numpy())
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())
    assert int(jn) == int(tn) > 0
    # the stacked [N, W] form gives the same table
    stacked = torch.from_numpy(np.stack(cols, -1).astype(np.int64))
    skeys, scnt, sn = T.count_batch(stacked, torch.from_numpy(good),
                                    min_count=min_count)
    assert torch.equal(skeys, tkeys) and torch.equal(scnt, tcnt)


def test_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    nw = rng.integers(0, 9, 40)
    flat = rng.integers(0, 100, int(nw.sum()))
    a = T.ragged_to_padded(flat, nw, 9, fill=-1)
    assert np.array_equal(a, J.ragged_to_padded(flat, nw, 9, fill=-1))
    assert np.array_equal(T.padded_to_ragged(a, nw), flat)
