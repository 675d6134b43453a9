"""The count path's padded input (parallel/prepare_reads.py) on the CPU.

The CUDA kernel builds its arrays from two 256-entry tables made here,
which must give every raw byte what the host steps give it; its window
chain (rolling counts of bad bases, the recompute points) is replayed in
Python floats by `schedule_plain` (tests/prepare_reads_cases.py), held
bit-equal to the host's `window_weights` and `good_kmer_mask`. On a CPU
device `_chunk_padded` (FilterReads) and `_padded_inputs`
(MeraculousCounter) return what their host NumPy steps returned before
the kernel existed, copied below. The kernel itself is held to the plain
version on the card by tests/test_torch_cuda.py. Tolerance: none.
"""
import numpy as np
import pytest
import torch

from kmernator_tpu_torch.apps import filter_reads, meraculous_counter
from kmernator_tpu_torch.io.reads import BASE_CODE
from kmernator_tpu_torch.ops.extensions import EXT_MIN_QUALITY
from kmernator_tpu_torch.ops.kmer import extract_kmers_flat
from kmernator_tpu_torch.ops.weights import (good_kmer_mask,
                                             phred_probability,
                                             window_weights)
from kmernator_tpu_torch.parallel import prepare_reads as pr
from kmernator_tpu_torch.parallel.device_spectrum import (pack_readset,
                                                          ragged_to_padded)
from kmernator_tpu_torch.parallel.spectrum import pack_keys

import prepare_reads_cases as cases
import torch_threads  # noqa: F401


def host_chunk_padded(rs, k, L, min_quality, output_base, min_kmer_quality,
                      subtract_keys=None, track_weights=False):
    """FilterReads' `_chunk_padded` as the host built it, unchanged."""
    NW = L - k + 1
    codes, _, lengths = pack_readset(rs, L, min_quality, output_base)
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    p = rs.base_probabilities(min_quality, output_base)
    w = window_weights(p, rs.offsets, markup, k)
    good = good_kmer_mask(w, min_kmer_quality)
    if subtract_keys is not None and len(subtract_keys):
        cds = np.where(markup, 0, codes_raw).astype(np.uint8)
        canon, _, _, _ = extract_kmers_flat(cds, rs.offsets, k)
        keys = pack_keys(canon)
        idx = np.clip(np.searchsorted(subtract_keys, keys), 0,
                      len(subtract_keys) - 1)
        good = good & (subtract_keys[idx] != keys)
    nw = np.maximum(rs.lengths() - k + 1, 0)
    good2d = ragged_to_padded(good, nw, NW, fill=False)
    good2d &= ~rs.discarded[:, None]
    weights2d = None
    if track_weights:
        weights2d = ragged_to_padded(w.astype(np.float32), nw, NW, fill=0.0)
    return codes, good2d, lengths, weights2d, int(nw.sum()), int(
        (good & ~rs.discarded[np.repeat(np.arange(rs.n), nw)]).sum())


def host_padded_inputs(rs, k, min_quality, output_base, min_kmer_quality,
                       n_devices):
    """MeraculousCounter's `_padded_inputs` as the host built it."""
    L = max(rs.max_length(), k)
    codes, _, lengths = pack_readset(rs, L, min_quality, output_base)
    B = codes.shape[0]
    NW = L - k + 1
    codes_raw = BASE_CODE[rs.seq]
    markup = codes_raw == 4
    p = rs.base_probabilities(min_quality, output_base)
    w = window_weights(p, rs.offsets, markup, k)
    exact_good = good_kmer_mask(w, min_kmer_quality)
    lens = rs.lengths()
    nw = np.maximum(lens - k + 1, 0)
    good2d = ragged_to_padded(exact_good, nw, NW, fill=False)
    phred = rs.phred()
    read_id = np.repeat(np.arange(rs.n), lens)
    ok_flat = (phred >= EXT_MIN_QUALITY) | ~rs.has_quals[read_id]
    ext_ok2d = ragged_to_padded(ok_flat, lens, L, fill=False)
    good2d &= ~rs.discarded[:, None]
    pad = (-B) % n_devices
    if pad:
        codes = np.concatenate([codes, np.zeros((pad, L), codes.dtype)])
        good2d = np.concatenate([good2d, np.zeros((pad, NW), bool)])
        ext_ok2d = np.concatenate([ext_ok2d, np.zeros((pad, L), bool)])
        lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
    return codes, good2d, ext_ok2d, lengths


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("input_qual_base", [33, 64])
@pytest.mark.parametrize("min_quality,output_base", [(0, 33), (3, 33),
                                                     (2, 64), (20, 64)])
def test_quality_table_every_byte(input_qual_base, min_quality,
                                  output_base):
    """Entry q is what the host gives a base of raw quality byte q."""
    tab = pr.quality_table(input_qual_base, min_quality, output_base)
    assert tab.dtype == np.float64 and tab.shape == (256,)
    for q in range(256):
        phred = np.array([q], np.uint8).astype(np.int16) - np.int16(
            input_qual_base)
        want = phred_probability(phred, min_quality, output_base)[0]
        assert tab[q].tobytes() == want.tobytes(), q


@pytest.mark.parametrize("input_qual_base", [33, 64])
def test_device_tables_every_byte(input_qual_base):
    """The two tables the wrapper hands the kernel (here on the CPU): the
    code of every base byte and the probability of every quality byte."""
    ptab, ctab = pr.device_tables(torch.device("cpu"), input_qual_base, 3,
                                  33)
    assert ctab.dtype == torch.uint8 and ptab.dtype == torch.float64
    assert np.array_equal(ctab.numpy(), BASE_CODE)
    assert set(np.flatnonzero(ctab.numpy() != 4)) == {ord(c)
                                                       for c in "ACGT"}
    phred = np.arange(256, dtype=np.uint8).astype(np.int16) - np.int16(
        input_qual_base)
    assert ptab.numpy().tobytes() == phred_probability(phred, 3,
                                                       33).tobytes()


@pytest.mark.parametrize("input_qual_base", [33, 64])
def test_quality_table_gives_the_readsets_probabilities(input_qual_base):
    """Gathering the table by a ReadSet's raw bytes gives
    base_probabilities for reads with qualities."""
    rs = cases.edge_cases(21, seed=1, input_qual_base=input_qual_base)
    for min_quality, output_base in ((3, 33), (2, 64)):
        tab = pr.quality_table(input_qual_base, min_quality, output_base)
        want = rs.base_probabilities(min_quality, output_base)
        hq = np.repeat(rs.has_quals, rs.lengths())
        assert np.array_equal(tab[rs.qual][hq].view(np.uint64),
                              want[hq].view(np.uint64))
        assert (want[~hq] == 1.0).all()


@pytest.mark.parametrize("k", [21, 31, 63, 127])
@pytest.mark.parametrize("min_quality,min_kmer_quality", [(3, 0.10),
                                                          (2, 0.0),
                                                          (20, 0.5)])
def test_schedule_bit_equal_to_host(k, min_quality, min_kmer_quality):
    """The kernel's chain in Python floats against window_weights and
    good_kmer_mask: every weight as float32 bits and every mask."""
    rs = cases.edge_cases(k, seed=k + min_quality)
    L = -(-max(rs.max_length(), k) // 32) * 32
    good, weights = cases.schedule_plain(rs, k, L, min_quality, 33,
                                         min_kmer_quality)
    host = pr.prepare_reads_plain(rs, k, L, min_quality, 33,
                                  min_kmer_quality, weights=True)
    _same(good, host.good2d.numpy())
    _same(weights.view(np.uint32), host.weights2d.numpy().view(np.uint32))
    # the cases reach every branch: bad windows, recomputes after them,
    # the resync, and windows that pass
    assert (weights == 0).any() and good.any()
    assert rs.lengths().max() - k + 1 > 2 * cases.RESYNC


@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("track_weights", [False, True])
@pytest.mark.parametrize("k", [31, 63])
def test_chunk_padded_on_the_cpu_as_before(subtract, track_weights, k):
    rs = cases.edge_cases(k, seed=3)
    L = -(-max(rs.max_length(), k) // 32) * 32
    sub = None
    if subtract:
        codes_raw = BASE_CODE[rs.seq]
        cds = np.where(codes_raw == 4, 0, codes_raw).astype(np.uint8)
        canon, _, _, _ = extract_kmers_flat(cds, rs.offsets, k)
        keys = pack_keys(canon)
        sub = np.unique(keys[::5])
    args = (rs, k, L, 3, 33, 0.10, sub, track_weights)
    want = host_chunk_padded(*args)
    got = filter_reads._chunk_padded(*args, device=torch.device("cpu"))
    for g, w in zip(got[:4], want[:4]):
        if w is None:
            assert g is None
        else:
            _same(g, w)
    assert got[4:] == want[4:]
    assert got[5] < got[4]
    if subtract:
        assert got[5] < host_chunk_padded(rs, k, L, 3, 33, 0.10)[5]


@pytest.mark.parametrize("n_devices", [1, 3])
@pytest.mark.parametrize("k", [21, 51])
def test_padded_inputs_on_the_cpu_as_before(n_devices, k):
    rs = cases.edge_cases(k, seed=4, input_qual_base=64)
    want = host_padded_inputs(rs, k, 2, 33, 0.0, n_devices)
    got = meraculous_counter._padded_inputs(rs, k, 2, 33, 0.0, n_devices,
                                            device=torch.device("cpu"))
    got4 = (got.codes, got.good2d, got.ext_ok2d, got.lengths)
    for g, w in zip(got4, want):
        assert g.device.type == "cpu"
        _same(g.numpy(), w)
    assert got.totals.tolist() == [
        int(np.maximum(rs.lengths() - k + 1, 0).sum()), int(want[1].sum())]


def test_refusals():
    rs = cases.edge_cases(21, seed=5)
    L = max(rs.max_length(), 21)
    with pytest.raises(ValueError):
        pr.prepare_reads(rs, 21, L - 1, 3, 33, 0.1, device="cpu")
    with pytest.raises(ValueError):
        pr.prepare_reads(rs, L + 1, L, 3, 33, 0.1, device="cpu")
    with pytest.raises(ValueError):
        pr.prepare_reads(rs, 21, L, 3, 33, 0.1, device="cpu", rows=rs.n - 1)
    # the plain version launches nothing
    before = pr.launches
    pr.prepare_reads(rs, 21, L, 3, 33, 0.1, device="cpu", rows=rs.n + 2)
    assert pr.launches == before
