"""MeraculousCounter's text files from the device table
(parallel/format_mers.py), on the CPU: what the wrapper computes on the
host (the slab plan, the blocks' byte prefixes, the threshold), and its
plain versions, which write the files slab by slab as the kernels do,
byte-identical to the host path's dumps. The kernels themselves are held
to the host dumps in tests/test_torch_cuda.py. No jax; tolerance: none.
"""
import os

import numpy as np
import pytest

from kmernator_tpu_torch.apps import meraculous_counter as app
from kmernator_tpu_torch.apps.generate_metagenome import run as generate
from kmernator_tpu_torch.parallel import format_mers as fm
from kmernator_tpu_torch.utils import timers

import format_mers_cases as cases
import torch_threads  # noqa: F401


@pytest.mark.parametrize("min_depth,want", [(0, 2), (1, 2), (2, 2), (3, 3),
                                            (10, 10)])
def test_dump_threshold(min_depth, want):
    """The purge of depth 2, then each dump's counts >= min_depth."""
    assert app.dump_threshold(min_depth) == want


def _ends(block_bytes):
    """block_ends rows from each block's (mercount, mergraph) bytes."""
    per = np.array([(c, g, int(c > 0)) for c, g in block_bytes],
                   np.int64).reshape(-1, 3)
    return np.concatenate([np.zeros((1, 3), np.int64), np.cumsum(per, 0)])


@pytest.mark.parametrize("blocks,slab,want", [
    ([], 64, []),                                   # no table
    ([(0, 0)] * 3, 64, []),                         # no key kept
    ([(10, 30), (6, 18)], 64, [(0, 2)]),            # 16 + 48: one slab
    ([(10, 30), (7, 20)], 64, [(0, 1), (1, 2)]),    # 32 + 50 > 64
    ([(16, 48), (16, 48)], 64, [(0, 1), (1, 2)]),   # exactly 64 each
    ([(100, 300), (1, 2)], 64, [(0, 1), (1, 2)]),   # a block past the slab
    ([(0, 0), (5, 9), (0, 0), (5, 9), (0, 0)], 64, [(0, 5)]),
    ([(16, 48), (16, 48), (0, 0)], 64, [(0, 1), (1, 3)]),
    ([(5, 9)] * 7, 40, [(0, 2), (2, 4), (4, 6), (6, 7)]),
])
def test_plan_slabs(blocks, slab, want):
    """Slabs of whole blocks from block 0, each as long as its buffer
    (mercount padded to 16 bytes, then mergraph) fits the slab, at least
    one block; no slab without text."""
    ends = _ends(blocks)
    plan = fm.plan_slabs(ends, slab)
    assert [(s.b0, s.b1) for s in plan] == want
    for s in plan:
        assert (s.c0, s.g0) == tuple(ends[s.b0, :2])
        assert s.c_bytes == ends[s.b1, 0] - ends[s.b0, 0]
        assert s.g_bytes == ends[s.b1, 1] - ends[s.b0, 1]
        assert s.g_at % 16 == 0 and s.g_at - s.c_bytes < 16
        assert s.size <= slab or s.b1 == s.b0 + 1
    if plan:
        assert sum(s.c_bytes + s.g_bytes for s in plan) == ends[-1, :2].sum()


def test_block_ends_sum_the_dumps(tmp_path):
    """The blocks' prefixes count the bytes and keys of the host dumps."""
    t = cases.random_table(21, 2000, seed=4)
    ends = fm.block_ends(t.counts.numpy(), t.ext.numpy(), 21, 3)
    assert ends.shape == (-(-t.counts.numel() // fm.THREADS) + 1, 3)
    c, g = cases.host_dumps(t, 21, 3, str(tmp_path))
    assert tuple(ends[-1]) == (len(c), len(g), c.count(b"\n") // 2)
    assert np.all(np.diff(ends, axis=0) >= 0)


@pytest.mark.parametrize("k", [21, 31, 32, 33, 64, 65, 101])
@pytest.mark.parametrize("min_depth", [1, 2, 3])
def test_plain_matches_host_dumps(tmp_path, k, min_depth):
    """The plain versions, slab by slab through the wrapper (slabs of 16
    KB: several a table), byte-identical to the host path's two files."""
    t = cases.random_table(k, 600, seed=k * 10 + min_depth)
    sel = fm.select(t, k, app.dump_threshold(min_depth))
    c, g = str(tmp_path / "c"), str(tmp_path / "g")
    plan = fm.write(sel, c, g, slab_bytes=16 << 10)
    want = cases.host_dumps(t, k, min_depth, str(tmp_path))
    assert cases.read_pair(c, g) == want
    assert len(plan) > 1 and len(want[0]) > 1000
    assert sel.offs is None and sel.ends[-1, 2] == want[0].count(b"\n") // 2


@pytest.mark.parametrize("case", ["none kept", "one key", "empty"])
def test_plain_edge_tables(tmp_path, case):
    """A table where no key survives, one key, and no key at all: two
    empty files, or the host path's two lines in each. (The host path
    raises on a table with no key to write: `_emit_lines` takes the
    maximum of an empty array.)"""
    t = cases.random_table(20, 1 if case == "one key" else 50, seed=3)
    if case == "empty":
        t = fm.DeviceTable([x[:0] for x in t.lanes], t.counts[:0],
                           t.ext[:0])
    elif case == "none kept":
        t.counts.clamp_(max=1)
    else:
        t.counts.fill_(7)
    c, g = str(tmp_path / "c"), str(tmp_path / "g")
    plan = fm.write(fm.select(t, 20, 2), c, g)
    got = cases.read_pair(c, g)
    if case == "one key":
        assert got == cases.host_dumps(t, 20, 2, str(tmp_path))
    else:
        assert got == (b"", b"")
    assert len(plan) == (case == "one key")
    assert [x.count(b"\n") for x in got] == [2 * len(plan)] * 2


@pytest.fixture(scope="module")
def small_input(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fm") / "meta.fastq")
    assert generate(["--genomes", "4", "--total-genome-mb", "0.02",
                     "--coverage", "10", "--read-length", "150",
                     "--seed", "5", "--out", path]) in (0, None)
    return path


@pytest.mark.parametrize("min_depth", [1, 3])
def test_run_mesh1_matches_host_engine(tmp_path, small_input, min_depth):
    """--device cpu --mesh 1 writes the host engine's bytes at any
    --min-depth; on the CPU it carries the table to the host and launches
    no format_mers kernel, and a traced run counts the table's keys and
    those dumped."""
    out = {}
    for name, extra in (("host", []), ("mesh", ["--mesh", "1"])):
        before = dict(fm.launches)
        assert app.run(["--device", "cpu"] + extra + [
            "--kmer-size", "21", "--min-depth", str(min_depth), "--debug",
            "1", "--out", str(tmp_path / name), small_input]) == 0
        assert dict(fm.launches) == before
        counters = timers.records()[-1]["counters"]
        files = sorted(n for n in os.listdir(tmp_path)
                       if n.startswith(name + "."))
        assert files == [name + ".mercount.m21",
                         name + ".mergraph.m21.D%d" % min_depth]
        out[name] = [open(tmp_path / n, "rb").read() for n in files]
        assert counters["io.keys_dumped"] == out[name][0].count(b"\n") // 2
        assert counters["table.keys"] > counters["io.keys_dumped"] > 100
    assert out["mesh"] == out["host"]
