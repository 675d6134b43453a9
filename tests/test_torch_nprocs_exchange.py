"""The shard exchange across processes (parallel/mesh.py `exchange` over
parallel/multihost.py `all_to_all_planes`, gloo on the CPU) and the
port's FilterReads `--streaming --distributed HOST:PORT --nprocs 2`.

The exchange and the shard tables at N = 2 and 4 processes, one shard
each, are held to the one-process mesh of N shards (PR 11's transpose,
itself held to the JAX package by tests/test_torch_mesh_exchange.py) on
the same rows, which every rank computes before its process group
exists: each rank's received planes and reply are its slice of the
one-process ones, the plane width, C and its retries are the same on
every rank though the ranks' own bucket loads differ, and a
MeshStreamingSpectrum over the processes gives the one-process table
(keys, counts and float32 weights bit-equal), drains, purged singletons,
lookups and variant purge. Tolerance: none.

FilterReads `--streaming --distributed` at two processes, in chunks of
0.05 MB and batches of 128 reads: every output file byte-identical to
the JAX host engine and to the JAX app at two `jax.distributed`
processes (one CPU device each) on an input whose second half has shorter
reads, so that rank 1 runs more lockstep rounds and rank 0 feeds empty
batches; and under capacity pressure (`--streaming-parts 2000`), where
which singletons go depends on the layout, byte-identical to the JAX app
at two processes with the same count purged."""
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from kmernator_tpu.apps import filter_reads as jax_app

from torch_ranks import app_ranks, run_ranks
import torch_threads  # noqa: F401

BASE = ["--kmer-scoring-type", "MEDIAN", "--mask-simple-repeats", "0",
        "--artifact-edit-distance", "1", "--min-read-length", "25"]
STREAM = ["--streaming", "--streaming-chunk-mb", "0.05", "--mesh-batch",
          "128", "--verbose", "1"]
PURGED = re.compile(r"mesh streaming purged (\d+) singletons")
STREAMED = re.compile(r"rank (\d) streamed (\d+) reads \(global (\d+)\)")

_RANK = r"""
import sys
import numpy as np
import torch
from kmernator_tpu_torch.parallel import mesh as tm
from kmernator_tpu_torch.parallel import multihost as mh
from kmernator_tpu_torch.parallel.mesh_stream import MeshStreamingSpectrum

coord, D, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
rng = np.random.default_rng(7)

# bucket planes of every rank: rank 0 sends most of its rows to shard 1,
# the others few rows anywhere, so only rank 0's own loads pass C0
N, C0 = 300, 64
owner = rng.integers(0, D, (D, N))
owner[0, :200] = 1
real = rng.random((D, N)) < np.where(np.arange(D) == 0, 0.8, 0.3)[:, None]
vals = rng.integers(-(1 << 40), 1 << 40, (D, N))
O, R = torch.from_numpy(owner), torch.from_numpy(real)
planes = {"int64": torch.from_numpy(vals),
          "float32": torch.from_numpy(vals.astype(np.float32)),
          "int32": torch.from_numpy((vals >> 20).astype(np.int32)),
          "pairs": torch.from_numpy(np.stack([vals, -vals], -1))}
fills = {"int64": -1, "float32": 0.5, "int32": 7, "pairs": 3}

def send_planes(x, ws, width, fill):
    # [S, N] or [S, N, 2] rows -> [S, D, width] or [S, D, width, 2]
    if x.dim() == 3:
        return torch.stack([tm.scatter_plane(x[..., j], ws, D, width, fill)
                            for j in range(x.shape[2])], -1)
    return tm.scatter_plane(x, ws, D, width, fill)

# the one-process mesh of D shards on the same rows, before the group
loads = tm.bucket_loads(O, R, D)
want_width = tm.plane_width(loads)
want_C = tm.bucket_capacity(want_width, C0, 64 * N)
own_retries = tm.bucket_capacity(max(int(loads[rank].max()), 1), C0,
                                 64 * N)[1]
ws, _ = tm.bucket_slots(O, R, D, want_width)
want = {}
for name, x in planes.items():
    recv = tm.exchange(send_planes(x, ws, want_width, fills[name]))
    back = tm.exchange(recv.reshape((D, D, want_width) + x.shape[2:]))
    want[name] = (recv[rank], back[rank])

# a shard table fed by every rank: reads of a 700 bp genome with errors
K, B, L = 21, 48, 64
genome = rng.integers(0, 4, 700)
def batch(seed):
    g = np.random.default_rng(seed)
    s = g.integers(0, 700 - L, B * D)
    codes = genome[s[:, None] + np.arange(L)].astype(np.uint8)
    err = g.random(codes.shape) < 0.02
    codes[err] = g.integers(0, 4, int(err.sum()))
    lengths = g.integers(40, L + 1, B * D).astype(np.int32)
    good = g.random((B * D, L - K + 1)) < 0.9
    weights = g.random((B * D, L - K + 1)).astype(np.float32)
    return codes, good, lengths, weights
batches = [batch(s) for s in range(8)]
mine = lambda a: a[rank * B:(rank + 1) * B]

def drive(sp, rows):
    for codes, good, lengths, weights in batches:
        sp.add_batch(rows(codes), rows(good), rows(lengths),
                     weights2d=rows(weights))
    out = {"drains": sp.drains, "purged": sp.purged_singletons,
           "retries": sp.overflow_retries}
    out["lookup"] = [sp.lookup_batch(rows(c), np.ones_like(rows(g)),
                                     rows(n), min_count=2)
                     for c, g, n, _ in batches[:3]]
    out["table"] = sp.finalize(min_depth=1, with_weights=True)
    sp.purge_min_depth(2)
    out["variants"] = sp.purge_variants_mesh(1.0, 1, 3.0, chunk_rows=4096)
    out["after"] = sp.finalize(min_depth=2, with_weights=True)
    keys, counts = out["after"][:2]
    sp.set_table(keys, counts)
    out["set"] = sp.to_numpy_tables()
    return out

ref = drive(MeshStreamingSpectrum(tm.make_mesh(D, "cpu"), K, 400),
            lambda a: a)
assert ref["purged"] > 0 and ref["variants"] > 0 and ref["drains"] > 2

assert mh.initialize(coord, D, rank) == (rank, D)
mesh = mh.global_mesh("cpu")
assert (mesh.size, mesh.local, mesh.first, mesh.nprocs) == (D, 1, rank, D)
o, r = O[rank:rank + 1], R[rank:rank + 1]
width = tm.plane_width(tm.bucket_loads(o, r, D))
C, retries = tm.bucket_capacity(width, C0, 64 * N)
assert width == want_width and (C, retries) == want_C
assert retries > own_retries or rank == 0, (retries, own_retries)
win_slot, _ = tm.bucket_slots(o, r, D, width)
for name, x in planes.items():
    xl = x[rank:rank + 1]
    recv = tm.exchange(send_planes(xl, win_slot, width, fills[name]))
    assert recv.shape == (1, D * width) + x.shape[2:], recv.shape
    assert torch.equal(recv[0], want[name][0]), name
    back = tm.exchange(recv.reshape((1, D, width) + x.shape[2:]))
    assert torch.equal(back[0], want[name][1]), name
    routed = win_slot[0] >= 0
    assert int(routed.sum()) == int(r.sum())
    assert torch.equal(back[0][win_slot[0][routed]], xl[0][routed]), name
agreed = mh.allgather_ints([width, C, retries])
assert (agreed == agreed[0]).all(), agreed

got = drive(MeshStreamingSpectrum(mesh, K, 400), mine)
for key in ("drains", "purged", "retries", "variants"):
    assert got[key] == ref[key], (key, got[key], ref[key])
for a, b in zip(got["lookup"], ref["lookup"]):
    assert np.array_equal(a, mine(b))
for key in ("table", "after"):
    for a, b in zip(got[key], ref[key]):
        assert a.dtype == b.dtype and np.array_equal(a, b), key
for a, b in zip(got["set"], ref["set"]):
    assert np.array_equal(a, b[..., rank:rank + 1, :])
print("OK", rank, retries, ref["purged"], ref["variants"])
"""


@pytest.mark.parametrize("n", [2, 4])
def test_exchange_across_processes(n):
    outs = run_ranks(lambda coord, r: [sys.executable, "-c", _RANK, coord,
                                       str(n), str(r)], n)
    said = [out.split() for out, _ in outs]
    assert [s[:2] for s in said] == [["OK", str(r)] for r in range(n)]
    # the same retries, purged singletons and variants on every rank
    assert len({tuple(s[2:]) for s in said}) == 1
    assert int(said[0][2]) >= 1


@pytest.fixture(scope="module")
def skewed(tmp_path_factory):
    """3,000 reads from a 1.5 kb genome with a Poisson(0.5) count of errors
    a read, then 300 random reads: 100 bp in the file's first half and 50
    bp in its second, so that rank 1's half holds more reads."""
    d = tmp_path_factory.mktemp("nprocs_stream")
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, 1500, dtype=np.uint8)
    path = str(d / "skewed.fastq")
    with open(path, "wb") as f:
        for i in range(3300):
            n = 100 if i < 1200 else 50
            if i < 3000:
                s = int(rng.integers(0, 1500 - n))
                read = genome[s:s + n].copy()
                for _ in range(rng.poisson(0.5 * n / 100)):
                    read[int(rng.integers(0, n))] = rng.integers(0, 4)
            else:
                read = rng.integers(0, 4, n, dtype=np.uint8)
            f.write(b"@s%d\n%s\n+\n%s\n" % (i, acgt[read].tobytes(),
                                            b"I" * n))
    return path


CASES = {"streaming": STREAM, "pressure": STREAM + ["--streaming-parts",
                                                    "2000"]}


def _outputs(prefix):
    d, base = os.path.split(prefix)
    return {n[len(base):]: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith(base + "-")}


def _job(module, case, skewed, out):
    outs = app_ranks(module, CASES[case] + ["--out", out] + BASE
                     + ["31", skewed], 2)
    return _outputs(out), [e for _, e in outs]


@pytest.fixture(scope="module")
def jax_runs(skewed, tmp_path_factory):
    """The JAX app's jobs at --nprocs 2, started together."""
    d = tmp_path_factory.mktemp("nprocs_jax")
    with ThreadPoolExecutor(len(CASES)) as pool:
        runs = pool.map(lambda c: _job("kmernator_tpu.apps.filter_reads", c,
                                       skewed, str(d / c)), CASES)
        return dict(zip(CASES, runs))


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_two_processes(skewed, jax_runs, tmp_path, case):
    got, logs = _job("kmernator_tpu_torch.apps.filter_reads", case, skewed,
                     str(tmp_path / "port"))
    want, jax_logs = jax_runs[case]
    assert want and got == want
    assert len(got["-MinDepth2-skewed.fastq"]) > 100000
    streamed = [STREAMED.findall(e) for e in logs]
    assert streamed == [STREAMED.findall(e) for e in jax_logs]
    (r0, n0, total), (r1, n1, _) = streamed[0][0], streamed[1][0]
    assert (r0, r1) == ("0", "1") and int(n0) + int(n1) == int(total) == 3300
    # 50 bp reads in rank 1's half: about 400 a 0.05 MB chunk against 220
    assert int(n1) > int(n0) + 4 * 128
    purged = [PURGED.findall(e) for e in logs]
    assert purged == [PURGED.findall(e) for e in jax_logs]
    if case == "pressure":
        assert purged[0] == purged[1] and int(purged[0][0]) > 0
    else:
        assert purged == [[], []]
        out = str(tmp_path / "host")
        assert jax_app.run(["--jax-platform", "cpu", "--out", out] + BASE
                           + ["31", skewed]) == 0
        assert _outputs(out) == got
