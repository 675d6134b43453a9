"""kmernator_tpu_torch/parallel/multihost.py: the host collectives and
gathered writes of the JAX module (the checks of tests/test_multihost.py:
78-125 without its sharded table, which needs D > 1), in two gloo
processes on the CPU; the size-1 short paths with no process group; and
the copy that takes the place of a rename across filesystems."""
import errno
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kmernator_tpu_torch.parallel import multihost as mh

from torch_threads import ONE_THREAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TWO = r"""
import os, sys
import numpy as np
import torch
rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from kmernator_tpu_torch.parallel import multihost as mh
assert mh.initialize("127.0.0.1:" + port, 2, rank) == (rank, 2)
assert os.environ["KMERNATOR_TPU_RANK"] == str(rank)
assert mh.my_partition(5) == (slice(0, 3) if rank == 0 else slice(3, 5))
got = mh.allgather_ints([rank, 10 * rank + 1])
assert got.dtype == np.int64 and got.tolist() == [[0, 1], [1, 11]], got
assert mh.allreduce_max_int(5 - 3 * rank) == 5
host = mh.allgather_host(torch.tensor([rank, rank + 10]))
assert host.tolist() == [0, 10, 1, 11], host
assert mh.allgather_host(np.full((1, 2), rank)).tolist() == [[0, 0], [1, 1]]
assert mh.allgather_strings([["b", "a"], ["c", "a", "d"]][rank]) == [
    "a", "b", "c", "d"]
try:
    mh.allgather_strings(["x" * 100], max_bytes=64)
except ValueError:
    pass
else:
    raise AssertionError("an oversized key set must raise")
blobs = mh.allgather_blobs([b"zero", b"one" + bytes(range(97))][rank],
                           max_bytes=64)
assert blobs == [b"zero", (b"one" + bytes(range(97)))[-56:]], blobs
assert mh.allgather_blobs(b"", max_bytes=64) == [b"", b""]
mh.write_gathered(os.path.join(d, "gathered.txt"),
                  ("rank%d\n" % rank).encode())
# file-backed: rank 0 has data, rank 1 an empty part; then both have data
part = os.path.join(d, "local-%d.part" % rank)
with open(part, "wb") as f:
    f.write(b"part of rank %d\n" % rank)
mh.write_gathered_file(os.path.join(d, "one.txt"),
                       part if rank == 0 else None)
part2 = os.path.join(d, "local2-%d.part" % rank)
with open(part2, "wb") as f:
    f.write(b"second of rank %d\n" % rank)
mh.write_gathered_file(os.path.join(d, "both.txt"), part2)
mh.barrier()
print("OK", rank)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_processes(tmp_path):
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD)
    procs = [subprocess.Popen([sys.executable, "-c", _TWO, str(r), port,
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        assert out.split() == ["OK", str(r)]
    read = lambda name: open(tmp_path / name, "rb").read()
    assert read("gathered.txt") == b"rank0\nrank1\n"
    assert read("one.txt") == b"part of rank 0\n"
    assert read("both.txt") == b"second of rank 0\nsecond of rank 1\n"
    # every part was moved into place or concatenated, then deleted
    assert sorted(os.listdir(tmp_path)) == ["both.txt", "gathered.txt",
                                            "local-1.part", "one.txt"]


def test_one_process_touches_no_process_group(tmp_path):
    """At one process every helper takes the JAX module's size-1 path and
    nothing initialises torch.distributed."""
    assert not dist.is_initialized()
    assert mh.initialize("127.0.0.1:1", 1, 0) == (0, 1)
    assert mh.initialize() == (0, 1)
    assert (mh.process_index(), mh.process_count()) == (0, 1)
    assert mh.my_partition(7) == slice(0, 7)
    got = mh.allgather_ints([3, 4])
    assert got.dtype == np.int64 and got.tolist() == [[3, 4]]
    assert mh.allreduce_max_int(9) == 9
    assert mh.allgather_host(torch.arange(3)).tolist() == [0, 1, 2]
    assert mh.allgather_strings(["b", "a", "b"]) == ["a", "b"]
    assert mh.allgather_blobs(b"x" * 100, max_bytes=16) == [b"x" * 100]
    mh.write_gathered(str(tmp_path / "g.txt"), b"data")
    part = tmp_path / "p.part"
    part.write_bytes(b"moved")
    mh.write_gathered_file(str(tmp_path / "f.txt"), str(part))
    mh.write_gathered_file(str(tmp_path / "empty.txt"), None)
    mh.barrier()
    assert (tmp_path / "g.txt").read_bytes() == b"data"
    assert (tmp_path / "f.txt").read_bytes() == b"moved"
    assert (tmp_path / "empty.txt").read_bytes() == b""
    assert not part.exists()
    assert not dist.is_initialized()


def test_gathered_file_across_filesystems(tmp_path, monkeypatch):
    """A part made under TMPDIR and an output on another filesystem: the
    rename raises EXDEV, and the part is copied into place and deleted.
    Any other error of the rename still raises."""
    part = tmp_path / "p.part"
    part.write_bytes(b"across filesystems\n" * 1000)
    calls = []

    def cross_device(src, dst):
        calls.append((src, dst))
        raise OSError(errno.EXDEV, "Invalid cross-device link")

    monkeypatch.setattr(os, "replace", cross_device)
    out = tmp_path / "out.fastq"
    mh.write_gathered_file(str(out), str(part))
    assert calls == [(str(part), str(out))]
    assert out.read_bytes() == b"across filesystems\n" * 1000
    assert not part.exists()

    def denied(src, dst):
        raise OSError(errno.EACCES, "Permission denied")

    monkeypatch.setattr(os, "replace", denied)
    part.write_bytes(b"kept")
    with pytest.raises(PermissionError):
        mh.write_gathered_file(str(tmp_path / "other"), str(part))
    assert part.read_bytes() == b"kept"
