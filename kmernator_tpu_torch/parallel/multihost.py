"""Multi-process runtime over torch.distributed: process lifecycle, host
collectives and gathered output.

Twin of kmernator_tpu/parallel/multihost.py (the role of ScopedMPIComm and
DistributedOfstreamMap, ref: src/MPIUtils.h:257-391,
src/DistributedOfstreamMap.h:67-412): rank-ordered output concatenation
(rank 0 first, apps/FilterReads-P.cpp:190-197) and the small host
collectives that keep a lockstep streaming build in step.

These helpers move host ints and bytes, so the process group is gloo, on
the card's host too. Rank and size come from torch.distributed when it is
initialised, else (0, 1); every helper keeps the JAX module's size-1 short
path, so a one-process run never touches torch.distributed.

Differences from the source:
- `initialize` calls `torch.distributed.init_process_group("gloo",
  init_method="tcp://" + coordinator, ...)` in place of
  `jax.distributed.initialize`, and registers the group's
  `destroy_process_group` to run at exit; `sync_global_devices` is
  `dist.barrier()`.
- `write_gathered_file` moves a part with `os.replace` and, where the part
  and the output lie on different filesystems (`EXDEV`), copies it and
  deletes the part; the source raises there.
- `all_to_all_rows` is new: the exchange that the JAX module's callers
  run as a `jax.lax.all_to_all` over `global_mesh` (one row a process,
  so D is the number of processes; parallel/bam_exchange.py).
- `all_to_all_planes` is new: `all_to_all_rows` for a device tensor. The
  planes cross the host, since gloo takes CPU tensors: one copy to the
  host, one `all_to_all_single`, one copy back to the device. This is
  the transport of the shard exchange across processes
  (parallel/mesh.py `exchange`), not a fallback.
- `global_mesh(device)` is the port's `Mesh` of D = process_count()
  shards, one on each process's `device` (the JAX global mesh at one
  device a process). `allgather_host` takes a numpy array or a tensor
  on any device.
- Not ported: `to_global` and `to_local`. A process holds its own shard
  as a tensor on its device; no global array is assembled.
"""
from __future__ import annotations

import atexit
import errno
import os
import shutil
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from kmernator_tpu_torch.utils import timers


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """ref: ScopedMPIComm ctor. No-op when running single-process."""
    if num_processes is None:
        num_processes = int(os.environ.get("KMERNATOR_TPU_NPROCS", "1"))
    if num_processes > 1:
        dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                                world_size=num_processes, rank=process_id)
        # a group left to the interpreter's teardown can abort the process
        # at exit ("terminate called without an active exception", seen
        # on a loaded host); one destroyed first does not
        atexit.register(dist.destroy_process_group)
    os.environ["KMERNATOR_TPU_RANK"] = str(process_index())
    return process_index(), process_count()


def global_mesh(device="cuda"):
    """The mesh over every process: D = process_count() shards, this
    process's one on `device` (parallel/mesh.py `Mesh`)."""
    from kmernator_tpu_torch.parallel.mesh import Mesh
    return Mesh(torch.device(device), process_count(), process_index(),
                process_count())


def load_partitioned_reads(paths: List[str], fastq_base_quality: int = 33,
                           output_base_quality: int = 33,
                           comment_stored: bool = True):
    """Each process parses its byte range of every input file
    (ref: ReadSet::appendAllFiles(files, rank, size))."""
    from kmernator_tpu_torch.io.reads import load_reads
    rank, size = process_index(), process_count()
    return load_reads(paths, fastq_base_quality, output_base_quality,
                      comment_stored,
                      byte_range=(rank, size) if size > 1 else None)


def barrier() -> None:
    """Every process reaches this point before any goes on (the JAX
    module's `sync_global_devices`)."""
    if process_count() > 1:
        dist.barrier()


def my_partition(n_items: int) -> slice:
    rank, size = process_index(), process_count()
    per = (n_items + size - 1) // size
    return slice(rank * per, min((rank + 1) * per, n_items))


def _allgather(a: np.ndarray) -> np.ndarray:
    """[P, *a.shape]: every process's array of the same shape and dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allgather_host(x) -> np.ndarray:
    """Every process's rows of x (a numpy array, or a tensor on any
    device, of the same shape on each), concatenated in rank order along
    axis 0, as a numpy array."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if process_count() == 1:
        return a
    return np.concatenate(list(_allgather(a)), axis=0)


def all_to_all_rows(send: np.ndarray) -> np.ndarray:
    """[P, ...] -> [P, ...]: row p of `send` goes to rank p, and row s of
    the result came from rank s (one `all_to_all_single`; gloo takes any
    dtype, uint8 bytes included). Every rank passes the same shape."""
    if process_count() == 1:
        return send
    t = torch.from_numpy(np.ascontiguousarray(send))
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    return out.numpy()


def all_to_all_planes(planes: torch.Tensor) -> torch.Tensor:
    """all_to_all_rows for a tensor on any device: [P, ...] -> [P, ...],
    row p to rank p, row s of the result from rank s, on the planes'
    device. The rows cross the host (gloo takes CPU tensors): a copy to
    the host, one all_to_all_single, a copy back. Every rank passes the
    same shape and dtype."""
    if process_count() == 1:
        return planes
    with timers.span("procs.all_to_all"):
        host = _planes_to_host(planes)
        timers.count("device.d2h_bytes", host.nbytes)
        timers.count("device.h2d_bytes", host.nbytes)
        with timers.span("procs.collective"):
            got = all_to_all_rows(host)
        return _planes_to_device(got, planes.device)


# the two copies of all_to_all_planes, functions of their own so that each
# can be timed apart from the collective

def _planes_to_host(planes: torch.Tensor) -> np.ndarray:
    return planes.cpu().numpy()


def _planes_to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def allreduce_max_int(v: int) -> int:
    """Host-level max across processes (to agree on loop trip counts —
    every process must issue the same collectives)."""
    if process_count() == 1:
        return int(v)
    t = torch.tensor([int(v)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t[0])


def allgather_ints(vals) -> np.ndarray:
    """[P, len(vals)] int64 matrix of every process's small int vector —
    the per-round handshake of the lockstep streaming build (has-data
    flags, padded lengths; ref: the empty-cycle consensus of
    MPIAllToAllMessageBuffer::finalize, src/MPIBuffer.h:922)."""
    a = np.asarray(vals, np.int64)
    if process_count() == 1:
        return a[None]
    return _allgather(a)


def allgather_strings(items: List[str], max_bytes: int = 1 << 16) -> List[str]:
    """Sorted union of string lists across processes (the reference's
    getGlobalKeySet, ref: src/DistributedOfstreamMap.h:149-168) — so every
    process opens the same output files in the same order."""
    if process_count() == 1:
        return sorted(set(items))
    blob = "\n".join(items).encode()
    if len(blob) > max_bytes:
        raise ValueError("key set too large for allgather buffer")
    buf = np.zeros(max_bytes, np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, np.uint8)
    out = set()
    for row in _allgather(buf):
        s = row.tobytes().rstrip(b"\x00").decode()
        out.update(p for p in s.split("\n") if p)
    return sorted(out)


def allgather_blobs(local: bytes, max_bytes: int = 1 << 20) -> List[bytes]:
    """Every process's byte blob, rank-ordered, delivered to all processes
    (a fixed-size allgather; oversized blobs keep their tail)."""
    if process_count() == 1:
        return [local]
    if len(local) > max_bytes - 8:
        local = local[-(max_bytes - 8):]
    buf = np.zeros(max_bytes, np.uint8)
    buf[:8] = np.frombuffer(np.int64(len(local)).tobytes(), np.uint8)
    buf[8:8 + len(local)] = np.frombuffer(local, np.uint8)
    out = []
    for row in _allgather(buf):
        n = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        out.append(row[8:8 + n].tobytes())
    return out


def _move(src: str, dst: str) -> None:
    """os.replace, or a copy and delete where src and dst lie on different
    filesystems (a part made under TMPDIR, an output elsewhere)."""
    try:
        os.replace(src, dst)
    except OSError as e:
        if e.errno != errno.EXDEV:
            raise
        shutil.copyfile(src, dst)
        os.unlink(src)


def _concatenate_parts(path: str, size: int) -> None:
    with open(path, "wb") as out:
        for r in range(size):
            p = "%s--part-%05d" % (path, r)
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out, 8 << 20)
            os.unlink(p)


def write_gathered_file(path: str, local_part: Optional[str]):
    """File-backed write_gathered: rank-ordered concatenation of per-rank
    part FILES, bounded memory for outputs too large to hold as bytes
    (the streaming x distributed output path; ref: DistributedOfstreamMap
    ::concatenateMPI, src/DistributedOfstreamMap.h:118).  Every process
    must call this for the same `path`; `local_part` may be None for a
    rank with no data (an empty part)."""
    rank, size = process_index(), process_count()
    if size == 1:
        if local_part is None:
            open(path, "wb").close()
        else:
            _move(local_part, path)
        return
    part = "%s--part-%05d" % (path, rank)
    if local_part is None:
        open(part, "wb").close()
    else:
        _move(local_part, part)
    barrier()
    if rank == 0:
        _concatenate_parts(path, size)
    barrier()


def write_gathered(path: str, local_data: bytes):
    """Rank-ordered concatenated output: each process writes a rank temp
    file; process 0 concatenates in rank order (ref: DistributedOfstreamMap
    ::concatenateMPI + the rank0-overwrite-then-append ordering)."""
    rank, size = process_index(), process_count()
    if size == 1:
        with open(path, "wb") as f:
            f.write(local_data)
        return
    with open("%s--part-%05d" % (path, rank), "wb") as f:
        f.write(local_data)
    # all processes must finish writing before rank 0 concatenates
    barrier()
    if rank == 0:
        _concatenate_parts(path, size)
    barrier()
