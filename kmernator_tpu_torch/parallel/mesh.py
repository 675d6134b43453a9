"""The device mesh of the port: one device for now.

Twin of kmernator_tpu/parallel/mesh.py `make_mesh`. With one device the
owner hash, the bucket scatter and the all_to_all of the JAX mesh are the
identity, so the handle only names the device. D > 1 (owner_hash_cols,
_bucket_scatter_cols and the exchange over NCCL) is a later PR's work.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh; `size` devices along axis 'd'."""
    device: torch.device
    size: int = 1


def make_mesh(n_devices: int = 1, device="cuda") -> Mesh:
    if n_devices != 1:
        raise NotImplementedError(
            "kmernator_tpu_torch runs a mesh of one device; --mesh %d "
            "(owner hash, bucket scatter and all_to_all over NCCL) waits "
            "for the D > 1 PR" % n_devices)
    return Mesh(torch.device(device))
