"""Explicit device choice for the port.

Takes the place of the JAX package's platform handling (`--jax-platform`,
`utils/jaxconfig.py`). The device is always named by the caller: `cuda`
without a visible GPU raises, and nothing moves to the CPU on its own.
"""
from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str = "cuda") -> torch.device:
    """'cuda' or 'cpu' -> torch.device. 'cuda' requires a visible GPU."""
    if name not in DEVICES:
        raise ValueError("--device must be one of %s, got %r"
                         % ("|".join(DEVICES), name))
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device "
                           "is visible; pass --device cpu to run the plain "
                           "PyTorch versions on the CPU")
    return torch.device(name)
