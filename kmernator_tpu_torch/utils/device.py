"""Explicit device choice for the port.

Takes the place of the JAX package's platform handling (`--jax-platform`,
`utils/jaxconfig.py`). The device is always named by the caller: `cuda`
without a visible GPU raises, and nothing moves to the CPU on its own.
"""
from __future__ import annotations

from typing import List, Tuple

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


def _split_device(argv: List[str]) -> Tuple[str, List[str]]:
    """The name given by `--device NAME` in argv (default cuda, checked
    against DEVICES) and argv without that flag."""
    argv = list(argv)
    name = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        name = argv[i + 1]
        del argv[i:i + 2]
    if name not in DEVICES:
        raise ValueError("--device must be one of %s, got %r"
                         % ("|".join(DEVICES), name))
    return name, argv


def take_device(argv: List[str]) -> Tuple[torch.device, List[str]]:
    """The device named by `--device NAME` in argv (default cuda, through
    `resolve_device`) and argv without that flag."""
    name, argv = _split_device(argv)
    return resolve_device(name), argv


def drop_device(argv: List[str]) -> List[str]:
    """argv without `--device NAME`, for the apps that run on the host
    whichever device is named: the name is checked, not resolved, so they
    run where no GPU is visible, as their sources run anywhere."""
    return _split_device(argv)[1]
