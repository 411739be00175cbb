"""PyTorch/CUDA port of the ``repro`` package.

The JAX package under ``src/repro`` is the reference; this package
mirrors its module layout and names so each counterpart is easy to find,
and never imports ``jax`` or anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(as the CPU tests do). Without CUDA and without an explicit ``cpu``
they raise: nothing here carries on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device on a machine without CUDA
    raises; only an explicit ``"cpu"`` runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
