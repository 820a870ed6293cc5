"""PyTorch + CUDA port of the serving stack in ``repro`` (the JAX package).

The port mirrors the JAX package's module names (``configs``, ``kernels``,
``models``, ``runtime``, ``launch``) and imports nothing of it: what it needs
from the JAX side's jax-free modules it keeps as its own copy. Its entry
points run on a CUDA device unless the caller asks for the CPU
(``device="cpu"``), where every kernel is replaced by its plain PyTorch
version; ``resolve_device`` is the one place that decides.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no CUDA
    device is present (entry points never fall back to the CPU on their
    own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev
