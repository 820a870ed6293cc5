"""Decode policy, greedy row only: the counterpart of the temperature-0 path
of ``repro.runtime.sampling`` (argmax over the real vocabulary; the padded
vocabulary tail never wins). Temperature, top-k and top-p are not ported
yet."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """argmax over ``logits[..., :vocab]`` (first index on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits[..., :vocab], dim=-1)
