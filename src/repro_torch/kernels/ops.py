"""The kernel seam: dispatch on the tensor's device, nothing else.

A CPU tensor goes to the plain PyTorch version in ``ref``; a CUDA tensor goes
to the hand-written CUDA kernel, whose wrapper launches it or raises. There
is no fallback: a kernel that fails to build or launch is an error, never a
silent detour through the plain version.

``seam_hook``: None, or what the dry-run's cost mode sets
(``analysis.op_cost.CostMode(seams="kernel")``) while it traces on
CPU-device fakes: a CPU call then goes through ``seam_hook(name, plain,
args, kwargs)``, which runs the plain version uncounted and counts the
call as the work of kernel ``name``, what the card runs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import attention as _attention
from repro_torch.kernels import conv_im2col as _conv
from repro_torch.kernels import gemm_os as _gemm
from repro_torch.kernels import maxpool as _maxpool
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import reshuffle as _reshuffle
from repro_torch.kernels import sampler as _sampler

seam_hook = None


def _plain(name: str, fn, *args, **kwargs):
    """Kernel ``name``'s plain version ``fn`` on CPU tensors, through
    ``seam_hook`` when it is set."""
    if seam_hook is not None:
        return seam_hook(name, fn, args, kwargs)
    return fn(*args, **kwargs)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_valid=None, q_offset: int = 0,
              window: int = 0) -> torch.Tensor:
    """Fused flash-MHA (q (B,Sq,H,D), k/v (B,Sk,KV,D)), q[:, 0] at absolute
    position ``q_offset``, with a sliding-window band of ``window`` keys
    when > 0; see ``kernels.attention.mha``."""
    if q.device.type == "cpu":
        return _plain("mha", ref.mha_ref, q, k, v, causal=causal,
                      kv_valid=kv_valid, q_offset=q_offset, window=window)
    return _attention.mha(q, k, v, causal=causal, kv_valid=kv_valid,
                          q_offset=q_offset, window=window)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor, lengths,
                    *, kv_scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Flash-decode over a paged KV pool; see
    ``kernels.paged_attention.paged_attention``."""
    if q.device.type == "cpu":
        return _plain("paged_attention", ref.paged_attention_ref, q,
                      k_pool, v_pool, block_table, lengths,
                      kv_scale=kv_scale, window=window)
    return _paged.paged_attention(q, k_pool, v_pool, block_table, lengths,
                                  kv_scale=kv_scale, window=window)


def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None
           ) -> torch.Tensor:
    """Output-stationary matmul (Voltra C1); see ``kernels.gemm_os``."""
    if x.device.type == "cpu":
        return _plain("gemm_os", ref.gemm_ref, x, w, out_dtype=out_dtype)
    return _gemm.gemm_os(x, w, out_dtype=out_dtype)


def quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: float
                 ) -> torch.Tensor:
    """INT8 x INT8 -> INT32 accumulate -> fused quant epilogue -> INT8
    (Voltra C1 + C4)."""
    if x.device.type == "cpu":
        return _plain("gemm_os_int8", ref.gemm_ref, x, w,
                      quant_scale=scale)
    return _gemm.gemm_os(x, w, quant_scale=scale)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1
           ) -> torch.Tensor:
    """Implicit-im2col Conv2D (the AGU analogue), NHWC x RSCK, SAME
    padding; see ``kernels.conv_im2col``."""
    if x.device.type == "cpu":
        return _plain("conv_im2col", ref.conv2d_ref, x, w, stride=stride)
    return _conv.conv2d(x, w, stride=stride)


def maxpool2d(x: torch.Tensor, *, window: int = 2, stride: int = 2
              ) -> torch.Tensor:
    """VALID max-pool over NHWC (Sec. II-E); see ``kernels.maxpool``."""
    if x.device.type == "cpu":
        return _plain("maxpool", ref.maxpool2d_ref, x, window=window,
                      stride=stride)
    return _maxpool.maxpool2d(x, window=window, stride=stride)


def blocked_layout(x: torch.Tensor, cb: int = 128) -> torch.Tensor:
    """(H, W, C) -> (Cp/cb, H, W, cb), the reshuffler's C/cb HWC cb."""
    if x.device.type == "cpu":
        return _plain("blocked_layout", ref.blocked_layout_ref, x, cb)
    return _reshuffle.blocked_layout(x, cb)


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (N, M), the dedicated-transposer pass."""
    if x.device.type == "cpu":
        return _plain("tiled_transpose", ref.transpose_ref, x)
    return _reshuffle.tiled_transpose(x)


def sampler_noise(seed: torch.Tensor, rid: torch.Tensor, idx: torch.Tensor,
                  n: int, *, draw: int, bits: bool = False) -> torch.Tensor:
    """The sampler's Gumbel noise (or its raw bits) for each row's key
    (seed, rid, idx, draw); see ``kernels.sampler.sampler_noise``."""
    if seed.device.type == "cpu":
        return _plain("sampler_noise", ref.sampler_noise_ref, seed, rid,
                      idx, n, draw=draw, bits=bits)
    return _sampler.sampler_noise(seed, rid, idx, n, draw=draw, bits=bits)


# launch counters, by the name chip_smoke.py reports each kernel under:
# (function, attribute) — gemm_os counts its two datapaths apart
_COUNTERS = {
    "paged_attention": (_paged.paged_attention, "launches"),
    "mha": (_attention.mha, "launches"),
    "gemm_os": (_gemm.gemm_os, "launches"),
    "gemm_os_int8": (_gemm.gemm_os, "int8_launches"),
    "conv_im2col": (_conv.conv2d, "launches"),
    "maxpool": (_maxpool.maxpool2d, "launches"),
    "blocked_layout": (_reshuffle.blocked_layout, "launches"),
    "tiled_transpose": (_reshuffle.tiled_transpose, "launches"),
    "sampler_noise": (_sampler.sampler_noise, "launches"),
}


def launch_counts() -> dict:
    """Each CUDA kernel's launches so far in this process."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)


def add_launch_counts(delta: dict) -> None:
    """Add ``delta[name]`` to each named counter. A CUDA graph's replay
    launches the kernels it captured without calling their wrappers, so
    the engine that replays it adds the launches the graph holds."""
    for name, n in delta.items():
        fn, attr = _COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)
