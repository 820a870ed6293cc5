"""Wrapper of the sampler's noise CUDA kernel (``csrc/sampler.cu``).

The noise of the categorical draw ``argmax(z + g)`` in
``runtime/sampling.py``: per row, ``jax.random.gumbel(key, (n,), float32)``
with jax's partitionable Threefry-2x32, the row's key folded from (seed,
rid, idx, draw) inside the kernel, all in one elementwise pass (the plain
version, ``ref.sampler_noise_ref``, takes a few hundred int64 tensor
passes). CUDA tensors only: ``kernels.ops.sampler_noise`` routes CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("sampler")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sampler_noise_launch.argtypes = [p, p, p, i, p, i, i, i, p]
    lib.sampler_noise_launch.restype = ctypes.c_int
    return lib


def sampler_noise(seed: torch.Tensor, rid: torch.Tensor, idx: torch.Tensor,
                  n: int, *, draw: int, bits: bool = False) -> torch.Tensor:
    """seed, rid, idx: (R,) int64 on CUDA (taken as uint32). Row r's key is
    ``fold_in(fold_in(fold_in(fold_in(key(seed[r]), rid[r]), idx[r]),
    draw)`` (``ref.row_keys``), folded inside the kernel. Returns (R, n)
    float32 Gumbel noise of that key, or with ``bits`` the raw uint32 bits
    as (R, n) int64 (a check of the hash)."""
    build.refuse_fake("sampler", seed, rid, idx)
    build.refuse_grad("sampler", seed, rid, idx)
    if not (seed.is_cuda and rid.is_cuda and idx.is_cuda):
        raise ValueError("sampler kernel: needs CUDA tensors (CPU tensors go "
                         "through repro_torch.kernels.ops)")
    R = seed.shape[0]
    ops_in = []
    for name, t in (("seed", seed), ("rid", rid), ("idx", idx)):
        if t.shape != (R,) or t.dtype != torch.int64:
            raise ValueError(f"sampler kernel: {name} must be ({R},) int64, "
                             f"got {tuple(t.shape)} {t.dtype}")
        ops_in.append(t.contiguous())
    out = torch.empty((R, n), dtype=torch.int32 if bits else torch.float32,
                      device=seed.device)
    err = build.launch_on(seed.device, _lib().sampler_noise_launch,
                          *(t.data_ptr() for t in ops_in), int(draw),
                          out.data_ptr(), R, n, int(bits))
    if err:
        raise RuntimeError(f"sampler kernel launch failed: CUDA error {err}")
    sampler_noise.launches += 1
    return out.to(torch.int64) & 0xFFFFFFFF if bits else out


sampler_noise.launches = 0
