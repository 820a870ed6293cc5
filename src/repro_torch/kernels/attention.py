"""Wrapper of the flash-MHA forward CUDA kernel (``csrc/mha.cu``).

The Hopper counterpart of ``repro.kernels.attention``: fused flash attention
with K in its natural layout, GQA, causal masking by absolute row, a traced
(B,) ``kv_valid``, fully masked rows -> 0, and a host-int ``q_offset`` (the
absolute position of query row 0: the suffix-only prefill against a cached
prefix, ``repro.models.layers.flash_attention(q_offset=)``). Same public signature and layouts
as the JAX ``mha`` (the TPU block sizes ``bq``/``bk`` have no counterpart:
the CUDA kernels' tiles are fixed). bfloat16 runs on the tensor cores
(wgmma fed by TMA), float32 on the FMA units (``csrc/mha.cu`` says why),
with its work laid out by ``f32_plan`` from shapes alone. CUDA tensors
only: ``kernels.ops.attention`` routes CPU tensors to ``ref.mha_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
F32_WARPS = 8         # warps of an fp32 CTA: row groups x key splits
F32_TILE_KEYS = 32    # keys of one warp's tile


def f32_pairs(Sq: int, causal: bool, q_offset: int = 0,
              window: int = 0) -> bool:
    """Whether the fp32 kernel pairs causal q blocks x and n - 1 - x in one
    CTA: where the key counts grow with the block, that levels them; a band
    that cuts any block (window < q_offset + Sq) makes most blocks sweep
    the same keys, and a pair would hold twice a lone block's work."""
    return causal and (window == 0 or window >= q_offset + Sq)


def _block_keys(blk: int, bq: int, Sk: int, causal: bool, q_offset: int,
                window: int) -> int:
    """Keys one q block sweeps: up to min(Sk, q_offset + its end) when
    causal (else all Sk), from the 32-key tile holding its first row's
    first band key when a window cuts it."""
    end = min(Sk, q_offset + (blk + 1) * bq) if causal else Sk
    start = 0
    if causal and window:
        start = max(q_offset + blk * bq - window + 1, 0) \
            // F32_TILE_KEYS * F32_TILE_KEYS
    return max(end - start, 0)


def f32_ctas(B: int, Sq: int, Sk: int, H: int, causal: bool, rg: int,
             q_offset: int = 0, window: int = 0
             ) -> List[List[Tuple[int, int, int, int]]]:
    """The fp32 kernel's work, CTA by CTA, as ``mha_f32_kernel`` lays it
    out: each CTA's list of (b, h, q block, keys), a q block being 16 * rg
    query rows and keys the ones its rows sweep: below min(Sk, q_offset +
    the block's end) when causal, else all Sk (``kv_valid`` may cut them on
    the card; the plan never reads it), and with a band from the 32-key
    tile that holds the first key of the block's first row's band. Paired
    (``f32_pairs``), CTA x of a head takes q blocks x and n - 1 - x (grid x
    = ceil(n / 2)), so that each sweeps about as many keys as the others
    (an offset adds q_offset keys to every block, so the pairs stay level);
    otherwise block x alone. A model of the layout for checks: the plan
    counts rounds with ``f32_heaviest``."""
    bq = 16 * rg
    n = -(-Sq // bq)
    pair = f32_pairs(Sq, causal, q_offset, window)
    ctas = []
    for b in range(B):
        for h in range(H):
            for x in range((n + 1) // 2 if pair else n):
                blocks = [x] if not pair or n - 1 - x == x else [x, n - 1 - x]
                ctas.append([(b, h, blk, _block_keys(blk, bq, Sk, causal,
                                                     q_offset, window))
                             for blk in blocks])
    return ctas


def f32_rounds(cta: List[Tuple[int, int, int, int]], rg: int) -> int:
    """Rounds of one CTA of ``f32_ctas``: a round stages 8 // rg tiles of
    32 keys, one per key split."""
    round_keys = F32_TILE_KEYS * F32_WARPS // rg
    return sum(-(-keys // round_keys) for *_, keys in cta)


def f32_heaviest(Sq: int, Sk: int, causal: bool, rg: int,
                 q_offset: int = 0, window: int = 0) -> int:
    """Rounds of the heaviest CTA of ``f32_ctas`` (all heads and batches
    alike), from each q block's key count without building the layout:
    paired, the most over the pairs (x, n - 1 - x) and a lone middle
    block; else the most over the blocks."""
    bq = 16 * rg
    round_keys = F32_TILE_KEYS * F32_WARPS // rg
    n = -(-Sq // bq)

    def rounds(blk: int) -> int:
        return -(-_block_keys(blk, bq, Sk, causal, q_offset, window)
                 // round_keys)
    if not causal:
        return rounds(0)
    if not f32_pairs(Sq, causal, q_offset, window):
        return max(rounds(x) for x in range(n))
    return max(rounds(x) + (rounds(n - 1 - x) if n - 1 - x != x else 0)
               for x in range((n + 1) // 2))


@functools.lru_cache(maxsize=256)
def f32_plan(B: int, Sq: int, Sk: int, H: int, D: int, causal: bool,
             sms: int, q_offset: int = 0, window: int = 0) -> int:
    """Row groups of 16 query rows per fp32 CTA, from shapes alone: 4 (8 //
    4 = 2 key splits a round), or 2 (4 key splits) where that takes fewer
    rounds on the busiest SM, counted as ceil(CTAs / SMs) times the
    heaviest CTA's rounds; ties go to 4, whose K/V tiles serve more rows.
    D >= 128 takes 4 only: two stages of a 4-split round (128 keys) would
    not fit in shared memory (at D = 256 one stage of a 2-split round
    fills it: the kernel keeps one stage there)."""
    best = None
    pair = f32_pairs(Sq, causal, q_offset, window)
    for rg in (4, 2) if D <= 64 else (4,):
        n = -(-Sq // (16 * rg))
        n_ctas = B * H * ((n + 1) // 2 if pair else n)
        cost = -(-n_ctas // sms) * f32_heaviest(Sq, Sk, causal, rg,
                                                q_offset, window)
        if best is None or cost < best[0]:
            best = (cost, rg)
    return best[1]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("mha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mha_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, f,
                                   i, p]
    lib.mha_fwd_launch.restype = ctypes.c_int
    lib.mha_fwd_launch_win.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                       i, i, f, i, i, p]
    lib.mha_fwd_launch_win.restype = ctypes.c_int
    return lib


def _require(ok: bool, msg: str, *args) -> None:
    """Raise with ``msg.format(*args)`` unless ``ok``; the message is built
    only on failure (its formatting would cost every call microseconds)."""
    if not ok:
        raise ValueError("mha kernel: " + msg.format(*args))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, kv_valid=None, q_offset: int = 0,
        window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D), one dtype (float32 or
    bfloat16), contiguous, H % KV == 0, D in (16, 32, 64, 128, 256).
    kv_valid: None (all Sk keys), an int, or a (B,) int32 tensor — only the
    first kv_valid[b] keys of sequence b attend. q_offset: a host int >= 0,
    the absolute position of q[:, 0] (causal row i sees keys <= q_offset +
    i; one offset for the whole batch). window: a host int >= 0; > 0
    (causal only) limits row i to keys > q_offset + i - window, the band of
    ``layers.flash_attention(window=)``. Returns (B, Sq, H, D)."""
    build.refuse_fake("mha", q, k, v, kv_valid)
    build.refuse_grad("mha", q, k, v, kv_valid)
    _require(q.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
             "q (B,Sq,H,D) and k, v (B,Sk,KV,D) of one shape, got {}, {}, "
             "{}", q.shape, k.shape, v.shape)
    B, Sq, H, D = q.shape
    _, Sk, KV, Dk = k.shape
    _require(k.shape[0] == B and Dk == D and H % KV == 0,
             "q {} does not fit k {}", q.shape, k.shape)
    _require(D in _HEAD_DIMS, "head dim {} not in {}", D, _HEAD_DIMS)
    dtype = _DTYPES.get(q.dtype)
    _require(dtype is not None and k.dtype == q.dtype and v.dtype == q.dtype,
             "dtypes {}/{}/{} (one of float32, bfloat16)", q.dtype, k.dtype,
             v.dtype)
    _require(isinstance(q_offset, int) and q_offset >= 0,
             "q_offset must be a host int >= 0, got {!r}", q_offset)
    _require(isinstance(window, int) and window >= 0
             and (causal or not window),
             "window must be a host int >= 0, and 0 unless causal: {!r}",
             window)
    dev = q.device
    _require(k.device == dev and v.device == dev, "q, k, v on {}, {}, {}",
             dev, k.device, v.device)
    _require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
             "q, k and v must be contiguous")
    _require((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0,
             "q, k and v must be 16-byte aligned")
    if kv_valid is None:
        valid_ptr = 0           # the kernel reads all Sk keys: no fill launch
    else:
        if isinstance(kv_valid, int):
            # filled on the device: no host copy, no sync
            valid = torch.full((B,), kv_valid, dtype=torch.int32, device=dev)
        else:
            valid = torch.as_tensor(kv_valid, dtype=torch.int32,
                                    device=dev).expand(B).contiguous()
        valid_ptr = valid.data_ptr()

    causal = bool(causal)
    rg = f32_plan(B, Sq, Sk, H, D, causal, build.sm_count(dev.index),
                  q_offset, window) if dtype == 0 else 0
    pair = f32_pairs(Sq, causal, q_offset, window) if dtype == 0 else False
    out = torch.empty_like(q)
    err = build.launch_on(dev, _lib().mha_fwd_launch_win, q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), valid_ptr,
                          out.data_ptr(), B, Sq, Sk, H, KV, D, dtype,
                          int(causal), q_offset, window, D ** -0.5, rg,
                          int(pair))
    if err:
        raise RuntimeError(f"mha kernel launch failed: CUDA error {err}")
    mha.launches += 1
    return out


mha.launches = 0
