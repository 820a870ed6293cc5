"""Layer library, attention-only subset: rmsnorm/layernorm, rotary embedding,
GQA attention for prefill (flash-MHA kernel) and paged decode (flash-decode
kernel), KV-cache quantization and the gated MLP.

Counterpart of ``repro.models.layers``: plain functions on tensors with
parameter dicts of the same names and shapes (``wq`` (d, H, hd), ``wo``
(H, hd, d), ...), so a parameter tree converted from the JAX package
(``repro_torch.convert``) drives both packages through the same function.
The attention products go through ``kernels.ops`` (CUDA kernel on a CUDA
tensor, plain version on a CPU tensor); matmuls, norms and RoPE stay plain
PyTorch, as they stay plain jnp in the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def norm_apply(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm (or layernorm) in fp32, cast back to x's dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, H, D); positions: (..., S).
    Frequencies are exp(-log(theta) * i / half) in fp32, the JAX package's
    formula (not theta ** x, which rounds differently)."""
    half = x.shape[-1] // 2
    # made on the device (a host tensor copied over would sync each call)
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=x.device))
    i = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-log_theta * i / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    ang = ang[..., None, :]                             # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def kv_quant(cfg, x: torch.Tensor) -> torch.Tensor:
    """k/v -> cache storage dtype (int8: symmetric, static absmax bound)."""
    if cfg.kv_cache_dtype != "int8":
        return x.to(getattr(torch, cfg.kv_cache_dtype))
    q = torch.round(x.float() * (127.0 / cfg.kv_scale))
    return torch.clamp(q, -127, 127).to(torch.int8)


def kv_dequant(cfg, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.dtype != torch.int8:
        return x.to(dtype)
    return (x.float() * (cfg.kv_scale / 127.0)).to(dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd), as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _qkv(cfg, p: Params, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _out(p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    return o.flatten(-2) @ p["wo"].reshape(-1, p["wo"].shape[-1])


def attention_apply(cfg, p: Params, x: torch.Tensor):
    """Causal self-attention over the whole (bucket-padded) prompt through
    the flash-MHA kernel. Bucket padding sits after every real row, so
    causal masking alone keeps the real rows exact. Returns (out, (k, v))
    for the caller to build its cache from."""
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True)
    return _out(p, out), (k, v)


def attention_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, block_table: torch.Tensor):
    """Paged decode step. x: (B, T, d); pos: (B,) int32 position of the
    first new token; cache {"k", "v"}: (P, page, KV, D) page pools;
    block_table: (B, n_blocks) int32. The T new tokens' k/v are scattered
    token by token to page block_table[b, (pos+t) // page], row
    (pos+t) % page — rows past the table go to scratch page 0 — and the
    flash-decode kernel then attends through the block table. The pools are
    updated IN PLACE (``index_put_``), where the JAX package returns new
    pools: the port never copies a layer's pool. Returns (out, cache)."""
    B, T = x.shape[0], x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    pos_t = pos[:, None] + torch.arange(T, device=x.device,
                                        dtype=pos.dtype)[None, :]
    q = rope(q, pos_t, cfg.rope_theta)
    k = rope(k, pos_t, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    page = ck.shape[1]
    n_blk = block_table.shape[1]
    blk = (pos_t // page).long()
    phys = torch.gather(block_table, 1, blk.clamp(max=n_blk - 1)).long()
    phys = torch.where(blk < n_blk, phys, torch.zeros_like(phys))
    off = (pos_t % page).long()
    ck.index_put_((phys, off), kv_quant(cfg, k))
    cv.index_put_((phys, off), kv_quant(cfg, v))
    scale = cfg.kv_scale if ck.dtype == torch.int8 else None
    out = ops.paged_attention(q.contiguous(), ck, cv, block_table, pos + T,
                              kv_scale=scale)
    return _out(p, out), cache


def mlp_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP as the JAX package writes it: the activation goes on the
    ``wg`` branch and multiplies ``wi`` — act(x @ wg) * (x @ wi) — then
    ``wo``. Ungated: act(x @ wi) @ wo."""
    h = x @ p["wi"]
    if cfg.act == "silu":
        act = F.silu
    else:       # jax.nn.gelu's default is the tanh approximation
        def act(t):
            return F.gelu(t, approximate="tanh")
    h = act(x @ p["wg"]) * h if cfg.gated_ffn else act(h)
    return h @ p["wo"]
