"""Model API for serving: init / prefill / decode_step / paged_cache_init.

Counterpart of the serving half of ``repro.models.api``. Parameters are a
plain dict: ``embed`` (Vp, d), ``final_norm``, ``head`` (d, Vp) unless the
embeddings are tied, and ``blocks`` — one dict per layer in order, with the
JAX package's names and shapes (``repro_torch.convert`` builds it from a JAX
tree).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import norm_apply


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_params(cfg, generator: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn on ``device`` from ``generator`` (which must
    live on that device), with the JAX ``Maker``'s scales: N(0, 1) * scale in
    fp32, cast to the model dtype; norms are ones (fp32), biases zeros."""
    dt = _dtype(cfg.dtype)
    device = torch.device(device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def norm(d):
        p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
        return p

    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    vp = tfm.padded_vocab(cfg.vocab)
    blocks = []
    for _ in tfm.layer_kinds(cfg):
        attn = {"wq": normal((d, h, hd), d ** -0.5),
                "wk": normal((d, kv, hd), d ** -0.5),
                "wv": normal((d, kv, hd), d ** -0.5),
                "wo": normal((h, hd, d), (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=zeros((h, hd)), bk=zeros((kv, hd)),
                        bv=zeros((kv, hd)))
        mlp = {"wi": normal((d, f), d ** -0.5), "wo": normal((f, d), f ** -0.5)}
        if cfg.gated_ffn:
            mlp["wg"] = normal((d, f), d ** -0.5)
        blocks.append({"ln1": norm(d), "attn": attn, "ln2": norm(d),
                       "mlp": mlp})
    p = {"embed": normal((vp, d), 0.02), "final_norm": norm(d),
         "blocks": blocks}
    if not cfg.tie_embeddings:
        p["head"] = normal((d, vp), d ** -0.5)
    return p


def _logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Head matmul in the model dtype, then fp32."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ w).float()


def prefill(cfg, params, tokens: torch.Tensor, *,
            length: Optional[torch.Tensor] = None, prefix_kv=None,
            prefix_len: int = 0):
    """Run the whole (bucket-padded) prompt. tokens: (B, S) int64; length:
    None or (B,) count of real tokens. Returns (logits (B, Vp) fp32 at
    position length - 1 only, per-layer {"k", "v"} (B, S, KV, D) in the
    cache dtype, next position (B,) int32).

    ``prefix_kv`` (per layer {"k", "v"} (B, Pb, KV, D), cache dtype) and
    ``prefix_len`` (a host int): suffix-only prefill — ``tokens`` and
    ``length`` describe only the prompt after a prefix whose KV is reused
    from the page pools; positions start at prefix_len. The returned k/v
    are the suffix's and the returned position counts suffix tokens
    (callers add prefix_len)."""
    B, S = tokens.shape
    x = params["embed"][tokens]
    x, caches = tfm.stack_apply(cfg, params["blocks"], x,
                                prefix_kv=prefix_kv, prefix_len=prefix_len)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    if length is None:
        length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=x.device).expand(B)
    idx = (length.long() - 1).clamp(0, S - 1)
    xl = x[torch.arange(B, device=x.device), idx]          # (B, d)
    return _logits(cfg, params, xl), caches, length


def decode_step(cfg, params, cache: List[Dict[str, torch.Tensor]],
                tokens: torch.Tensor, pos: torch.Tensor, *,
                block_table: torch.Tensor):
    """tokens: (B, T) int64, token t of request b at position pos[b] + t;
    pos: (B,) int32; block_table: (B, n_blocks) int32 into the page pools
    of ``paged_cache_init`` (updated in place). Returns (logits, cache):
    (B, Vp) fp32 for T == 1, (B, T, Vp) for T > 1."""
    x = params["embed"][tokens]
    x = tfm.stack_decode(cfg, params["blocks"], x, cache, pos, block_table)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    logits = _logits(cfg, params, x)
    return (logits[:, 0] if tokens.shape[1] == 1 else logits), cache


def paged_cache_init(cfg, num_pages: int, page_size: int, *,
                     device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Per-layer {"k", "v"} page pools (num_pages, page_size, KV, D), zeros —
    never uninitialized memory: the kernel's invariance to pool garbage
    (masked keys get probability exactly 0) assumes finite contents."""
    dt = _dtype(cfg.kv_cache_dtype)
    shape = (num_pages, page_size, cfg.kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in tfm.layer_kinds(cfg)]
