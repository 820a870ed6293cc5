"""Decoder stack: embedding -> a Python loop over blocks -> norm -> head.

Counterpart of ``repro.models.transformer`` for full-attention stacks
(``attn_mlp`` blocks). Where the JAX package stacks each pattern position's
parameters and runs ``lax.scan`` over super-blocks, the port keeps one
parameter dict per layer, in layer order, and loops over them.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.models.layers import (attention_apply, attention_decode,
                                       kv_quant, mlp_apply, norm_apply)

VOCAB_PAD = 256
SERVABLE_KINDS = ("attn_mlp",)


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def pattern_for(cfg) -> Tuple[str, ...]:
    if cfg.is_encdec:
        return ("dec",)
    if cfg.family == "ssm":
        return ("ssm",)
    if cfg.family == "hybrid":
        return cfg.hybrid.pattern
    if cfg.moe is not None and cfg.moe.num_experts > 0:
        period = cfg.moe.moe_every
        return tuple(["attn_mlp"] * (period - 1) + ["attn_moe"])
    return ("attn_mlp",)


def layer_plan(cfg) -> Tuple[int, Tuple[str, ...]]:
    """(n_super, tail_kinds): whole periods of the pattern, then the rest."""
    pat = pattern_for(cfg)
    p = len(pat)
    return cfg.num_layers // p, pat[: cfg.num_layers % p]


def layer_kinds(cfg) -> List[str]:
    """Block kind of every layer in order (super-blocks, then the tail);
    raises for a kind the port has no layers for yet."""
    n_super, tail = layer_plan(cfg)
    kinds = list(pattern_for(cfg)) * n_super + list(tail)
    bad = sorted(set(kinds) - set(SERVABLE_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kind(s) {bad} are not ported yet (the port "
            f"has {SERVABLE_KINDS})")
    return kinds


def block_apply(cfg, p, x: torch.Tensor, prefix=None):
    """Full-sequence attn_mlp block (``prefix``: see
    ``layers.attention_apply``). Returns (x, {"k", "v"}) with k/v in the
    cache storage dtype."""
    a, (k, v) = attention_apply(cfg, p["attn"], norm_apply(p["ln1"], x,
                                                           cfg.norm),
                                prefix=prefix)
    x = x + a
    x = x + mlp_apply(cfg, p["mlp"], norm_apply(p["ln2"], x, cfg.norm))
    return x, {"k": kv_quant(cfg, k), "v": kv_quant(cfg, v)}


def block_decode(cfg, p, x: torch.Tensor, cache, pos: torch.Tensor,
                 block_table: torch.Tensor) -> torch.Tensor:
    """Paged decode step of one attn_mlp block (its pools change in place)."""
    a, _ = attention_decode(cfg, p["attn"], norm_apply(p["ln1"], x, cfg.norm),
                            cache, pos, block_table)
    x = x + a
    return x + mlp_apply(cfg, p["mlp"], norm_apply(p["ln2"], x, cfg.norm))


def stack_apply(cfg, blocks, x: torch.Tensor, *, prefix_kv=None,
                prefix_len: int = 0):
    """Run every layer over the prompt. Returns (x, per-layer {"k","v"}).
    ``prefix_kv`` (per layer {"k", "v"} (B, Pb, KV, D) in the cache dtype)
    with ``prefix_len`` switches every layer to suffix-only prefill against
    that reused KV (``layers.attention_apply``); the returned k/v are then
    the suffix's."""
    caches = []
    for j, p in enumerate(blocks):
        pref = None if prefix_kv is None else (
            prefix_kv[j]["k"], prefix_kv[j]["v"], prefix_len)
        x, c = block_apply(cfg, p, x, prefix=pref)
        caches.append(c)
    return x, caches


def stack_decode(cfg, blocks, x: torch.Tensor, caches, pos: torch.Tensor,
                 block_table: torch.Tensor) -> torch.Tensor:
    """One decode step through every layer; each layer's pools change in
    place."""
    for p, c in zip(blocks, caches):
        x = block_decode(cfg, p, x, c, pos, block_table)
    return x
