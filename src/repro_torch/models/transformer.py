"""Decoder stack: embedding -> a Python loop over blocks -> norm -> head.

Counterpart of ``repro.models.transformer`` for the stacks the paged engine
serves: full attention with a dense MLP (``attn_mlp``) or a token-dropping
MoE FFN (``attn_moe``), sliding-window attention (``local_attn``), Mamba2
(``ssm``) and RG-LRU (``rglru``) blocks, in any pattern. Where the JAX
package stacks each pattern position's parameters and runs ``lax.scan``
over super-blocks, the port keeps one parameter dict per layer, in layer
order, and loops over them.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.models import griffin, ssm
from repro_torch.models.layers import (attention_apply, attention_decode,
                                       kv_quant, mlp_apply, moe_apply,
                                       norm_apply, paged_rows)

VOCAB_PAD = 256
PAGEABLE_KINDS = ("attn_mlp", "attn_moe")   # full-attention page pools
WINDOW_KINDS = ("local_attn",)          # sliding-window page pools
STATE_KINDS = ("ssm", "rglru")          # fixed-size per-slot state
SERVABLE_KINDS = PAGEABLE_KINDS + WINDOW_KINDS + STATE_KINDS


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


def block_apply(cfg, kind: str, p, x: torch.Tensor, prefix=None,
                length=None):
    """Full-sequence block of ``kind``. Returns (x, cache entry): {"k",
    "v"} (B, S, KV, D) in the cache storage dtype for the attention kinds
    (``prefix``: see ``layers.attention_apply``), the decode state for the
    recurrent ones, whose updates past ``length`` (real tokens of a
    right-padded bucket) are the identity. ``ssm`` blocks have no FFN
    sublayer; ``attn_moe`` blocks route every row, bucket padding too,
    through ``moe_apply``."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        a, cache = ssm.ssm_apply(cfg, p["mixer"], h, return_state=True,
                                 length=length)
        return x + a, cache
    if kind == "rglru":
        a, cache = griffin.rglru_apply(cfg, p["mixer"], h, return_state=True,
                                       length=length)
    else:
        window = cfg.hybrid.window if kind == "local_attn" else 0
        a, (k, v) = attention_apply(cfg, p["attn"], h, prefix=prefix,
                                    window=window)
        cache = {"k": kv_quant(cfg, k), "v": kv_quant(cfg, v)}
    x = x + a
    return x + ffn_apply(cfg, kind, p, norm_apply(p["ln2"], x, cfg.norm)), \
        cache


def ffn_apply(cfg, kind: str, p, h: torch.Tensor) -> torch.Tensor:
    """The FFN sublayer: ``moe_apply`` on an ``attn_moe`` block, else the
    dense MLP."""
    if kind == "attn_moe":
        return moe_apply(cfg, p["moe"], h)
    return mlp_apply(cfg, p["mlp"], h)


def block_decode(cfg, kind: str, p, x: torch.Tensor, cache,
                 pos: torch.Tensor, block_table: torch.Tensor,
                 win_block_table: Optional[torch.Tensor], rows, win_rows):
    """Decode step of one block. Attention kinds write their pools in place
    (``local_attn`` through ``win_block_table``, with the window; ``rows``
    / ``win_rows``: ``layers.paged_rows`` of the two tables, None for a
    table the stack has no layer on) and return (x, None); recurrent kinds
    read their state and return (x, new state): plain for T == 1,
    checkpointed for T > 1 (see ``griffin.rglru_decode``,
    ``ssm.ssm_decode``). An ``attn_moe`` block routes every row of the
    step, dead slots' too, as the JAX package's step does."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    new = None
    if kind == "ssm":
        a, new = ssm.ssm_decode(cfg, p["mixer"], h, cache)
        return x + a, new
    if kind == "rglru":
        a, new = griffin.rglru_decode(cfg, p["mixer"], h, cache)
    elif kind == "local_attn":
        a, _ = attention_decode(cfg, p["attn"], h, cache, pos,
                                win_block_table, win_rows,
                                window=cfg.hybrid.window)
    else:
        a, _ = attention_decode(cfg, p["attn"], h, cache, pos, block_table,
                                rows)
    x = x + a
    return x + ffn_apply(cfg, kind, p, norm_apply(p["ln2"], x, cfg.norm)), \
        new


def stack_apply(cfg, blocks, x: torch.Tensor, *, prefix_kv=None,
                prefix_len: int = 0, length=None):
    """Run every layer over the prompt. Returns (x, per-layer cache
    entries). ``prefix_kv`` (per layer {"k", "v"} (B, Pb, KV, D) in the
    cache dtype) with ``prefix_len`` switches every layer to suffix-only
    prefill against that reused KV (``layers.attention_apply``; full
    attention stacks only); the returned k/v are then the suffix's.
    ``length``: real tokens of a right-padded bucket, for the recurrent
    blocks' states."""
    kinds = layer_kinds(cfg)
    if prefix_kv is not None and set(kinds) - set(PAGEABLE_KINDS):
        raise ValueError(f"prefix reuse needs an attention-only stack, got "
                         f"{sorted(set(kinds))}")
    caches = []
    for j, (kind, p) in enumerate(zip(kinds, blocks)):
        pref = None if prefix_kv is None else (
            prefix_kv[j]["k"], prefix_kv[j]["v"], prefix_len)
        x, c = block_apply(cfg, kind, p, x, prefix=pref, length=length)
        caches.append(c)
    return x, caches


def stack_decode(cfg, blocks, x: torch.Tensor, caches, pos: torch.Tensor,
                 block_table: torch.Tensor,
                 win_block_table: Optional[torch.Tensor] = None,
                 state_out=None):
    """One decode step through every layer. Pools change in place. A
    recurrent layer's new state goes, in place, into its cache entry (T ==
    1) or, for a T > 1 verify block, into ``state_out[j]`` (fixed (B, T,
    ...) buffers) when given. Returns (x, per-layer entries: the caches,
    with a T > 1 block's checkpointed states in place of the recurrent
    layers' when no ``state_out`` takes them)."""
    T = x.shape[1]
    kinds = layer_kinds(cfg)
    # where the step's rows write, once for each table (every layer on a
    # table writes the same pool rows)
    rows = win_rows = None
    for kind, c in zip(kinds, caches):
        if kind in PAGEABLE_KINDS and rows is None:
            rows = paged_rows(block_table, pos, T, c["k"].shape[1])
        if kind in WINDOW_KINDS and win_rows is None:
            win_rows = paged_rows(win_block_table, pos, T, c["k"].shape[1])
    out = list(caches)
    for j, (kind, p, c) in enumerate(zip(kinds, blocks, caches)):
        x, new = block_decode(cfg, kind, p, x, c, pos, block_table,
                              win_block_table, rows, win_rows)
        if new is None:
            continue
        dst = c if T == 1 else (None if state_out is None else state_out[j])
        if dst is None:
            out[j] = new
        else:
            for name, t in new.items():
                dst[name].copy_(t)
    return x, out
