"""Decoder stack (+ optional encoder): embedding -> a Python loop over
blocks -> norm -> head.

Counterpart of ``repro.models.transformer``: full attention with a dense
MLP (``attn_mlp``) or a token-dropping MoE FFN (``attn_moe``),
sliding-window attention (``local_attn``), Mamba2 (``ssm``) and RG-LRU
(``rglru``) blocks, in any pattern, and the encoder-decoder kinds: ``enc``
(non-causal self-attention + MLP) and ``dec`` (causal self-attention,
cross-attention to the encoder output, MLP). Where the JAX package stacks
each pattern position's parameters and runs ``lax.scan`` over
super-blocks, the port keeps one parameter dict per layer, in layer order,
and loops over them.

Two cache layouts, as the reference's: the paged engine's (page pools and
block tables; prefill returns each attention layer's exact-length k/v for
the engine to scatter) and the dense engine's (one lane a slot: prefill
pads full attention to ``max_len`` (``_grow``) and folds a window layer
into its ring (``_window_cache``)). The encoder-decoder kinds have the
dense layout only: cross-attention KV is per request, not paged.

Training runs ``stack_train`` / ``block_train``: no cache, attention
through the plain ``layers.flash_attention`` (autograd), the MoE blocks'
auxiliary losses summed over the layers, each period of the pattern
rematerialised as one unit per ``cfg.remat`` and the tail layers not at all
(the reference's ``_remat`` of its scan body); on a rank of a mesh its
``rules`` are a ``sharding.TrainRules``, whose sums and gathers autograd
differentiates. Every stack gathers a layer's split leaves at the start of
that layer (``rules.use``; the identity but on a sharded training or
dry-run rank), inside the remat region, and the context-parallel gathers
of the sequence (``rules.cp_gather``) run inside it too.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from repro_torch.models import griffin, ssm
from repro_torch.models.layers import (attention_apply, attention_decode,
                                       cross_kv, dense_rows, kv_quant,
                                       mlp_apply, moe_apply, norm_apply,
                                       paged_rows)
from repro_torch.parallel.sharding import NO_RULES, Rules

VOCAB_PAD = 256
PAGEABLE_KINDS = ("attn_mlp", "attn_moe")   # full-attention page pools
WINDOW_KINDS = ("local_attn",)          # sliding-window page pools
STATE_KINDS = ("ssm", "rglru")          # fixed-size per-slot state
# every kind the paged engine can host (the encoder-decoder kinds stay on
# the dense engine, as in the reference)
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
    """Block kind of every decoder layer in order (super-blocks, then the
    tail); the encoder's layers are ``cfg.enc_layers`` ``enc`` blocks."""
    n_super, tail = layer_plan(cfg)
    return list(pattern_for(cfg)) * n_super + list(tail)


def _grow(cfg, k: torch.Tensor, v: torch.Tensor, max_len: Optional[int]):
    """A full-attention prefill's k/v (B, S, KV, D) in the cache storage
    dtype, padded with zeros to ``max_len`` rows when given (the dense
    engine's lane)."""
    k, v = kv_quant(cfg, k), kv_quant(cfg, v)
    pad = max(0, (max_len or 0) - k.shape[1])
    if pad:
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    return {"k": k, "v": v}


def _window_cache(cfg, k: torch.Tensor, v: torch.Tensor, w: int):
    """The ring buffer (slot = position % w) of a local_attn layer from its
    prefill's k/v: the last w positions, zeros where the prompt is
    shorter."""
    k, v = kv_quant(cfg, k), kv_quant(cfg, v)
    S = k.shape[1]
    if S <= w:
        return {"k": F.pad(k, (0, 0, 0, 0, 0, w - S)),
                "v": F.pad(v, (0, 0, 0, 0, 0, w - S))}
    pos = torch.arange(S - w, S, device=k.device)
    out = {}
    for name, t in (("k", k), ("v", v)):
        ring = t.new_zeros((t.shape[0], w) + t.shape[2:])
        ring[:, pos % w] = t[:, pos]
        out[name] = ring
    return out


def block_apply(cfg, kind: str, p, x: torch.Tensor, prefix=None,
                length=None, enc_out=None, max_len=None,
                rules: Rules = NO_RULES):
    """Full-sequence block of ``kind``. Returns (x, cache entry). The
    attention kinds' entry is {"k", "v"} in the cache storage dtype:
    exact-length (B, S, KV, D) for the paged engine (``prefix``: see
    ``layers.attention_apply``), or with ``max_len`` the dense engine's
    lane (padded to max_len; a ``local_attn`` layer's window ring). A
    ``dec`` block adds its cross-attention lane {"xk", "xv"} (B, S_enc,
    KV, D) from ``enc_out``; an ``enc`` block has no entry (None). The
    recurrent kinds' entry is their decode state, whose updates past
    ``length`` (real tokens of a right-padded bucket) are the identity.
    ``ssm`` blocks have no FFN sublayer; ``attn_moe`` blocks route every
    row, bucket padding too, through ``moe_apply``. ``rules``: the
    tensor-parallel hooks, passed to the attention and the FFN."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        a, cache = ssm.ssm_apply(cfg, p["mixer"], h, return_state=True,
                                 length=length, rules=rules)
        return x + a, cache
    if kind == "rglru":
        a, cache = griffin.rglru_apply(cfg, p["mixer"], h, return_state=True,
                                       length=length, rules=rules)
    elif kind == "enc":
        a, _ = attention_apply(cfg, p["attn"], h, causal=False, rules=rules)
        cache = None
    else:
        window = cfg.hybrid.window if kind == "local_attn" else 0
        a, (k, v) = attention_apply(cfg, p["attn"], h, prefix=prefix,
                                    window=window, rules=rules)
        if rules.seq and max_len is not None:
            # a dense lane is split over the ranks as a whole: build it
            # from the whole k/v and keep the rank's rows of it
            k, v = rules.cp_gather(k), rules.cp_gather(v)
        cache = _window_cache(cfg, k, v, window) \
            if window and max_len is not None else _grow(cfg, k, v, max_len)
        if rules.seq and max_len is not None:
            cache = {name: rules.cp_own(t) for name, t in cache.items()}
    x = x + a
    if kind == "dec":
        hx = norm_apply(p["lnx"], x, cfg.norm)
        ck, cv = cross_kv(cfg, p["cross"], enc_out, rules)
        a, _ = attention_apply(cfg, p["cross"], hx, cross_kv=(ck, cv),
                               rules=rules)
        x = x + a
        cache.update(xk=kv_quant(cfg, rules.cp_own(ck)),
                     xv=kv_quant(cfg, rules.cp_own(cv)))
    return x + ffn_apply(cfg, kind, p, norm_apply(p["ln2"], x, cfg.norm),
                         rules), cache


def ffn_apply(cfg, kind: str, p, h: torch.Tensor,
              rules: Rules = NO_RULES, seq_split: bool = True
              ) -> torch.Tensor:
    """The FFN sublayer: ``moe_apply`` on an ``attn_moe`` block, else the
    dense MLP. ``seq_split``: whether ``h``'s rows are the rank's block of
    the sequence under context parallelism (not a decode step's)."""
    if kind == "attn_moe":
        return moe_apply(cfg, p["moe"], h, rules, seq_split=seq_split)
    return mlp_apply(cfg, p["mlp"], h, rules)


def block_decode(cfg, kind: str, p, x: torch.Tensor, cache,
                 pos: torch.Tensor, block_table: Optional[torch.Tensor],
                 win_block_table: Optional[torch.Tensor], rows, win_rows,
                 rules: Rules = NO_RULES):
    """Decode step of one block. Attention kinds write their cache in place
    and return (x, None): through ``block_table`` (``local_attn`` through
    ``win_block_table``, with the window) on page pools, or, where the
    table is None, into the slot's dense lane (a ``local_attn`` lane is a
    ring); ``rows`` / ``win_rows``: ``layers.paged_rows`` or
    ``layers.dense_rows`` of each, None for one the stack has no layer on.
    A ``dec`` block then attends its cross lane {"xk", "xv"}, unchanged.
    Recurrent kinds read their state and return (x, new state): plain for
    T == 1, checkpointed for T > 1 (see ``griffin.rglru_decode``,
    ``ssm.ssm_decode``). An ``attn_moe`` block routes every row of the
    step, dead slots' too, as the JAX package's step does. ``rules``: as
    ``block_apply``'s."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    new = None
    if kind == "ssm":
        a, new = ssm.ssm_decode(cfg, p["mixer"], h, cache, rules)
        return x + a, new
    if kind == "rglru":
        a, new = griffin.rglru_decode(cfg, p["mixer"], h, cache, rules)
    elif kind == "local_attn":
        a, _ = attention_decode(cfg, p["attn"], h, cache, pos,
                                win_block_table, win_rows,
                                window=cfg.hybrid.window, rules=rules)
    else:
        a, _ = attention_decode(cfg, p["attn"], h, cache, pos, block_table,
                                rows, rules=rules)
    x = x + a
    if kind == "dec":
        hx = norm_apply(p["lnx"], x, cfg.norm)
        a, _ = attention_decode(cfg, p["cross"], hx,
                                {"k": cache["xk"], "v": cache["xv"]}, pos,
                                cross=True, rules=rules)
        x = x + a
    return x + ffn_apply(cfg, kind, p, norm_apply(p["ln2"], x, cfg.norm),
                         rules, seq_split=False), new


def stack_apply(cfg, blocks, x: torch.Tensor, *, prefix_kv=None,
                prefix_len: int = 0, length=None, enc_out=None,
                max_len=None, kinds=None, rules: Rules = NO_RULES):
    """Run every layer over the prompt. Returns (x, per-layer cache
    entries). ``prefix_kv`` (per layer {"k", "v"} (B, Pb, KV, D) in the
    cache dtype) with ``prefix_len`` switches every layer to suffix-only
    prefill against that reused KV (``layers.attention_apply``; full
    attention stacks only); the returned k/v are then the suffix's.
    ``length``: real tokens of a right-padded bucket, for the recurrent
    blocks' states. ``enc_out``: the encoder's output, for ``dec`` blocks.
    ``max_len``: build the dense engine's lanes (see ``block_apply``).
    ``kinds``: the blocks' kinds (default the decoder's). ``rules``: the
    tensor-parallel hooks (``block_apply``)."""
    kinds = layer_kinds(cfg) if kinds is None else kinds
    if prefix_kv is not None and set(kinds) - set(PAGEABLE_KINDS):
        raise ValueError(f"prefix reuse needs an attention-only stack, got "
                         f"{sorted(set(kinds))}")
    caches = []
    for j, (kind, p) in enumerate(zip(kinds, blocks)):
        pref = None if prefix_kv is None else (
            prefix_kv[j]["k"], prefix_kv[j]["v"], prefix_len)
        x, c = block_apply(cfg, kind, rules.use(p, kind), x, prefix=pref,
                           length=length, enc_out=enc_out, max_len=max_len,
                           rules=rules)
        caches.append(c)
    return x, caches


def block_train(cfg, kind: str, p, x: torch.Tensor, enc_out=None,
                rules: Rules = NO_RULES):
    """The training forward of one block (the reference's ``block_apply``
    without a cache): the same sublayers as ``block_apply``, attention
    through ``layers.flash_attention`` (``attention_apply(train=True)``),
    recurrent mixers without their decode state. ``rules``: the
    tensor-parallel hooks (``parallel.sharding.TrainRules`` on a rank).
    Returns (x, aux): an ``attn_moe`` block's {"lb_loss", "z_loss"}, else
    {}."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        return x + ssm.ssm_apply(cfg, p["mixer"], h, rules=rules), {}
    if kind == "rglru":
        a = griffin.rglru_apply(cfg, p["mixer"], h, rules=rules)
    else:
        window = cfg.hybrid.window if kind == "local_attn" else 0
        a, _ = attention_apply(cfg, p["attn"], h, window=window,
                               causal=kind != "enc", rules=rules,
                               train=True)
    x = x + a
    if kind == "dec":
        hx = norm_apply(p["lnx"], x, cfg.norm)
        a, _ = attention_apply(
            cfg, p["cross"], hx,
            cross_kv=cross_kv(cfg, p["cross"], enc_out, rules), rules=rules,
            train=True)
        x = x + a
    h = norm_apply(p["ln2"], x, cfg.norm)
    if kind == "attn_moe":
        f, aux = moe_apply(cfg, p["moe"], h, rules, aux=True)
        return x + f, aux
    return x + mlp_apply(cfg, p["mlp"], h, rules), {}


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_plain_matmuls(ctx, op, *args, **kwargs):
    """The ``dots`` policy, after ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``: keep the outputs of 2-D matmuls
    (the projections and MLPs: ``x @ w`` folds its leading dims into one
    ``mm``), recompute everything else, the batched attention products
    (``bmm``) among it."""
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _MM
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """``fn`` rematerialised per ``cfg.remat``: "none" as it is; "full"
    keeps only its inputs and recomputes it in the backward pass; "dots"
    also keeps its plain matmuls' outputs (``_save_plain_matmuls``)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                checkpoint.create_selective_checkpoint_contexts,
                _save_plain_matmuls))
    raise ValueError(f"remat {cfg.remat!r} is not none, full or dots")


def _super_block(cfg, kinds, blocks, x: torch.Tensor, aux, enc_out,
                 rules: Rules):
    """``block_train`` over one period of layers, their aux losses added
    to ``aux`` layer by layer (the reference's scan body). Each layer's
    leaves are gathered at its start (``rules.use``), so whole weights
    live one layer at a time, and a remat of the period gathers them
    again."""
    aux = dict(aux)
    for kind, p in zip(kinds, blocks):
        x, a = block_train(cfg, kind, rules.use(p, kind), x, enc_out, rules)
        for name, v in a.items():
            aux[name] = aux[name] + v
    return x, aux


def stack_train(cfg, blocks, x: torch.Tensor, *, kinds=None,
                enc_out=None, rules: Rules = NO_RULES):
    """The training forward of every layer (``block_train``), grouped as
    the reference's ``stack_apply`` scans them: each whole period of the
    pattern (``layer_plan``'s super-blocks; an encoder's blocks one at a
    time) rematerialised as one unit per ``cfg.remat``, the tail layers
    not at all (the reference's tail runs outside its remat'd scan). The
    recompute runs a super-block's all-reduces again, in the same order
    on every rank. ``kinds``: the blocks' kinds (default the decoder's,
    by ``layer_plan``; given, one a period); ``enc_out``: the encoder's
    output, for ``dec`` blocks; ``rules``: the tensor-parallel hooks.
    Returns (x, {"lb_loss", "z_loss"}: fp32 sums over the MoE layers, zero
    without any), as the reference's ``stack_apply`` sums them."""
    if kinds is None:
        kinds = layer_kinds(cfg)
        n_super, _ = layer_plan(cfg)
        period = len(pattern_for(cfg))
    else:
        n_super, period = len(kinds), 1
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux: Dict[str, torch.Tensor] = {"lb_loss": zero, "z_loss": zero}
    body = _remat(cfg, _super_block)
    for i in range(0, n_super * period, period):
        x, aux = body(cfg, kinds[i:i + period], blocks[i:i + period], x,
                      aux, enc_out, rules)
    return _super_block(cfg, kinds[n_super * period:],
                        blocks[n_super * period:], x, aux, enc_out, rules)


def stack_decode(cfg, blocks, x: torch.Tensor, caches, pos: torch.Tensor,
                 block_table: Optional[torch.Tensor] = None,
                 win_block_table: Optional[torch.Tensor] = None,
                 state_out=None, rules: Rules = NO_RULES):
    """One decode step through every layer. Pools and lanes change in
    place; a None table means the dense lanes. A recurrent layer's new
    state goes, in place, into its cache entry (T == 1) or, for a T > 1
    verify block, into ``state_out[j]`` (fixed (B, T, ...) buffers) when
    given. Returns (x, per-layer entries: the caches, with a T > 1 block's
    checkpointed states in place of the recurrent layers' when no
    ``state_out`` takes them). ``rules``: the tensor-parallel hooks."""
    T = x.shape[1]
    kinds = layer_kinds(cfg)
    # where the step's rows write, once for each table or lane length
    # (every layer on it writes the same rows)
    rows = win_rows = None
    for kind, c in zip(kinds, caches):
        # a context-parallel rank's dense lane is its block of the whole
        if kind in PAGEABLE_KINDS + ("dec",) and rows is None:
            S = c["k"].shape[1]
            rows = dense_rows(pos, S * rules.cp, False) \
                if block_table is None \
                else paged_rows(block_table, pos, T, S)
        if kind in WINDOW_KINDS and win_rows is None:
            S = c["k"].shape[1]
            win_rows = dense_rows(pos, S * rules.cp, True) \
                if win_block_table is None \
                else paged_rows(win_block_table, pos, T, S)
    out = list(caches)
    for j, (kind, p, c) in enumerate(zip(kinds, blocks, caches)):
        x, new = block_decode(cfg, kind, rules.use(p, kind), x, c, pos,
                              block_table, win_block_table, rows, win_rows,
                              rules)
        if new is None:
            continue
        dst = c if T == 1 else (None if state_out is None else state_out[j])
        if dst is None:
            out[j] = new
        else:
            for name, t in new.items():
                dst[name].copy_(t)
    return x, out
