"""Layer library: rmsnorm/layernorm, rotary embedding, GQA attention
(full or sliding-window, causal or not, self or cross) for prefill
(flash-MHA kernel), paged decode (flash-decode kernel, or the dense-gather
baseline through ``attend_decode``) and dense-lane decode (flash-MHA at one
query row with a device ``kv_valid``), the training forward's plain chunked
attention (``flash_attention``, which autograd differentiates), KV-cache
quantization, the gated MLP and the token-dropping MoE FFN (``moe_apply``,
with its auxiliary losses for training).

Counterpart of ``repro.models.layers``: plain functions on tensors with
parameter dicts of the same names and shapes (``wq`` (d, H, hd), ``wo``
(H, hd, d), ...), so a parameter tree converted from the JAX package
(``repro_torch.convert``) drives both packages through the same function.
The attention products go through ``kernels.ops`` (CUDA kernel on a CUDA
tensor, plain version on a CPU tensor); matmuls, norms and RoPE stay plain
PyTorch, as they stay plain jnp in the JAX package. The kernels have no
backward (their wrappers refuse a grad-requiring input), so training
attends through ``flash_attention`` on every device, as the reference
trains through its jnp ``flash_attention`` and never through a Pallas
kernel: the caller chooses it (``attention_apply(train=True)``). Under
context parallelism (``rules.seq``) each layer works on a rank's block of
the sequence: see ``attention_apply``, ``attention_decode`` and
``moe_apply``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import NO_RULES, Rules

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_valid: Optional[int] = None, q_chunk: int = 256,
                    kv_chunk: int = 512, chunked: bool = True
                    ) -> torch.Tensor:
    """The reference's jnp ``layers.flash_attention`` in plain PyTorch, the
    attention of the training forward: autograd runs through it on every
    device. q: (B, Sq, H, D); k, v: (B, Sk, KV, D), GQA by head groups.
    Row i sits at absolute position ``q_offset`` + i (a host int: a
    context-parallel rank's first query); key j at j. ``causal``: row i
    sees keys at positions <= its own; ``window`` > 0 also limits it to
    keys within ``window`` of it. ``kv_valid`` (a host int): only the
    first kv_valid keys are real. ``chunked``: q in chunks of
    ``q_chunk`` rows against k/v in chunks of ``kv_chunk`` through an
    online softmax (fp32 max, sum and accumulator), both padded to whole
    chunks, so no (Sq, Sk) score matrix is made; else one softmax over all
    keys. Scores and P V products are
    fp32 from the inputs' values (the reference's
    ``preferred_element_type``), P cast to v's dtype first; masked scores
    are -1e30. Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    kv_lim = Sk if kv_valid is None else kv_valid
    dev = q.device

    def mask_of(qpos, kpos):
        mask = (kpos < kv_lim)[None, :]
        if causal:
            band = qpos[:, None] >= kpos[None, :]
            if window:
                band = band & (qpos[:, None] - kpos[None, :] < window)
            mask = mask & band
        return mask                       # (Sq or qc, Sk or kc)

    if not chunked:
        qg = q.reshape(B, Sq, KV, G, D).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
        mask = mask_of(q_offset + torch.arange(Sq, device=dev),
                       torch.arange(Sk, device=dev))
        p = torch.softmax(torch.where(mask, s, -1e30), -1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                         v.float())
        return o.reshape(B, Sq, H, D).to(q.dtype)
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    pq, pk = (-Sq) % qc, (-Sk) % kc
    qp = F.pad(q, (0, 0, 0, 0, 0, pq)).reshape(B, -1, qc, KV, G, D)
    kp = F.pad(k, (0, 0, 0, 0, 0, pk)).reshape(B, -1, kc, KV, D)
    vp = F.pad(v, (0, 0, 0, 0, 0, pk)).reshape(B, -1, kc, KV, D)
    outs = []
    for qi in range(qp.shape[1]):
        qb = qp[:, qi].float()
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, KV, G, qc), -torch.inf, device=dev)
        l = torch.zeros((B, KV, G, qc), device=dev)
        o = torch.zeros((B, KV, G, qc, D), device=dev)
        for ki in range(kp.shape[1]):
            kb, vb = kp[:, ki], vp[:, ki]
            s = torch.einsum("bqkgd,bckd->bkgqc", qb, kb.float()) * scale
            s = torch.where(
                mask_of(qpos, ki * kc + torch.arange(kc, device=dev)), s,
                -1e30)
            m2 = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(vb.dtype).float(), vb.float())
            m = m2
        o = o / l[..., None].clamp(min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4))        # (B, qc, KV, G, D)
    out = torch.cat(outs, 1).reshape(B, -1, H, D)
    return out[:, :Sq].to(q.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd), as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def kv_heads_of(cfg, rules: Rules, heads: int):
    """(lo, hi): the KV heads that a rank's ``heads`` query heads read,
    where its query heads split over ``model`` while every rank holds the
    KV heads whole (``rules.whole_kv``; head j reads KV head j // G,
    kv-major, so rank r's heads [r heads, (r + 1) heads) read KV heads
    [r heads // G, ((r + 1) heads - 1) // G + 1)); None elsewhere (a rank's
    KV heads are those its queries read). Raises ``ValueError`` where a
    rank's heads would take part of a KV head's group and more than that
    head."""
    if not rules.whole_kv:
        return None
    G = cfg.num_heads // cfg.kv_heads
    first = rules.model_rank * heads
    lo, hi = first // G, (first + heads - 1) // G + 1
    if hi - lo > 1 and (first % G or heads % G):
        raise ValueError(
            f"{cfg.name}: a rank's {heads} query heads from head {first} "
            f"straddle the {G}-head groups of its {cfg.kv_heads} KV heads "
            f"over model = {rules.model}")
    return lo, hi


def _attended(cfg, rules: Rules, q: torch.Tensor, *kv: torch.Tensor):
    """Each of ``kv`` (..., KV, D) cut to the KV heads the rank's queries
    q (..., H, D) read (``kv_heads_of``; views), or as they are."""
    heads = kv_heads_of(cfg, rules, q.shape[-2])
    if heads is None:
        return kv
    return tuple(t[..., heads[0]:heads[1], :] for t in kv)


def _kv_leaves(cfg, p: Params, rules: Rules):
    """``wk`` / ``wv`` (and ``bk`` / ``bv``): where they are whole on a
    rank that reads only some of their heads (``rules.whole_kv``), through
    ``rules.partial``, which sums their gradients over ``model``."""
    names = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
    leaves = tuple(p[n] for n in names)
    if rules.whole_kv:
        leaves = rules.partial(*leaves)
    return dict(zip(names, leaves))


def _qkv(cfg, p: Params, x: torch.Tensor, rules: Rules = NO_RULES,
         v_heads=None):
    """q, k, v of x; with ``v_heads`` (lo, hi) v only at KV heads [lo,
    hi)."""
    kv = _kv_leaves(cfg, p, rules)
    wv, bv = kv["wv"], kv.get("bv")
    if v_heads is not None:
        wv = wv[:, v_heads[0]:v_heads[1]]
        bv = None if bv is None else bv[v_heads[0]:v_heads[1]]
    q, k, v = _proj(x, p["wq"]), _proj(x, kv["wk"]), _proj(x, wv)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + kv["bk"], v + bv
    return q, k, v


def cross_kv(cfg, p: Params, enc: torch.Tensor, rules: Rules = NO_RULES):
    """A decoder layer's cross-attention k/v from the encoder output enc
    (B, S_enc, d): its ``cross`` weights' projections (plus ``bk`` /
    ``bv``), no RoPE. -> (k, v), each (B, S_enc, KV, D), every KV head
    (``attention_apply`` cuts them to a rank's). ``enc`` enters a
    sublayer that contracts "heads" (``rules.enter``). Under context
    parallelism ``enc`` is the rank's block of the encoder's rows and the
    k/v are gathered whole (``rules.cp_gather``)."""
    enc = rules.enter(enc, "heads")
    kv = _kv_leaves(cfg, p, rules)
    k, v = _proj(enc, kv["wk"]), _proj(enc, kv["wv"])
    if cfg.qkv_bias:
        k, v = k + kv["bk"], v + kv["bv"]
    return rules.cp_gather(k), rules.cp_gather(v)


def _out(p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    return o.flatten(-2) @ p["wo"].reshape(-1, p["wo"].shape[-1])


def attention_apply(cfg, p: Params, x: torch.Tensor, prefix=None,
                    window: int = 0, causal: bool = True, cross_kv=None,
                    rules: Rules = NO_RULES, train: bool = False):
    """Self-attention over the whole (bucket-padded) prompt through the
    flash-MHA kernel, RoPE at positions 0.. S - 1. Bucket padding sits
    after every real row, so causal masking alone keeps the real rows
    exact. ``window`` > 0 limits each row to its last ``window`` keys (a
    local_attn layer). ``causal=False``: every row sees every key (the
    encoder). Returns (out, (k, v)) for the caller to build its cache from.

    cross_kv=(k, v) (B, S_enc, KV, D): encoder-decoder cross-attention. q
    is x's projection (plus ``bq``), k/v the encoder's, no RoPE, not
    causal; returns (out, None).

    prefix=(pk, pv, plen): suffix-only prefill against reused KV (the
    prefix cache). ``x`` holds only the tokens after the shared prefix;
    pk/pv (B, Pb, KV, D, cache dtype) are the prefix KV gathered from the
    page pools, valid for their first ``plen`` rows (a host int). The
    suffix k/v are spliced in at row plen, so buffer index == absolute
    position for every real token, and the kernel's query offset (q[:, 0]
    at plen) masks both the prefix buffer's tail and the suffix's bucket
    padding: those rows sit past every real query. The returned k/v are
    the suffix's only, what the caller scatters into its pages.

    ``train``: the training forward's choice, attention through
    ``flash_attention`` (chunked per ``cfg.flash_chunking``; cross-attention
    always chunked, as in the reference), which autograd differentiates, in
    place of the kernel; no prefix. Where the rank's queries read only some
    of the whole KV heads (``rules.whole_kv``), v is projected at those
    heads only (the reference's partition computes k whole, as its
    ``kv_heads`` constraint asks, and v at the heads its use reads), and
    the returned v is theirs.

    The out-projection contracts "heads": ``rules.contract`` (a rank's
    all-reduce over its ``model`` group under tensor parallelism); ``x``
    enters through ``rules.enter`` (the gradient's sum in training). A
    rank whose query heads split over ``model`` while its KV heads are
    whole (``rules.whole_kv``) computes k and v whole, returns them whole
    and attends only the KV heads its queries read (``kv_heads_of``).

    Context parallelism (``rules.seq``): ``x`` is the rank's block of the
    sequence, its rows at r S + 0.. S - 1 (``rules.cp_offset``); k and v
    are gathered whole along the sequence (``rules.cp_gather``), and the
    rank's queries attend them at that query offset (the kernel's
    ``q_offset``; ``flash_attention``'s in training), so causal and window
    masks work on absolute positions. The returned k/v are the rank's own
    rows: its part of a context-parallel cache. No prefix."""
    x = rules.enter(x, "heads")
    if cross_kv is not None:
        q = _proj(x, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
        ck, cv = _attended(cfg, rules, q, *cross_kv)
        if train:
            out = flash_attention(q, ck, cv, causal=False)
        else:
            out = ops.attention(q.contiguous(), ck.contiguous(),
                                cv.contiguous(), causal=False)
        return rules.contract(_out(p, out), "heads"), None
    S = x.shape[1]
    v_heads = None
    if train and rules.whole_kv:
        v_heads = kv_heads_of(cfg, rules, p["wq"].shape[1])
    q, k, v = _qkv(cfg, p, x, rules, v_heads)
    off = rules.cp_offset(S)
    if prefix is not None and rules.seq:
        raise ValueError("a context-parallel prefill takes no prefix")
    plen = 0 if prefix is None else prefix[2]
    positions = plen + off + torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if train:
        if prefix is not None:
            raise ValueError("the training forward takes no prefix")
        kf, = _attended(cfg, rules, q, rules.cp_gather(k))
        out = flash_attention(q, kf, rules.cp_gather(v), causal=causal,
                              window=window, q_offset=off,
                              chunked=cfg.flash_chunking)
        return rules.contract(_out(p, out), "heads"), (k, v)
    if prefix is None:
        kf, vf = rules.cp_gather(k), rules.cp_gather(v)
    else:
        pk, pv, _ = prefix
        kf = torch.cat([kv_dequant(cfg, pk, x.dtype), torch.zeros_like(k)], 1)
        vf = torch.cat([kv_dequant(cfg, pv, x.dtype), torch.zeros_like(v)], 1)
        kf[:, plen:plen + S] = k
        vf[:, plen:plen + S] = v
    kf, vf = _attended(cfg, rules, q, kf, vf)
    out = ops.attention(q.contiguous(), kf.contiguous(), vf.contiguous(),
                        causal=causal, q_offset=plen + off, window=window)
    return rules.contract(_out(p, out), "heads"), (k, v)


def paged_rows(block_table: torch.Tensor, pos: torch.Tensor, T: int,
               page: int):
    """Where a T-row decode block writes its k/v: (phys, off, last), each
    (B, T). Token t of request b goes to page block_table[b, (pos + t) //
    page], row (pos + t) % page; rows past the table go to scratch page 0.
    ``last`` (``last_writer``) names, for each row, the last row in (b, t)
    order that writes the same pool row: dead slots (all-scratch tables)
    and rows past the table share scratch rows, and a row takes the last
    writer's value there, the JAX engine's scatter order, so the pool ends
    the same whatever order the device applies the writes in. The same
    for every layer on one table: ``transformer.stack_decode`` computes it
    once a step."""
    pos_t = pos[:, None] + torch.arange(T, device=pos.device,
                                        dtype=pos.dtype)[None, :]
    n_blk = block_table.shape[1]
    blk = (pos_t // page).long()
    phys = torch.gather(block_table, 1, blk.clamp(max=n_blk - 1)).long()
    phys = torch.where(blk < n_blk, phys, torch.zeros_like(phys))
    off = (pos_t % page).long()
    return phys, off, last_writer(phys * page + off).view_as(phys)


def dense_rows(pos: torch.Tensor, S: int, ring: bool):
    """Where a dense-lane decode step writes and what it attends, the same
    for every layer on lanes of length ``S``: (b, slot, n), each (B,).
    slot: ``pos % S`` on a window ring, ``min(pos, S - 1)`` on a
    contiguous lane (the reference's write slots); n (int32, contiguous:
    the mha kernel's ``kv_valid`` as it is, nothing allocated or read from
    the host inside a captured graph): ``min(pos + 1, S)``, the rows that
    hold keys (a ring holds its last S positions, a contiguous lane
    positions 0..pos). ``transformer.stack_decode`` computes it once a
    step for each lane length."""
    slot = (pos % S if ring else pos.clamp(max=S - 1)).long()
    n = (pos + 1).clamp(max=S).to(torch.int32).contiguous()
    return torch.arange(pos.shape[0], device=pos.device), slot, n


def attention_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, block_table=None, rows=None,
                     window: int = 0, cross: bool = False,
                     rules: Rules = NO_RULES):
    """Decode step. x: (B, T, d); pos: (B,) int32 position of the first
    new token. Three modes, as the reference's ``attention_decode``:

    * paged (``block_table`` (B, n_blocks) int32; cache {"k", "v"}: (P,
      page, KV, D) page pools; rows: ``paged_rows(block_table, pos, T,
      page)``, the same for every layer on the table). The T new tokens'
      k/v are scattered token by token to page block_table[b, (pos+t) //
      page], row (pos+t) % page — rows past the table go to scratch page
      0, and rows that share a pool row write its last writer's value —
      and the flash-decode kernel then attends through the block table
      (with ``cfg.paged_attn_impl == "gather"``, a dense gather of the
      tables' pages and ``attend_decode`` instead). ``window`` > 0 (a
      local_attn layer on its window table): each row sees its last
      ``window`` keys, and the kernel skips the pages wholly below the
      earliest row's window, the ones the engine recycles to scratch.
    * dense (``block_table`` None; cache {"k", "v"}: (B, S, KV, D), one
      lane a slot; rows: ``dense_rows(pos, S, window > 0)``; T == 1). The
      new k/v go to lane row ``slot`` (a window ring's ``pos % S``, else
      ``min(pos, S - 1)``): the values of the reference's one-hot write.
      Then flash-MHA with one query row a slot, not causal, over the
      lane's first ``n = min(pos + 1, S)`` rows (a device ``kv_valid``):
      what ``attend_decode`` (``ring=`` for a window) computes.
    * cross (``cross=True``; cache {"k", "v"}: a (B, S_enc, KV, D) lane of
      encoder k/v): q from x (plus ``bq``), no RoPE, attending every row
      of the lane, which stays as it is.

    The pools and lanes are updated IN PLACE (``index_put_``), where the
    JAX package returns new ones: the port never copies a layer's cache.
    The out-projection contracts "heads" (``rules.contract``), in every
    mode. Where a rank's query heads split over ``model`` while its KV
    heads are whole (``rules.whole_kv``), the rank writes every KV head
    and attends only those its queries read (``kv_heads_of``).

    Context parallelism (``rules.seq``; dense and cross lanes only): a
    rank's lane is its block of ``S`` rows of the whole lane (``rows``
    then name the whole lane's slots). Only the rank that owns the new
    row's slot writes it (the others write back what the slot held: the
    reference's one-hot write, cut to the rank's rows); each rank attends
    its rows with a partial softmax (``attend_partial``, plain PyTorch)
    and ``rules.cp_merge`` merges the partials over the ranks. The mha
    kernel is not used there: its decode row returns the normalised
    output, not the row max and sum that a merge needs. Returns (out,
    cache)."""
    if cross:
        q = _proj(x, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
        ck, cv = _attended(cfg, rules, q, cache["k"], cache["v"])
        ck, cv = kv_dequant(cfg, ck, q.dtype), kv_dequant(cfg, cv, q.dtype)
        if rules.seq:
            S = ck.shape[1]
            every = torch.full((x.shape[0], 1), S * rules.cp,
                               device=x.device)
            out = _merged(q, ck, cv, every, rules, S)
        else:
            out = ops.attention(q.contiguous(), ck.contiguous(),
                                cv.contiguous(), causal=False)
        return rules.contract(_out(p, out), "heads"), cache
    if rules.seq and block_table is not None:
        raise ValueError("context-parallel decode reads dense lanes; the "
                         "page pools are not split over the sequence")
    B, T = x.shape[0], x.shape[1]
    q, k, v = _qkv(cfg, p, x, rules)
    pos_t = pos[:, None] + torch.arange(T, device=x.device,
                                        dtype=pos.dtype)[None, :]
    q = rope(q, pos_t, cfg.rope_theta)
    k = rope(k, pos_t, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    if block_table is None:
        if T != 1:
            raise ValueError(f"dense-lane decode is single-token, got a "
                             f"T={T} block")
        b, slot, n = rows
        if rules.seq:
            S = ck.shape[1]
            local = slot - rules.cp_offset(S)
            own = ((local >= 0) & (local < S))[:, None, None]
            local = local.clamp(0, S - 1)
            for lane, new in ((ck, k), (cv, v)):
                lane.index_put_((b, local), torch.where(
                    own, kv_quant(cfg, new[:, 0]), lane[b, local]))
            out = _merged(q, kv_dequant(cfg, ck, q.dtype),
                          kv_dequant(cfg, cv, q.dtype), n[:, None], rules,
                          S, kv_chunk=cfg.decode_kv_chunk)
            return rules.contract(_out(p, out), "heads"), cache
        ck.index_put_((b, slot), kv_quant(cfg, k[:, 0]))
        cv.index_put_((b, slot), kv_quant(cfg, v[:, 0]))
        ck, cv = _attended(cfg, rules, q, ck, cv)
        out = ops.attention(q.contiguous(),
                            kv_dequant(cfg, ck, q.dtype).contiguous(),
                            kv_dequant(cfg, cv, q.dtype).contiguous(),
                            causal=False, kv_valid=n)
        return rules.contract(_out(p, out), "heads"), cache
    phys, off, last = rows
    ck.index_put_((phys, off), kv_quant(cfg, k).flatten(0, 1)[last])
    cv.index_put_((phys, off), kv_quant(cfg, v).flatten(0, 1)[last])
    ck, cv = _attended(cfg, rules, q, ck, cv)
    if cfg.paged_attn_impl == "gather":
        # the reference's baseline: every request's whole table gathered
        # into a dense (B, n_blocks * page, KV, D) copy, then plain
        # attention over it (buffer index == absolute position)
        kg = ck[block_table.long()].flatten(1, 2)
        vg = cv[block_table.long()].flatten(1, 2)
        out = attend_decode(q, kv_dequant(cfg, kg, q.dtype),
                            kv_dequant(cfg, vg, q.dtype), pos,
                            window=window, kv_chunk=cfg.decode_kv_chunk)
    else:
        scale = cfg.kv_scale if ck.dtype == torch.int8 else None
        out = ops.paged_attention(q.contiguous(), ck.contiguous(),
                                  cv.contiguous(), block_table, pos + T,
                                  kv_scale=scale, window=window)
    return rules.contract(_out(p, out), "heads"), cache


def _merged(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
            nvalid: torch.Tensor, rules: Rules, S: int,
            kv_chunk: int = 0) -> torch.Tensor:
    """A context-parallel decode row: the partial softmax over this rank's
    ``S`` lane rows (slots r S.. of the whole lane; slots below
    ``nvalid`` are valid), merged over the ranks (``rules.cp_merge``)."""
    m, l, o = attend_partial(q, ck, cv, nvalid, kv_chunk=kv_chunk,
                             base=rules.cp_offset(S))
    l, o = rules.cp_merge(m, l, o)
    return normalised(o, l, q)


def last_writer(target: torch.Tensor) -> torch.Tensor:
    """For each of ``target``'s n elements (flattened, any shape), the index
    of the last element with the same value: a scatter that writes element
    i's value from ``last_writer(target)[i]`` leaves every target the value
    of its last writer in index order, however the device orders the
    duplicate writes. An (n, n) comparison on the device, no host sync:
    meant for the few dozen rows of a decode or verify step."""
    t = target.reshape(-1)
    ix = torch.arange(t.numel(), device=t.device)
    same = t[:, None] == t[None, :]
    return torch.where(same, ix[None, :], -1).amax(1)


def attend_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  pos: torch.Tensor, *, window: int = 0, ring: bool = False,
                  kv_chunk: int = 0) -> torch.Tensor:
    """Decode attention against a cache, the reference's ``attend_decode``.
    q: (B, Tq, H, D), row t at position pos + t; ck/cv: (B, S, KV, D);
    pos: (B,) position of the first row. Two layouts:

    * ``ring=False``: buffer index == the key's absolute position. Row t
      attends to keys at positions <= pos + t (in-block causal), and with
      ``window`` > 0 only to the last ``window`` of them.
    * ``ring=True``: a window-sized ring buffer (slot = position % S) that
      holds only the last S positions, so the first min(pos + 1, S) slots
      are valid. Single-token: a Tq > 1 block raises ``ValueError``, as
      in the reference. This is the plain oracle of the dense engine's
      decode (``attention_decode`` with ``block_table=None``).

    The keys go in chunks of ``kv_chunk``
    (one chunk if 0 or if it does not divide S) through an online
    softmax, scores and sums in fp32, P cast to the cache dtype before the
    P V product, as in the reference (``attend_partial``). Returns q's
    shape and dtype."""
    B, Tq, H, D = q.shape
    S = ck.shape[1]
    if ring:
        if Tq != 1:
            raise ValueError(
                f"ring-buffer windowed decode is single-token (got a "
                f"Tq={Tq} query block): the ring has already overwritten "
                f"positions the block's older rows would attend to — use "
                f"the paged window layout (ring=False) for multi-token "
                f"blocks")
        nvalid = torch.clamp(pos + 1, max=S)[:, None]       # slot count
    else:
        nvalid = (pos[:, None] + torch.arange(Tq, device=q.device)[None, :]
                  + 1)                                     # (B, Tq)
    _, l, o = attend_partial(q, ck, cv, nvalid,
                             window=0 if ring else window, kv_chunk=kv_chunk)
    return normalised(o, l, q)


def normalised(o: torch.Tensor, l: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """A partial softmax's output (o (B, KV, G, Tq, D) over sums l) as q's
    (B, Tq, H, D) rows in q's dtype."""
    o = o / l[..., None].clamp(min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)


def attend_partial(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   nvalid: torch.Tensor, *, window: int = 0,
                   kv_chunk: int = 0, base: int = 0):
    """``attend_decode``'s online softmax over the slots of ``ck``/``cv``
    (B, S, KV, D), slot j at index ``base`` + j of its lane: a slot is
    valid for row t when its index < ``nvalid`` (B, Tq), and with
    ``window`` > 0 when it is also > nvalid - 1 - window. Returns the
    unnormalised partial (m, l, o): the row max (B, KV, G, Tq), the sum of
    exp past it and the output (B, KV, G, Tq, D), fp32; a row with no
    valid slot has m = -1e30, l = 0 and o = 0."""
    B, Tq, H, D = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, Tq, KV, G, D).float()
    c = S if kv_chunk <= 0 else min(kv_chunk, S)
    if S % c:
        c = S
    m = torch.full((B, KV, G, Tq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Tq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, KV, G, Tq, D), dtype=torch.float32, device=dev)
    for i in range(0, S, c):
        kb, vb = ck[:, i:i + c], cv[:, i:i + c]
        s = torch.einsum("btkgd,bckd->bkgtc", qg, kb.float()) * D ** -0.5
        slots = base + i + torch.arange(c, device=dev)
        mask = slots[None, None, :] < nvalid[:, :, None]    # (B, Tq, c)
        if window:
            mask = mask & (slots[None, None, :]
                           > nvalid[:, :, None] - 1 - window)
        mask = mask[:, None, None]                 # over (b, k, g, t, c)
        m2 = torch.maximum(m, torch.where(mask, s, -torch.inf).amax(-1))
        m2 = m2.clamp(min=-1e30)                   # fully masked chunk
        p = torch.where(mask, torch.exp(s - m2[..., None]), 0.0)
        corr = torch.exp(m - m2)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bkgtc,bckd->bkgtd", p.to(vb.dtype).float(), vb.float())
        m = m2
    return m, l, o


def mlp_apply(cfg, p: Params, x: torch.Tensor,
              rules: Rules = NO_RULES) -> torch.Tensor:
    """Gated MLP as the JAX package writes it: the activation goes on the
    ``wg`` branch and multiplies ``wi`` — act(x @ wg) * (x @ wi) — then
    ``wo``. Ungated: act(x @ wi) @ wo. The down-projection contracts "ffn"
    (``rules.contract``); ``x`` enters through ``rules.enter``."""
    x = rules.enter(x, "ffn")
    h = x @ p["wi"]
    if cfg.act == "silu":
        act = F.silu
    else:       # jax.nn.gelu's default is the tanh approximation
        def act(t):
            return F.gelu(t, approximate="tanh")
    h = act(x @ p["wg"]) * h if cfg.gated_ffn else act(h)
    return rules.contract(h @ p["wo"], "ffn")


def moe_capacity(cfg, T: int, replicas: int = 1):
    """(G, C) for ``T`` routed rows: dispatch groups (``dispatch_groups``
    when it divides T, else 1) and each expert's capacity in a group. C is
    the JAX package's expression copied as written: the two minus signs
    cancel, so it FLOORS, max(4, floor(Tg * cf * K / E)).

    ``replicas`` > 1: the T rows are one data-parallel replica's share
    (rows r·T to (r + 1)·T) of a global batch of ``replicas`` · T rows,
    which the reference groups as one batch. G and C are then the global
    batch's, and the replica routes its G / ``replicas`` of the groups;
    raises ``ValueError`` when the groups do not split over the
    replicas."""
    m = cfg.moe
    total = T * replicas
    G = m.dispatch_groups if total % max(m.dispatch_groups, 1) == 0 else 1
    if G % replicas:
        raise ValueError(
            f"{G} dispatch group(s) of {total} routed rows do not split "
            f"over {replicas} data replicas")
    Tg = total // G
    C = int(max(4, -(-Tg * m.capacity_factor * m.top_k) // m.num_experts))
    return G // replicas, C


def moe_route(cfg, p: Params, x: torch.Tensor):
    """The routing half of ``moe_apply``. x: (B, S, d). Every one of the T =
    B * S rows is routed (bucket padding and dead decode slots take
    capacity, as in the JAX package). Returns (gate_w (T, K) fp32, the
    renormalised top-K probabilities; gate_i (T, K) int64 experts; flat (G,
    K * Tg) int64, each routed slot's row e * C + pos of the (E * C + 1)-row
    dispatch buffer, E * C for a dropped slot; keep (G, K * Tg) bool). The
    router runs in fp32; ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them; slots are ranked slot-major in their
    group (all first choices, then all second choices, ...). No host sync
    and no data-dependent shape, so it runs inside a captured graph."""
    return _route(cfg, p, x)[2:]


def _route(cfg, p: Params, x: torch.Tensor, replicas: int = 1):
    """``moe_route``'s work, with the router's fp32 logits (T, E) and
    probabilities first: (logits, probs, gate_w, gate_i, flat, keep).
    ``replicas``: as ``moe_capacity``'s."""
    G, C = moe_capacity(cfg, x.shape[0] * x.shape[1], replicas)
    logits, probs, gate_w, gate_i = _scores(cfg, p, x)
    return (logits, probs, gate_w, gate_i) + _slots(cfg, gate_i, G, C)


def _scores(cfg, p: Params, x: torch.Tensor):
    """The router on every row of x (B, S, d): (logits, probs, gate_w,
    gate_i), as ``_route`` returns them."""
    K = cfg.moe.top_k
    logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
    probs = torch.softmax(logits, -1)
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True,
                                stable=True)
    gate_w, gate_i = gate_w[:, :K], gate_i[:, :K]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_w, gate_i


def _slots(cfg, gate_i: torch.Tensor, G: int, C: int):
    """(flat, keep) of ``_route`` from every row's choices ``gate_i``
    (T, K) in G dispatch groups of capacity C a expert."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    Tg = gate_i.shape[0] // G
    eidx = gate_i.reshape(G, Tg, K).transpose(1, 2).reshape(G, K * Tg)
    oh = (eidx[..., None] == torch.arange(E, device=gate_i.device)
          ).to(torch.int32)
    pos = torch.gather(torch.cumsum(oh, 1) - 1, 2, eidx[..., None])[..., 0]
    keep = pos < C
    flat = torch.where(keep, eidx * C + pos, torch.full_like(eidx, E * C))
    return flat, keep


def moe_aux(cfg, logits: torch.Tensor, probs: torch.Tensor,
            gate_i: torch.Tensor, rules: Rules = NO_RULES
            ) -> Dict[str, torch.Tensor]:
    """The reference's auxiliary losses over all T routed rows:
    ``lb_loss`` (Switch load balance: E · sum_e mean_prob_e · share_e, the
    share of the T · K choices that went to expert e; no gradient through
    the choices) and ``z_loss`` (the mean squared logsumexp of the router
    logits).

    Under context parallelism (``rules.seq``) ``logits`` and ``probs`` are
    the rank's rows and ``gate_i`` every rank's choices: the means are
    the whole sequence's, their sums over the ranks' rows taken by
    ``rules.cp_sum`` (each rank's gradient is of its own rows).

    Over ``rules.data`` > 1 replicas (data-parallel training) both means
    of ``lb_loss``'s product are the global batch's: averaged over the
    ``data`` group, the mean probability with the identity for its
    gradient, so that the train step's average of the replicas'
    gradients is the global loss's. ``z_loss`` is a plain mean, whose
    average over the replicas the train step takes."""
    E = cfg.moe.num_experts
    share = (gate_i.reshape(-1, 1) == torch.arange(E, device=gate_i.device)
             ).sum(0).float() / gate_i.numel()
    if rules.seq:
        n = probs.shape[0] * rules.cp
        mean_prob = rules.cp_sum(probs.sum(0)) / n
        z = rules.cp_sum(torch.logsumexp(logits, -1).square().sum()) / n
    else:
        mean_prob = probs.mean(0)
        z = torch.mean(torch.logsumexp(logits, -1).square())
    if rules.data > 1:
        share = rules.all_reduce(share, "data").div_(rules.data)
        local = mean_prob.detach()
        mean_prob = mean_prob + (
            rules.all_reduce(local.clone(), "data").div_(rules.data) - local)
    lb = E * torch.sum(mean_prob * share)
    return {"lb_loss": lb, "z_loss": z}


def _expert_rows(flat: torch.Tensor, lo: int, n: int, C: int
                 ) -> torch.Tensor:
    """``flat`` (rows e * C + pos of all E experts) as rows of the buffer
    of experts [lo, lo + n): (e - lo) * C + pos, and n * C (the discarded
    row) for a slot routed to another expert or dropped."""
    local = flat - lo * C
    return torch.where((local >= 0) & (local < n * C), local,
                       torch.full_like(local, n * C))


def moe_dispatch(cfg, x: torch.Tensor, flat: torch.Tensor,
                 replicas: int = 1, experts=None) -> torch.Tensor:
    """The (G, E, C, d) expert buffer: each kept routed slot's row copied to
    its one row e * C + pos of its group (a dropped slot to the discarded
    row E * C, cut off here); rows no slot fills stay zero. No accumulating
    scatter: every kept row has one writer, so two runs give the same
    bits. ``replicas``: as ``moe_capacity``'s. ``experts`` (lo, n): only
    experts [lo, lo + n) (an expert-parallel rank's), a (G, n, C, d)
    buffer; a slot routed elsewhere goes to the discarded row."""
    B, S, d = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    G, C = moe_capacity(cfg, B * S, replicas)
    lo, n = (0, E) if experts is None else experts
    Tg = B * S // G
    xrep = x.reshape(G, 1, Tg, d).expand(G, K, Tg, d).reshape(G, K * Tg, d)
    buf = x.new_zeros((G, n * C + 1, d))
    rows = flat if (lo, n) == (0, E) else _expert_rows(flat, lo, n, C)
    buf.scatter_(1, rows[..., None].expand(G, K * Tg, d), xrep)
    return buf[:, : n * C].reshape(G, n, C, d)


def moe_experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's gated MLP over its rows of each group: silu(buf @ wg)
    * (buf @ wi) @ wo, (G, E, C, d) -> (G, E, C, d). Plain ``einsum``, as
    the reference's expert products are plain jnp."""
    h = torch.einsum("gecd,edf->gecf", buf, p["wi"])
    g = torch.einsum("gecd,edf->gecf", buf, p["wg"])
    return torch.einsum("gecf,efd->gecd", F.silu(g) * h, p["wo"])


def moe_combine(cfg, eo: torch.Tensor, gate_w: torch.Tensor,
                flat: torch.Tensor, keep: torch.Tensor,
                x: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Each row's output sum_k w_k * keep_k * (its k-th slot's expert row),
    in x's dtype (a dropped slot reads the zero row E * C). ``eo`` may hold
    experts [lo, lo + n) only (an expert-parallel rank's): a slot routed
    to another expert then reads the zero row too. -> x's shape."""
    B, S, d = x.shape
    G, E, C = eo.shape[0], eo.shape[1], eo.shape[2]
    K = cfg.moe.top_k
    Tg = B * S // G
    if (lo, E) != (0, cfg.moe.num_experts):
        flat = _expert_rows(flat, lo, E, C)
    eo_flat = torch.cat([eo.reshape(G, E * C, d), eo.new_zeros((G, 1, d))], 1)
    got = torch.gather(eo_flat, 1, flat[..., None].expand(G, K * Tg, d))
    w = (gate_w.reshape(G, Tg, K).transpose(1, 2)
         * keep.reshape(G, K, Tg)).to(x.dtype)
    return torch.einsum("gkt,gktd->gtd", w,
                        got.reshape(G, K, Tg, d)).reshape(B, S, d)


def moe_apply(cfg, p: Params, x: torch.Tensor,
              rules: Rules = NO_RULES, aux: bool = False,
              seq_split: bool = True):
    """Token-dropping MoE FFN with grouped dispatch, after the JAX
    package's ``layers.moe_apply``: ``moe_route``, ``moe_dispatch``,
    ``moe_experts`` (the expert products stay plain PyTorch, as they stay
    jnp in the reference), ``moe_combine``, plus the shared expert's MLP
    where the config has one, which contracts its own "ffn" (a training
    plan splits it like any MLP; the serving plan never does). x: (B, S,
    d) -> (B, S, d); with ``aux`` (the training forward) -> (out,
    ``moe_aux``'s {"lb_loss", "z_loss"}), the aux losses computed before
    the experts: under remat the recompute then stops before the combine,
    the block's last product, as the reference's dead-code elimination
    drops it. In the training forward x is one replica's rows of the
    global batch over ``rules.data`` replicas (the trainer splits it so),
    which route as their share of the global batch's groups
    (``moe_capacity``).

    Expert-parallel (``rules`` contract "experts"; ``p``'s expert leaves
    the rank's E/m experts, the router whole): every rank routes all rows
    over all E experts (the same choices and aux losses on every rank),
    dispatches only its experts' rows, runs them, and combines what they
    computed (a slot routed to another rank reads zero); ``contract``
    sums the ranks' outputs. The expert rows' input and the gate weights
    ``enter``: each rank's gradient holds its experts' share.

    Context-parallel (``rules.seq`` and ``seq_split``: x is the rank's
    block of each row's sequence; a decode step's rows, replicated, pass
    ``seq_split=False``): ``_moe_cp``."""
    if rules.seq and seq_split:
        return _moe_cp(cfg, p, x, rules, aux)
    replicas = rules.data if aux else 1
    logits, probs, gate_w, gate_i, flat, keep = _route(cfg, p, x, replicas)
    losses = moe_aux(cfg, logits, probs, gate_i, rules) if aux else None
    n = p["wi"].shape[0]                # the rank's experts
    lo = rules.model_rank * n if "experts" in rules.contract_axes else 0
    eo = moe_experts(p, moe_dispatch(cfg, rules.enter(x, "experts"), flat,
                                     replicas, experts=(lo, n)))
    out = rules.contract(moe_combine(
        cfg, eo, rules.enter(gate_w, "experts"), flat, keep, x, lo),
        "experts")
    if cfg.moe.shared_expert:
        out = out + mlp_apply(cfg, p["shared"], x, rules)
    return (out, losses) if aux else out


def _moe_cp(cfg, p: Params, x: torch.Tensor, rules: Rules, aux: bool):
    """``moe_apply`` on the rank's block of the sequence. The reference
    groups the flattened (B, S) rows, row-major, into dispatch groups and
    ranks each group's slots by a running count, so a group generally
    spans every rank's block: each rank routes its own tokens, the top-K
    choices are all-gathered (ints, small), and every rank computes every
    group's capacity ranks (``keep``, the buffer rows), so the routing is
    the whole sequence's. Each rank writes its kept tokens into their
    rows of the (G, E, C, d) dispatch buffer, the other rows zero; a
    reduce-scatter along E (``rules.cp_scatter``: every row has one
    writer, so the sum adds zeros only) hands each rank its experts' rows
    of every group; its experts run; an all-gather along E
    (``rules.cp_gather``) returns every expert's rows, and each rank
    combines its own tokens. Each collective's backward is the other one.
    The experts must split over the ranks (their count divides
    ``model``). The shared expert is the rank's rows' MLP. The aux losses
    are the whole sequence's (``moe_aux``)."""
    if "experts" not in rules.contract_axes:
        raise ValueError(f"a context-parallel MoE needs its "
                         f"{cfg.moe.num_experts} experts split over the "
                         f"{rules.cp} ranks")
    B, Sl, d = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    S = Sl * rules.cp
    G, C = moe_capacity(cfg, B * S, rules.data if aux else 1)
    Tg = B * S // G
    dev = x.device
    logits, probs, gate_w, gate_i = _scores(cfg, p, x)
    every = rules.all_gather(gate_i.reshape(B, Sl, K), 1,
                             "model").reshape(B * S, K)
    flat, keep = _slots(cfg, every, G, C)
    losses = moe_aux(cfg, logits, probs, every, rules) if aux else None
    # the rank's tokens: (b, rank block) of the replica's B x S, in groups
    t = (torch.arange(B, device=dev)[:, None] * S + rules.cp_offset(Sl)
         + torch.arange(Sl, device=dev)[None, :]).reshape(-1)
    g = (t // Tg)[:, None]
    cols = torch.arange(K, device=dev)[None, :] * Tg + (t % Tg)[:, None]
    rows = g * (E * C + 1) + flat[g, cols]           # (B Sl, K)
    xrep = x.reshape(B * Sl, 1, d).expand(B * Sl, K, d).reshape(-1, d)
    buf = x.new_zeros((G * (E * C + 1), d)).scatter(
        0, rows.reshape(-1, 1).expand(-1, d), xrep)
    buf = buf.reshape(G, E * C + 1, d)[:, :E * C].reshape(G, E, C, d)
    eo = rules.cp_gather(moe_experts(p, rules.cp_scatter(buf, 1)), 1)
    eo = torch.cat([eo.reshape(G, E * C, d), eo.new_zeros((G, 1, d))], 1)
    got = eo.reshape(-1, d)[rows]                     # (B Sl, K, d)
    w = (gate_w * keep[g, cols]).to(x.dtype)
    out = torch.einsum("tk,tkd->td", w, got).reshape(B, Sl, d)
    if cfg.moe.shared_expert:
        out = out + mlp_apply(cfg, p["shared"], x, rules)
    return (out, losses) if aux else out

