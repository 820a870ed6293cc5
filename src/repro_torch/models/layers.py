"""Layer library, attention-only subset: rmsnorm/layernorm, rotary embedding,
GQA attention for prefill (flash-MHA kernel) and paged decode (flash-decode
kernel, or the dense-gather baseline through ``attend_decode``), KV-cache
quantization and the gated MLP.

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


def attention_apply(cfg, p: Params, x: torch.Tensor, prefix=None):
    """Causal self-attention over the whole (bucket-padded) prompt through
    the flash-MHA kernel. Bucket padding sits after every real row, so
    causal masking alone keeps the real rows exact. Returns (out, (k, v))
    for the caller to build its cache from.

    prefix=(pk, pv, plen): suffix-only prefill against reused KV (the
    prefix cache). ``x`` holds only the tokens after the shared prefix;
    pk/pv (B, Pb, KV, D, cache dtype) are the prefix KV gathered from the
    page pools, valid for their first ``plen`` rows (a host int). The
    suffix k/v are spliced in at row plen, so buffer index == absolute
    position for every real token, and the kernel's query offset (q[:, 0]
    at plen) masks both the prefix buffer's tail and the suffix's bucket
    padding: those rows sit past every real query. The returned k/v are
    the suffix's only, what the caller scatters into its pages."""
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    plen = 0 if prefix is None else prefix[2]
    positions = plen + torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if prefix is None:
        kf, vf = k, v
    else:
        pk, pv, _ = prefix
        kf = torch.cat([kv_dequant(cfg, pk, x.dtype), torch.zeros_like(k)], 1)
        vf = torch.cat([kv_dequant(cfg, pv, x.dtype), torch.zeros_like(v)], 1)
        kf[:, plen:plen + S] = k
        vf[:, plen:plen + S] = v
    out = ops.attention(q.contiguous(), kf.contiguous(), vf.contiguous(),
                        causal=True, q_offset=plen)
    return _out(p, out), (k, v)


def attention_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, block_table: torch.Tensor):
    """Paged decode step. x: (B, T, d); pos: (B,) int32 position of the
    first new token; cache {"k", "v"}: (P, page, KV, D) page pools;
    block_table: (B, n_blocks) int32. The T new tokens' k/v are scattered
    token by token to page block_table[b, (pos+t) // page], row
    (pos+t) % page — rows past the table go to scratch page 0 — and the
    flash-decode kernel then attends through the block table (with
    ``cfg.paged_attn_impl == "gather"``, a dense gather of the tables'
    pages and ``attend_decode`` instead). The pools are
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
    if cfg.paged_attn_impl == "gather":
        # the reference's baseline: every request's whole table gathered
        # into a dense (B, n_blocks * page, KV, D) copy, then plain
        # attention over it (buffer index == absolute position)
        kg = ck[block_table.long()].flatten(1, 2)
        vg = cv[block_table.long()].flatten(1, 2)
        out = attend_decode(q, kv_dequant(cfg, kg, q.dtype),
                            kv_dequant(cfg, vg, q.dtype), pos,
                            kv_chunk=cfg.decode_kv_chunk)
    else:
        scale = cfg.kv_scale if ck.dtype == torch.int8 else None
        out = ops.paged_attention(q.contiguous(), ck, cv, block_table,
                                  pos + T, kv_scale=scale)
    return _out(p, out), cache


def attend_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  pos: torch.Tensor, *, window: int = 0,
                  kv_chunk: int = 0) -> torch.Tensor:
    """Decode attention against a contiguous cache whose buffer index is the
    key's absolute position: the reference's ``attend_decode`` with
    ``ring=False`` (the ring-buffer layout waits for the hybrid stacks).
    q: (B, Tq, H, D), row t at position pos + t; ck/cv: (B, S, KV, D);
    pos: (B,) position of the first row. Row t attends to keys at
    positions <= pos + t (in-block causal), and with ``window`` > 0 only
    to the last ``window`` of them. The keys go in chunks of ``kv_chunk``
    (one chunk if 0 or if it does not divide S) through an online
    softmax, scores and sums in fp32, P cast to the cache dtype before the
    P V product, as in the reference. Returns q's shape and dtype."""
    B, Tq, H, D = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, Tq, KV, G, D).float()
    nvalid = (pos[:, None] + torch.arange(Tq, device=dev)[None, :]
              + 1)                                         # (B, Tq)
    c = S if kv_chunk <= 0 else min(kv_chunk, S)
    if S % c:
        c = S
    m = torch.full((B, KV, G, Tq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Tq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, KV, G, Tq, D), dtype=torch.float32, device=dev)
    for i in range(0, S, c):
        kb, vb = ck[:, i:i + c], cv[:, i:i + c]
        s = torch.einsum("btkgd,bckd->bkgtc", qg, kb.float()) * D ** -0.5
        slots = i + torch.arange(c, device=dev)
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
    o = o / l[..., None].clamp(min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, D).to(q.dtype)


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
