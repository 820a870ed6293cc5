"""Mamba2 (SSD, state-space duality) mixer (arXiv:2405.21060).

Counterpart of ``repro.models.ssm``: the same parameter names, shapes and
functions. The prefill runs the chunked SSD algorithm (``_ssd_scan``): a
loop over chunks whose intra-chunk terms are batched products, carrying
the (B, heads, head_dim, state) state from chunk to chunk; decode is the
O(1) recurrent step. Plain PyTorch: the reference has no Pallas kernel
here either. The SSM state is fp32, the conv state in the model dtype.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.griffin import gather_conv_state, last_rows
from repro_torch.models.layers import norm_apply
from repro_torch.parallel.sharding import NO_RULES, Rules

Params = Dict[str, torch.Tensor]


def dims(cfg):
    """(d_inner, heads, conv channels)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.num_groups * s.state_dim
    return d_inner, nheads, conv_dim


def _split(cfg, zxbcdt: torch.Tensor):
    """-> z (d_inner), xBC (d_inner + 2 groups * state), dt (heads)."""
    s = cfg.ssm
    d_inner, nheads, _ = dims(cfg)
    gn = s.num_groups * s.state_dim
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, nheads], dim=-1)


def _conv(cfg, p: Params, xBC: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over axis 1, then silu."""
    w, S = cfg.ssm.conv_width, xBC.shape[1]
    out = p["conv_b"] * torch.ones_like(xBC)
    for i in range(w):
        xs = F.pad(xBC, (0, 0, w - 1 - i, 0))[:, :S]
        out = out + p["conv_w"][i] * xs
    return F.silu(out)


def _ssd_scan(x, dt, A, B, C, chunk: int):
    """Chunked SSD. x: (b, l, h, p), dt: (b, l, h) fp32, A: (h,) fp32, B, C:
    (b, l, g, n). Returns (y (b, l, h, p) in x's dtype, final state (b, h,
    p, n) fp32). Products accumulate in fp32 (the reference's
    ``preferred_element_type``); the intra-chunk scores are cast to x's
    dtype before their product with x, as in the reference."""
    b, l, h, pdim = x.shape
    g, n = B.shape[2], B.shape[3]
    Q = min(chunk, l)
    pad = (-l) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (l + pad) // Q
    rep = h // g
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    S = torch.zeros((b, h, pdim, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq = x[:, sl], B[:, sl], C[:, sl]
        dtq = dt[:, sl].permute(0, 2, 1)                   # (b, h, Q)
        cum = torch.cumsum(dtq * A[None, :, None], -1)
        seg = cum[..., :, None] - cum[..., None, :]         # (b, h, Q, Q)
        lmask = torch.where(tril, torch.exp(seg), torch.zeros_like(seg))
        CB = torch.einsum("bqgn,bkgn->bgqk", Cq.float(), Bq.float())
        scores = CB.repeat_interleave(rep, 1) * lmask * dtq[:, :, None, :]
        y = torch.einsum("bhqk,bkhp->bqhp", scores.to(x.dtype).float(),
                         xq.float())
        # the state entering the chunk
        Ch = Cq.repeat_interleave(rep, 2).float()           # (b, Q, h, n)
        y = y + torch.einsum("bqhn,bhpn->bqhp", Ch, S) \
            * torch.exp(cum).permute(0, 2, 1)[..., None]
        # the state leaving it
        wq = (torch.exp(cum[..., -1:] - cum) * dtq).permute(0, 2, 1)
        Bh = Bq.repeat_interleave(rep, 2).float()
        dstate = torch.einsum("bqhn,bqhp->bhpn", Bh,
                              wq[..., None] * xq.float())
        S = torch.exp(cum[..., -1])[..., None, None] * S + dstate
        ys.append(y.to(x.dtype))
    return torch.cat(ys, 1)[:, :l], S


def ssm_apply(cfg, p: Params, x: torch.Tensor, *,
              return_state: bool = False, length=None,
              rules: Rules = NO_RULES):
    """Full-sequence Mamba2 mixer. x: (B, S, d). ``length`` (None, an int or
    (B,)): real tokens of a right-padded bucket; padded rows get dt = 0
    (identity updates), so the returned state is the state at length - 1,
    and the conv state gathers the last real pre-activation rows. Returns
    out, or (out, {"ssm": (B, h, p, n) fp32, "conv": (B, w - 1, conv)}).

    Context parallelism (``rules.seq``): as ``griffin.rglru_apply``'s,
    the whole sequence gathered, the conv and the SSD scan run whole on
    every rank, the rank's rows kept."""
    if rules.seq:
        out = ssm_apply(cfg, p, rules.cp_gather(x),
                        return_state=return_state, length=length)
        if not return_state:
            return rules.cp_own(out)
        return rules.cp_own(out[0]), out[1]
    s = cfg.ssm
    d_inner, nheads, _ = dims(cfg)
    b, l = x.shape[0], x.shape[1]
    z, xBC_raw, dt = _split(cfg, x @ p["in_proj"])
    xBC = _conv(cfg, p, xBC_raw)
    gn = s.num_groups * s.state_dim
    xin, B_, C_ = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    xin = xin.reshape(b, l, nheads, s.head_dim)
    B_ = B_.reshape(b, l, s.num_groups, s.state_dim)
    C_ = C_.reshape(b, l, s.num_groups, s.state_dim)
    dt_ = F.softplus(dt.float() + p["dt_bias"])
    if length is not None:
        lv = torch.as_tensor(length, device=x.device).expand(b)
        live = (torch.arange(l, device=x.device)[None, :]
                < lv[:, None])[..., None]
        dt_ = torch.where(live, dt_, torch.zeros_like(dt_))
    A = -torch.exp(p["A_log"])
    y, S_final = _ssd_scan(xin, dt_, A, B_, C_, s.chunk)
    y = y + p["D"][None, None, :, None].to(y.dtype) * xin
    y = norm_apply(p["norm"], y.reshape(b, l, d_inner), "rmsnorm") \
        * F.silu(z)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    w = s.conv_width
    conv = gather_conv_state(xBC_raw, length, w) if length is not None \
        else last_rows(xBC_raw, w)
    return out, {"ssm": S_final.float(), "conv": conv.to(x.dtype)}


def ssm_state_shapes(cfg, batch: int):
    """(shape, dtype) of each decode-state leaf for ``batch`` slots."""
    s = cfg.ssm
    _, nheads, conv_dim = dims(cfg)
    return {"ssm": ((batch, nheads, s.head_dim, s.state_dim), torch.float32),
            "conv": ((batch, s.conv_width - 1, conv_dim),
                     getattr(torch, cfg.dtype))}


def _token_step(cfg, p: Params, S_prev: torch.Tensor,
                conv_prev: torch.Tensor, zxbcdt: torch.Tensor):
    """One recurrent token: (S, conv) x (B, in_dim) -> (S', conv', y)."""
    s = cfg.ssm
    d_inner, nheads, _ = dims(cfg)
    z, xBC, dt = _split(cfg, zxbcdt)
    hist = torch.cat([conv_prev, xBC[:, None]], 1)            # (B, w, conv)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, p["conv_w"])
                      + p["conv_b"])
    gn = s.num_groups * s.state_dim
    xin, B_, C_ = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    bsz = zxbcdt.shape[0]
    rep = nheads // s.num_groups
    xf = xin.reshape(bsz, nheads, s.head_dim).float()
    Bh = B_.reshape(bsz, s.num_groups, s.state_dim).repeat_interleave(
        rep, 1).float()
    Ch = C_.reshape(bsz, s.num_groups, s.state_dim).repeat_interleave(
        rep, 1).float()
    dt_ = F.softplus(dt.float() + p["dt_bias"])                     # (B, h)
    dA = torch.exp(dt_ * -torch.exp(p["A_log"]))
    S = dA[..., None, None] * S_prev \
        + (dt_[..., None] * xf)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, S) + p["D"][None, :, None] * xf
    y = y.reshape(bsz, d_inner).to(zxbcdt.dtype)
    y = norm_apply(p["norm"], y, "rmsnorm") * F.silu(z)
    return S, hist[:, 1:], y


def ssm_decode(cfg, p: Params, x: torch.Tensor, cache: Params):
    """Recurrent decode step. x: (B, T, d); cache {"ssm", "conv"}. T == 1
    returns plain states; T > 1 (a speculative verify block) runs T token
    steps and returns checkpointed states ({"ssm": (B, T, h, p, n),
    "conv": (B, T, w - 1, conv)}, state t after block row t). Returns (out,
    new state); the cache is read, never written."""
    T = x.shape[1]
    zxbcdt = x @ p["in_proj"]
    S, conv = cache["ssm"], cache["conv"]
    Ss, convs, ys = [], [], []
    for t in range(T):
        S, conv, y = _token_step(cfg, p, S, conv, zxbcdt[:, t])
        Ss.append(S)
        convs.append(conv)
        ys.append(y)
    out = torch.stack(ys, 1) @ p["out_proj"]
    if T == 1:
        return out, {"ssm": Ss[0], "conv": convs[0]}
    return out, {"ssm": torch.stack(Ss, 1), "conv": torch.stack(convs, 1)}
