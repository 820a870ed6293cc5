"""Mamba2 (SSD, state-space duality) mixer (arXiv:2405.21060).

Counterpart of ``repro.models.ssm``: the same parameter names, shapes and
functions. The prefill runs the chunked SSD algorithm (``_ssd_scan``): a
loop over chunks whose intra-chunk terms are batched products, carrying
the (B, heads, head_dim, state) state from chunk to chunk; decode is the
O(1) recurrent step. Plain PyTorch: the reference has no Pallas kernel
here either. The SSM state is fp32, the conv state in the model dtype.

Over ``model`` (``rules`` contract "ssm": a training plan whose ``model``
divides the heads, after the reference's ``"batch,seq,heads"`` ``xin``) a
rank computes its nheads / m heads: their channels of ``z``, ``x`` and
``dt``, and the whole ``B`` and ``C`` (one group, which every head reads).
``in_proj``'s stored split is contiguous over all of its columns (z, x, B,
C, dt), so the rank's product with its columns is gathered whole along
them (``rules.gather_sum``: each rank's gradient of B and C is partial, so
the gradient is summed back to the parts); an ``in_proj`` whose columns do
not divide is whole on every rank and used whole. The conv runs on the
rank's ``x`` channels and the whole ``B`` and ``C`` channels, the SSD scan
on its heads; ``A_log`` / ``D`` / ``dt_bias`` are its parts; the gated
rmsnorm's mean square over all of ``d_inner`` is summed over the ranks in
both directions (``rules.sum_both``: the downstream differs per rank);
``out_proj``'s rows are the rank's heads' and contract "ssm", which the
input enters. The leaves whole on every rank (the conv, the norm's scale,
a whole ``in_proj``) sum their gradients (``rules.partial``). A returned
state is gathered back to whole heads (the caches keep it whole).
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


def _parallel(rules: Rules) -> bool:
    return "ssm" in rules.contract_axes


def _rank_cols(cfg, rules: Rules):
    """(the rank's x channels, its heads) as slices of d_inner and of
    nheads (module doc)."""
    d_inner, nheads, _ = dims(cfg)
    dl, hl, r = d_inner // rules.model, nheads // rules.model, \
        rules.model_rank
    return slice(r * dl, (r + 1) * dl), slice(r * hl, (r + 1) * hl)


def _rank_conv(cfg, t: torch.Tensor, rules: Rules) -> torch.Tensor:
    """The rank's conv channels of ``t`` (..., conv channels): its x
    channels, then every B and C channel."""
    d_inner = dims(cfg)[0]
    xc, _ = _rank_cols(cfg, rules)
    return torch.cat([t[..., xc], t[..., d_inner:]], -1)


def _rank_part(cfg, p: Params, rules: Rules):
    """(the leaves at the rank's heads and conv channels, whether
    ``in_proj`` is split over ``model``): the whole leaves (the conv, the
    norm's scale, an ``in_proj`` whose columns do not divide) through
    ``rules.partial``, cut to the rank's channels. A world of one rank
    takes ``in_proj`` as split."""
    s = cfg.ssm
    d_inner, nheads, _ = dims(cfg)
    in_dim = 2 * d_inner + 2 * s.num_groups * s.state_dim + nheads
    split = p["in_proj"].shape[-1] * rules.model == in_dim
    names = ("conv_w", "conv_b", "scale") + (() if split else ("in_proj",))
    leaves = dict(p, scale=p["norm"]["scale"])
    whole = dict(zip(names, rules.partial(*(leaves[n] for n in names))))
    xc, _ = _rank_cols(cfg, rules)
    out = dict(p, conv_w=_rank_conv(cfg, whole["conv_w"], rules),
               conv_b=_rank_conv(cfg, whole["conv_b"], rules),
               norm=dict(p["norm"], scale=whole["scale"][xc]))
    if not split:
        out["in_proj"] = whole["in_proj"]
    return out, split


def _zxbcdt(cfg, p: Params, x: torch.Tensor, rules: Rules, par: bool,
            split: bool):
    """x @ in_proj as (z, xBC, dt): whole, or over ``model`` the rank's z
    channels, conv channels (``_rank_conv``) and dt heads of the whole
    product (a split ``in_proj``'s parts gathered, ``rules.gather_sum``)."""
    zx = x @ p["in_proj"]
    if not par:
        return _split(cfg, zx)
    if split:
        zx = rules.gather_sum(zx, zx.dim() - 1)
    z, xBC, dt = _split(cfg, zx)
    xc, hc = _rank_cols(cfg, rules)
    return z[..., xc], _rank_conv(cfg, xBC, rules), dt[..., hc]


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, rules: Rules,
                par: bool) -> torch.Tensor:
    """rmsnorm(y) * silu(z) over all of d_inner (``layers.norm_apply``'s
    arithmetic): over ``model`` y holds the rank's channels, whose mean
    squares the ranks average (``rules.sum_both``)."""
    if not par:
        return norm_apply(p["norm"], y, "rmsnorm") * F.silu(z)
    yf = y.float()
    var = rules.sum_both(yf.square().mean(-1, keepdim=True)) / rules.model
    out = yf * torch.rsqrt(var + 1e-6) * p["norm"]["scale"]
    return out.to(y.dtype) * F.silu(z)


def _whole(cfg, state: Params, rules: Rules, par: bool,
           head_dim: int) -> Params:
    """A state of the rank's heads gathered whole: the SSM state along its
    heads (``head_dim``), the conv state's x channels along its channels
    (its B and C channels are every rank's)."""
    if not par:
        return state
    nx = dims(cfg)[0] // rules.model
    conv = state["conv"]
    last = conv.dim() - 1
    return {"ssm": rules.all_gather(state["ssm"], head_dim, "model"),
            "conv": torch.cat([rules.all_gather(
                conv[..., :nx].contiguous(), last, "model"),
                conv[..., nx:]], last)}


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
    dtype before their product with x, as in the reference. The decays
    above the diagonal are masked before their exp, not after: there the
    segment sums are positive and, over a long chunk, overflow to inf,
    whose masked gradient (0 · inf) would be NaN; the values are the
    reference's bit for bit, and the gradient is finite where the
    reference's (which masks after its exp) is NaN."""
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
        lmask = torch.exp(torch.where(tril, seg, -torch.inf))
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

    Over ``model`` (``rules`` contract "ssm"): the module doc.

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
    par = _parallel(rules)
    split = False
    if par:
        x = rules.enter(x, "ssm")
        p, split = _rank_part(cfg, p, rules)
    b, l = x.shape[0], x.shape[1]
    z, xBC_raw, dt = _zxbcdt(cfg, p, x, rules, par, split)
    d_inner, nheads = z.shape[-1], dt.shape[-1]       # the rank's
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
    y = _gated_norm(p, y.reshape(b, l, d_inner), z, rules, par)
    out = rules.contract(y @ p["out_proj"], "ssm")
    if not return_state:
        return out
    w = s.conv_width
    conv = gather_conv_state(xBC_raw, length, w) if length is not None \
        else last_rows(xBC_raw, w)
    return out, _whole(cfg, {"ssm": S_final.float(),
                             "conv": conv.to(x.dtype)}, rules, par, 1)


def ssm_state_shapes(cfg, batch: int):
    """(shape, dtype) of each decode-state leaf for ``batch`` slots."""
    s = cfg.ssm
    _, nheads, conv_dim = dims(cfg)
    return {"ssm": ((batch, nheads, s.head_dim, s.state_dim), torch.float32),
            "conv": ((batch, s.conv_width - 1, conv_dim),
                     getattr(torch, cfg.dtype))}


def _token_step(cfg, p: Params, S_prev: torch.Tensor,
                conv_prev: torch.Tensor, z: torch.Tensor, xBC: torch.Tensor,
                dt: torch.Tensor, rules: Rules = NO_RULES, par: bool = False):
    """One recurrent token: (S, conv) x (z, xBC, dt) (B, ...) -> (S', conv',
    y), at the rank's heads and channels over ``model``."""
    s = cfg.ssm
    d_inner, nheads = z.shape[-1], dt.shape[-1]
    hist = torch.cat([conv_prev, xBC[:, None]], 1)            # (B, w, conv)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, p["conv_w"])
                      + p["conv_b"])
    gn = s.num_groups * s.state_dim
    xin, B_, C_ = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    bsz = z.shape[0]
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
    y = y.reshape(bsz, d_inner).to(z.dtype)
    return S, hist[:, 1:], _gated_norm(p, y, z, rules, par)


def ssm_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
               rules: Rules = NO_RULES):
    """Recurrent decode step. x: (B, T, d); cache {"ssm", "conv"}. T == 1
    returns plain states; T > 1 (a speculative verify block) runs T token
    steps and returns checkpointed states ({"ssm": (B, T, h, p, n),
    "conv": (B, T, w - 1, conv)}, state t after block row t). Returns (out,
    new state); the cache is read, never written. Over ``model`` (module
    doc) a rank steps its heads of the state and the new state is gathered
    whole."""
    T = x.shape[1]
    S, conv = cache["ssm"], cache["conv"]
    par = _parallel(rules)
    split = False
    if par:
        p, split = _rank_part(cfg, p, rules)
        S = S[:, _rank_cols(cfg, rules)[1]]
        conv = _rank_conv(cfg, conv, rules)
    z, xBC, dt = _zxbcdt(cfg, p, x, rules, par, split)
    Ss, convs, ys = [], [], []
    for t in range(T):
        S, conv, y = _token_step(cfg, p, S, conv, z[:, t], xBC[:, t],
                                 dt[:, t], rules, par)
        Ss.append(S)
        convs.append(conv)
        ys.append(y)
    out = rules.contract(torch.stack(ys, 1) @ p["out_proj"], "ssm")
    if T == 1:
        return out, _whole(cfg, {"ssm": Ss[0], "conv": convs[0]}, rules,
                           par, 1)
    return out, _whole(cfg, {"ssm": torch.stack(Ss, 1),
                             "conv": torch.stack(convs, 1)}, rules, par, 2)
