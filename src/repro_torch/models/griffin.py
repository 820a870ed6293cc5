"""Griffin / RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427).

Counterpart of ``repro.models.griffin``: the same parameter names, shapes
and functions. The prefill runs the diagonal linear recurrence h_t = a_t
h_{t-1} + b_t as a log-depth doubling scan over the sequence (``_scan``:
ceil(log2 S) steps of whole-tensor products, where the reference runs
``lax.associative_scan``; the sums go in another order, so fp32 outputs
agree to about 1e-6 relative); decode is the O(1) step. Plain PyTorch: the
reference has no Pallas kernel here either.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import NO_RULES, Rules

_C = 8.0  # RG-LRU constant
CONV_WIDTH = 4  # temporal conv width (RecurrentGemma uses 4)

Params = Dict[str, torch.Tensor]


def lru_dim(cfg) -> int:
    return cfg.hybrid.lru_dim or cfg.d_model


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv, width 4, over axis 1 (the reference's sum
    order: the bias, then taps 0..3)."""
    w, S = p["conv_w"].shape[0], x.shape[1]
    out = p["conv_b"] * torch.ones_like(x)
    for i in range(w):
        xs = F.pad(x, (0, 0, w - 1 - i, 0))[:, :S]
        out = out + p["conv_w"][i] * xs
    return out


def _gates(p: Params, u: torch.Tensor):
    """u: (..., r) post-conv branch input -> (a, gated input), fp32."""
    uf = u.float()
    r_t = torch.sigmoid(uf @ p["gate_a"].float() + p["gate_a_b"])
    i_t = torch.sigmoid(uf @ p["gate_x"].float() + p["gate_x_b"])
    log_a = -_C * F.softplus(p["lam"]) * r_t
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i_t * uf)
    return a, gated


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0, by doubling: at
    step d each position absorbs the segment ending d before it, (a, b) <-
    (a a', a b' + b), so after ceil(log2 S) steps b holds h."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def gather_conv_state(conv_in: torch.Tensor, length, w: int) -> torch.Tensor:
    """Last ``w - 1`` real rows of a right-padded (B, S, C) input at the
    per-batch ``length``; rows before position 0 are zero (the exact-length
    path's left pad)."""
    B, S = conv_in.shape[0], conv_in.shape[1]
    lv = torch.as_tensor(length, dtype=torch.long,
                         device=conv_in.device).expand(B)
    idx = lv[:, None] - (w - 1) + torch.arange(w - 1,
                                               device=conv_in.device)[None]
    g = torch.gather(conv_in, 1, idx.clamp(0, S - 1)[..., None].expand(
        B, w - 1, conv_in.shape[2]))
    return torch.where(idx[..., None] >= 0, g, torch.zeros_like(g))


def last_rows(conv_in: torch.Tensor, w: int) -> torch.Tensor:
    """Last ``w - 1`` rows of an exact-length (B, S, C) input, zero rows in
    front when S < w - 1."""
    st = conv_in[:, -(w - 1):]
    return F.pad(st, (0, 0, w - 1 - st.shape[1], 0))


def rglru_apply(cfg, p: Params, x: torch.Tensor, *,
                return_state: bool = False, length=None,
                rules: Rules = NO_RULES):
    """Full-sequence RG-LRU block. x: (B, S, d). ``length`` (None, an int
    or (B,)): real tokens of a right-padded bucket; updates at padded rows
    are the identity (a = 1, b = 0), so the returned state is the state at
    length - 1, and the conv state is gathered at ``length``. Returns out,
    or (out, {"h": (B, r) fp32, "conv": (B, 3, r)}).

    Context parallelism (``rules.seq``): x is the rank's block of the
    sequence; it is gathered whole (``rules.cp_gather``), the conv and the
    scan run over the whole sequence on every rank (M times a rank's
    share of the work), and the rank keeps its rows of the output; the
    state is the whole sequence's, the same on every rank."""
    if rules.seq:
        out = rglru_apply(cfg, p, rules.cp_gather(x),
                          return_state=return_state, length=length)
        if not return_state:
            return rules.cp_own(out)
        return rules.cp_own(out[0]), out[1]
    B, S, _ = x.shape
    u = x @ p["proj_x"]
    gate = _gelu(x @ p["proj_y"])
    conv_in = u
    a, b = _gates(p, _conv(p, u))
    if length is not None:
        lv = torch.as_tensor(length, device=x.device).expand(B)
        live = (torch.arange(S, device=x.device)[None, :]
                < lv[:, None])[..., None]
        a = torch.where(live, a, torch.ones_like(a))
        b = torch.where(live, b, torch.zeros_like(b))
    hh = _scan(a, b)
    out = (hh.to(x.dtype) * gate) @ p["proj_out"]
    if not return_state:
        return out
    w = p["conv_w"].shape[0]
    conv = gather_conv_state(conv_in, length, w) if length is not None \
        else last_rows(conv_in, w)
    return out, {"h": hh[:, -1].float(), "conv": conv.to(x.dtype)}


def rglru_state_shapes(cfg, batch: int):
    """(shape, dtype) of each decode-state leaf for ``batch`` slots."""
    r = lru_dim(cfg)
    return {"h": ((batch, r), torch.float32),
            "conv": ((batch, CONV_WIDTH - 1, r), getattr(torch, cfg.dtype))}


def _token_step(p: Params, h_prev: torch.Tensor, conv_prev: torch.Tensor,
                u: torch.Tensor):
    """One recurrent token: (h, conv) x u (B, r) -> (h', conv')."""
    hist = torch.cat([conv_prev, u[:, None]], 1)                # (B, w, r)
    conv_out = torch.einsum("bwr,wr->br", hist, p["conv_w"]) + p["conv_b"]
    a, b = _gates(p, conv_out)
    return a * h_prev + b, hist[:, 1:]


def rglru_decode(cfg, p: Params, x: torch.Tensor, cache: Params):
    """Decode step. x: (B, T, d); cache {"h": (B, r), "conv": (B, 3, r)}.
    T == 1 returns plain states; T > 1 (a speculative verify block) runs T
    steps and returns checkpointed states ({"h": (B, T, r), "conv": (B, T,
    3, r)}, state t after block row t). Returns (out, new state); the cache
    is read, never written."""
    T = x.shape[1]
    u_all = x @ p["proj_x"]
    gate_all = _gelu(x @ p["proj_y"])
    h, conv = cache["h"], cache["conv"]
    hs, convs = [], []
    for t in range(T):
        h, conv = _token_step(p, h, conv, u_all[:, t])
        hs.append(h)
        convs.append(conv)
    h_seq = torch.stack(hs, 1)                                  # (B, T, r)
    out = (h_seq.to(x.dtype) * gate_all) @ p["proj_out"]
    if T == 1:
        return out, {"h": hs[0], "conv": convs[0]}
    return out, {"h": h_seq, "conv": torch.stack(convs, 1)}
