"""Griffin / RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427).

Counterpart of ``repro.models.griffin``: the same parameter names, shapes
and functions. The prefill runs the diagonal linear recurrence h_t = a_t
h_{t-1} + b_t as a log-depth doubling scan over the sequence (``_scan``:
ceil(log2 S) steps of whole-tensor products, where the reference runs
``lax.associative_scan``; the sums go in another order, so fp32 outputs
agree to about 1e-6 relative); decode is the O(1) step. Plain PyTorch: the
reference has no Pallas kernel here either.

Over ``model`` (``rules`` contract "rglru": a training plan whose ``model``
divides ``lru_dim``, after the reference's ``"batch,seq,ffn"`` branch) a
rank computes its block of r / m channels: ``proj_x`` / ``proj_y`` /
``proj_out`` / ``lam`` are its parts; ``gate_a`` / ``gate_x``, split on
their rows, give partial sums of all r outputs, which a reduce-scatter
sums to the rank's columns (``rules.scatter_sum``, an all-gather in
backward); the conv and the gate biases, whole on every rank, are used at
the rank's columns (``rules.partial`` sums their gradients);
``proj_out`` contracts "rglru" and the input enters it. A returned state
is gathered back to whole rows (the caches keep it whole).
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


def _parallel(rules: Rules) -> bool:
    return "rglru" in rules.contract_axes


def _cols(cfg, rules: Rules) -> slice:
    """The rank's block of the ``lru_dim`` channels."""
    w = lru_dim(cfg) // rules.model
    return slice(rules.model_rank * w, (rules.model_rank + 1) * w)


def _rank_part(cfg, p: Params, rules: Rules) -> Params:
    """The leaves at the rank's block of channels (module doc): the split
    leaves as they are, the whole ones cut to its columns through
    ``rules.partial``."""
    names = ("conv_w", "conv_b", "gate_a_b", "gate_x_b")
    whole = rules.partial(*(p[n] for n in names))
    c = _cols(cfg, rules)
    return dict(p, **{n: t[..., c] for n, t in zip(names, whole)})


def _gates(p: Params, u: torch.Tensor, rules: Rules = NO_RULES):
    """u: (..., r) post-conv branch input -> (a, gated input), fp32. Over
    ``model`` (module doc) u is the rank's channels and the gates' partial
    sums are reduce-scattered to them, both in one collective."""
    uf = u.float()
    ya, yx = uf @ p["gate_a"].float(), uf @ p["gate_x"].float()
    if _parallel(rules):
        ya, yx = rules.scatter_sum(torch.stack([ya, yx], -2), -1).unbind(-2)
    r_t = torch.sigmoid(ya + p["gate_a_b"])
    i_t = torch.sigmoid(yx + p["gate_x_b"])
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

    Over ``model`` (``rules`` contract "rglru"): the module doc.

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
    par = _parallel(rules)
    if par:
        x = rules.enter(x, "rglru")
        p = _rank_part(cfg, p, rules)
    B, S, _ = x.shape
    u = x @ p["proj_x"]
    gate = _gelu(x @ p["proj_y"])
    conv_in = u
    a, b = _gates(p, _conv(p, u), rules)
    if length is not None:
        lv = torch.as_tensor(length, device=x.device).expand(B)
        live = (torch.arange(S, device=x.device)[None, :]
                < lv[:, None])[..., None]
        a = torch.where(live, a, torch.ones_like(a))
        b = torch.where(live, b, torch.zeros_like(b))
    hh = _scan(a, b)
    out = rules.contract((hh.to(x.dtype) * gate) @ p["proj_out"], "rglru")
    if not return_state:
        return out
    w = p["conv_w"].shape[0]
    conv = gather_conv_state(conv_in, length, w) if length is not None \
        else last_rows(conv_in, w)
    return out, _whole({"h": hh[:, -1].float(), "conv": conv.to(x.dtype)},
                       rules, par)


def _whole(state: Params, rules: Rules, par: bool) -> Params:
    """A state of the rank's channels (the last dim) gathered whole."""
    if not par:
        return state
    return {k: rules.all_gather(t, t.dim() - 1, "model")
            for k, t in state.items()}


def rglru_state_shapes(cfg, batch: int):
    """(shape, dtype) of each decode-state leaf for ``batch`` slots."""
    r = lru_dim(cfg)
    return {"h": ((batch, r), torch.float32),
            "conv": ((batch, CONV_WIDTH - 1, r), getattr(torch, cfg.dtype))}


def _token_step(p: Params, h_prev: torch.Tensor, conv_prev: torch.Tensor,
                u: torch.Tensor, rules: Rules = NO_RULES):
    """One recurrent token: (h, conv) x u (B, r) -> (h', conv')."""
    hist = torch.cat([conv_prev, u[:, None]], 1)                # (B, w, r)
    conv_out = torch.einsum("bwr,wr->br", hist, p["conv_w"]) + p["conv_b"]
    a, b = _gates(p, conv_out, rules)
    return a * h_prev + b, hist[:, 1:]


def rglru_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                 rules: Rules = NO_RULES):
    """Decode step. x: (B, T, d); cache {"h": (B, r), "conv": (B, 3, r)}.
    T == 1 returns plain states; T > 1 (a speculative verify block) runs T
    steps and returns checkpointed states ({"h": (B, T, r), "conv": (B, T,
    3, r)}, state t after block row t). Returns (out, new state); the cache
    is read, never written. Over ``model`` (module doc) a rank steps its
    channels of the state and the new state is gathered whole."""
    T = x.shape[1]
    h, conv = cache["h"], cache["conv"]
    par = _parallel(rules)
    if par:
        p = _rank_part(cfg, p, rules)
        h, conv = h[..., _cols(cfg, rules)], conv[..., _cols(cfg, rules)]
    u_all = x @ p["proj_x"]
    gate_all = _gelu(x @ p["proj_y"])
    hs, convs = [], []
    for t in range(T):
        h, conv = _token_step(p, h, conv, u_all[:, t], rules)
        hs.append(h)
        convs.append(conv)
    h_seq = torch.stack(hs, 1)                                  # (B, T, r)
    out = rules.contract((h_seq.to(x.dtype) * gate_all) @ p["proj_out"],
                         "rglru")
    if T == 1:
        return out, _whole({"h": hs[0], "conv": convs[0]}, rules, par)
    return out, _whole({"h": h_seq, "conv": torch.stack(convs, 1)}, rules,
                       par)
