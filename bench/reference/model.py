"""Plain PyTorch reference of the qwen2 and dbrx decoder blocks, written
from the configuration files (``dims``), in float32 (``precision="fp32"``)
or with every matrix product's operands rounded to fp8 e4m3
(``precision="fp8"``: the correctness control).

It imports nothing of the port. It reads the benchmark's weights (the
port's layout: ``wq`` (d, H, D), ``wo`` (H, D, d), an MLP's ``wi`` /
``wg`` / ``wo``, an MoE's ``router`` (d, E) and ``wi`` / ``wg`` (E, d, f),
``wo`` (E, f, d)) and casts each to float32 as it uses it.

``served_logits`` scores the tokens a request was served: a prefill over
the prompt padded to its bucket with token 0 (padding takes MoE capacity,
as the rule in the configuration file says), then every served token
but the last fed back at positions L, L + 1, ... attending the prompt's
keys and its own predecessors. Row j of the result is the distribution
that chose served token j."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from bench.reference.dims import Dims, capacity

Q_BLOCK = 512          # query rows an attention block
HEAD_ROWS = 256        # rows a block of the vocabulary head


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to fp8 e4m3 with an absmax scale along ``dim``, back in
    float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class Ops:
    """The matrix product and weight cast of one precision."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32|fp8: {precision}")
        self.fp8 = precision == "fp8"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A (.., in, out) weight in float32 (fp8: per output column)."""
        t = t.float()
        return _fp8(t, -2) if self.fp8 else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (.., in) @ w (in, out), w already through ``self.w``."""
        if self.fp8:
            x = _fp8(x, -1)
        return x @ w


def _norm(dm: Dims, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if dm.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + dm.norm_eps) * p["scale"].float() \
            + p["bias"].float()
    var = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + dm.norm_eps) * p["scale"].float()


def _rope(dm: Dims, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x (S, H, D) at positions pos (S,): rotate the halves."""
    half = dm.head_dim // 2
    i = torch.arange(half, dtype=torch.float64, device=x.device)
    inv = (dm.rope_theta ** (-i / half)).float()
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _qkv(dm: Dims, ops: Ops, p: Dict, h: torch.Tensor, pos: torch.Tensor):
    d, H, KV, D = dm.d, dm.heads, dm.kv_heads, dm.head_dim
    q = ops.mm(h, ops.w(p["wq"].reshape(d, H * D))).view(-1, H, D)
    k = ops.mm(h, ops.w(p["wk"].reshape(d, KV * D))).view(-1, KV, D)
    v = ops.mm(h, ops.w(p["wv"].reshape(d, KV * D))).view(-1, KV, D)
    if dm.qkv_bias:
        q = q + p["bq"].float()
        k = k + p["bk"].float()
        v = v + p["bv"].float()
    if dm.clip_qkv is not None:
        c = float(dm.clip_qkv)
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
    return _rope(dm, q, pos), _rope(dm, k, pos), v


def _attend(dm: Dims, q, qpos, k, v, kpos) -> torch.Tensor:
    """Causal GQA: query row i sees keys with kpos <= qpos[i]; head j reads
    KV head j // (H / KV). -> (S, H * D)."""
    H, KV, D = dm.heads, dm.kv_heads, dm.head_dim
    G = H // KV
    out = [q.new_zeros((0, H * D))]
    for lo in range(0, q.shape[0], Q_BLOCK):
        qb = q[lo:lo + Q_BLOCK].view(-1, KV, G, D)
        s = torch.einsum("qkgd,tkd->kgqt", qb, k) / math.sqrt(D)
        mask = kpos[None, :] <= qpos[lo:lo + Q_BLOCK, None]
        s = s.masked_fill(~mask, float("-inf"))
        o = torch.einsum("kgqt,tkd->qkgd", torch.softmax(s, -1), v)
        out.append(o.reshape(qb.shape[0], H * D))
    return torch.cat(out, 0)


def _mlp(ops: Ops, p: Dict, h: torch.Tensor) -> torch.Tensor:
    return ops.mm(F.silu(ops.mm(h, ops.w(p["wg"]))) * ops.mm(h, ops.w(p["wi"])),
                  ops.w(p["wo"]))


def route(dm: Dims, router: torch.Tensor, h: torch.Tensor, groups: bool):
    """(weights (T, K), experts (T, K), keep (T, K)): softmax over the
    experts in float32, the top K by a stable descending sort, weights
    renormalised; with ``groups`` the file's capacity rule over these T
    rows, else every slot kept."""
    T, K, E = h.shape[0], dm.top_k, dm.experts
    probs = torch.softmax(h @ router.float(), -1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[:, :K], e[:, :K]
    w = w / w.sum(-1, keepdim=True)
    if not groups:
        return w, e, torch.ones_like(e, dtype=torch.bool)
    G, C = capacity(dm, T)
    tg = T // G
    keep = torch.empty_like(e, dtype=torch.bool)
    for g in range(G):
        rows = slice(g * tg, (g + 1) * tg)
        order = e[rows].T.reshape(-1)          # slot-major: choice k, row t
        onehot = F.one_hot(order, E)
        rank = (onehot.cumsum(0) - 1).gather(1, order[:, None])[:, 0]
        keep[rows] = (rank < C).view(K, tg).T
    return w, e, keep


def _moe(dm: Dims, ops: Ops, p: Dict, h: torch.Tensor,
         groups: bool) -> torch.Tensor:
    w, e, keep = route(dm, p["router"], h, groups)
    out = torch.zeros_like(h)
    for x in range(dm.experts):
        sel = (e == x) & keep
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        gate = (w * sel).sum(-1)[rows]
        hx = h[rows]
        y = ops.mm(F.silu(ops.mm(hx, ops.w(p["wg"][x])))
                   * ops.mm(hx, ops.w(p["wi"][x])), ops.w(p["wo"][x]))
        out.index_add_(0, rows, gate[:, None] * y)
    return out


def decode_never_drops(dm: Dims, slots: int) -> bool:
    """Whether the capacity rule can bind at a decode step of ``slots``
    rows: a row's K choices are distinct experts, so an expert gets at most
    one slot a row, T / G a group."""
    if not dm.moe:
        return True
    G, C = capacity(dm, slots)
    return C >= slots // G


def served_logits(dm: Dims, w: Dict, prompt: List[int], served: List[int],
                  bucket: int, slots: int, *, precision: str = "fp32",
                  device=None) -> torch.Tensor:
    """(len(served), vocab) float32 logits; row j scores served[j]."""
    if not decode_never_drops(dm, slots):
        raise ValueError(
            f"at {slots} decode rows the capacity rule drops by what the "
            f"other rows route: a request alone cannot be followed")
    ops = Ops(precision)
    dev = device or w["embed"].device
    L, n = len(prompt), len(served)
    tok_p = torch.zeros(bucket, dtype=torch.long, device=dev)
    tok_p[:L] = torch.tensor(prompt, device=dev)
    tok_d = torch.tensor(served[:-1], dtype=torch.long, device=dev)
    pos_p = torch.arange(bucket, device=dev)
    pos_d = torch.arange(L, L + n - 1, device=dev)
    emb = w["embed"]
    xp, xd = emb[tok_p].float(), emb[tok_d].float()
    for p in w["blocks"]:
        hp, hd_ = _norm(dm, p["ln1"], xp), _norm(dm, p["ln1"], xd)
        qp, kp, vp = _qkv(dm, ops, p["attn"], hp, pos_p)
        qd, kd, vd = _qkv(dm, ops, p["attn"], hd_, pos_d)
        wo = ops.w(p["attn"]["wo"].reshape(-1, dm.d))
        xp = xp + ops.mm(_attend(dm, qp, pos_p, kp, vp, pos_p), wo)
        kall = torch.cat([kp[:L], kd])
        vall = torch.cat([vp[:L], vd])
        pall = torch.cat([pos_p[:L], pos_d])
        xd = xd + ops.mm(_attend(dm, qd, pos_d, kall, vall, pall), wo)
        hp, hd_ = _norm(dm, p["ln2"], xp), _norm(dm, p["ln2"], xd)
        if dm.moe:
            xp = xp + _moe(dm, ops, p["moe"], hp, groups=True)
            xd = xd + _moe(dm, ops, p["moe"], hd_, groups=False)
        else:
            xp = xp + _mlp(ops, p["mlp"], hp)
            xd = xd + _mlp(ops, p["mlp"], hd_)
    x = _norm(dm, w["final_norm"], torch.cat([xp[L - 1:L], xd]))
    head = w["embed"].T if dm.tied else w["head"]
    hw = ops.w(head[:, :dm.vocab])
    return torch.cat([ops.mm(x[lo:lo + HEAD_ROWS], hw)
                      for lo in range(0, x.shape[0], HEAD_ROWS)], 0)
