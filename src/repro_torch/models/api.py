"""Model API: init / forward / loss / prefill / decode_step / the caches.

Counterpart of ``repro.models.api``. Training goes ``loss_fn`` ->
``forward_hidden`` -> ``transformer.stack_train`` (plain attention that
autograd differentiates, no cache), then a blockwise cross-entropy; serving
goes ``prefill`` / ``decode_step`` through the kernels. Parameters are a
plain dict: ``embed`` (Vp, d), ``final_norm``, ``head`` (d, Vp) unless the
embeddings are tied, ``blocks`` — one dict per layer in order, with the
JAX package's names and shapes (``repro_torch.convert`` builds it from a JAX
tree) — and for an encoder-decoder ``enc`` ({"blocks", "final_norm"}).
Caches are a list, one entry per layer: page pools
(``paged_cache_init``) or one dense lane a slot (``cache_init``) for the
attention layers, per-slot state for the recurrent ones;
``state_slot_export`` / ``state_slot_import`` move one slot's state out and
back (the host tier's swap of a hybrid request).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import checkpoint

from repro_torch.models import griffin, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import norm_apply
from repro_torch.parallel.sharding import NO_RULES, Rules


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class _Maker:
    """Makes each parameter leaf of ``_build``'s tree from (shape, logical
    axes, how to fill it), as the reference's ``Maker`` does: in mode
    ``"init"`` the tensor, drawn on ``device`` from ``generator``; in
    ``"axes"`` the reference's logical-axes string; in ``"shape"`` the
    shape; in ``"empty"`` an uninitialised tensor of its dtype on
    ``device``."""

    def __init__(self, mode: str, generator=None, device=None, dtype=None):
        self.mode, self.generator = mode, generator
        self.device, self.dtype = device, dtype

    def _other(self, shape, axes: str, dtype):
        if self.mode == "empty":
            return torch.empty(shape, dtype=dtype or self.dtype,
                               device=self.device)
        return axes if self.mode == "axes" else torch.Size(shape)

    def normal(self, shape, axes: str, scale: float, dtype=None):
        if self.mode != "init":
            return self._other(shape, axes, dtype)
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return (x * scale).to(dtype or self.dtype)

    def experts(self, shape, axes: str, scale: float):
        """(E, ...) drawn one expert at a time."""
        if self.mode != "init":
            return self._other(shape, axes, None)
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        for e in range(shape[0]):
            out[e] = self.normal(shape[1:], axes, scale)
        return out

    def full(self, shape, axes: str, value: float, dtype=None):
        if self.mode != "init":
            return self._other(shape, axes, dtype)
        return torch.full(shape, value, dtype=dtype or self.dtype,
                          device=self.device)


def _build(cfg, mk: _Maker) -> Dict[str, Any]:
    """The parameter tree, leaf by leaf through ``mk``."""
    f32 = torch.float32

    def norm(d):
        p = {"scale": mk.full((d,), "", 1.0, f32)}
        if cfg.norm == "layernorm":
            p["bias"] = mk.full((d,), "", 0.0, f32)
        return p

    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)

    def attn():
        a = {"wq": mk.normal((d, h, hd), "wembed,wheads", d ** -0.5),
             "wk": mk.normal((d, kv, hd), "wembed,wkv_heads", d ** -0.5),
             "wv": mk.normal((d, kv, hd), "wembed,wkv_heads", d ** -0.5),
             "wo": mk.normal((h, hd, d), "wheads,,wembed",
                             (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            a.update(bq=mk.full((h, hd), "wheads", 0.0),
                     bk=mk.full((kv, hd), "wkv_heads", 0.0),
                     bv=mk.full((kv, hd), "wkv_heads", 0.0))
        return a

    def mlp():
        m = {"wi": mk.normal((d, f), "wembed,wff", d ** -0.5),
             "wo": mk.normal((f, d), "wff,wembed", f ** -0.5)}
        if cfg.gated_ffn:
            m["wg"] = mk.normal((d, f), "wembed,wff", d ** -0.5)
        return m

    def moe():
        e = cfg.moe.num_experts
        m = {"router": mk.normal((d, e), "wembed,wexperts", d ** -0.5, f32),
             "wi": mk.experts((e, d, f), "wexperts,wembed,wff", d ** -0.5),
             "wg": mk.experts((e, d, f), "wexperts,wembed,wff", d ** -0.5),
             "wo": mk.experts((e, f, d), "wexperts,wff,wembed", f ** -0.5)}
        if cfg.moe.shared_expert:
            m["shared"] = mlp()
        return m

    def rglru():
        r, w = griffin.lru_dim(cfg), griffin.CONV_WIDTH
        return {"proj_x": mk.normal((d, r), "wembed,wff", d ** -0.5),
                "proj_y": mk.normal((d, r), "wembed,wff", d ** -0.5),
                "conv_w": mk.normal((w, r), "", w ** -0.5),
                "conv_b": mk.full((r,), "", 0.0),
                "gate_a": mk.normal((r, r), "wff,", r ** -0.5),
                "gate_a_b": mk.full((r,), "", 0.0),
                "gate_x": mk.normal((r, r), "wff,", r ** -0.5),
                "gate_x_b": mk.full((r,), "", 0.0),
                "lam": mk.full((r,), "ffn", 1.0, f32),
                "proj_out": mk.normal((r, d), "wff,wembed", r ** -0.5)}

    def mamba():
        sc = cfg.ssm
        d_inner, nheads, conv_dim = ssm.dims(cfg)
        in_dim = 2 * d_inner + 2 * sc.num_groups * sc.state_dim + nheads
        return {"in_proj": mk.normal((d, in_dim), "wembed,wff", d ** -0.5),
                "conv_w": mk.normal((sc.conv_width, conv_dim), "",
                                    sc.conv_width ** -0.5),
                "conv_b": mk.full((conv_dim,), "", 0.0),
                "A_log": mk.full((nheads,), "heads", 1.0, f32),
                "D": mk.full((nheads,), "heads", 1.0, f32),
                "dt_bias": mk.full((nheads,), "heads", 0.0, f32),
                "norm": {"scale": mk.full((d_inner,), "", 1.0, f32)},
                "out_proj": mk.normal((d_inner, d), "wff,wembed",
                                      d_inner ** -0.5)}

    def block(kind):
        if kind == "ssm":           # a Mamba2 block has no FFN sublayer
            return {"ln1": norm(d), "mixer": mamba()}
        mixer = {"mixer": rglru()} if kind == "rglru" else {"attn": attn()}
        if kind == "dec":           # + cross-attention to the encoder
            mixer.update(lnx=norm(d), cross=attn())
        ffn = {"moe": moe()} if kind == "attn_moe" else {"mlp": mlp()}
        return {"ln1": norm(d), **mixer, "ln2": norm(d), **ffn}

    vp = tfm.padded_vocab(cfg.vocab)
    p = {"embed": mk.normal((vp, d), "wvocab,wembed", 0.02),
         "final_norm": norm(d),
         "blocks": [block(kind) for kind in tfm.layer_kinds(cfg)]}
    if not cfg.tie_embeddings:
        p["head"] = mk.normal((d, vp), "wembed,wvocab", d ** -0.5)
    if cfg.is_encdec:
        p["enc"] = {"blocks": [block("enc") for _ in range(cfg.enc_layers)],
                    "final_norm": norm(d)}
    return p


def init_params(cfg, generator: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn on ``device`` from ``generator`` (which must
    live on that device), with the JAX ``Maker``'s shapes, dtypes and
    scales: N(0, 1) * scale in fp32, cast to the model dtype; norms are
    ones (fp32), biases zeros; RG-LRU's ``lam`` and Mamba2's ``A_log``,
    ``D`` (ones) and ``dt_bias`` (zeros) fp32, and an MoE block's router
    (d, E) fp32, as the reference makes them. Expert tensors (E, d, f) are
    drawn one expert at a time, so the fp32 draw never holds more than one
    expert's matrix (llama4's ``wi`` alone is 5.37 G values). An
    encoder-decoder's ``dec`` blocks add ``lnx`` and a ``cross`` attention,
    and ``enc`` holds the encoder's blocks and its ``final_norm``."""
    return _build(cfg, _Maker("init", generator, torch.device(device),
                              _dtype(cfg.dtype)))


def param_axes(cfg) -> Dict[str, Any]:
    """``init_params``' tree with each leaf's logical axes (the reference's
    ``param_axes`` strings: ``wq`` "wembed,wheads", ``wk`` / ``wv``
    "wembed,wkv_heads", ``wo`` "wheads,,wembed"; an MLP's ``wi`` / ``wg``
    "wembed,wff" and ``wo`` "wff,wembed"; ...), what the tensor-parallel
    plan (``parallel/tp.py``) shards by."""
    return _build(cfg, _Maker("axes"))


def param_shapes(cfg) -> Dict[str, Any]:
    """``init_params``' tree with each leaf's shape, nothing allocated."""
    return _build(cfg, _Maker("shape"))


def empty_params(cfg, *, device="meta") -> Dict[str, Any]:
    """``init_params``' tree of uninitialised tensors with its shapes and
    dtypes (on ``meta`` by default: nothing allocated). Under a
    ``FakeTensorMode`` any device gives fake tensors (the dry-run)."""
    return _build(cfg, _Maker("empty", device=torch.device(device),
                              dtype=_dtype(cfg.dtype)))


def _vocab_parallel(rules: Rules) -> bool:
    return "vocab" in rules.contract_axes


def _head(cfg, params) -> torch.Tensor:
    """The head matrix (d, Vp), or the rank's (d, Vp/m) columns of it."""
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _used(params, rules: Rules):
    """``params`` with the embedding and the head gathered at their use
    (``rules.use``; the identity but on a sharded rank): gathered once,
    so tied embeddings use the one tensor for the lookup and the head."""
    out = dict(params, embed=rules.use(params["embed"], "embed"))
    if "head" in params:
        out["head"] = rules.use(params["head"], "head")
    return out


def _embed(params, tokens: torch.Tensor, rules: Rules) -> torch.Tensor:
    """The token embeddings. Vocab-parallel (``rules`` contract "vocab")
    the rank holds rows [r Vp/m, (r + 1) Vp/m): a token outside them reads
    zeros, and ``contract`` sums the ranks' rows."""
    w = params["embed"]
    if not _vocab_parallel(rules):
        return w[tokens]
    n = w.shape[0]
    local = tokens - rules.model_rank * n
    inside = (local >= 0) & (local < n)
    x = torch.where(inside[..., None], w[local.clamp(0, n - 1)], 0.0)
    return rules.contract(x.to(w.dtype), "vocab")


def _logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Head matmul in the model dtype, then fp32: (..., Vp), or the rank's
    (..., Vp/m) slice where the head is vocab-parallel (the reference's
    ``rules.cons(logits, "batch,vocab")``)."""
    return (x @ _head(cfg, params)).float()


def encode(cfg, params, enc_embeds: torch.Tensor, *,
           rules: Rules = NO_RULES, train: bool = False) -> torch.Tensor:
    """The encoder: its ``enc`` blocks (non-causal self-attention with RoPE
    at 0.. S_enc - 1, then the MLP) over ``enc_embeds`` (B, S_enc, d), then
    its ``final_norm``. ``train``: through ``transformer.stack_train`` (the
    training forward). ``rules``: the tensor-parallel hooks. -> (B, S_enc,
    d) in the model dtype."""
    x = enc_embeds.to(params["embed"].dtype)
    enc = params["enc"]
    kinds = ["enc"] * len(enc["blocks"])
    if train:
        x, _ = tfm.stack_train(cfg, enc["blocks"], x, kinds=kinds,
                               rules=rules)
    else:
        x, _ = tfm.stack_apply(cfg, enc["blocks"], x, kinds=kinds,
                               rules=rules)
    return norm_apply(enc["final_norm"], x, cfg.norm)


def _need_enc(cfg, enc_embeds) -> None:
    if cfg.is_encdec and enc_embeds is None:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: it needs enc_embeds, the "
            f"encoder's frame embeddings (B, S_enc, d)")


def forward_hidden(cfg, params, batch: Dict[str, torch.Tensor], *,
                   rules: Rules = NO_RULES):
    """The training forward, the reference's ``forward_hidden`` without a
    cache. batch: {"tokens" (B, S) [, "frontend_embeds" (B, F, d) |
    "enc_embeds" (B, S_enc, d)]}; a patch frontend's embeddings go before
    the token embeddings; an encoder-decoder's frames go through
    ``encode``. Every layer goes through ``transformer.stack_train``, whose
    attention is the plain ``layers.flash_attention`` on every device, so
    autograd differentiates the whole forward and no kernel is reached.
    ``rules``: the tensor-parallel hooks (``parallel.sharding.TrainRules``
    on a rank of a mesh: the split leaves gathered at their use, the
    embedding lookup vocab-parallel where the plan splits the vocab; the
    norms replicate). Returns (hidden (B, F + S, d) after the final norm,
    {"lb_loss", "z_loss"} summed over the MoE layers)."""
    return _hidden(cfg, _used(params, rules), batch, rules)


def _hidden(cfg, params, batch, rules: Rules):
    """``forward_hidden`` on parameters whose embedding and head
    ``_used`` gathered."""
    _need_enc(cfg, batch.get("enc_embeds"))
    x = _embed(params, batch["tokens"], rules)
    if cfg.frontend == "patch" and "frontend_embeds" in batch:
        x = _with_frontend(batch["frontend_embeds"], x, rules)
    enc_out = encode(cfg, params, batch["enc_embeds"], rules=rules,
                     train=True) if cfg.is_encdec else None
    x, aux = tfm.stack_train(cfg, params["blocks"], x, enc_out=enc_out,
                             rules=rules)
    return norm_apply(params["final_norm"], x, cfg.norm), aux


def _with_frontend(fe: torch.Tensor, x: torch.Tensor,
                   rules: Rules) -> torch.Tensor:
    """A patch frontend's embeddings before the token embeddings. Under
    context parallelism both are the rank's blocks of their own
    sequences: the joined sequence's block is cut from both gathered."""
    fe = fe.to(x.dtype)
    if not rules.seq:
        return torch.cat([fe, x], 1)
    return rules.cp_own(torch.cat([rules.cp_gather(fe),
                                   rules.cp_gather(x)], 1))


def forward(cfg, params, batch: Dict[str, torch.Tensor]):
    """Full-sequence logits (B, F + S, Vp) fp32 and the aux losses, through
    ``forward_hidden`` (small models and tests: training uses ``loss_fn``'s
    blockwise cross-entropy, which never holds all the logits)."""
    x, aux = forward_hidden(cfg, params, batch)
    return _logits(cfg, params, x), aux


CE_CHUNK = 512


def _ce_chunk(cfg, w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
              rules: Rules = NO_RULES):
    """(sum of the cross-entropies, count of labels >= 0) over one sequence
    chunk; its (B, c, Vp) fp32 logits live only in here. Padded vocab rows
    (by global index) are -1e30. The log-sum-exp is the max (no
    gradient) plus the log of the sum of exp past it. Vocab-parallel
    (``rules`` contract "vocab"; ``w`` the rank's (d, Vp/m) columns):
    ``x`` enters, the logits are the rank's, the max is all-reduced (MAX)
    over the model group, the sum of exp and the label's logit (taken on
    the rank that owns it) are contracted."""
    vocab = _vocab_parallel(rules)
    if vocab:
        x = rules.enter(x, "vocab")
    logits = (x @ w).float()
    vl = logits.shape[-1]
    lo = rules.model_rank * vl if vocab else 0
    if lo + vl > cfg.vocab:
        logits = torch.where(
            lo + torch.arange(vl, device=x.device) < cfg.vocab, logits,
            -1e30)
    mask = (labels >= 0).float()
    lab = labels.clamp(min=0).long() - lo
    m = logits.detach().amax(-1)
    if vocab:
        m = rules.all_reduce(m, "model", op=dist.ReduceOp.MAX)
    total = torch.exp(logits - m[..., None]).sum(-1)
    own = (lab >= 0) & (lab < vl)
    ll = torch.gather(logits, -1, lab.clamp(0, vl - 1)[..., None])[..., 0]
    ll = torch.where(own, ll, 0.0)
    if vocab:
        total = rules.contract(total, "vocab")
        ll = rules.contract(ll, "vocab")
    lse = m + torch.log(total)
    return ((lse - ll) * mask).sum(), mask.sum()


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor], *,
            rules: Rules = NO_RULES):
    """Next-token cross-entropy (labels[t] is the target of position t;
    labels < 0 carry no loss), as the reference's ``loss_fn``: blockwise
    over ``CE_CHUNK``-token chunks, the last padded, each chunk recomputed
    in the backward pass (``torch.utils.checkpoint``), so no more than one
    chunk's (B, 512, Vp) fp32 logits ever exist. A vlm's loss covers the
    text positions only (the last ``labels.shape[1]``). MoE stacks add
    0.01 · lb_loss + 0.001 · z_loss. ``rules``: as ``forward_hidden``'s
    (every rank of a mesh computes the same loss; the head and the
    cross-entropy vocab-parallel where the plan splits the vocab,
    ``_ce_chunk``). Under context parallelism the batch is the rank's
    block of each row's sequence, and the loss is the whole sequence's:
    the sums of the label losses and of the label counts over the ranks
    (``rules.cp_sum``), not a mean of the ranks' means. Returns (loss,
    {"ce", "lb_loss", "z_loss"}), 0-dim fp32."""
    params = _used(params, rules)
    x, aux = _hidden(cfg, params, batch, rules)
    labels = batch["labels"]
    if rules.seq and "frontend_embeds" in batch:
        # the rank's block of the joined sequence: frontend rows carry -1
        whole = rules.all_gather(labels, 1, "model")
        n = x.shape[1] * rules.cp - whole.shape[1]
        labels = rules.cp_own(F.pad(whole, (n, 0), value=-1))
    elif x.shape[1] != labels.shape[1]:  # frontend positions carry no loss
        x = x[:, -labels.shape[1]:]
    S = x.shape[1]
    c = min(CE_CHUNK, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    w = _head(cfg, params)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S + pad, c):
        t, n = checkpoint.checkpoint(_ce_chunk, cfg, w, x[:, i:i + c],
                                     labels[:, i:i + c], rules,
                                     use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    # context parallelism: the sums over every rank's rows
    tot, cnt = rules.cp_sum(tot), rules.cp_sum(cnt)
    ce = tot / cnt.clamp(min=1.0)
    loss = ce
    if cfg.moe is not None and cfg.moe.num_experts > 0:
        loss = loss + 0.01 * aux["lb_loss"] + 0.001 * aux["z_loss"]
    return loss, {"ce": ce, **aux}


def prefill(cfg, params, tokens: torch.Tensor, *,
            length: Optional[torch.Tensor] = None, prefix_kv=None,
            prefix_len: int = 0,
            frontend_embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, rules: Rules = NO_RULES):
    """Run the whole (bucket-padded) prompt. tokens: (B, S) int64; length:
    None or (B,) count of real tokens. Returns (logits (B, Vp) fp32 at
    position length - 1 only, per-layer cache entries, next position (B,)
    int32). An attention layer's entry is {"k", "v"} (B, S, KV, D) in the
    cache dtype (a local_attn layer's too: the engine scatters only the
    live window blocks); a recurrent layer's is its decode state at
    position length - 1 ({"h", "conv"} or {"ssm", "conv"}): updates past
    ``length`` are the identity, so bucket padding never reaches it.

    ``prefix_kv`` (per layer {"k", "v"} (B, Pb, KV, D), cache dtype) and
    ``prefix_len`` (a host int): suffix-only prefill — ``tokens`` and
    ``length`` describe only the prompt after a prefix whose KV is reused
    from the page pools; positions start at prefix_len. The returned k/v
    are the suffix's and the returned position counts suffix tokens
    (callers add prefix_len). Full-attention stacks only.

    ``frontend_embeds`` (B, F, d), a ``frontend="patch"`` stack's
    precomputed patch embeddings (the vlm stub), go before the token
    embeddings, as the reference's ``forward_hidden`` puts them; ``length``
    and the returned position then count them too. The serving engine
    passes none: it serves tokens only, as the reference's does.

    ``enc_embeds`` (B, S_enc, d), the ``frames`` frontend stub's
    precomputed frame embeddings, are what an encoder-decoder's encoder
    reads (``encode``); its ``dec`` layers' entries add the cross lanes
    {"xk", "xv"} (B, S_enc, KV, D). Such a stack without them raises
    ``ValueError`` (the reference raises ``KeyError('enc_embeds')``): the
    serving engines pass none, so serving it fails, as in the reference.

    ``max_len``: the dense engine's layout — full-attention k/v padded to
    max_len rows, a local_attn layer's k/v folded into its window ring
    (slot = position % window); the prompt then must be unpadded.

    ``rules``: the tensor-parallel hooks (``parallel.sharding``; a rank's
    ``ManualRules`` sums the attention out-projection and the MLP
    down-projection over its ``model`` group; a dry-run rank's also
    gather its split leaves and, where the vocab splits, look up and
    return its (B, Vp/m) slice of the logits). ``NO_RULES``: none. Under
    context parallelism (``rules.seq``) the prompt (and any frontend or
    encoder embeddings) is the rank's block of each row, ``length`` and
    the returned position are the whole sequence's, the logits at
    ``length`` - 1 come from the rank that holds that position, and each
    attention layer's entry is the rank's rows: its part of a
    context-parallel dense lane (with ``max_len``, its block of the
    padded lane or window ring)."""
    _need_enc(cfg, enc_embeds)
    params = _used(params, rules)
    enc_out = encode(cfg, params, enc_embeds, rules=rules) \
        if cfg.is_encdec else None
    x = _embed(params, tokens, rules)
    if frontend_embeds is not None:
        if cfg.frontend != "patch":
            raise ValueError(f"{cfg.name} has no patch frontend")
        x = _with_frontend(frontend_embeds, x, rules)
    B, S = x.shape[0], x.shape[1] * rules.cp
    x, caches = tfm.stack_apply(cfg, params["blocks"], x,
                                prefix_kv=prefix_kv, prefix_len=prefix_len,
                                length=length, enc_out=enc_out,
                                max_len=max_len, rules=rules)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    if length is None:
        length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=x.device).expand(B)
    idx = (length.long() - 1).clamp(0, S - 1)
    b = torch.arange(B, device=x.device)
    if rules.seq:
        # the rank that holds position length - 1 gives its row, every
        # other rank zeros, and the sum reaches every rank
        n = x.shape[1]
        local = idx - rules.cp_offset(n)
        own = ((local >= 0) & (local < n))[:, None]
        xl = rules.all_reduce(torch.where(own, x[b, local.clamp(0, n - 1)],
                                          0.0).to(x.dtype), "model")
    else:
        xl = x[b, idx]                                     # (B, d)
    return _logits(cfg, params, xl), caches, length


def decode_step(cfg, params, cache: List[Dict[str, torch.Tensor]],
                tokens: torch.Tensor, pos: torch.Tensor, *,
                block_table: Optional[torch.Tensor] = None,
                win_block_table: Optional[torch.Tensor] = None,
                state_out=None, rules: Rules = NO_RULES):
    """tokens: (B, T) int64, token t of request b at position pos[b] + t;
    pos: (B,) int32. block_table: (B, n_blocks) int32 into the full-
    attention page pools of ``paged_cache_init``, win_block_table the same
    for the local_attn layers' pools (both updated in place); a table left
    None means the dense lanes of ``cache_init`` for those layers (a
    local_attn lane is its window ring), written in place, single-token:
    a T > 1 block there raises the reference's ``ValueError`` naming the
    layer kinds. Recurrent layers' state slots change in place for T ==
    1; a T > 1 verify block writes their checkpointed states into
    ``state_out`` (``state_buffers``) when given
    (``transformer.stack_decode``). ``rules``: as ``prefill``'s; under
    context parallelism the dense lanes are the rank's blocks of their
    rows (``layers.attention_decode``), while the tokens, positions and
    recurrent state stay replicated over ``model``. Returns (logits,
    cache): (B, Vp) fp32 for T == 1, (B, T, Vp) for T > 1."""
    T = tokens.shape[1]
    if T > 1:
        present = dict.fromkeys(tfm.layer_kinds(cfg))
        bad = [k for k, need in
               (("attn_mlp", block_table), ("attn_moe", block_table),
                ("local_attn", win_block_table))
               if k in present and need is None]
        bad += [k for k in ("dec", "enc") if k in present]
        if bad:
            raise ValueError(
                f"multi-token decode blocks (T={T}) need every attention "
                f"layer on a paged cache layout, but layer kind(s) {bad} "
                f"have none: pass block_table for full attention and "
                f"win_block_table for local_attn (the dense ring buffer "
                f"is single-token — it has already overwritten the keys "
                f"older block rows attend to)")
    params = _used(params, rules)
    x = _embed(params, tokens, rules)
    x, cache = tfm.stack_decode(cfg, params["blocks"], x, cache, pos,
                                block_table, win_block_table, state_out,
                                rules=rules)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    logits = _logits(cfg, params, x)
    return (logits[:, 0] if T == 1 else logits), cache


PAGEABLE_KINDS = tfm.PAGEABLE_KINDS      # full-attention page pools
WINDOW_KINDS = tfm.WINDOW_KINDS          # sliding-window page pools
STATE_KINDS = tfm.STATE_KINDS            # fixed-size per-slot state


def _state_shapes(cfg, kind: str, slots: int):
    return (ssm.ssm_state_shapes if kind == "ssm"
            else griffin.rglru_state_shapes)(cfg, slots)


def cache_init(cfg, slots: int, max_len: int, *, device="cuda"
               ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer cache entries of the dense engine, zeros: one lane a slot.
    Full attention {"k", "v"} (slots, max_len, KV, D) and a ``dec`` layer's
    four lanes {"k", "v", "xk", "xv"} of that shape, in the cache dtype; a
    local_attn layer's {"k", "v"} ring (slots, window, KV, D); a recurrent
    layer's state (``paged_cache_init``'s)."""
    dt = _dtype(cfg.kv_cache_dtype)
    kv, hd = cfg.kv_heads, cfg.resolved_head_dim
    out = []
    for kind in tfm.layer_kinds(cfg):
        if kind in STATE_KINDS:
            out.append({name: torch.zeros(sh, dtype=sdt, device=device)
                        for name, (sh, sdt)
                        in _state_shapes(cfg, kind, slots).items()})
            continue
        S = cfg.hybrid.window if kind in WINDOW_KINDS else max_len
        names = ("k", "v", "xk", "xv") if kind == "dec" else ("k", "v")
        out.append({name: torch.zeros((slots, S, kv, hd), dtype=dt,
                                      device=device) for name in names})
    return out


def cache_shapes(cfg, batch: int, seq_len: int
                 ) -> List[Dict[str, torch.Tensor]]:
    """``cache_init``'s entries as ``meta`` tensors (shapes and dtypes,
    nothing allocated): the dry-run's decode cache."""
    return cache_init(cfg, batch, seq_len, device="meta")


def cache_axes(cfg) -> List[Dict[str, str]]:
    """``cache_init``'s list with each leaf's logical axes, the
    reference's ``cache_axes`` for one layer (its stacked leaves add a
    leading "layers"): the dense lanes "batch,seq,kv_heads", Mamba2's
    ``ssm`` state "batch,heads", RG-LRU's ``h`` "batch,ffn", a ``conv``
    window "batch"."""
    def ax(name: str) -> str:
        if name in ("k", "v", "xk", "xv"):
            return "batch,seq,kv_heads"
        return {"ssm": "batch,heads", "h": "batch,ffn"}.get(name, "batch")
    return [{name: ax(name) for name in e} for e in cache_shapes(cfg, 1, 2)]


def paged_cache_init(cfg, num_pages: int, page_size: int, *,
                     slots: int = 1, device="cuda"
                     ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer cache entries for paged serving: {"k", "v"} page pools
    (num_pages, page_size, KV, D) for the attention layers (full and
    sliding-window alike: the engine recycles the window layers' pages as
    they slide out of the window), and zeroed per-slot state (slots, ...)
    for the recurrent layers (``ssm``: {"ssm" fp32, "conv"}; ``rglru``:
    {"h" fp32, "conv"}). Zeros, never uninitialized memory: the kernel's
    invariance to pool garbage (masked keys get probability exactly 0)
    assumes finite contents. Raises ``ValueError`` for a kind the pages
    cannot host (the encoder-decoder's), as the reference does."""
    kinds = tfm.layer_kinds(cfg)
    unpageable = [k for k in kinds if k not in tfm.SERVABLE_KINDS]
    if unpageable:
        raise ValueError(
            f"paged cache cannot host block kind(s) {unpageable}; "
            f"servable kinds are {tfm.SERVABLE_KINDS}")
    dt = _dtype(cfg.kv_cache_dtype)
    shape = (num_pages, page_size, cfg.kv_heads, cfg.resolved_head_dim)
    out = []
    for kind in kinds:
        if kind in STATE_KINDS:
            out.append({name: torch.zeros(sh, dtype=sdt, device=device)
                        for name, (sh, sdt)
                        in _state_shapes(cfg, kind, slots).items()})
        else:
            out.append({"k": torch.zeros(shape, dtype=dt, device=device),
                        "v": torch.zeros(shape, dtype=dt, device=device)})
    return out


def paged_cache_axes(cfg) -> List[Dict[str, str]]:
    """``paged_cache_init``'s list with each leaf's logical axes, the
    reference's ``paged_cache_axes``: a page pool (P, page, KV, D) shards
    its KV-head dim (",,kv_heads"); recurrent state slots replicate ("")."""
    return [{name: "" for name in _state_shapes(cfg, kind, 1)}
            if kind in STATE_KINDS else {"k": ",,kv_heads", "v": ",,kv_heads"}
            for kind in tfm.layer_kinds(cfg)]


def state_buffers(cfg, slots: int, T: int, *, device="cuda"
                  ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """Fixed (slots, T, ...) buffers for a T-row verify block's
    checkpointed recurrent states, one dict per recurrent layer (None for
    the attention layers)."""
    out: List[Optional[Dict[str, torch.Tensor]]] = []
    for kind in tfm.layer_kinds(cfg):
        if kind not in STATE_KINDS:
            out.append(None)
            continue
        out.append({name: torch.zeros((sh[0], T) + sh[1:], dtype=sdt,
                                      device=device)
                    for name, (sh, sdt)
                    in _state_shapes(cfg, kind, slots).items()})
    return out


def state_slot_export(cfg, cache: List[Dict[str, torch.Tensor]], slot: int
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """One slot's recurrent state, every ``ssm``/``rglru`` layer of a
    ``paged_cache_init`` list, as detached copies keyed by layer index
    (``{str(j): {name: (...)}}``; attention layers are left out): the
    swap-out half of the host tier (``runtime/host_tier.py``), so a
    preempted hybrid request carries its state instead of re-prefilling."""
    return {str(j): {name: t[slot].detach().clone()
                     for name, t in e.items()}
            for j, (e, kind) in enumerate(zip(cache, tfm.layer_kinds(cfg)))
            if kind in STATE_KINDS}


def state_slot_import(cfg, cache: List[Dict[str, torch.Tensor]], slot: int,
                      state: Dict[str, Dict[str, torch.Tensor]]
                      ) -> List[Dict[str, torch.Tensor]]:
    """Write a ``state_slot_export`` tree back into ``slot``, in place (a
    captured graph's addresses stay valid), each leaf cast to its entry's
    storage dtype: the swap-in half. Returns ``cache``."""
    for j, (e, kind) in enumerate(zip(cache, tfm.layer_kinds(cfg))):
        if kind in STATE_KINDS:
            for name, t in e.items():
                t[slot].copy_(state[str(j)][name].to(t.dtype))
    return cache
