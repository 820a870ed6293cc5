"""The program's side of a configuration: the port's ``ModelConfig`` built
from a configuration file, and the weights made from ``--seed`` in the
port's parameter layout, on the device, in a few large draws."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench.reference.dims import Dims, dims


def port_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    dm = dims(cfg)
    moe = None
    if dm.moe:
        moe = MoEConfig(num_experts=dm.experts, top_k=dm.top_k,
                        capacity_factor=dm.capacity_factor,
                        dispatch_groups=dm.dispatch_groups)
    return ModelConfig(
        name=cfg["name"], family="moe" if dm.moe else "dense",
        num_layers=dm.layers, d_model=dm.d, num_heads=dm.heads,
        kv_heads=dm.kv_heads, d_ff=dm.ffn, vocab=dm.vocab,
        head_dim=dm.head_dim, qkv_bias=dm.qkv_bias, norm=dm.norm,
        act="silu", gated_ffn=True, rope_theta=dm.rope_theta,
        tie_embeddings=dm.tied, moe=moe, dtype="bfloat16")


def padded_vocab(v: int) -> int:
    from repro_torch.models import transformer
    return transformer.padded_vocab(v)


# (path, shape, init, dtype): init is ("normal", scale), ("one", scale) for
# 1 + N(0,1) * scale, or ("zero",)
Leaf = Tuple[Tuple, Tuple[int, ...], Tuple, torch.dtype]


def layout(dm: Dims, vp: int) -> List[Leaf]:
    """Every leaf of the port's parameter tree (``models/api.py``'s names
    and shapes) with how the benchmark fills it."""
    bf16, f32 = torch.bfloat16, torch.float32
    d, h, kv, hd, f = dm.d, dm.heads, dm.kv_heads, dm.head_dim, dm.ffn
    leaves: List[Leaf] = [(("embed",), (vp, d), ("normal", 0.02), bf16)]

    def norm(path):
        out = [(path + ("scale",), (d,), ("one", 0.05), f32)]
        if dm.norm == "layernorm":
            out.append((path + ("bias",), (d,), ("zero",), f32))
        return out

    for i in range(dm.layers):
        b = ("blocks", i)
        leaves += norm(b + ("ln1",))
        a = b + ("attn",)
        leaves += [(a + ("wq",), (d, h, hd), ("normal", d ** -0.5), bf16),
                   (a + ("wk",), (d, kv, hd), ("normal", d ** -0.5), bf16),
                   (a + ("wv",), (d, kv, hd), ("normal", d ** -0.5), bf16),
                   (a + ("wo",), (h, hd, d), ("normal", (h * hd) ** -0.5),
                    bf16)]
        if dm.qkv_bias:
            leaves += [(a + ("bq",), (h, hd), ("normal", 0.1), bf16),
                       (a + ("bk",), (kv, hd), ("normal", 0.1), bf16),
                       (a + ("bv",), (kv, hd), ("normal", 0.1), bf16)]
        leaves += norm(b + ("ln2",))
        if dm.moe:
            m, e = b + ("moe",), dm.experts
            leaves += [(m + ("router",), (d, e), ("normal", d ** -0.5), f32),
                       (m + ("wi",), (e, d, f), ("normal", d ** -0.5), bf16),
                       (m + ("wg",), (e, d, f), ("normal", d ** -0.5), bf16),
                       (m + ("wo",), (e, f, d), ("normal", f ** -0.5), bf16)]
        else:
            m = b + ("mlp",)
            leaves += [(m + ("wi",), (d, f), ("normal", d ** -0.5), bf16),
                       (m + ("wo",), (f, d), ("normal", f ** -0.5), bf16),
                       (m + ("wg",), (d, f), ("normal", d ** -0.5), bf16)]
    leaves += norm(("final_norm",))
    if not dm.tied:
        leaves.append((("head",), (d, vp), ("normal", d ** -0.5), bf16))
    return leaves


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _put(tree: dict, path: Tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        if isinstance(k, int):              # node is the blocks list
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if k == "blocks" else {})
    node[path[-1]] = value


CHUNK = 1 << 28      # elements a draw: below 2**31 for every kernel


def make_weights(cfg: dict, seed: int, device) -> Dict:
    """The parameter tree, drawn from ``seed`` on ``device`` with a
    generator there: one flat buffer a (dtype, init), filled by a few
    ``normal_`` calls in the served dtype; every leaf a view of its
    buffer."""
    dm = dims(cfg)
    leaves = layout(dm, padded_vocab(dm.vocab))
    groups: Dict[Tuple, List[Leaf]] = {}
    for leaf in leaves:
        groups.setdefault((leaf[3], leaf[2]), []).append(leaf)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    tree: Dict = {}
    for key in sorted(groups, key=str):
        dtype, init = key
        members = groups[key]
        total = sum(_numel(s) for _, s, _, _ in members)
        buf = torch.empty(total, dtype=dtype, device=device)
        if init[0] == "zero":
            buf.zero_()
        else:
            for lo in range(0, total, CHUNK):
                buf[lo:lo + CHUNK].normal_(0.0, init[1], generator=gen)
            if init[0] == "one":
                buf.add_(1.0)
        off = 0
        for path, shape, _, _ in members:
            n = _numel(shape)
            _put(tree, path, buf[off:off + n].view(shape))
            off += n
    return tree
