"""The sizes and rules of a configuration file, read from its published
keys and its ``as_run`` block, for the reference and the frozen counts.
Plain Python: nothing of the port."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Dims:
    block: str            # "qwen2" | "dbrx"
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    tied: bool
    qkv_bias: bool
    norm: str             # "rmsnorm" | "layernorm"
    norm_eps: float
    rope_theta: float
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    dispatch_groups: int = 1
    clip_qkv: Optional[float] = None

    @property
    def moe(self) -> bool:
        return self.experts > 0


def dims(cfg: dict) -> Dims:
    pub, run = cfg["published"], cfg["as_run"]
    block = run["block"]
    common = dict(block=block, head_dim=run["head_dim"],
                  qkv_bias=run["qkv_bias"], norm=run["norm"],
                  norm_eps=float(run["norm_eps"]),
                  vocab=pub["vocab_size"],
                  tied=bool(pub.get("tie_word_embeddings", False)))
    if block == "qwen2":
        return Dims(layers=pub["num_hidden_layers"], d=pub["hidden_size"],
                    heads=pub["num_attention_heads"],
                    kv_heads=pub["num_key_value_heads"],
                    ffn=pub["intermediate_size"],
                    rope_theta=float(pub["rope_theta"]), **common)
    if block == "dbrx":
        attn, ffn = pub["attn_config"], pub["ffn_config"]
        return Dims(layers=pub["n_layers"], d=pub["d_model"],
                    heads=pub["n_heads"], kv_heads=attn["kv_n_heads"],
                    ffn=ffn["ffn_hidden_size"],
                    rope_theta=float(attn["rope_theta"]),
                    experts=ffn["moe_num_experts"], top_k=ffn["moe_top_k"],
                    capacity_factor=float(run["capacity_factor"]),
                    dispatch_groups=int(run["dispatch_groups"]),
                    clip_qkv=run.get("clip_qkv"), **common)
    raise ValueError(f"no reference for block {block!r}")


def capacity(dm: Dims, rows: int):
    """(G, C) of a call over ``rows`` routed rows, by the file's rule."""
    G = dm.dispatch_groups if rows % max(dm.dispatch_groups, 1) == 0 else 1
    tg = rows // G
    C = max(4, int(tg * dm.capacity_factor * dm.top_k // dm.experts))
    return G, C
