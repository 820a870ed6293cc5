"""The shared half of the context-parallel layer tests
(``tests/test_torch_cp_{layers,moe,serve}.py``): their cases, the inputs
the ranks read (fp32 SMOKE configs, the JAX package's parameters moved
over by ``repro_torch.convert``, numpy inputs from a seed), worlds of 2
and 4 gloo ranks running ``tests/torch_cp_ranks.py``'s scenarios, and the
JAX side's helpers. Tolerance: atol = rtol = 2e-5 on every output (the
sums run in other orders: a split softmax, gathered keys)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import torch_cp_ranks as ranks
from repro_torch.launch.mesh import run_world
from repro_torch.models import transformer as tfm
from torch_train_cases import pair

F32 = dict(atol=2e-5, rtol=2e-5)
WORLDS = (2, 4)
B, S = 2, 32

ATTN_CASES = {   # name: (window, chunked, train)
    "train_chunked": (0, True, True),
    "train_one_shot": (0, False, True),
    "train_window": (5, True, True),
    "prefill": (0, True, False),
    "prefill_window": (5, True, False),
}
DECODE_CASES = {  # name: (window, decode_kv_chunk)
    "lane": (0, 0), "lane_chunk2048": (0, 2048), "lane_chunk4": (0, 4),
    "ring": (8, 0), "ring_chunk2048": (8, 2048),
}
LANE = {0: 16, 8: 8}                        # lane rows by window
POS = {0: [3, 9, 15], 8: [2, 8, 13]}        # the ring wraps at 8
MOE_SHAPES = {"b1_s36": (1, 36), "b2_s64": (2, 64)}
SERVE_ARCHS = ("qwen2.5-3b", "recurrentgemma-9b")
SERVE_S, SERVE_MAX, SERVE_STEPS = 32, 40, 8


def to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def block_of(arch, kind, **over):
    """(jax cfg, port cfg, the first ``kind`` block's port params)."""
    jc, tc, _, tp = pair(arch, **over)
    return jc, tc, tp["blocks"][tfm.layer_kinds(tc).index(kind)]


def inputs(names):
    """What the ranks read for the scenarios ``names``."""
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    out = {}
    if {"attention", "decode"} & set(names):
        _, tc, blk = block_of("qwen2.5-3b", "attn_mlp",
                              kv_cache_dtype="float32")
        kvh, hd = tc.kv_heads, tc.resolved_head_dim
        out["attn"] = {"cfg": tc, "p": blk["attn"],
                       "x": normal(B, S, tc.d_model), "cases": ATTN_CASES}
        out["decode"] = {
            "cfg": tc, "p": blk["attn"], "x": normal(3, 1, tc.d_model),
            "cases": DECODE_CASES,
            "lanes": {w: {"k": normal(3, n, kvh, hd),
                          "v": normal(3, n, kvh, hd)}
                      for w, n in LANE.items()},
            "pos": {w: torch.tensor(p, dtype=torch.int32)
                    for w, p in POS.items()}}
    if "mixers" in names:
        out["mixers"] = {}
        for arch, kind in (("recurrentgemma-9b", "rglru"),
                           ("mamba2-2.7b", "ssm")):
            _, tc, blk = block_of(arch, kind)
            out["mixers"][arch] = {
                "cfg": tc, "p": blk["mixer"], "x": normal(B, S, tc.d_model),
                "length": torch.tensor([20, S])}
    if "moe" in names:
        _, tc, blk = block_of("dbrx-132b", "attn_moe")
        out["moe"] = {name: {"cfg": tc, "block": blk,
                             "x": normal(b, s, tc.d_model)}
                      for name, (b, s) in MOE_SHAPES.items()}
    if "serve" in names:
        out["serve"] = {}
        for arch in SERVE_ARCHS:
            _, tc, _, tp = pair(arch, kv_cache_dtype="float32")
            out["serve"][arch] = {
                "cfg": tc, "params": tp, "max_len": SERVE_MAX,
                "steps": SERVE_STEPS, "tokens": torch.from_numpy(
                    rng.integers(0, tc.vocab, (B, SERVE_S)))}
    return out


def bundle_and_worlds(d, names):
    """(the inputs, {world size: every rank's results}) of the scenarios
    ``names`` in worlds of 2 and 4 gloo ranks, files under ``d``."""
    ins = inputs(names)
    torch.save(ins, d / "inputs.pt")
    return ins, {n: run_world(ranks.run_scenarios, n, backend="gloo",
                              init_file=str(d / f"rendezvous{n}"),
                              args=(str(d / "inputs.pt"), str(d), names),
                              timeout=300) for n in WORLDS}


def joined(res, key, i, dim=1):
    """Output ``i`` of case ``key``, every rank's rows joined."""
    return np.concatenate([r[key][i] for r in res], dim)
