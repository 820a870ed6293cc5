"""Rank-side scenarios of tests/test_torch_sharded.py: tensor-parallel and
replica-routed serving of the port on the CPU, in spawned gloo worlds
(``repro_torch.launch.mesh.run_world``). Imports neither jax nor the JAX
package: the ranks read the converted fp32 parameters from a
``torch.save`` file.

``run_scenarios(rank, params_file, names)`` runs each named scenario in a
world and returns {name: result}; the test process calls the same
scenario functions with ``world=None`` for the single-shard baselines
(no mesh, no world). Every SMOKE config is fp32 with an fp32 KV cache:
the all-reduce reorders the out- and down-projection sums, and the
contract (the reference's) is exact greedy tokens there.
"""
import dataclasses
import sys
import traceback
import warnings

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.router import make_replicas
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.serving import PagedServingEngine, Request
from torch_cases import dying_traffic

ARCHS = ("qwen2.5-3b", "recurrentgemma-9b", "mamba2-2.7b", "dbrx-132b")
QWEN = "qwen2.5-3b"
ENGINE = dict(slots=3, max_len=64, page_size=8)


def cfg_of(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               kv_cache_dtype="float32")


def reqs(n=4, max_new=6):
    return [Request(rid=i, prompt=[1 + i, 7, 3 + i, 9, 2], max_new=max_new)
            for i in range(n)]


def _mesh(world):
    return None if world is None else make_host_mesh(
        world, devices=["cpu"] * world)


def _serve(params, arch, world, requests, **kw):
    """Requests through a PagedServingEngine on a mesh of ``world`` (None:
    no mesh); what every rank must agree on."""
    kw = {**ENGINE, **kw}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = PagedServingEngine(cfg_of(arch), params[arch],
                                 mesh=_mesh(world), device="cpu", **kw)
    sched = Scheduler(eng)
    for r in requests:
        sched.add(r)
    sched.drain(max_steps=400)
    assert all(r.done for r in requests)
    return {"tokens": [r.generated for r in requests],
            "preemptions": [r.preemptions for r in requests],
            "warnings": [str(w.message) for w in caught],
            "shard": eng.shard_stats(), "peak": eng.alloc.peak_pages,
            "reduces": getattr(eng._model_rules, "reduces", 0),
            "saved": eng.prefix_stats()["prefill_tokens_saved"],
            "allocated": eng.alloc.allocated_pages}


def kernel(params, world):
    return _serve(params, QWEN, world, reqs())


def gather(params, world):
    return _serve(params, QWEN, world, reqs(), attn_impl="gather")


def prefix(params, world):
    sys_p = [9, 9, 9, 9, 8, 8, 8, 8, 7, 7]          # shared page + partial
    return _serve(params, QWEN, world,
                  [Request(rid=i, prompt=sys_p + [i + 1, i + 2], max_new=5)
                   for i in range(4)], slots=2, prefix_cache=True)


def spec(params, world):
    # repetitive prompts, so the n-gram drafter lands accepts
    return _serve(params, QWEN, world,
                  [Request(rid=i, prompt=[5, 6, 5, 6, 5, 6, 5], max_new=8)
                   for i in range(3)], spec_k=3)


def preempt(params, world):
    # a pool too small for every request: preemption and re-prefill on
    # sharded pools
    return _serve(params, QWEN, world,
                  [Request(rid=i, prompt=[1 + i, 7, 3 + i, 9, 2, 4, 6],
                           max_new=10) for i in range(3)], num_pages=5)


def rgemma(params, world):
    return _serve(params, "recurrentgemma-9b", world, reqs())


def mamba(params, world):
    return _serve(params, "mamba2-2.7b", world, reqs())


def dbrx(params, world):
    # 6 slots whose requests die at different steps while others decode:
    # dead rows route through the replicated MoE beside live ones
    vocab = cfg_of("dbrx-132b").vocab
    return _serve(params, "dbrx-132b", world,
                  [Request(rid=i, prompt=p, max_new=b)
                   for i, (p, b) in enumerate(dying_traffic(6, vocab))],
                  slots=6, max_len=32, page_size=4)


def sampled(params, world):
    # the gather path: the one the port's sampled streams are held to
    # against the JAX engine (tests/test_torch_sampling.py)
    rs = reqs()
    for i, r in enumerate(rs):
        r.params = SamplingParams(temperature=0.9, top_k=6, top_p=0.9,
                                  seed=100 + i)
    return _serve(params, QWEN, world, rs, attn_impl="gather")


def _route(params, world, replicas, model, policy):
    """6 requests through ``make_replicas`` (R x M = the world; without a
    world, one replica, no mesh)."""
    if world is None:
        replicas = model = 1
    router = make_replicas(cfg_of(QWEN), params[QWEN], replicas=replicas,
                           model=model, devices=["cpu"] * (world or 1),
                           policy=policy, device="cpu", **ENGINE)
    rs = reqs(6)
    done = router.run_to_completion(rs)
    st = router.stats()
    return {"tokens": [r.generated for r in rs], "done": len(done),
            "routed": st["routed"], "model_shards": st["model_shards"],
            "peak_pages_per_shard": st["peak_pages_per_shard"],
            "peak_pages_per_replica": st["peak_pages_per_replica"]}


def router_hash(params, world):
    return _route(params, world, 2, 1, "hash")


def router_least(params, world):
    return _route(params, world, 2, 1, "least_loaded")


def router_2x2(params, world):
    return _route(params, world, 2, 2, "hash")


SCENARIOS = {f.__name__: f for f in (
    kernel, gather, prefix, spec, preempt, rgemma, mamba, dbrx, sampled,
    router_hash, router_least, router_2x2)}


def run_scenarios(rank, params_file, names):
    """A rank's results, {name: result or {"error": traceback}}, plus
    "jax_loaded": whether anything imported jax or the JAX package."""
    params = torch.load(params_file, weights_only=True)
    world = dist.get_world_size()
    out = {}
    for name in names:
        try:
            out[name] = SCENARIOS[name](params, world)
        except Exception:       # reported per scenario; the test fails it
            out[name] = {"error": traceback.format_exc()}
    out["jax_loaded"] = sorted(
        m for m in sys.modules if m in ("jax", "repro")
        or m.startswith(("jax.", "repro.")))
    return out
