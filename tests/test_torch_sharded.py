"""Tensor-parallel paged serving and the replica router of the port, held to
the single-shard tokens (the contract of ``tests/test_sharded_serving.py``).

In-process: the mesh folds, the sharding rules' divisibility fallback, the
tensor-parallel plan's decisions on three SMOKE configs, the parameter
and pool shards, and one layer computed shard by shard (partial outputs
summed) against the whole layer. Spawned worlds on the CPU over gloo
(``launch.mesh.run_world``; the ranks are ``tests/torch_sharded_ranks.py``,
which imports no jax and reads the converted parameters from a
``torch.save`` file): each world size runs all its scenarios once, in a
module fixture, and each test asserts on one scenario's result on every
rank. The single-shard engine with ``attn_impl="gather"`` is held to the
JAX ``PagedServingEngine``'s tokens.

fp32 SMOKE configs with an fp32 KV cache: the all-reduce reorders the out-
and down-projection sums, which fp32 absorbs below an argmax flip on these
configs (the reference's contract); layer outputs are held at atol = rtol
= 2e-5 (the same fp32 products, summed in another order).
"""
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # the reference tokens come from the JAX engine

import jax  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import check_csv  # noqa: E402
from repro_torch.launch.mesh import (WorldError, make_host_mesh,  # noqa: E402
                                     run_world)
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel import tp  # noqa: E402
from repro_torch.parallel.sharding import Rules  # noqa: E402
from repro_torch.runtime.router import (ReplicaRouter,  # noqa: E402
                                        make_replicas)
from repro_torch.runtime.serving import (PagedServingEngine,  # noqa: E402
                                         ServingEngine)

REPO = Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=2e-5)
QWEN = ranks.QWEN
WORLD_SCENARIOS = {
    1: ("kernel", "gather", "sampled"),
    2: ("kernel", "gather", "prefix", "spec", "preempt", "rgemma", "mamba",
        "dbrx", "sampled", "router_hash", "router_least"),
    4: ("kernel", "gather", "sampled", "router_2x2"),
}


def cpus(n):
    return ["cpu"] * n


# ---------------------------------------------------------------------------
# shared inputs: converted parameters, baselines, the worlds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, {arch: port params}, {arch: jax params}): fp32 SMOKE
    weights from the JAX package's init, converted, and saved for the
    ranks."""
    d = tmp_path_factory.mktemp("sharded")
    jparams, params = {}, {}
    for arch in ranks.ARCHS:
        jc = dataclasses.replace(jcfg(arch), dtype="float32",
                                 kv_cache_dtype="float32")
        jparams[arch] = japi.init_params(jc, jax.random.key(0))
        params[arch] = params_from_jax(
            ranks.cfg_of(arch), jax.tree.map(np.asarray, jparams[arch]),
            device="cpu")
    torch.save(params, d / "params.pt")
    return d, params, jparams


@pytest.fixture(scope="module")
def base(bundle):
    """Every scenario on the single-shard engine (no mesh, no world)."""
    return {name: f(bundle[1], None) for name, f in ranks.SCENARIOS.items()}


def _world(bundle, n):
    d = bundle[0]
    return run_world(ranks.run_scenarios, n, backend="gloo",
                     init_file=str(d / f"rendezvous{n}"),
                     args=(str(d / "params.pt"), WORLD_SCENARIOS[n]),
                     timeout=240)


@pytest.fixture(scope="module")
def world1(bundle):
    return _world(bundle, 1)


@pytest.fixture(scope="module")
def world2(bundle):
    return _world(bundle, 2)


@pytest.fixture(scope="module")
def world4(bundle):
    return _world(bundle, 4)


def results(world, name):
    """``name``'s result on every rank, after checking none failed."""
    out = [r[name] for r in world]
    for rank, res in enumerate(out):
        assert "error" not in res, f"rank {rank}:\n{res['error']}"
    return out


def assert_tokens_equal_base(world, base, name, keys=("tokens",)):
    for res in results(world, name):
        for k in keys:
            assert res[k] == base[name][k], (name, k)


# ---------------------------------------------------------------------------
# mesh folds (the reference's tests/test_sharded_serving.py:70-96)
# ---------------------------------------------------------------------------


def test_make_host_mesh_rejects_bad_fold():
    with pytest.raises(ValueError) as e:
        make_host_mesh(model=3, devices=cpus(2))
    assert "2" in str(e.value) and "3" in str(e.value)  # names n AND model
    with pytest.raises(ValueError):
        make_host_mesh(model=0, devices=cpus(1))
    with pytest.raises(ValueError):
        make_host_mesh(model=3, devices=cpus(1))


def test_make_host_mesh_defaults_to_cuda_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default fold works")
    with pytest.raises(ValueError, match="0 device"):
        make_host_mesh(model=1)


def test_make_host_mesh_devices_override():
    mesh = make_host_mesh(model=1, devices=cpus(1))
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == ((torch.device("cpu"),),)
    assert mesh.group is None and mesh.device == torch.device("cpu")


def test_make_host_mesh_folds_data_axis():
    mesh = make_host_mesh(model=2, devices=cpus(4))
    assert mesh.shape == {"data": 2, "model": 2}
    assert (mesh.data_rank, mesh.model_rank) == (0, 0)


# ---------------------------------------------------------------------------
# divisibility fallback (:98, :110)
# ---------------------------------------------------------------------------


def test_rules_divisibility_fallback_no_warning_when_divisible():
    rules = Rules(make_host_mesh(model=1, devices=cpus(1)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spec = rules.spec((4, 8), "heads,ffn")
    assert spec[0] == "model"                       # heads sharded (1-wide)


def test_rules_divisibility_fallback_warns_and_replicates():
    rules = Rules(make_host_mesh(model=2, devices=cpus(2)))
    with pytest.warns(UserWarning, match="'heads'"):
        spec = rules.spec((5, 6), "heads,ffn")
    assert spec == (None, "model")
    with warnings.catch_warnings():                 # once per (instance, axis)
        warnings.simplefilter("error")
        rules.spec((5, 6), "heads,ffn")
    assert Rules(None).spec((4, 8), "heads,ffn") == ()


# ---------------------------------------------------------------------------
# the plan (:122): GQA coupling, MoE, the fallbacks
# ---------------------------------------------------------------------------

# (arch, m) -> (contract axes, the warning's axis or None); SMOKE heads /
# kv_heads / d_ff: qwen 4 / 2 / 128, recurrentgemma 4 / 1 / 128, dbrx 4 / 2
# / 96 with MoE
PLANS = {
    (QWEN, 2): ({"heads", "ffn"}, None),
    (QWEN, 4): ({"ffn"}, "kv_heads"),
    ("recurrentgemma-9b", 2): ({"ffn"}, "kv_heads"),
    ("recurrentgemma-9b", 4): ({"ffn"}, "kv_heads"),
    ("dbrx-132b", 2): ({"heads"}, None),
    ("dbrx-132b", 4): (set(), "kv_heads"),
}


@pytest.mark.parametrize("arch,m", sorted(PLANS))
def test_tp_plan_gqa_coupling_and_moe(arch, m):
    cfg = ranks.cfg_of(arch)
    contract, warned = PLANS[(arch, m)]
    mesh = make_host_mesh(model=m, devices=cpus(m))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan = tp.tp_plan(cfg, mesh)
    msgs = [str(w.message) for w in caught]
    assert plan.rules.contract_axes == frozenset(contract)
    assert plan.model_shards == m
    # heads and kv_heads shard together or not at all
    assert ("kv_heads" in plan.sharded_axes) == ("heads" in plan.sharded_axes)
    assert ("ffn" in plan.sharded_axes) == ("ffn" in contract)
    if warned is None:
        assert msgs == []
    else:
        assert len(msgs) == 1 and warned in msgs[0]


def test_tp_plan_edges():
    cfg = ranks.cfg_of(QWEN)
    assert tp.tp_plan(cfg, None) is None
    plan = tp.tp_plan(cfg, make_host_mesh(model=1, devices=cpus(1)))
    assert plan.sharded_axes == frozenset()         # m = 1 shards nothing
    assert plan.rules.contract_axes == frozenset()  # and contracts nothing
    nomodel = dataclasses.replace(make_host_mesh(1, devices=cpus(1)),
                                  shape={"data": 1})
    with pytest.raises(ValueError, match="model"):
        tp.tp_plan(cfg, nomodel)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _block_axes(tree):
    """{(leaf path within its block, ...): axes} of a params-axes tree, the
    blocks' leaves keyed without their layer (the reference stacks them;
    a stacked leaf's axes start with "layers,")."""
    out = {}
    for path, axes in _flat(tree):
        if path[0] == "blocks":
            # port: ("blocks", i, ...); reference: ("blocks", "scan" |
            # "tail", j, ...)
            path = path[3:] if path[1] in ("scan", "tail") else path[2:]
            axes = axes.removeprefix("layers,").removeprefix("layers")
            path = ("blocks",) + path
        out.setdefault(path, set()).add(axes)
    return out


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_param_axes_are_the_references(arch):
    cfg = ranks.cfg_of(arch)
    axes = api.param_axes(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    shapes = api.param_shapes(cfg)
    got = dict(_flat(axes))
    assert got.keys() == dict(_flat(params)).keys() == dict(
        _flat(shapes)).keys()
    for path, t in _flat(params):
        assert dict(_flat(shapes))[path] == t.shape
    assert _block_axes(axes) == _block_axes(japi.param_axes(jcfg(arch)))
    # the pools shard their KV heads, the state slots replicate, as the
    # reference's paged_cache_axes (whose leaves carry a "layers" prefix
    # where it stacks them)
    want = {a.removeprefix("layers,").removeprefix("layers")
            for _, a in _flat(japi.paged_cache_axes(jcfg(arch)))}
    cache_axes = api.paged_cache_axes(cfg)
    assert {a for _, a in _flat(cache_axes)} == want
    for e, kind in zip(cache_axes, tfm.layer_kinds(cfg)):
        if kind in api.STATE_KINDS:
            assert set(e.values()) == {""}
        else:
            assert e == {"k": ",,kv_heads", "v": ",,kv_heads"}


@pytest.mark.parametrize("arch", [QWEN, "recurrentgemma-9b", "dbrx-132b"])
def test_shard_params_round_trip(arch, bundle):
    """Each sharded leaf's parts, concatenated along its sharded dim in
    rank order, are the full leaf; replicated leaves are the full tensor
    on every rank."""
    cfg, params = ranks.cfg_of(arch), bundle[1][arch]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = tp.tp_plan(cfg, make_host_mesh(model=2, devices=cpus(2)))
    specs = dict(_flat(plan.param_specs(cfg)))
    parts = [dict(_flat(tp.shard_params(params, plan, r))) for r in (0, 1)]
    n_sharded = 0
    for path, full in _flat(params):
        spec = specs[path]
        if "model" not in spec:
            assert all(p[path] is full for p in parts), path
            continue
        n_sharded += 1
        dim = spec.index("model")
        assert all(p[path].is_contiguous() for p in parts)
        assert torch.equal(torch.cat([p[path] for p in parts], dim), full)
        # only attention and MLP weights shard
        assert {"attn", "mlp"} & set(path), path
    if arch == QWEN:            # wq wk wv wo bq bk bv wi wg wo, two layers
        assert n_sharded == 2 * 10
    if arch == "dbrx-132b":     # attention only: MoE replicates
        assert n_sharded == 2 * 4


def test_paged_cache_init_at_kv_over_m():
    cfg = ranks.cfg_of(QWEN)
    plan = tp.tp_plan(cfg, make_host_mesh(model=2, devices=cpus(2)))
    full = api.paged_cache_init(cfg, 5, 8, slots=3, device="cpu")
    specs = plan.cache_specs(cfg, full)
    assert specs[0] == {"k": (None, None, "model"),
                        "v": (None, None, "model")}
    part = tp.paged_cache_init(plan, cfg, 5, 8, slots=3, device="cpu")
    assert [e["k"].shape for e in part] == [(5, 8, cfg.kv_heads // 2,
                                             cfg.resolved_head_dim)] * 2
    assert all(float(t.abs().sum()) == 0 for e in part for t in e.values())


# ---------------------------------------------------------------------------
# one layer, shard by shard: a wrong kv-major slice shows here
# ---------------------------------------------------------------------------


def _layer_case(bundle):
    cfg = ranks.cfg_of(QWEN)
    p = bundle[1][QWEN]["blocks"][0]
    plan = tp.tp_plan(cfg, make_host_mesh(model=2, devices=cpus(2)))
    parts = [tp.shard_params(bundle[1][QWEN], plan, r)["blocks"][0]
             for r in (0, 1)]
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, cfg.d_model), generator=g)
    return cfg, p, parts, x, g


def test_attention_prefill_shard_sums_equal_whole_layer(bundle):
    cfg, p, parts, x, _ = _layer_case(bundle)
    want, (k, v) = layers.attention_apply(cfg, p["attn"], x)
    outs = [layers.attention_apply(cfg, q["attn"], x) for q in parts]
    torch.testing.assert_close(outs[0][0] + outs[1][0], want, **F32)
    # each rank's k/v are its KV heads of the whole layer's, kv-major
    kv = cfg.kv_heads // 2
    for r, (_, (kr, vr)) in enumerate(outs):
        torch.testing.assert_close(kr, k[:, :, r * kv:(r + 1) * kv], **F32)
        torch.testing.assert_close(vr, v[:, :, r * kv:(r + 1) * kv], **F32)


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_paged_decode_shard_sums_equal_whole_layer(bundle, impl):
    cfg, p, parts, _, g = _layer_case(bundle)
    cfg = dataclasses.replace(cfg, paged_attn_impl=impl)
    B, T, page, nb = 2, 2, 8, 3
    hd, kvh = cfg.resolved_head_dim, cfg.kv_heads
    pools = {n: torch.randn((1 + B * nb, page, kvh, hd), generator=g)
             for n in ("k", "v")}
    table = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    pos = torch.tensor([5, 13], dtype=torch.int32)
    x = torch.randn((B, T, cfg.d_model), generator=g)
    rows = layers.paged_rows(table, pos, T, page)
    whole = {n: t.clone() for n, t in pools.items()}
    want, _ = layers.attention_decode(cfg, p["attn"], x, whole, pos, table,
                                      rows)
    kv = kvh // 2
    got = 0
    for r, q in enumerate(parts):
        part = {n: t[:, :, r * kv:(r + 1) * kv].clone()
                for n, t in pools.items()}
        out, _ = layers.attention_decode(cfg, q["attn"], x, part, pos,
                                         table, rows)
        got = got + out
        for n in ("k", "v"):         # the rank's pool got its heads' rows
            torch.testing.assert_close(
                part[n], whole[n][:, :, r * kv:(r + 1) * kv], **F32)
    torch.testing.assert_close(got, want, **F32)


def test_mlp_shard_sums_equal_whole_layer(bundle):
    cfg, p, parts, x, _ = _layer_case(bundle)
    want = layers.mlp_apply(cfg, p["mlp"], x)
    got = sum(layers.mlp_apply(cfg, q["mlp"], x) for q in parts)
    torch.testing.assert_close(got, want, **F32)


# ---------------------------------------------------------------------------
# refusals, in one process
# ---------------------------------------------------------------------------


def test_host_tier_with_mesh_raises(bundle):
    with pytest.raises(ValueError, match="host_tier"):
        PagedServingEngine(ranks.cfg_of(QWEN), bundle[1][QWEN],
                           mesh=make_host_mesh(1, devices=cpus(1)),
                           host_tier=True, device="cpu", **ranks.ENGINE)


def test_sharded_engine_outside_a_world_raises(bundle):
    with pytest.raises(ValueError, match="process group"):
        PagedServingEngine(ranks.cfg_of(QWEN), bundle[1][QWEN],
                           mesh=make_host_mesh(2, devices=cpus(2)),
                           device="cpu", **ranks.ENGINE)


def test_router_validates(bundle):
    cfg, params = ranks.cfg_of(QWEN), bundle[1][QWEN]
    with pytest.raises(ValueError, match="device"):
        make_replicas(cfg, params, replicas=2, devices=cpus(1))
    with pytest.raises(ValueError, match="device"):
        make_replicas(cfg, params, replicas=1, model=2, devices=cpus(1))
    with pytest.raises(ValueError, match="world"):
        make_replicas(cfg, params, replicas=2, devices=cpus(2))
    with pytest.raises(ValueError, match="policy"):
        ReplicaRouter([object()], policy="round_robin")
    with pytest.raises(ValueError):
        ReplicaRouter([])
    with pytest.raises(ValueError, match="world"):
        ReplicaRouter([None, object()])


def test_factory_passes_mesh_to_the_paged_engine(bundle):
    mesh = make_host_mesh(1, devices=cpus(1))
    eng = ServingEngine(ranks.cfg_of(QWEN), bundle[1][QWEN], mesh=mesh,
                        device="cpu", **ranks.ENGINE)
    assert isinstance(eng, PagedServingEngine)
    assert eng.tp is not None and eng.tp.model_shards == 1
    assert eng.metrics()["shard.model_shards"] == 1.0


# ---------------------------------------------------------------------------
# the single-shard baselines against the JAX engine and each other
# ---------------------------------------------------------------------------


def test_plain_gather_engine_equals_jax_engine(bundle, base):
    jc = dataclasses.replace(jcfg(QWEN), dtype="float32",
                             kv_cache_dtype="float32")
    jeng = JEngine(jc, bundle[2][QWEN], attn_impl="gather", **ranks.ENGINE)
    jreqs = [JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
             for r in ranks.reqs()]
    jeng.run_to_completion(jreqs)
    assert all(r.done for r in jreqs)
    assert base["gather"]["tokens"] == [r.generated for r in jreqs]
    assert base["kernel"]["tokens"] == base["gather"]["tokens"]


def test_router_single_replica_matches_engine(base, bundle):
    eng = PagedServingEngine(ranks.cfg_of(QWEN), bundle[1][QWEN],
                             device="cpu", **ranks.ENGINE)
    rs = ranks.reqs(6)
    eng.run_to_completion(rs)
    one = base["router_hash"]          # make_replicas(replicas=1): no world
    assert one["tokens"] == [r.generated for r in rs]
    assert one["routed"] == [6] and one["model_shards"] == [1.0]


# ---------------------------------------------------------------------------
# world of 1: the mesh path with nothing to contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", WORLD_SCENARIOS[1])
def test_world1_mesh_equals_plain_engine(world1, base, name):
    assert_tokens_equal_base(world1, base, name)
    res = results(world1, name)[0]
    assert res["shard"]["model_shards"] == 1.0
    assert res["shard"]["pool_bytes_per_shard"] == \
        base[name]["shard"]["pool_bytes_per_shard"]
    assert res["reduces"] == 0                      # m = 1 contracts nothing


def test_world1_sampled_streams_are_distinct(base):
    toks = base["sampled"]["tokens"]
    assert len({tuple(t) for t in toks}) == len(toks)


# ---------------------------------------------------------------------------
# world of 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["kernel", "gather"])
def test_tp2_exact_equivalence(world2, base, name):
    assert_tokens_equal_base(world2, base, name)
    for res in results(world2, name):
        st = res["shard"]
        assert st["model_shards"] == 2.0
        assert st["peak_pages_per_shard"] == float(res["peak"])
        assert res["peak"] == base[name]["peak"]
        assert st["pool_bytes_per_shard"] * 2 == \
            base[name]["shard"]["pool_bytes_per_shard"]
        assert "kv_heads" in st["sharded_axes"] and "ffn" in st["sharded_axes"]
        assert res["reduces"] > 0 and res["warnings"] == []


def test_tp2_with_prefix_cache(world2, base):
    assert_tokens_equal_base(world2, base, "prefix")
    for res in results(world2, "prefix"):
        assert res["saved"] == base["prefix"]["saved"] > 0  # sharing happened


def test_tp2_with_speculative_decode(world2, base):
    assert_tokens_equal_base(world2, base, "spec")


def test_tp2_preemption_resume(world2, base):
    assert sum(base["preempt"]["preemptions"]) > 0  # pressure was real
    assert_tokens_equal_base(world2, base, "preempt",
                             keys=("tokens", "preemptions"))


def test_tp2_recurrentgemma_attention_falls_back_mlp_shards(world2, base):
    assert_tokens_equal_base(world2, base, "rgemma")
    for res in results(world2, "rgemma"):
        assert any("kv_heads" in w for w in res["warnings"])
        assert res["shard"]["sharded_axes"] == "ffn+wff"
        # attention replicates: the window pools keep every KV head
        assert res["shard"]["pool_bytes_per_shard"] == \
            base["rgemma"]["shard"]["pool_bytes_per_shard"]


def test_tp2_mamba2(world2, base):
    assert_tokens_equal_base(world2, base, "mamba")
    for res in results(world2, "mamba"):
        assert res["reduces"] == 0          # no attention, no MLP: no sums


def test_tp2_dbrx_dying_slots(world2, base):
    assert len({len(t) for t in base["dbrx"]["tokens"]}) > 3  # staggered
    assert_tokens_equal_base(world2, base, "dbrx")
    for res in results(world2, "dbrx"):
        assert res["shard"]["sharded_axes"] == \
            "heads+kv_heads+wheads+wkv_heads"           # MoE replicated
        assert res["allocated"] == 0


def test_tp2_sampled_equivalence(world2, base):
    assert_tokens_equal_base(world2, base, "sampled")


@pytest.mark.parametrize("name", ["router_hash", "router_least"])
def test_router_replicas_match_baseline(world2, base, name):
    for res in results(world2, name):
        assert res["tokens"] == base["router_hash"]["tokens"]
        assert res["done"] == 6
        assert sum(res["routed"]) == 6 and min(res["routed"]) > 0
        assert res["model_shards"] == [1.0, 1.0]
        assert len(res["peak_pages_per_shard"]) == 2


def test_router_hash_routes_by_rid(world2):
    assert results(world2, "router_hash")[0]["routed"] == [3, 3]


# ---------------------------------------------------------------------------
# world of 4: kv_heads = 2 falls back, the ffn still shards; 2 x 2 routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["kernel", "gather"])
def test_tp4_exact_equivalence_with_fallback(world4, base, name):
    assert_tokens_equal_base(world4, base, name)
    for res in results(world4, name):
        assert any("kv_heads" in w for w in res["warnings"])
        assert res["shard"]["sharded_axes"] == "ffn+wff"
        assert res["shard"]["model_shards"] == 4.0


def test_tp4_sampled_equivalence(world4, base):
    assert_tokens_equal_base(world4, base, "sampled")


def test_router_tp_replicas_compose(world4, base):
    """2 replicas x 2 shards on 4 ranks: DP and TP together."""
    for res in results(world4, "router_2x2"):
        assert res["tokens"] == base["router_hash"]["tokens"]
        assert res["model_shards"] == [2.0, 2.0]
        assert res["routed"] == [3, 3]


# ---------------------------------------------------------------------------
# lockstep: every rank returns the same results, and none imported jax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4])
def test_every_rank_returns_the_same_results(n, request):
    world = request.getfixturevalue(f"world{n}")
    assert len(world) == n
    for name in WORLD_SCENARIOS[n]:
        res = results(world, name)
        for r in res[1:]:
            assert r == res[0], name
    assert all(r["jax_loaded"] == [] for r in world)


# ---------------------------------------------------------------------------
# the world launcher, the bench's sharded scenario and the launcher's knobs
# ---------------------------------------------------------------------------


def _fails_on_rank_1(rank):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 refuses")
    dist.barrier()            # rank 0 would wait here for ever


def test_run_world_reraises_a_ranks_exception_and_stops_the_rest(tmp_path):
    with pytest.raises(WorldError, match="--- rank 1 ---(.|\n)*refuses"):
        run_world(_fails_on_rank_1, 2, backend="gloo",
                  init_file=str(tmp_path / "rendezvous"), timeout=120)


def _run(module, *args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_serve_bench_sharded_scenario_rows():
    r = _run("repro_torch.launch.serve_bench", "--smoke", "--device", "cpu",
             "--scenario", "sharded", "--dtype", "float32",
             "--cpu-shards", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    rows = [row for _, rs in check_csv.parse_sections(r.stdout)
            for row in rs]
    assert [row["engine"] for row in rows] == [
        "paged[kernel,tp1]", "paged[kernel,tp2]", "paged[kernel,tp4]"]
    for row in rows[:2]:
        assert row["tokens_match_tp1"] == "1"
        assert row["requests_done"] == "4"
    assert int(rows[1]["pool_bytes_per_shard"]) * 2 == \
        int(rows[0]["pool_bytes_per_shard"])
    assert rows[1]["peak_pages_per_shard"] == rows[0]["peak_pages_per_shard"]
    assert "needs 4 devices, have 2" in rows[2]["skipped"]
    # the other scenarios' columns are absent, this one's passes
    assert check_csv.UNPORTED == ()
    assert check_csv.check(r.stdout) == check_csv.missing_scenario_errors(
        ("tokens_match_unconstrained", "tokens_match_greedy"))


def test_serve_launcher_shards_and_replicas_on_cpu():
    r = _run("repro_torch.launch.serve", "--arch", QWEN, "--smoke",
             "--device", "cpu", "--slots", "2", "--requests", "5",
             "--max-new", "4", "--max-len", "64", "--shards", "2",
             "--replicas", "2", "--route", "least_loaded")
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert "router: 2 replica(s) x 2 shard(s) over 4 rank(s)" in out
    assert "5/5 requests, 20 tokens" in out
    assert out.count("2 shards (ffn+heads+kv_heads") == 2
    assert out.count("[launch.serve] engine:") == 1      # rank 0 prints
