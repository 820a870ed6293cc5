"""The port's dry-run and its analysis, held to the JAX package on the CPU.

* the cells: ``SHAPES``, ``cell_runnable``, ``input_specs`` (shapes and
  dtypes; tokens and labels int64 in the port), ``cache_shapes`` /
  ``cache_axes`` (the reference's stacked leaves unstacked a layer at a
  time), ``model_flops_for``: equal for all ten archs;
* ``roofline``: the reference's formulas under the H100 constants;
  ``report``: the reference's strings on the same records;
* ``op_cost`` on hand-made cases, as ``tests/test_sharding_analysis.py``
  holds ``hlo_cost``: a matmul, a view, an index op, the sums a decode
  and a remat-full train step record at ``model`` 2, a step that reads a
  value back to the host; a kernel seam counted as its kernel (flash-MHA:
  the causal pairs it attends, no scores held; the attended pairs against
  the plain version's mask) or as its plain version, and the full-width
  prefill cell, whose memory the plain version's scores no longer fill;
* the period extrapolation: from depths p and 2p, a trace at depth 4p,
  exactly for FLOPs, bytes, collectives and ops, and the memory within
  5% (SMOKE widths);
* the kernel seam: every ``kernels.ops`` entry refuses fake and meta CUDA
  inputs before any build or launch (fake CUDA tensors exist in a
  CPU-only build).

The CLI at full width is in ``tests/test_torch_dryrun_cli.py``; the matmul
FLOPs against the JAX dry-run's compiled HLO in
``tests/test_torch_dryrun_flops*.py`` (their JAX compiles take workers of
their own).
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from repro.analysis import report as jreport  # noqa: E402
from repro.analysis import roofline as jrl  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.analysis import op_cost, report, roofline as rl  # noqa: E402
from repro_torch.configs import ARCHS, base, get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402,E501
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.parallel import tp  # noqa: E402
from repro_torch.parallel.sharding import Rules  # noqa: E402
from torch_cases import OP_NAMES, op_calls_on  # noqa: E402

CELLS = [(a, s) for a in ARCHS for s in base.SHAPES]


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def test_shapes_equal_the_reference():
    assert list(base.SHAPES) == list(jbase.SHAPES)
    for name, s in base.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jbase.SHAPES[name])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_runnable_equals_the_reference(arch, shape):
    assert base.cell_runnable(get_config(arch), base.SHAPES[shape]) == \
        jbase.cell_runnable(jget(arch), jbase.SHAPES[shape])


def _spec_sd(spec):
    return tuple(spec.shape), str(spec.dtype)


def _unstack_shapes(cfg, tree):
    """The reference's {"scan": {j: leaf (n_super, ...)}, "tail": [...]}
    cache tree of ShapeDtypeStructs as one dict a layer, in layer order:
    (shape, dtype) a leaf."""
    n_super, _ = tfm.layer_plan(cfg)
    p = len(tfm.pattern_for(cfg))
    out = [{k: (tuple(v.shape[1:]), str(v.dtype))
            for k, v in tree["scan"][str(i % p)].items()}
           for i in range(n_super * p)]
    return out + [{k: _spec_sd(v) for k, v in e.items()}
                  for e in tree["tail"]]


def _port_sd(cache):
    return [{k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
             for k, t in e.items()} for e in cache]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    got = base.input_specs(get_config(arch), base.SHAPES[shape])
    want = jbase.input_specs(jget(arch), jbase.SHAPES[shape])
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "cache":
            assert _port_sd(got[k]) == _unstack_shapes(jget(arch), w)
            assert all(t.device.type == "meta" for e in got[k]
                       for t in e.values())
            continue
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].device.type == "meta"
        dt = str(got[k].dtype).replace("torch.", "")
        if k in ("tokens", "labels"):
            assert (dt, str(w.dtype)) == ("int64", "int32")
        else:
            assert dt == str(w.dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_and_axes_equal_the_reference(arch):
    for cfg_of, jcfg_of in ((get_config, jget),
                            (get_smoke_config, None)):
        cfg = cfg_of(arch)
        if jcfg_of is None:
            from repro.configs import get_smoke_config as jcfg_of
        jc = jcfg_of(arch)
        assert _port_sd(api.cache_shapes(cfg, 3, 40)) == _unstack_shapes(
            jc, japi.cache_shapes(jc, 3, 40))
        want = japi.cache_axes(jc)
        n_super, _ = tfm.layer_plan(cfg)
        p = len(tfm.pattern_for(cfg))
        flat = [{k: v.removeprefix("layers,")
                 for k, v in want["scan"][str(i % p)].items()}
                for i in range(n_super * p)] + list(want["tail"])
        assert api.cache_axes(cfg) == flat


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    assert rl.model_flops_for(get_config(arch), base.SHAPES[shape]) == \
        jrl.model_flops_for(jget(arch), jbase.SHAPES[shape])


# ---------------------------------------------------------------------------
# roofline and report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("link", ["nvlink", "nic"])
@pytest.mark.parametrize("terms", [(3e15, 2e12, 1e9), (1e12, 9e12, 2e9),
                                   (1e12, 1e9, 4e11), (0.0, 0.0, 0.0)])
def test_roofline_follows_the_reference_under_h100_constants(
        monkeypatch, terms, link):
    flops, bts, coll = terms
    kw = dict(flops=flops, bytes_hbm=bts, bytes_coll=coll, chips=256,
              coll_breakdown={"all-reduce:model": int(coll)},
              model_flops=5e17)
    got = rl.Roofline(**kw, link=link)
    monkeypatch.setattr(jrl, "PEAK_FLOPS", 989e12)
    monkeypatch.setattr(jrl, "HBM_BW", 3.35e12)
    monkeypatch.setattr(jrl, "ICI_BW", 450e9 if link == "nvlink" else 50e9)
    want = jrl.Roofline(**kw)
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "t_bound", "useful_flops_frac", "roofline_frac"):
        assert getattr(got, name) == getattr(want, name), name
    d = got.to_dict()
    assert {k: v for k, v in d.items() if k in want.to_dict()} == \
        want.to_dict()
    assert d["collective_link"] == link
    assert (d["peak_flops"], d["hbm_bw"]) == (989e12, 3.35e12)


def test_roofline_link_choice():
    """NVLink while the summing axis fits one 8-GPU node, else the NIC:
    pod16x16's 16-way model axis spans two nodes; a (data 2, model 4)
    fold keeps its model groups in a node but not its data groups."""
    prod = make_production_mesh().shape
    assert rl.link_for(prod, ["model"]) == "nic"
    assert rl.link_for({"data": 2, "model": 4}, ["model"]) == "nvlink"
    assert rl.link_for({"data": 2, "model": 4}, ["data"]) == "nvlink"
    assert rl.link_for({"data": 4, "model": 4}, ["data"]) == "nic"
    assert rl.link_for(prod, []) == "nvlink"
    cost = op_cost.Cost(flops=1.0, bytes=2.0,
                        coll_bytes={"all-reduce:model": 3.0})
    r = rl.analyze(cost, chips=256, axis_sizes=prod)
    assert (r.link, r.bytes_coll, r.t_collective) == ("nic", 3.0, 3.0 / 50e9)


def _records():
    ok = {"cell": "yi-6b__train_4k__pod16x16", "arch": "yi-6b",
          "shape": "train_4k", "mesh": "pod16x16", "status": "ok",
          "memory": {"total_bytes_per_device": 3.5 * 2**30},
          "roofline": rl.Roofline(1e15, 4e12, 1e10, 256, {}, 3e17,
                                  "nic").to_dict()}
    ok2 = dict(ok, cell="yi-6b__decode_32k__pod16x16", shape="decode_32k",
               roofline=rl.Roofline(1e9, 4e12, 0.0, 256, {}, 1e12
                                    ).to_dict())
    skip = {"cell": "yi-6b__long_500k__pod16x16", "status": "skipped",
            "reason": "long_500k needs sub-quadratic attention; full-attn"}
    err = {"cell": "yi-6b__prefill_32k__pod16x16", "arch": "yi-6b",
           "shape": "prefill_32k", "mesh": "pod16x16", "status": "error",
           "error": "DataDependentOutputException: aten._local_scalar_dense"}
    return [ok, ok2, skip, err]


def test_report_equals_the_reference_strings():
    rows = _records()
    assert report.roofline_table(rows) == jreport.roofline_table(rows)
    assert report.summary(rows) == jreport.summary(rows)
    assert report.summary(rows)["bottlenecks"] == {"memory": 2}


def test_report_reads_its_own_directory(tmp_path):
    assert report.DRYRUN_DIR.endswith(os.path.join("experiments",
                                                   "dryrun_torch"))
    for r in _records():
        (tmp_path / (r["cell"] + ".json")).write_text(json.dumps(r))
    rows = report.load_cells(str(tmp_path), mesh="pod16x16")
    assert rows == jreport.load_cells(str(tmp_path), mesh="pod16x16")
    assert len(rows) == 3            # the skipped record names no mesh


# ---------------------------------------------------------------------------
# op_cost on hand-made cases
# ---------------------------------------------------------------------------


def _fake_trace(fn, *shapes_dtypes, rules=None):
    with op_cost.fake_mode():
        args = tuple(torch.empty(s, dtype=d) for s, d in shapes_dtypes)
        return op_cost.trace(fn, args, rules)


def test_matmul_flops_and_bytes():
    f32 = torch.float32
    tr = _fake_trace(lambda a, b: a @ b, ((64, 32), f32), ((32, 16), f32))
    assert tr.cost.dot_flops == tr.cost.flops == 2 * 64 * 32 * 16
    assert tr.cost.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert tr.memory["argument_bytes"] == (64 * 32 + 32 * 16) * 4
    assert tr.memory["output_bytes"] == 64 * 16 * 4
    assert tr.memory["alias_bytes"] == 0
    assert tr.cost.coll_bytes == {}
    # bf16 batched: the same formula a batch
    bf = torch.bfloat16
    tr = _fake_trace(lambda a, b: a @ b, ((3, 64, 32), bf), ((3, 32, 16), bf))
    assert tr.cost.dot_flops == 3 * 2 * 64 * 32 * 16
    assert tr.cost.bytes == 3 * (64 * 32 + 32 * 16 + 64 * 16) * 2


def test_a_view_counts_nothing():
    f32 = torch.float32
    tr = _fake_trace(lambda a: a.view(32, 64).t()[:, 1:5].transpose(0, 1),
                     ((64, 32), f32))
    assert (tr.cost.flops, tr.cost.bytes) == (0.0, 0.0)
    assert tr.memory["temp_bytes"] == 0
    assert tr.memory["alias_bytes"] == tr.memory["output_bytes"] == 64 * 32 * 4


def test_an_index_op_counts_its_slice():
    """A gather of 5 rows of a (1000, 64) table: 2 x the (5, 64) output
    (``_SLICING``), the table unread; an in-place write of 3 rows: 2 x the
    update, and its output aliases the argument."""
    f32 = torch.float32
    with op_cost.fake_mode():
        t = torch.empty(1000, 64)
        idx = torch.zeros(5, dtype=torch.int64)
        tr = op_cost.trace(lambda t, i: t[i], (t, idx))
    assert tr.cost.bytes == 2 * 5 * 64 * 4
    assert tr.cost.flops == 0.0

    def write(t, u):
        t[10:13] = u
        return t

    tr = _fake_trace(write, ((1000, 64), f32), ((3, 64), f32))
    assert tr.cost.bytes == 2 * 3 * 64 * 4
    assert tr.memory["alias_bytes"] == 1000 * 64 * 4
    assert tr.memory["total_bytes_per_device"] == (1000 + 3) * 64 * 4


def test_elementwise_and_transcendental_flops():
    f32 = torch.float32
    tr = _fake_trace(lambda a, b: torch.exp(a * b + 1.0), ((8, 16), f32),
                     ((8, 16), f32))
    assert tr.cost.flops == 3 * 128
    assert tr.cost.transcendentals == 128
    assert tr.cost.dot_flops == 0.0


def test_visible_keys_equal_the_plain_versions_mask():
    """``op_cost``'s count of attended (row, key) pairs against the mask
    ``kernels.ref.mha_ref`` builds, over offsets, windows and lengths."""
    for Sq, Sk, causal, valid, off, win in [
            (16, 16, True, 16, 0, 0), (5, 40, True, 40, 35, 0),
            (7, 30, True, 21, 20, 6), (1, 64, False, 37, 0, 0),
            (12, 12, True, 9, 0, 4), (3, 50, True, 50, 10, 0)]:
        qpos = off + torch.arange(Sq)[:, None]
        kpos = torch.arange(Sk)[None, :]
        mask = kpos < valid
        if causal:
            mask = mask & (kpos <= qpos)
            if win:
                mask = mask & (qpos - kpos < win)
        assert op_cost._visible_keys(Sq, Sk, causal, valid, off, win) \
            == int(mask.sum()), (Sq, Sk, causal, valid, off, win)


def test_a_kernel_seam_counts_its_kernel():
    """Under ``seams="kernel"`` an ``ops.attention`` call on CPU fakes
    counts as the flash-MHA kernel: its products over the causal pairs,
    one exp a pair and head, q, k and v read and the output written once,
    one op, and no (Sq, Sk) scores held. Under "plain" the plain version's
    every op: the full products and the fp32 scores."""
    B, S, H, KV, D = 2, 256, 4, 2, 64
    f32 = torch.float32

    def attn(q, k, v):
        return ops.attention(q, k, v, causal=True)

    with op_cost.fake_mode():
        args = (torch.empty(B, S, H, D), torch.empty(B, S, KV, D),
                torch.empty(B, S, KV, D))
        kern = op_cost.trace(attn, args)
        plain = op_cost.trace(attn, args, seams="plain")
        # a device kv_valid is data: the whole lane counts, and the
        # kernel's (B,) int32 lengths are its workspace
        q1 = torch.empty(B, 1, H, D, dtype=f32)
        n = torch.empty(B, dtype=torch.int32)
        dec = op_cost.trace(lambda q, k, v, n: ops.attention(
            q, k, v, causal=False, kv_valid=n), (q1, *args[1:], n))
    assert ops.seam_hook is None
    pairs = B * S * (S + 1) // 2
    q_bytes, kv_bytes = B * S * H * D * 4, B * S * KV * D * 4
    assert kern.cost.dot_flops == 4 * D * H * pairs
    assert kern.cost.transcendentals == H * pairs
    assert kern.cost.flops == 4 * D * H * pairs + H * pairs
    assert kern.cost.bytes == 2 * q_bytes + 2 * kv_bytes
    assert kern.ops == 1 and kern.cost.by_op == {"kernel:mha": kern.cost.bytes}
    assert kern.memory["temp_bytes"] == 0
    assert kern.memory["output_bytes"] == q_bytes
    assert plain.cost.dot_flops == 4 * D * H * B * S * S
    assert plain.memory["temp_bytes"] >= B * H * S * S * 4
    assert plain.ops > 10
    assert dec.cost.dot_flops == 4 * D * H * B * S
    assert dec.cost.bytes == 2 * B * H * D * 4 + 2 * kv_bytes + 4 * B
    assert dec.memory["temp_bytes"] == 4 * B


def test_a_seam_without_a_kernel_cost_is_an_error():
    with op_cost.fake_mode():
        x = torch.empty(8, 8)
        with pytest.raises(NotImplementedError, match="tiled_transpose"):
            op_cost.trace(ops.transpose, (x,))
        assert op_cost.trace(ops.transpose, (x,), seams="plain").ops > 0
    assert ops.seam_hook is None


def test_the_prefill_cell_holds_no_scores():
    """qwen2.5-3b's prefill_32k on pod16x16 (2 rows of 32k a rank, its 16
    query heads over the 16 ranks, one a rank): the card's kernel holds no
    (32k, 32k) scores, so the rank's memory is its parameters, activations
    and cache, under 16 GiB, where the plain version's fp32 scores alone
    take 2 x 2 x 1 x 32k x 32k x 4 bytes; the causal kernel does about
    half the plain products."""
    cfg, mesh = get_config("qwen2.5-3b"), make_production_mesh()
    shape = base.SHAPES["prefill_32k"]
    kern, _ = dryrun.trace_cell(cfg, shape, mesh)
    plain, _ = dryrun.trace_cell(cfg, shape, mesh, seams="plain")
    assert kern.memory["total_bytes_per_device"] < 16 * 2**30
    heads = cfg.num_heads // mesh.shape["model"]
    assert heads == 1
    assert plain.memory["temp_bytes"] > 2 * 2 * heads * 32768**2 * 4
    per_layer = 4 * 128 * heads * 2       # 4 D H B, a head each rank
    assert plain.cost.dot_flops - kern.cost.dot_flops == \
        cfg.num_layers * per_layer * (32768**2 - 32768 * 32769 // 2)


def _model2():
    """qwen2.5-3b SMOKE (4 heads over 2 KV heads, d 64) on a described
    (data 1, model 2) fold: attention and MLP both shard."""
    return get_smoke_config("qwen2.5-3b"), make_host_mesh(
        2, devices=["cpu"] * 2)


def test_decode_at_model_2_records_two_sums_a_layer():
    """Two sums a layer (the out- and down-projections), and one more for
    the step: the vocab-parallel embedding lookup's (the rank holds half
    the rows). The logits are the rank's half of the vocab."""
    cfg, mesh = _model2()
    B = 3
    shape = base.ShapeConfig("d", 64, B, "decode")
    with op_cost.fake_mode():
        fn, args, rank = steps.make_step(cfg, shape, Rules(mesh))
        logits = fn(*args)[0]
        tr = op_cost.trace(fn, args, rank)
    assert rank.contract_axes == {"heads", "ffn", "vocab"}
    sums = 2 * cfg.num_layers + 1
    assert tr.reduces == sums
    each = B * cfg.d_model * torch.empty((), dtype=getattr(
        torch, cfg.dtype)).element_size()
    assert rank.sums == [("model", each)] * sums
    assert tr.cost.coll_bytes == {"all-reduce:model": sums * each}
    assert tuple(logits.shape) == (B, 256 // 2)
    # the rank's KV heads: half the lanes
    assert args[1][0]["k"].shape == (B, 64, cfg.kv_heads // 2,
                                     cfg.resolved_head_dim)
    assert tr.memory["alias_bytes"] == sum(
        t.numel() * t.element_size() for e in args[1] for t in e.values())


def test_remat_full_train_step_counts_five_sums_a_layer():
    """As ``tests/test_torch_train_parallel.py`` counts on gloo ranks: two
    forward, two backward, and the attention's again in the recompute;
    and for the step the vocab-parallel head's: the embedding lookup's
    sum, the loss input's gradient sum, and the loss chunk's two sums (of
    exp, of the label's logit) in forward and again in its recompute,
    beside its max (a MAX, no ``reduces``) in both."""
    cfg, mesh = _model2()
    assert cfg.remat == "full"
    shape = base.ShapeConfig("t", 64, 2, "train")
    with op_cost.fake_mode():
        fn, args, rank = steps.make_step(cfg, shape, Rules(mesh))
        tr = op_cost.trace(fn, args, rank)
    assert tr.reduces == 5 * cfg.num_layers + 6
    model = [b for a, b in rank.sums if a == "model"]
    act = 2 * 64 * cfg.d_model * 2          # (B, S, d) bf16
    chunk = 2 * 64 * 4                      # (B, chunk) fp32
    assert model.count(act) == 5 * cfg.num_layers + 2
    assert model.count(chunk) == 4 + 2
    # and the norm's one scalar sum; no data axis, nothing gathered
    assert model.count(4) == 1 and len(model) == 5 * cfg.num_layers + 9
    assert all(a == "model" for a, _ in rank.sums)
    assert rank.moves == []


def test_data_axis_sums_every_gradient_leaf():
    """At (data 2, model 1) each gradient leaf crosses the data group once:
    a leaf split over it (every ``wembed`` dim, FSDP) reduce-scatters its
    whole gradient in its gather's backward, every other leaf (norms,
    biases) is summed; the loss and ce are summed too, and the norm's
    squares of the split leaves (one (2,) sum)."""
    cfg = get_smoke_config("qwen2.5-3b")
    mesh = make_host_mesh(1, devices=["cpu"] * 2)
    shape = base.ShapeConfig("t", 64, 4, "train")
    with op_cost.fake_mode():
        fn, args, rank = steps.make_step(cfg, shape, Rules(mesh))
        tr = op_cost.trace(fn, args, rank)
    params = args[0]["params"]
    split = set(rank.sharded)
    flat = torch.utils._pytree.tree_flatten_with_path(params)[0]
    leaves = {tp.path_key(p): t.numel() * t.element_size() for p, t in flat}
    assert args[1]["tokens"].shape == (2, 64)       # the replica's rows
    assert split and all(v == {"data"} for v in rank.sharded.values())
    assert sorted(b for a, b in rank.sums) == sorted(
        [b for k, b in leaves.items() if k not in split] + [4, 4, 8])
    scatters = [b for kind, a, b in rank.moves if kind == "reduce-scatter"]
    assert sorted(scatters) == sorted(2 * b for k, b in leaves.items()
                                      if k in split)
    assert tr.cost.coll_bytes["all-reduce:data"] == sum(
        b for k, b in leaves.items() if k not in split) + 16
    assert tr.cost.coll_bytes["reduce-scatter:data"] == sum(scatters)
    assert tr.reduces == 0


def test_a_step_that_reads_the_host_is_an_error(monkeypatch, tmp_path):
    def reads(cfg, shape, rules, device="cpu"):
        fn, args, rank = steps.make_step(cfg, shape, rules, device=device)

        def step(*a):
            out = fn(*a)
            out[0].sum().item()
            return out
        return step, args, rank

    monkeypatch.setattr(dryrun, "make_step", reads)
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", out_dir=str(tmp_path),
                          verbose=False)
    assert rec["status"] == "error"
    assert "DataDependentOutputException" in rec["error"]
    saved = json.loads((tmp_path / (rec["cell"] + ".json")).read_text())
    assert saved["status"] == "error" and "traceback" in saved


def test_optimized_refuses_context_parallelism(tmp_path):
    """No longer: ``--optimized`` is the reference's options exactly, its
    context parallelism included (``rules_table`` {"seq": "model"}), and a
    cell run with them traces (the context-parallel cells themselves are
    held in ``tests/test_torch_dryrun_cp.py``)."""
    from repro.launch import dryrun as jdryrun
    for shape in base.SHAPES:
        assert dryrun.optimized_kwargs(shape) == \
            jdryrun.optimized_kwargs(shape)
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", out_dir=str(tmp_path),
                          verbose=False,
                          **dryrun.optimized_kwargs("decode_32k"))
    assert rec["status"] == "ok" and rec["rules_table"] == {"seq": "model"}


# ---------------------------------------------------------------------------
# the period extrapolation
# ---------------------------------------------------------------------------

EXTRAP = {
    "qwen2.5-3b": {},
    "recurrentgemma-9b": {},          # a pattern of 3, layer 1 of a tail
    "llama4-maverick-400b-a17b": {},  # moe_every 2
    "seamless-m4t-large-v2": {},      # encoder and decoder together
}


@pytest.mark.parametrize("arch", list(EXTRAP))
def test_period_extrapolation_equals_a_full_trace(arch):
    """Depths p (+ tail) and 2p (+ tail) extrapolated to 4p (+ tail) equal
    a trace of all 4p: FLOPs, bytes, collectives, ops and the sums exactly;
    arguments and outputs exactly, the temporaries' peak within 5% (it is
    affine in the depth up to the order in which a tensor or two die:
    seamless's SMOKE peak parts by one (2, 64, 64) fp32 tensor of 1.46 MB,
    2.2%)."""
    smoke = get_smoke_config(arch)
    p = dryrun.period(smoke)
    r = smoke.num_layers % p
    over = {"num_layers": 4 * p + r}
    if smoke.is_encdec:
        over["enc_layers"] = 4
    cfg = dataclasses.replace(smoke, **over)
    mesh = make_host_mesh(2, devices=["cpu"] * 2)
    shape = base.ShapeConfig("t", 64, 2, "train")
    got, traced = dryrun.trace_cell(cfg, shape, mesh)
    want = dryrun._trace(cfg, shape, Rules(mesh))
    assert traced == [p + r, 2 * p + r]
    g, w = got.cost, want.cost
    for name in ("flops", "dot_flops", "bytes", "transcendentals"):
        assert getattr(g, name) == getattr(w, name), name
    assert g.coll_bytes == w.coll_bytes
    assert (got.ops, got.reduces) == (want.ops, want.reduces)
    for key, v in want.memory.items():
        assert got.memory[key] == pytest.approx(v, rel=5e-2), key
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert got.memory[key] == want.memory[key], key


def test_depths_plan():
    q = get_config("qwen2.5-3b")
    assert dryrun.depths(q) == ({"num_layers": 1}, {"num_layers": 2}, 35)
    rg = get_config("recurrentgemma-9b")          # 38 = 12 x 3 + 2
    assert dryrun.depths(rg) == ({"num_layers": 5}, {"num_layers": 8}, 11)
    sm = get_config("seamless-m4t-large-v2")
    assert dryrun.depths(sm) == ({"num_layers": 1, "enc_layers": 1},
                                 {"num_layers": 2, "enc_layers": 2}, 23)
    assert dryrun.depths(get_smoke_config("qwen2.5-3b")) is None


# ---------------------------------------------------------------------------
# the kernel seam refuses fakes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", OP_NAMES)
def test_kernel_seam_refuses_fake_and_meta_cuda_inputs(monkeypatch, name):
    """A fake CUDA tensor's ``data_ptr()`` is 0: each wrapper refuses it,
    and a meta tensor, first, so nothing is built or launched."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel was built")

    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(build, "library", no_build)
    before = ops.launch_counts()
    with op_cost.fake_mode():
        with pytest.raises(RuntimeError, match="fake or meta tensor"):
            op_calls_on("cuda")[name]()
    with pytest.raises(RuntimeError, match="fake or meta tensor"):
        op_calls_on("meta")[name]()
    assert ops.launch_counts() == before
