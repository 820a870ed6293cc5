"""The port's CUDA kernels and engine on the card, against their plain
PyTorch versions (run there: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_*.py``). Every test is marked ``gpu`` and skips, inside
its fixture, when no CUDA device is present. Imports no jax: the card's
machine runs the port alone."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import attention as mha_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as paged_kernel  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa
from torch_cases import (F32, MHA_CASES, PAGED_CASES,  # noqa: E402
                         mha_inputs, paged_inputs)


def assert_agrees(got, want):
    """fp32: summation order only. bf16: on every query row, within
    ref.ROW_TOL of the row's largest reference output (rounding of the bf16
    output, and of P in mha)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32)
    else:
        worst = ref.row_error(got, want).max().item()
        assert worst <= ref.ROW_TOL[got.dtype], worst


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_cuda_paged_matches_plain(cuda, name, dtype):
    (q, kp, vp, table, lens), kw = paged_inputs(name)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(q).to(cuda, dt)
    kp, vp = (torch.from_numpy(x).to(cuda) for x in (kp, vp))
    if kp.is_floating_point():
        kp, vp = kp.to(dt), vp.to(dt)
    table, lens = torch.from_numpy(table).to(cuda), \
        torch.from_numpy(lens).to(cuda)
    before = paged_kernel.paged_attention.launches
    got = ops.paged_attention(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    assert paged_kernel.paged_attention.launches == before + 1
    want = ref.paged_attention_ref(q, kp, vp, table, lens, **kw)
    assert_agrees(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", MHA_CASES)
def test_cuda_mha_matches_plain(cuda, shape, causal, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in mha_inputs(sum(shape), *shape))
    valid = torch.tensor([shape[2] - 3] * shape[0], dtype=torch.int32,
                         device=cuda)
    for kv_valid in (None, valid):
        before = mha_kernel.mha.launches
        got = ops.attention(q, k, v, causal=causal, kv_valid=kv_valid)
        torch.cuda.synchronize()
        assert mha_kernel.mha.launches == before + 1
        want = ref.mha_ref(q, k, v, causal=causal, kv_valid=kv_valid)
        assert_agrees(got, want)


@pytest.mark.gpu
def test_cuda_engine_tokens_equal_cpu_engine(cuda):
    """fp32 smoke model: the engine on the card (both kernels) emits the
    CPU engine's greedy tokens (plain versions), through a preemption, and
    launches each kernel once per layer per decode step / prefill."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    out = {}
    for dev in ("cpu", cuda):
        eng = PagedServingEngine(cfg, to(params, dev), slots=2, max_len=32,
                                 page_size=4, num_pages=4, device=dev)
        reqs = [Request(rid=0, prompt=[5, 4, 3, 2, 1, 6, 7], max_new=8),
                Request(rid=1, prompt=[1, 2, 3, 4, 5, 6], max_new=8)]
        before = ops.launch_counts()
        eng.run_to_completion(reqs, max_steps=400)
        after = ops.launch_counts()
        out[str(dev)] = [r.generated for r in reqs]
        eng.alloc.check_no_aliasing()
    assert after["paged_attention"] - before["paged_attention"] == \
        cfg.num_layers * eng.decode_steps
    assert after["mha"] - before["mha"] == cfg.num_layers * eng.prefills
    assert out["cuda"] == out["cpu"]
