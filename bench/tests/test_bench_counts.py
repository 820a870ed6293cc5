"""The frozen counts against hand counts at the published widths."""
from bench.lib import counts, spec
from bench.reference.dims import dims


def test_qwen_counts():
    dm = dims(spec.config("qwen2.5-3b"))
    attn = 2048 * 2048 + 2 * 2048 * 256 + 2048 * 2048 + (2048 + 256 + 256)
    mlp = 3 * 2048 * 11008
    assert counts.attn_proj_params(dm) == attn == 9_439_744
    assert counts.ffn_active_params(dm) == mlp
    assert 36 * (attn + mlp) + 151936 * 2048 == 3_085_789_184
    assert counts.token_matmul_flops(dm) == 2 * 36 * (attn + mlp)
    assert counts.head_flops(dm) == 2 * 2048 * 151936
    assert counts.attn_flops(dm, 1000) == 4 * 36 * 16 * 128 * 1000
    assert counts.kv_bytes(dm, 1) == 36_864
    # a 512-token prefill: 512 rows of products, one head row, the
    # causal pairs 512 * 513 / 2
    assert counts.prefill_flops(dm, 512) == (
        512 * 2 * 36 * (attn + mlp) + 2 * 2048 * 151936
        + 4 * 36 * 16 * 128 * 512 * 513 // 2)
    # a decode step of two rows at 100 and 200 keys reads the weights
    # once (no embedding table; the tied head once) and both K/V
    w = (36 * (attn + mlp) + 2048 * 151936) * 2
    assert counts.decode_step_bytes(dm, [100, 200]) == w + 36_864 * 300


def test_dbrx_counts():
    dm = dims(spec.config("dbrx-132b"))
    attn = 6144 * 6144 * 2 + 2 * 6144 * 1024
    expert = 3 * 6144 * 10752
    assert counts.attn_proj_params(dm) == attn == 88_080_384
    assert counts.expert_params(dm) == expert
    assert counts.ffn_active_params(dm) == 4 * expert + 6144 * 16
    total = 8 * (attn + 16 * expert + 6144 * 16) + 2 * 100352 * 6144
    assert total == 27_305_705_472          # 27.31B held on the card
    assert counts.kv_bytes(dm, 1) == 32_768
    # one live row routes to 4 experts; 64 rows to all 16
    one = counts.decode_weight_bytes(dm, 1)
    every = counts.decode_weight_bytes(dm, 64)
    assert every - one == 8 * 12 * expert * 2
    assert every == (8 * (attn + 16 * expert) + 6144 * 100352) * 2 \
        + 8 * 6144 * 16 * 4


def test_mha_flops_counts_the_true_prompt():
    dm = dims(spec.config("qwen2.5-3b"))
    assert counts.mha_flops(dm, 1) == 4 * 36 * 16 * 128
    assert counts.mha_flops(dm, 3) == 4 * 36 * 16 * 128 * 6
