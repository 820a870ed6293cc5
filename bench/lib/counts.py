"""Frozen counts of the work these inputs need, from the configuration's
sizes alone (``Dims``), and the H100's peaks.

Operations are multiply-adds times two. A token at position p attends
p + 1 keys. Counted: true prompt tokens, not bucket padding; an MoE
layer's routed experts (top_k of them a token) and its router, not
capacity rows; the vocabulary head once for each token that is emitted
(a prefill's last position, every decode row). Bytes are bf16 (2 a
value): a decode step reads every weight once (an MoE layer's experts
that its live rows can route to, at most all of them; the embedding table
only at the rows looked up, so nought), and each live row's K and V at
its p + 1 positions."""
from __future__ import annotations

from bench.reference.dims import Dims

PEAK_BF16_FLOPS = 989e12        # H100 SXM, dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12        # H100 SXM HBM3
BYTES = 2                       # bf16


def attn_proj_params(dm: Dims) -> int:
    hd = dm.head_dim
    n = dm.d * dm.heads * hd + 2 * dm.d * dm.kv_heads * hd \
        + dm.heads * hd * dm.d
    if dm.qkv_bias:
        n += (dm.heads + 2 * dm.kv_heads) * hd
    return n


def expert_params(dm: Dims) -> int:
    return 3 * dm.d * dm.ffn


def ffn_active_params(dm: Dims) -> int:
    if dm.moe:
        return dm.top_k * expert_params(dm) + dm.d * dm.experts
    return 3 * dm.d * dm.ffn


def token_matmul_flops(dm: Dims) -> int:
    """Every product of one token's pass but attention and the head."""
    return 2 * dm.layers * (attn_proj_params(dm) + ffn_active_params(dm))


def head_flops(dm: Dims) -> int:
    return 2 * dm.d * dm.vocab


def attn_flops(dm: Dims, keys: int) -> int:
    """QK^T and PV of one query row over ``keys`` keys, every layer."""
    return 4 * dm.layers * dm.heads * dm.head_dim * keys


def prefill_flops(dm: Dims, L: int) -> int:
    return (L * token_matmul_flops(dm) + head_flops(dm)
            + mha_flops(dm, L))


def mha_flops(dm: Dims, L: int) -> int:
    """The causal prefill attention of L true tokens, every layer."""
    return 4 * dm.layers * dm.heads * dm.head_dim * L * (L + 1) // 2


def decode_row_flops(dm: Dims, keys: int) -> int:
    return token_matmul_flops(dm) + head_flops(dm) + attn_flops(dm, keys)


def kv_bytes(dm: Dims, keys: int) -> int:
    """K and V of ``keys`` positions, every layer."""
    return 2 * dm.layers * dm.kv_heads * dm.head_dim * keys * BYTES


def paged_bytes(dm: Dims, keys: int) -> int:
    """What the paged-decode kernel must move for one row, every layer:
    its K/V, its query read and its output written."""
    return kv_bytes(dm, keys) + 2 * dm.layers * dm.heads * dm.head_dim \
        * BYTES


def decode_weight_bytes(dm: Dims, live_rows: int) -> int:
    per_layer = attn_proj_params(dm)
    if dm.moe:
        per_layer += min(dm.experts, live_rows * dm.top_k) \
            * expert_params(dm) + dm.d * dm.experts * 2   # fp32 router
    else:
        per_layer += 3 * dm.d * dm.ffn
    return (dm.layers * per_layer + dm.d * dm.vocab) * BYTES


def decode_step_bytes(dm: Dims, keys_per_row) -> int:
    """The least a decode step must move: weights once, each live row's
    K/V once."""
    keys_per_row = list(keys_per_row)
    return decode_weight_bytes(dm, len(keys_per_row)) \
        + sum(kv_bytes(dm, k) for k in keys_per_row)
