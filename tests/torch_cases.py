"""Shared inputs of the port's kernel tests (tests/test_torch_kernels.py on
the CPU against the JAX package, tests/test_torch_gpu.py on the card):
numpy arrays made from a seed, so both packages and both devices see the
same numbers. Imports neither jax nor the JAX package.

Tolerances: fp32 atol = rtol = 2e-5 — the same fp32 arithmetic, only the
order of the sums differs (per-page online softmax vs one dense softmax);
bf16 2e-2 between the two packages — bf16 inputs and outputs round at 2^-8
relative. On the card a bf16 kernel is held to its plain version per query
row instead (``repro_torch.kernels.ref.ROW_TOL``).
"""
import numpy as np

F32 = dict(atol=2e-5, rtol=2e-5)   # fp32: summation order only
BF16 = dict(atol=2e-2, rtol=2e-2)  # bf16 rounding of inputs and outputs


def paged_case(seed, B, T, H, KV, D, page, n_blocks, lengths, *,
               poison=False):
    """numpy (q, k_pool, v_pool, block_table, lengths): request b's first
    lengths[b] tokens on pages picked by a shuffled table, scratch page 0
    and unowned entries elsewhere. poison=True fills the scratch page and
    every row past each length with 1e4."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_blocks
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    phys = rng.permutation(np.arange(1, P, dtype=np.int32))
    table = np.zeros((B, n_blocks), np.int32)
    nxt = 0
    for b in range(B):
        for j in range(-(-lengths[b] // page)):
            table[b, j] = phys[nxt]
            nxt += 1
    if poison:
        for x in (kp, vp):
            x[0] = 1e4
            for b, n in enumerate(lengths):
                if n % page:
                    x[table[b, n // page], n % page:] = 1e4
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def int8(x, scale):
    return np.clip(np.round(x * 127 / scale), -127, 127).astype(np.int8)


PAGED_CASES = {
    # name: (B, T, H, KV, D, page, n_blocks, lengths, kwargs)
    "page8": (3, 1, 8, 2, 32, 8, 16, [5, 97, 128], {}),
    "page16": (3, 1, 8, 2, 32, 16, 8, [5, 97, 128], {}),
    "page64": (3, 1, 8, 2, 32, 64, 2, [5, 97, 128], {}),
    "ragged_poisoned": (4, 1, 4, 4, 16, 8, 4, [1, 7, 9, 32],
                        {"poison": True}),
    "int8": (2, 1, 8, 2, 32, 16, 2, [13, 32], {"kv_scale": 8.0}),
    "window": (3, 1, 8, 2, 32, 8, 4, [2, 9, 26], {"window": 7}),
    "T3_window_int8": (2, 3, 6, 3, 16, 8, 4, [4, 30],
                       {"window": 5, "kv_scale": 8.0}),
    "T5": (3, 5, 8, 2, 32, 16, 8, [6, 24, 37], {"poison": True}),
}


def paged_inputs(name):
    B, T, H, KV, D, page, nb, lengths, kw = PAGED_CASES[name]
    kw = dict(kw)
    poison = kw.pop("poison", False)
    q, kp, vp, table, lens = paged_case(len(name), B, T, H, KV, D, page, nb,
                                        lengths, poison=poison)
    if "kv_scale" in kw:
        kp, vp = int8(kp, kw["kv_scale"]), int8(vp, kw["kv_scale"])
    return (q, kp, vp, table, lens), kw


MHA_CASES = [
    # (B, Sq, Sk, H, KV, D), from tests/test_kernels.py
    (1, 64, 64, 4, 4, 32),
    (2, 100, 100, 8, 2, 32),
    (2, 37, 53, 6, 3, 16),
    (1, 1, 64, 8, 1, 32),
    (1, 128, 128, 8, 2, 64),    # head dim 64, as the kernel_mha bench row
]


def mha_inputs(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# The kernel layer (gemm_os, conv_im2col, maxpool, reshuffle), from
# tests/test_kernels.py. Float GEMMs and convs are held to
# repro_torch.kernels.ref.sum_order_error (two fp32 sums of the same
# products in another order: depth * 2^-24 * (|x| @ |w|) elementwise, plus
# one bf16 step of |want| for a bf16 output); everything else is exact.
# ---------------------------------------------------------------------------

GEMM_SHAPES = [(8, 8, 8), (100, 300, 200), (128, 128, 128), (1, 512, 96),
               (257, 129, 65)]
QUANT_SCALES = [1.0, 0.01, 0.0005]
CONV_SPECS = [
    # (H, W, C, K, R, stride), batch 2
    (12, 12, 16, 24, 3, 1),
    (12, 12, 16, 24, 3, 2),
    (8, 8, 8, 32, 1, 1),
    (14, 14, 16, 8, 7, 2),
    (9, 9, 16, 8, 3, 2),        # odd spatial
]
POOL_SPECS = [
    # (H, W, C, window, stride), batch 2
    (8, 8, 16, 2, 2),
    (9, 9, 8, 3, 2),
    (12, 12, 32, 3, 3),
    (10, 10, 8, 5, 1),          # arbitrary window, stride 1
]
BLOCKED_CASES = [
    # (H, W, C, cb)
    (5, 6, 256, 8), (5, 6, 256, 32), (5, 6, 256, 128),
    (4, 4, 100, 128),           # C padded up to cb
]
TRANSPOSE_SHAPES = [(128, 128), (100, 70), (257, 33), (1, 129)]


def normal(seed, *shape):
    """float32 standard normal values (bf16 cases round them on both
    sides)."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def int8s(seed, *shape):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(
        np.int8)


def gemm_inputs(seed, M, K, N, integer=False):
    make = int8s if integer else normal
    return make(seed, M, K), make(seed + 1, K, N)


def pool_input(seed, H, W, C, *, nan=False):
    """(2, H, W, C); nan=True puts a NaN in a window of each image."""
    x = normal(seed, 2, H, W, C)
    if nan:
        x[0, H // 2, W // 2, 1] = np.nan
        x[1, 0, 0, 0] = np.nan
    return x
