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
]


def mha_inputs(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32))
