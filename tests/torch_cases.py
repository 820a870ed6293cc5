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
    (1, 200, 200, 8, 1, 128),   # D 128, G 8; 200 rows: no multiple of a tile
    (2, 150, 70, 4, 2, 16),     # Sq > Sk at D 16: rows past the last key
]


# Inputs whose scores peak on one key (repro_torch.kernels.ref.
# peaked_mha_inputs), where a mask off by one key misses the bf16 row
# tolerance on every row: (kind, B, S, H, KV, D, kv_valid). "causal": each
# row peaks on its diagonal key, the causal mask is shifted. "kv_valid":
# every row of batch b peaks on key kv_valid[b] - 1, kv_valid is shifted.
MASK_PROBES = [
    ("causal", 1, 256, 8, 2, 64, None),
    ("causal", 1, 200, 8, 1, 128, None),
    ("causal", 2, 150, 4, 2, 16, None),
    ("kv_valid", 2, 200, 8, 2, 64, [200, 77]),
    ("kv_valid", 2, 150, 8, 1, 128, [150, 1]),
]

# A stem-like bf16 conv whose last tap (kh, kw) = (6, 6) is dropped: the
# sum-order limit must reject it. (H, W, C, K, R, stride), batch 2.
STEM_SPEC = (16, 16, 3, 8, 7, 2)


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
# gemm_os on the tensor cores (bf16, int8), on the card only: a shape for
# each loader variant (x through 16-byte copies where K is a whole number
# of 16-byte chunks, 8 bf16 or 16 int8, w where N is; else scalar loads)
# under each tile the launcher picks on an H100 (32 x 32 for the small
# grids, 64 x 64 for 1000 x 1000 and up), M = 1, and the BERT-Base FFN.
TC_GEMM_SHAPES = [
    (100, 256, 192),    # vector x, vector w
    (100, 250, 192),    # scalar x, vector w
    (100, 256, 190),    # vector x, scalar w
    (100, 250, 190),    # scalar x, scalar w
    (100, 248, 200),    # bf16 vector / vector; int8 scalar / scalar
    (1, 768, 3072),     # M = 1
    (1000, 256, 1024),  # 64 x 64: vector x, vector w
    (1000, 250, 1024),  # scalar x, vector w
    (1000, 256, 1002),  # vector x, scalar w
    (1000, 250, 1002),  # scalar x, scalar w
    (512, 768, 3072),   # the FFN's first product
    (512, 3072, 768),   # its second
]
QUANT_SCALES = [1.0, 0.01, 0.0005]
# The quant epilogue's edge cases at a depth that takes the 16-byte copies
# (K, N multiples of 16): with scale 0.5 every odd accumulator lands on .5
# (a tie, rounded to even), and rows of x at +-127 push acc * scale far
# beyond +-127 (clipped). (M, K, N), scale.
EPILOGUE_EDGES = ((64, 64, 48), 0.5)
CONV_SPECS = [
    # (H, W, C, K, R, stride), batch 2
    (12, 12, 16, 24, 3, 1),
    (12, 12, 16, 24, 3, 2),
    (8, 8, 8, 32, 1, 1),
    (14, 14, 16, 8, 7, 2),
    (9, 9, 16, 8, 3, 2),        # odd spatial
    (16, 16, 3, 8, 7, 2),       # stem-like: C = 3, 7x7/2, depth 147
    (10, 10, 12, 16, 3, 1),     # C = 12, not a multiple of 8
    (11, 13, 32, 40, 3, 1),     # M = 286 and K = 40: no multiple of a tile
]
POOL_SPECS = [
    # (H, W, C, window, stride), batch 2
    (8, 8, 16, 2, 2),
    (9, 9, 8, 3, 2),
    (12, 12, 32, 3, 3),
    (10, 10, 8, 5, 1),          # arbitrary window, stride 1
]
BLOCKED_CASES = [
    # (H, W, C, cb); the CUDA kernel moves 16-byte vectors (4 fp32 or 8
    # bf16 channels) where cb and C are whole vectors, else elements
    (5, 6, 256, 8), (5, 6, 256, 32), (5, 6, 256, 128),
    (4, 4, 100, 128),           # C padded up to cb (fp32 vectors, bf16 not)
    (5, 6, 6, 8),               # odd C: padded, elements
    (5, 6, 30, 3),              # cb not a multiple of 4
    (5, 6, 36, 6),              # cb 6: elements, no padding
    (4, 4, 104, 64),            # vectors in both dtypes, padded
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


def epilogue_inputs(seed, M, K, N):
    """int8 (x, w) for EPILOGUE_EDGES: w and the first half of x's rows in
    [-3, 3] (small sums, many odd), the other rows of x at +-127."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (M, K)).astype(np.int8)
    x[M // 2:] = rng.choice(np.array([-127, 127], np.int8), (M - M // 2, K))
    return x, rng.integers(-3, 4, (K, N)).astype(np.int8)


def int8_extremes(seed, M, K, N):
    """int8 (x, w) at +-127 with random signs, the first row of x and the
    first column of w all +127: sums up to K * 127^2, exact in int32."""
    rng = np.random.default_rng(seed)
    sign = np.array([-127, 127], np.int8)
    x, w = rng.choice(sign, (M, K)), rng.choice(sign, (K, N))
    x[0], w[:, 0] = 127, 127
    return x, w


def pool_input(seed, H, W, C, *, nan=False):
    """(2, H, W, C); nan=True puts a NaN in a window of each image."""
    x = normal(seed, 2, H, W, C)
    if nan:
        x[0, H // 2, W // 2, 1] = np.nan
        x[1, 0, 0, 0] = np.nan
    return x


def dying_traffic(slots, vocab):
    """(prompt, max_new) of slots + 4 requests of 3-11 tokens with budgets
    of 2-11 tokens: decode slots die at different steps while others
    decode, and the queue refills them (the MoE engine tests' traffic, on
    the CPU against the JAX engine and on the card)."""
    rng = np.random.default_rng(7)
    n = slots + 4
    lens, budgets = rng.integers(3, 12, n), rng.integers(2, 12, n)
    return [([int(t) for t in rng.integers(1, vocab, L)], int(b))
            for L, b in zip(lens, budgets)]


OP_NAMES = ("attention", "paged_attention", "matmul", "quant_matmul",
            "conv2d", "maxpool2d", "blocked_layout", "transpose",
            "sampler_noise")


def op_calls_on(device):
    """Each entry of ``repro_torch.kernels.ops`` (``OP_NAMES``) as a call
    on small zeros made on ``device`` when it runs (inside a
    ``FakeTensorMode``: fakes on that device)."""
    import torch
    from repro_torch.kernels import ops

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i8, i32, i64 = torch.int8, torch.int32, torch.int64
    return {
        "attention": lambda: ops.attention(z(1, 4, 2, 16), z(1, 4, 2, 16),
                                           z(1, 4, 2, 16)),
        "paged_attention": lambda: ops.paged_attention(
            z(1, 4, 2, 16), z(2, 4, 2, 16), z(2, 4, 2, 16),
            z(1, 1, dtype=i32), [4]),
        "matmul": lambda: ops.matmul(z(8, 16), z(16, 8)),
        "quant_matmul": lambda: ops.quant_matmul(z(8, 16, dtype=i8),
                                                 z(16, 8, dtype=i8), 0.1),
        "conv2d": lambda: ops.conv2d(z(1, 2, 4, 16), z(3, 3, 16, 8)),
        "maxpool2d": lambda: ops.maxpool2d(z(1, 2, 4, 16)),
        "blocked_layout": lambda: ops.blocked_layout(z(2, 4, 16)),
        "transpose": lambda: ops.transpose(z(8, 16)),
        "sampler_noise": lambda: ops.sampler_noise(
            z(1, dtype=i64), z(1, dtype=i64), z(1, dtype=i64), 8, draw=0),
    }
