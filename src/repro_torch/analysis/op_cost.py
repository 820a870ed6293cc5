"""Cost accounting over the aten ops of a fake-tensor trace.

Counterpart of ``repro.analysis.hlo_cost``, which walks XLA's optimised HLO;
the port reads no HLO. ``CostMode`` is a ``TorchDispatchMode`` that sees
every aten op a step runs (under ``FakeTensorMode``: shapes only, nothing
allocated, nothing launched) and fills the reference's ``Cost`` fields:

* dot FLOPs: ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
  baddbmm, convolution, SDPA and their backward ops), into ``flops`` and
  ``dot_flops``;
* elementwise FLOPs: one per output element of the aten counterparts of
  the reference's ``_ELTWISE_FLOP_OPS``; transcendentals likewise for
  ``_TRANSCEND_OPS`` (also into ``transcendentals``). Reductions count
  none, as XLA's ``reduce`` counts none there;
* bytes: inputs + outputs of every op, except ops that return a view or
  only metadata (the counterpart of ``_FREE_OPS``), and allocations that
  write nothing (``empty``). Gather and index ops count 2 x their output
  (``_SLICING``); an in-place write of a slice (``copy_``, ``index_put_``,
  the scatters) 2 x the update (the dynamic-update-slice rule). The port
  runs eagerly and fuses nothing, so every intermediate goes through
  memory: its bytes are its own, not XLA's fused bytes;
* collective bytes: operand bytes of every collective the rank's
  ``sharding.DryRunRules`` recorded, keyed ``<kind>:<mesh axis>`` (kind
  ``all-reduce``, ``all-gather`` or ``reduce-scatter``), as the
  reference's ``collective_bytes`` sums operand bytes by kind.

The port unrolls its layers in Python, so there is no trip count to
multiply: a trace runs every layer (``launch/dryrun.py`` extrapolates a
deep train step from two shallow traces instead).

Kernel seams (``seams``): on CPU-device fakes every seam of
``kernels.ops`` takes its plain version. With ``seams="plain"`` the trace
counts that version's aten ops, what the JAX dry-run compiled on a CPU
host counts (XLA's attention, no Pallas kernel). With ``seams="kernel"``
(the dry-run's default: what the card runs) each seam call counts as its
CUDA kernel, the way the reference's HLO counts a ``pallas_call`` as one
op: the kernel's own FLOPs (``KERNEL_COSTS``), the bytes of its inputs
and outputs, and its output and workspace allocations; the plain
version's internals (mha's (B, H, Sq, Sk) fp32 scores) are neither
counted nor held.

``CostMode`` also follows the storages the trace allocates (each freed
when its last tensor dies), for the memory of ``trace``: arguments,
outputs, their aliasing, and the peak of live intermediate bytes.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

_ELTWISE_FLOP_OPS = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "clamp", "clamp_min", "clamp_max",
    "floor", "ceil", "round", "sign", "bitwise_left_shift",
    "bitwise_right_shift", "remainder", "fmod", "reciprocal", "square",
    "addcmul", "addcdiv", "lerp",
}
_TRANSCEND_OPS = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sigmoid",
                  "sin", "cos", "atan2", "erf", "expm1", "log1p", "silu",
                  "gelu", "softplus", "_softmax", "_log_softmax",
                  "logsumexp"}
# allocations that write nothing, and reshapes of a fresh tensor
_FREE_OPS = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_unsafe_view", "lift_fresh_copy"}
_SLICING = {"index", "gather", "index_select", "embedding", "take"}
# in-place writes of a slice: 2 x the update (read-modify-write)
_UPDATE_ARG = {"copy_": 1, "index_put_": 2, "index_put": 2,
               "slice_scatter": 1, "select_scatter": 1, "index_copy_": 3,
               "index_copy": 3, "scatter_": 3, "scatter": 3}


def _name(func) -> str:
    """An op's name without its overload, in-place ops as their
    out-of-place name (``add_`` -> ``add``) unless listed by name."""
    n = func._overloadpacket.__name__
    return n if n in _UPDATE_ARG or not n.endswith("_") else n[:-1]


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    dot_flops: float = 0.0
    transcendentals: float = 0.0
    # diagnostics: bytes per op and the largest single contributors
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    top: List[Tuple[float, str, str]] = dataclasses.field(
        default_factory=list)

    @property
    def total_coll(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def _note(self, op: str, b: float, detail: str = "") -> None:
        self.by_op[op] = self.by_op.get(op, 0.0) + b
        if b > 1e8:
            self.top.append((b, op, detail[:120]))
            if len(self.top) > 400:
                self.top.sort(reverse=True)
                del self.top[200:]

    def top_entries(self, n: int = 15):
        return sorted(self.top, reverse=True)[:n]

    def extrapolate(self, deeper: "Cost", k: float) -> "Cost":
        """``self + k * (deeper - self)`` field by field: the cost of a
        stack ``k`` periods deeper than ``self``'s, from ``deeper``'s one
        period more (``top`` is kept from ``deeper``)."""
        def lin(a, b):
            return a + k * (b - a)

        def dicts(a, b):
            return {key: lin(a.get(key, 0.0), b.get(key, 0.0))
                    for key in sorted(set(a) | set(b))}

        return Cost(lin(self.flops, deeper.flops),
                    lin(self.bytes, deeper.bytes),
                    dicts(self.coll_bytes, deeper.coll_bytes),
                    lin(self.dot_flops, deeper.dot_flops),
                    lin(self.transcendentals, deeper.transcendentals),
                    dicts(self.by_op, deeper.by_op), list(deeper.top))


def _visible_keys(Sq: int, Sk: int, causal: bool, valid: int,
                  q_offset: int, window: int) -> int:
    """Keys attended, summed over the ``Sq`` query rows of one (batch,
    head): row i at position q_offset + i sees keys below ``valid``, and
    causally those <= q_offset + i, within ``window`` of it when > 0."""
    if not causal:
        return Sq * min(valid, Sk)
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(pos + 1, min(valid, Sk))
    lo = np.maximum(pos - window + 1, 0) if window else 0
    return int(np.maximum(hi - lo, 0).sum())


def mha_cost(q, k, v, *, causal=True, kv_valid=None, q_offset=0,
             window=0) -> Tuple[float, float, float, int]:
    """(dot FLOPs, transcendentals, bytes, workspace bytes) of the flash-MHA
    kernel (``kernels.attention.mha``): QK^T and PV over the pairs it
    attends (2 · 2 · D FLOPs a pair and head), one exp a pair and head,
    q, the keys and values it reads and the output, and its (B,) int32
    lengths when ``kv_valid`` is given. A ``kv_valid`` tensor's values are
    data, unknown to a trace: every key of the lane counts, as at a full
    context (the cell's length)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    valid = kv_valid if isinstance(kv_valid, int) else Sk
    pairs = B * _visible_keys(Sq, Sk, causal, valid, q_offset, window)
    read = min(valid, Sk)
    if causal:      # the keys of the rows' band, from the first row's
        read = max(0, min(read, q_offset + Sq)
                   - (max(0, q_offset - window + 1) if window else 0))
    kv = 2 * B * read * k.shape[2] * D * k.element_size()
    nbytes = 2 * _nbytes(q) + kv
    ws = 0 if kv_valid is None else 4 * B
    return 4.0 * D * H * pairs, float(H * pairs), float(nbytes + ws), ws


# the kernels a seam counts as its own (``seams="kernel"``): name ->
# cost of a call, from the call's arguments
KERNEL_COSTS = {"mha": mha_cost}


class CostMode(TorchDispatchMode):
    """Counts each aten op into ``cost`` (see the module doc) and follows
    the storages the ops allocate: ``live_bytes`` now, ``peak_bytes`` the
    most at once. Storages of ``known`` tensors (the arguments) are not
    counted. ``ops``: the aten ops seen, a kernel call as one.
    ``seams``: "plain" or "kernel", as the module doc says; under
    "kernel", ``seam`` is the hook ``trace`` gives ``kernels.ops``."""

    def __init__(self, known=(), seams: str = "plain"):
        super().__init__()
        if seams not in ("plain", "kernel"):
            raise ValueError(f"seams {seams!r}: 'plain' or 'kernel'")
        self.seams = seams
        self.cost = Cost()
        self.ops = 0
        self._known = {t.untyped_storage()._cdata for t in known}
        self._live: Dict[int, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._inside = 0        # > 0 inside a kernel's plain version

    def seam(self, name: str, plain, args, kwargs):
        """A kernel seam's call: ``plain(*args, **kwargs)`` run uncounted
        and untracked, then counted as kernel ``name``
        (``KERNEL_COSTS``); its output allocated, its workspace live for
        the call."""
        if name not in KERNEL_COSTS:
            raise NotImplementedError(
                f"the dry-run has no cost for the {name} kernel: no step "
                f"it traces reached it before")
        self._inside += 1
        try:
            out = plain(*args, **kwargs)
        finally:
            self._inside -= 1
        dot, trans, nbytes, ws = KERNEL_COSTS[name](*args, **kwargs)
        c = self.cost
        c.flops += dot + trans
        c.dot_flops += dot
        c.transcendentals += trans
        c.bytes += nbytes
        c._note(f"kernel:{name}", nbytes, name)
        self.ops += 1
        for t in _tensors(out):
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes + ws)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        self.ops += 1
        outs = _tensors(out)
        if outs:
            self._count(func, args, kwargs, out, outs)
            for t in outs:
                self._track(t)
        return out

    # -- costs ---------------------------------------------------------
    def _count(self, func, args, kwargs, out, outs) -> None:
        from torch.utils.flop_counter import flop_registry
        c = self.cost
        name = _name(func)
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops += f
            c.dot_flops += f
        elif name in _ELTWISE_FLOP_OPS:
            c.flops += sum(t.numel() for t in outs)
        elif name in _TRANSCEND_OPS:
            n = sum(t.numel() for t in outs)
            c.flops += n
            c.transcendentals += n
        if func.is_view or name in _FREE_OPS:
            return
        if name in _SLICING:
            b = 2.0 * sum(_nbytes(t) for t in outs)
        elif name in _UPDATE_ARG:
            i = _UPDATE_ARG[name]
            flat = list(args) + list(kwargs.values())
            upd = flat[i] if i < len(flat) else None
            b = 2.0 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                       else _nbytes(outs[0]))
        else:
            b = float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                      + sum(_nbytes(t) for t in outs))
        c.bytes += b
        c._note(name, b, str(func))

    # -- memory --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [st.nbytes(), set()]
            self.live_bytes += ent[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if id(t) not in ent[1]:
            ent[1].add(id(t))
            weakref.finalize(t, self._free, key, id(t))

    def _free(self, key: int, tid: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1].discard(tid)
        if not ent[1]:
            self.live_bytes -= ent[0]
            del self._live[key]


def _storage_bytes(tensors) -> Dict[int, int]:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}


@dataclasses.dataclass
class Trace:
    """What ``trace`` found: the ``cost``, the ``memory`` dict (the
    reference's keys), the aten ops traced and the model-axis sums."""
    cost: Cost
    memory: Dict[str, float]
    ops: int
    reduces: int


def trace(fn: Callable, args: tuple, rules=None, *,
          seams: str = "kernel") -> Trace:
    """Run ``fn(*args)`` under a ``CostMode`` (inside the caller's
    ``FakeTensorMode``) and account it. ``rules``: the rank's
    ``DryRunRules``, whose collectives during the call become
    ``coll_bytes``.
    ``seams``: how a kernel seam counts (the module doc).

    Memory, per device: ``argument_bytes`` the storages of ``args``;
    ``output_bytes`` those of the outputs, ``alias_bytes`` the part of
    them that are arguments (state or cache updated in place); ``temp_bytes``
    the peak of storage the call allocated, less the outputs it allocated
    (so ``total_bytes_per_device`` = arguments + that peak)."""
    from repro_torch.kernels import ops
    arg_t = _tensors(args)
    mode = CostMode(arg_t, seams)
    if rules is not None:
        rules.sums.clear()
        rules.moves.clear()
        r0 = rules.reduces
    if seams == "kernel":
        ops.seam_hook = mode.seam
    try:
        with mode:
            out = fn(*args)
    finally:
        ops.seam_hook = None
    cost = mode.cost
    if rules is not None:
        for kind, axis, b in [("all-reduce", *s) for s in rules.sums] \
                + rules.moves:
            key = f"{kind}:{axis}"
            cost.coll_bytes[key] = cost.coll_bytes.get(key, 0.0) + b
    arg_b = _storage_bytes(arg_t)
    out_b = _storage_bytes(_tensors(out))
    alias = sum(b for k, b in out_b.items() if k in arg_b)
    out_bytes = sum(out_b.values())
    temp = max(0, mode.peak_bytes - (out_bytes - alias))
    arg_bytes = sum(arg_b.values())
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": temp, "alias_bytes": alias,
              "total_bytes_per_device": arg_bytes + temp + out_bytes - alias}
    return Trace(cost, memory, mode.ops,
                 0 if rules is None else rules.reduces - r0)


def fake_mode():
    """The dry-run's ``FakeTensorMode``: tensors made inside are fakes on
    the device they name (the dry-run names the CPU, so every kernel seam
    takes its plain version); real tensors may not enter."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=False)

