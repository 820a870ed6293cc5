"""Three-term roofline of a dry-run cell, against an H100 SXM.

  compute    = op_FLOPs         / PEAK_FLOPS
  memory     = op_bytes         / HBM_BW
  collective = collective_bytes / the link's bandwidth

per device, as ``repro.analysis.roofline`` computes it against TPU v5e
constants. FLOPs, bytes and collective bytes come from ``analysis.
op_cost`` (a fake-tensor trace of the rank's step). The reference's
``collective_bytes(hlo_text)``, which parses XLA's collectives out of HLO
text, has no counterpart: the rank's ``DryRunRules`` record every sum's
bytes as the step issues it.

The collective term's link: NVLink when every summing axis fits one
8-GPU node (the axis's size times the sizes of the axes inside it, the
ranks it strides over, at most 8), else the node's NIC. ``pod16x16``'s
16-way ``model`` axis spans two nodes, so its sums go at the NIC's rate.
``to_dict`` states the choice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 dense FLOP/s per GPU (H100 SXM data sheet)
HBM_BW = 3.35e12           # bytes/s per GPU, HBM3 (H100 SXM data sheet)
NVLINK_BW = 450e9          # bytes/s a direction per GPU, NVLink 4 (900 GB/s
                           # both ways, H100 SXM data sheet)
NIC_BW = 50e9              # bytes/s per GPU, one 400 Gb/s NDR InfiniBand
                           # NIC a GPU (DGX H100 data sheet)
NODE_GPUS = 8              # GPUs an NVLink domain holds (DGX / HGX H100)


def link_for(axis_sizes: Dict[str, int], axes) -> str:
    """"nvlink" when every axis in ``axes`` fits one node (its size times
    the sizes of the axes after it in ``axis_sizes``' order), else
    "nic"."""
    names = list(axis_sizes)
    for a in axes:
        span = math.prod(axis_sizes[n] for n in names[names.index(a):])
        if span > NODE_GPUS:
            return "nic"
    return "nvlink"


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device op FLOPs
    bytes_hbm: float           # per-device op bytes
    bytes_coll: float          # per-device collective operand bytes
    chips: int
    coll_breakdown: Dict[str, int]
    model_flops: float = 0.0   # analytic 6*N*D (global)
    link: str = "nvlink"       # the collective term's link (``link_for``)

    @property
    def coll_bw(self) -> float:
        return NVLINK_BW if self.link == "nvlink" else NIC_BW

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.bytes_coll / self.coll_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (chips * op_FLOPs): the traced compute's
        usefulness."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at the
        bound of its dominant term: t_compute_model / t_bound."""
        t_model = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_model / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.bytes_hbm,
            "collective_bytes_per_device": self.bytes_coll,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
            "coll_breakdown": self.coll_breakdown,
            "peak_flops": PEAK_FLOPS,
            "hbm_bw": HBM_BW,
            "collective_link": self.link,
            "collective_bw": self.coll_bw,
        }


def analyze(cost, *, chips: int, model_flops: float = 0.0,
            axis_sizes: Optional[Dict[str, int]] = None) -> Roofline:
    """The roofline of an ``op_cost.Cost`` of one device's step;
    ``axis_sizes``: the mesh's axes in order, which pick the link."""
    axes = [k.split(":", 1)[1] for k in cost.coll_bytes if ":" in k]
    return Roofline(
        flops=cost.flops,
        bytes_hbm=cost.bytes,
        bytes_coll=cost.total_coll,
        chips=chips,
        coll_breakdown={k: int(v) for k, v in cost.coll_bytes.items()},
        model_flops=model_flops,
        link=link_for(axis_sizes or {}, axes),
    )


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE); decode
    processes global_batch tokens (one step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: 1 new token per sample
