"""Device time of the decode step's sampler on the card, beside a bare
argmax and the reference's literal form.

  PYTHONPATH=src python -m repro_torch.launch.sampler_probe

At a serving step's logits (8 rows of qwen2.5-3b's 151936-token vocabulary,
fp32), each variant is captured in a CUDA graph and the graph replayed 50
times between CUDA events (ms per replay, median of 5 such runs):

* ``argmax``: ``torch.argmax`` of the logits, what a greedy-only step
  would need;
* ``sample_rows``: ``runtime/sampling.sample_rows`` as the decode step runs
  it (one sort; the noise kernel folding each row's key itself);
* ``two sorts, plain noise``: the reference's literal form: ``scale_mask``
  sorting a second time after the top-k cut, and the key fold and the
  Gumbel noise as plain int64 tensor ops (``kernels/ref.py``).

Each under an all-greedy batch (what greedy serving pays) and a mixed one
(greedy rows, temperature, top-k and top-p). Prints the card's name and
power limit first. CUDA only.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

from repro_torch.kernels import ref
from repro_torch.runtime import sampling

V, B = 151936, 8


def _two_sort_sample(logits, pol):
    """The reference's ``scale_mask`` (a second sort after the top-k cut)
    and its noise through plain tensor ops."""
    z = logits.float() / torch.where(pol.temp > 0, pol.temp,
                                     torch.ones_like(pol.temp))[:, None]
    srt = torch.sort(z, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, (pol.top_k.long() - 1).clamp(0, V - 1)[:, None])
    neg = torch.full_like(z, sampling.NEG_FILTER)
    z = torch.where((z >= kth) | (pol.top_k <= 0)[:, None], z, neg)
    srt = torch.sort(z, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < pol.top_p[:, None]
    pth = torch.gather(srt, -1, (keep.sum(-1).clamp(min=1) - 1)[:, None])
    z = torch.where((z >= pth) | (pol.top_p >= 1.0)[:, None], z, neg)
    g = ref.sampler_noise_ref(pol.seed, pol.rid, pol.idx, V,
                              draw=sampling.SAMPLE_DRAW)
    return torch.argmax(z + (pol.temp > 0).float()[:, None] * g, dim=-1)


def _graph_ms(body, reps: int = 50, runs: int = 5) -> float:
    out = torch.zeros(B, dtype=torch.int64, device="cuda")

    def step():
        out.copy_(body())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    times = []
    for _ in range(runs):
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sampler_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi unavailable")
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = 3 * torch.randn((B, V), generator=gen, device="cuda")
    mixed = [None, sampling.SamplingParams(0.9, 0, 0.95),
             sampling.SamplingParams(1.0, 50, 1.0),
             sampling.SamplingParams(0.7, 20, 0.9)] * (B // 4)
    for name, pols in (("all greedy", [None] * B), ("mixed", mixed)):
        pol = sampling.policy_operands(pols, list(range(B)), [3] * B, 0,
                                       "cuda")
        for label, fn in (
                ("argmax", lambda: torch.argmax(logits, dim=-1)),
                ("sample_rows", lambda: sampling.sample_rows(logits, pol)),
                ("two sorts, plain noise",
                 lambda: _two_sort_sample(logits, pol))):
            print(f"sampler_probe [{name}, {B} x {V}] {label}: "
                  f"{_graph_ms(fn):.4f} ms a graph replay")


if __name__ == "__main__":
    main()
