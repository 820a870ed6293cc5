"""Training launcher of the port: ``--arch`` selects any config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --steps 30 [--ckpt-dir DIR] [--grad-accum 2] \\
      [--compress-grads] [--model-parallel M] [--data-parallel D] \\
      [--device cpu]

The flags are the reference launcher's (``repro.launch.train``), plus
``--device``: CUDA by default, which raises without a card (nothing falls
back to the CPU); ``--device cpu`` runs the same loop on the CPU.
``--smoke`` takes the reduced same-family config; without it the full one
(its memory is the card's to hold). A second call with the same
``--ckpt-dir`` resumes from the newest checkpoint there.

``--model-parallel M`` > 1 spawns M ranks (``launch.mesh.run_world``), a
``model`` axis of M (``Trainer(mesh=)``): NCCL over the first M CUDA
devices, one a rank (fewer than M raises, naming the count), or gloo with
``--device cpu``. Rank 0 prints; a checkpoint holds the full leaves, so a
resume may take another M (and D).

``--data-parallel D`` > 1 multiplies the world by D: D replicas of each
shard (``data`` x ``model`` = D x M ranks, NCCL one CUDA device a rank or
gloo on the CPU), each stepping on its ``--batch`` / D rows and averaging
the gradients over the ``data`` axis.

``--model-parallel M --data-parallel D`` trains at the reference's layout
(``tp.train_plan``: its ``Rules(mesh)`` over the whole table, as the
reference trains under ``Rules(mesh)``; there is no flag for it): every
``wembed`` dim split over the D replicas (FSDP, gathered at its use), the
heads, ffn, vocab and expert dims over the M ranks of a shard.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.launch.mesh import make_host_mesh, run_world
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    m, d = args.model_parallel, args.data_parallel
    if m < 1 or d < 1:
        raise SystemExit(f"--model-parallel {m} --data-parallel {d}: each "
                         f"needs 1 or more ranks")
    n = m * d
    if n == 1:
        _train(args, device, 0)
        return
    if args.batch % d:
        raise SystemExit(f"--batch {args.batch} does not split over "
                         f"--data-parallel {d}")
    what = (f"--model-parallel {m}" if d == 1 else
            f"--model-parallel {m} --data-parallel {d}")
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"{what} needs {n} CUDA devices, one a rank; have "
                         f"{torch.cuda.device_count()}")
    backend = "gloo" if device.type == "cpu" else "nccl"
    with tempfile.TemporaryDirectory() as tmp:
        run_world(_train_rank, n, backend=backend,
                  init_file=os.path.join(tmp, "rendezvous"), args=(args,),
                  timeout=24 * 3600.0)


def _train_rank(rank: int, args) -> None:
    """One rank of a ``--model-parallel`` / ``--data-parallel`` world."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    _train(args, device, rank)


def _quiet(*_args, **_kwargs) -> None:
    pass


def _train(args, device: torch.device, rank: int) -> None:
    """Build the config, data and trainer (this rank's part on a mesh),
    run it and print the summary (rank 0 only)."""
    say = print if rank == 0 else _quiet
    m, d = args.model_parallel, args.data_parallel
    mesh = None
    if m * d > 1:
        devs = ["cpu"] * (m * d) if device.type == "cpu" \
            else [torch.device("cuda", i) for i in range(m * d)]
        mesh = make_host_mesh(m, devices=devs)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    say(f"[launch.train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
        f"on {device}" + (f", model-parallel over {m} ranks" if m > 1
                          else "")
        + (f", data-parallel over {d} replicas" if d > 1 else ""))
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                     global_batch=args.batch))
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=max(5, args.steps // 10),
                            total_steps=args.steps,
                            moment_dtype=cfg.moment_dtype)
    tr = Trainer(cfg, opt, ds, ckpt_dir=args.ckpt_dir,
                 save_every=args.save_every, grad_accum=args.grad_accum,
                 compress_grads=args.compress_grads, log_every=10,
                 log_fn=say, device=device, mesh=mesh)
    tr.run(args.steps)
    say(f"[launch.train] done at step {tr.step}; "
        f"{tr.monitor.slow_steps} straggler-flagged steps")


if __name__ == "__main__":
    main()
