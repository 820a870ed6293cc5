"""Training launcher of the port: ``--arch`` selects any config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --steps 30 [--ckpt-dir DIR] [--grad-accum 2] \\
      [--compress-grads] [--device cpu]

The flags are the reference launcher's (``repro.launch.train``), plus
``--device``: CUDA by default, which raises without a card (nothing falls
back to the CPU); ``--device cpu`` runs the same loop on the CPU.
``--smoke`` takes the reduced same-family config; without it the full one
(its memory is the card's to hold). A second call with the same
``--ckpt-dir`` resumes from the newest checkpoint there. Model-parallel
training (``--model-parallel`` > 1) is not ported and raises.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1: model-parallel training is not ported "
            "(ROADMAP Queue 1 item 3b)")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[launch.train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"on {device}")
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                     global_batch=args.batch))
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=max(5, args.steps // 10),
                            total_steps=args.steps,
                            moment_dtype=cfg.moment_dtype)
    tr = Trainer(cfg, opt, ds, ckpt_dir=args.ckpt_dir,
                 save_every=args.save_every, grad_accum=args.grad_accum,
                 compress_grads=args.compress_grads, log_every=10,
                 device=device)
    tr.run(args.steps)
    print(f"[launch.train] done at step {tr.step}; "
          f"{tr.monitor.slow_steps} straggler-flagged steps")


if __name__ == "__main__":
    main()
