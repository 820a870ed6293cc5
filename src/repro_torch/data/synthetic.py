"""Deterministic synthetic LM data pipeline: the port's own copy of
``repro.data.synthetic`` (numpy only; the port imports nothing of the JAX
package), whose batches it reproduces bit for bit.

Per-host sharded, stateful (a checkpointable cursor), packed fixed-length
sequences. Each batch comes from a numpy generator seeded by (seed, step,
host), so any (host, step) batch is reproducible after a restart: no data
files, the contract of a sharded tokenized corpus reader.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 1234
    # structured synthetic task: next-token = (token * a + c) % vocab, so a
    # real model can learn it (the loss goes down)
    learnable: bool = True


class SyntheticDataset:
    """Stateful, checkpointable synthetic token stream."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {cfg.num_hosts} hosts")
        self.cfg = cfg
        self.step = 0

    # -- checkpointable state ------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step}

    def load_state_dict(self, s: Dict[str, Any]) -> None:
        self.step = int(s["step"])

    # -- batches ---------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 131 + self.cfg.host_id)

    def next_batch(self) -> Dict[str, np.ndarray]:
        """{"tokens", "labels"}: (batch / hosts, seq_len) int32, labels the
        tokens shifted by one."""
        cfg = self.cfg
        b = cfg.global_batch // cfg.num_hosts
        rng = self._rng(self.step)
        if cfg.learnable:
            # affine-mod sequences x_{t+1} = (a x_t + c) % V with a per-row
            # (a, c): learnable by a small LM, and it needs the context
            a = rng.integers(2, 8, size=(b, 1))
            c = rng.integers(1, 64, size=(b, 1))
            x0 = rng.integers(0, cfg.vocab, size=(b, 1))
            toks = np.empty((b, cfg.seq_len + 1), np.int64)
            toks[:, :1] = x0
            for t in range(cfg.seq_len):
                toks[:, t + 1] = (toks[:, t] * a[:, 0] + c[:, 0]) % cfg.vocab
        else:
            toks = rng.integers(0, cfg.vocab, size=(b, cfg.seq_len + 1))
        self.step += 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
