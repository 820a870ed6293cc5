"""Npz checkpointing with an async save: the on-disk format of
``repro.checkpoint.ckpt``, with torch tensors in and out.

A copy of the reference's jax-free contract (the port imports nothing of
the JAX package):

* atomic writes (a ``.tmp`` directory renamed into place), so a save cut
  short never corrupts the previous checkpoint;
* a flat key/value layout, ``arrays.npz``, whose keys are the tree's paths
  joined by ``/`` (dict keys in sorted order, list indices as numbers, as
  ``jax.tree_util`` spells them), beside ``manifest.json`` (the keys, the
  true dtype of every array stored as raw bits, and the caller's
  ``extra``);
* bfloat16, which npz cannot hold, is stored as its uint16 bits with
  ``"bfloat16"`` in the manifest, so the reference's ``restore`` reads a
  port checkpoint back bit for bit and the other way round;
* ``AsyncCheckpointer`` saves on a background thread, one in flight; a
  failed save re-raises on the next ``save()`` or ``wait()``.

Restore returns CPU tensors (or tensors on ``device``) in the structure of
``like``; the caller moves them where they belong.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _unflatten(like, flat: Dict[str, Any], prefix: str = ""):
    def key(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: _unflatten(v, flat, key(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, flat, key(i))
                          for i, v in enumerate(like))
    return flat[prefix]


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (bf16 as its bits, viewed uint16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()
    return np.array(leaf)


def _snapshot(state) -> Dict[str, Any]:
    """{path: (numpy array, manifest dtype name or None)}."""
    out = {}
    for k, v in _flatten(state).items():
        bits = isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
        out[k] = (_to_numpy(v), "bfloat16" if bits else None)
    return out


def _write(path: str, snap: Dict[str, Any], extra) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"keys": [], "dtypes": {}, "extra": extra or {}}
    arrs = {}
    for k, (a, dtype_name) in snap.items():
        if dtype_name is not None:
            manifest["dtypes"][k] = dtype_name
        arrs[k] = a
        manifest["keys"].append(k)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrs)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save(path: str, state, *, extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomic synchronous save of a tree of tensors (or arrays)."""
    _write(path, _snapshot(state), extra)


class AsyncCheckpointer:
    """Saves on a background thread, one in flight. A failed save is never
    silent: it re-raises on the next ``save()`` or ``wait()`` and counts in
    ``failed_saves``; ``last_error`` reads it without consuming it, and
    raising clears it, so one failure surfaces exactly once."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.last_error: Optional[BaseException] = None
        self.completed_saves = 0
        self.failed_saves = 0

    def save(self, path: str, state, *, extra=None) -> None:
        # join and re-raise first, so a caller that only ever saves still
        # sees the previous failure before queueing more work
        self.wait()
        snap = _snapshot(state)          # host copies, on the caller thread

        def work():
            try:
                _write(path, snap, extra)
                with self._lock:
                    self.completed_saves += 1
            except BaseException as e:  # surfaced on next save()/wait()
                with self._lock:
                    self.last_error = e
                    self.failed_saves += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            err, self.last_error = self.last_error, None
        if err is not None:
            raise err


def restore(path: str, like, *, device=None):
    """Restore into the structure of ``like`` (a tree of tensors: their
    shapes and dtypes are the contract). Returns (tree, extra); leaves are
    CPU tensors unless ``device`` is given."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    flat_like = _flatten(like)
    missing = [k for k in flat_like if k not in data]
    if missing:
        raise KeyError(f"checkpoint at {path} missing keys: {missing[:5]}...")
    dtypes = manifest.get("dtypes", {})
    out = {}
    for k, ref in flat_like.items():
        arr = data[k]
        if k in dtypes:                  # stored as raw bits
            if dtypes[k] != "bfloat16":
                raise ValueError(f"{k}: unsupported stored dtype "
                                 f"{dtypes[k]!r}")
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: ckpt shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        t = t.to(ref.dtype)
        out[k] = t.to(device) if device is not None else t
    return _unflatten(like, out), manifest["extra"]


def latest_step_dir(root: str) -> Optional[str]:
    """The newest ``step_N`` checkpoint under ``root`` (resume on restart),
    or None."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append((int(name.split("_")[1]), name))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])
