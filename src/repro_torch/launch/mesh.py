"""Device meshes and process worlds of the port (``torch.distributed``).

Counterpart of ``repro.launch.mesh``. The reference folds one process's
devices into a ``("data", "model")`` mesh and lets ``shard_map`` run a
body on each; the port runs one process per device (a *rank*), each with
the same host logic, and a mesh here names which rank holds which device
and which ranks form each ``model`` group:

* ``make_host_mesh(model, devices=)`` folds the listed ``torch.device``s
  into ``(data, model)`` (every visible CUDA device by default; on the CPU
  the caller lists ``["cpu"] * n``). Inside a world of ``len(devices)``
  ranks, rank r holds ``devices[r]``, each row of the fold is a ``model``
  group, and the mesh binds the calling rank's group (every rank must
  make the mesh, in the same order: group creation is collective).
  Outside a world it only describes the fold (``group`` None), which the
  sharding rules and plans can read but an engine with ``model`` > 1
  cannot run on. When ``data`` > 1 each column of the fold is a ``data``
  group too (``data_group``: the ranks holding replicas of one shard,
  over which data-parallel training averages its gradients).
* ``make_production_mesh(multi_pod=)`` describes the reference's
  production meshes for the dry-run: 16 x 16 ``(data, model)`` or 2 x 16
  x 16 ``(pod, data, model)``, the pod axis folded into the data rows, on
  placeholder ``meta`` devices; no world, nothing allocated.
* ``run_world(fn, world, backend=, init_file=)`` starts ``world`` ranks
  (``torch.multiprocessing``, spawn) that meet through a ``file://``
  rendezvous, calls ``fn(rank, *args)`` in each and returns their results
  in rank order; a rank's exception, an exit without a result, or the
  timeout fails the whole world at once (the other ranks are stopped:
  a rank left waiting in a collective would hang). ``backend="nccl"``
  makes the default group ``cpu:gloo,cuda:nccl``, so CPU tensors (the
  router's loads) still have a backend; each rank runs with
  ``torch.set_num_threads(1)``.
"""
from __future__ import annotations

import dataclasses
import queue
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` fold of devices, and the calling rank's place
    in it. ``devices[i][j]``: the device of data row i, model column j
    (rank i * model + j inside a world); ``group``: the calling rank's
    ``model`` group (None outside a world, or when ``model`` is 1);
    ``data_rank`` / ``model_rank``: the calling rank's coordinates (0, 0
    outside a world); ``data_group``: its ``data`` group (None outside a
    world, or when ``data`` is 1); ``device``: its device."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    shape: Dict[str, int]
    group: Any = None
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None

    @property
    def device(self) -> torch.device:
        return self.devices[self.data_rank][self.model_rank]

    @property
    def backend(self) -> Optional[str]:
        """The model group's backend (None without a group)."""
        return None if self.group is None else dist.get_backend(self.group)


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device (none without CUDA)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_host_mesh(model: int = 1, *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """Fold ``devices`` (default: every visible CUDA device) into a
    ``(data, model)`` mesh; raises ``ValueError`` unless their count is a
    positive multiple of ``model``. In a world, the world must have one
    rank a device, and every rank must call this (collectively, in the
    same order): it creates the ``model`` groups when ``model`` > 1."""
    devs = [torch.device(d) for d in (visible_devices() if devices is None
                                      else devices)]
    n = len(devs)
    if model < 1 or n == 0 or n % model != 0:
        raise ValueError(
            f"make_host_mesh: cannot fold {n} device(s) into a "
            f"(data, model) mesh with model={model} — n must be a "
            f"positive multiple of model")
    rows = tuple(tuple(devs[i:i + model]) for i in range(0, n, model))
    shape = {"data": n // model, "model": model}
    if not dist.is_initialized():
        return Mesh(rows, shape)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(
            f"make_host_mesh: a world of {world} rank(s) holds one device "
            f"a rank; {n} device(s) were listed")
    group = data_group = None
    if model > 1:
        group, _ = dist.new_subgroups_by_enumeration(
            [list(range(i, i + model)) for i in range(0, n, model)])
    if n > model:
        data_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(j, n, model)) for j in range(model)])
    return Mesh(rows, shape, group, rank // model, rank % model, data_group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as a described fold: 16 x 16
    ``(data, model)``, or 2 x 16 x 16 ``(pod, data, model)`` whose 32 data
    rows are the pods' rows in turn (``Rules`` maps "batch" to ``("pod",
    "data")``, so the batch splits 32 ways). Devices are ``meta``
    placeholders; there is no world and no group."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    rows = shape.get("pod", 1) * shape["data"]
    meta = torch.device("meta")
    return Mesh(tuple((meta,) * shape["model"] for _ in range(rows)), shape)


def _rank_main(fn: Callable, rank: int, world: int, backend: str,
               init_file: str, args: tuple, out) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if backend == "nccl" else backend,
            init_method=f"file://{init_file}", rank=rank, world_size=world)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
    except Exception:         # reported to the parent, which fails the world
        out.put((rank, False, traceback.format_exc()))
        return
    out.put((rank, True, result))


class WorldError(RuntimeError):
    """A rank of a ``run_world`` world failed, died or timed out."""


def _failures(world: int, failed: Dict[int, str], out,
              grace: float = 2.0) -> str:
    """The message of a failed world: the first failure's traceback and
    those of the ranks that fail within ``grace`` seconds of it (a rank
    that raises takes its peers' collectives down with it, so the first
    message to arrive need not be the cause), in rank order."""
    end = time.monotonic() + grace
    while time.monotonic() < end:
        try:
            rank, ok, value = out.get(timeout=max(0.0, end - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            failed[rank] = value
    return f"rank(s) {sorted(failed)} of {world} failed:\n" + "\n".join(
        f"--- rank {r} ---\n{failed[r]}" for r in sorted(failed))


def run_world(fn: Callable, world: int, *, backend: str, init_file: str,
              args: tuple = (), timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks of one
    ``torch.distributed`` world (``backend`` "gloo" or "nccl";
    ``init_file``: a path that does not exist yet, the rendezvous) and
    return the results in rank order. ``fn`` and its arguments and results
    must pickle (``fn`` by import path). Raises ``WorldError`` with the
    failing rank's traceback, or when a rank exits without a result, or
    after ``timeout`` seconds; every rank is stopped before it returns."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init_file, args, out),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    done = False
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()]
                if dead and out.empty():
                    raise WorldError(f"rank(s) {dead} exited without a "
                                     f"result (exit codes "
                                     f"{[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise WorldError(
                        f"world of {world} timed out after {timeout:.0f} s "
                        f"with rank(s) "
                        f"{sorted(set(range(world)) - set(results))} "
                        f"still running")
                continue
            if not ok:
                raise WorldError(_failures(world, {rank: value}, out))
            results[rank] = value
        done = True
    finally:
        for p in procs:
            if done:
                p.join(timeout=30.0)
            if p.is_alive():     # a failed world's ranks may wait forever
                p.kill()
            p.join()
    return [results[r] for r in range(world)]
