"""Data-parallel replica router: whole-engine replicas behind one router.

Counterpart of ``repro.runtime.router``. Tensor parallelism
(``parallel/tp.py``) scales ONE engine across the ``model`` axis of its
mesh; this module scales throughput the orthogonal way: R independent
``PagedServingEngine`` replicas, each with its own continuous-batching
``Scheduler``. The two compose: a replica may itself be an M-way
tensor-parallel engine.

Where replicas live: a replica is a tensor-parallel group of M ranks, and
the router runs on every rank of an R x M world (``launch.mesh.run_world``)
with the same inputs. Each rank holds its own replica's engine (the other
entries of ``engines`` are None) and makes the same routing decisions, so
the ranks of a replica stay in lockstep; with R x M = 1 no world is needed
and the router holds its one engine, as the reference's single-device
default. A router may also hold several engines of one process (every
entry an engine): it then ticks them in turn, host-sequentially, as the
reference's does.

Routing policies (``policy=``):

* ``"hash"``: ``rid % R``, stateless and sticky (a resubmitted request
  lands on the replica that still caches its prefix), the default;
* ``"least_loaded"``: the replica with the fewest in-flight tokens (queued
  prompt + budget, plus what its live slots still owe) at submit time; in
  a world each rank knows only its own replica's load, so every submit
  all-gathers the R loads over the world's CPU group (a max-reduce of one
  vector: each replica's ranks give the same value).

``step()`` ticks each local replica with work once; ``drain`` bounds the
per-replica step budget like ``Scheduler.drain``; ``run_to_completion``
then gathers every request's tokens from the rank that served it, so each
rank returns the same requests. ``stats()`` rolls up per-replica
allocator and telemetry counters, gathering what a rank cannot see.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.runtime.scheduler import Scheduler, SchedulerExhausted
from repro_torch.runtime.serving import Request

_POLICIES = ("hash", "least_loaded")


def make_replicas(cfg, params, *, replicas: int = 1, model: int = 1,
                  devices: Optional[Sequence] = None, policy: str = "hash",
                  **engine_kwargs) -> "ReplicaRouter":
    """Build the calling rank's replica of R paged engines, each M shards
    wide, and wrap it in a router. ``devices`` (default: every visible
    CUDA device) must hold R x M of them, else ``ValueError``; R x M > 1
    needs a world of exactly R x M ranks (rank r on ``devices[r]``, every
    rank calling this with the same arguments), where rank r serves
    replica r // M. ``params`` are the full tensors on the rank's device;
    the engine's ``device`` defaults to it."""
    from repro_torch.launch.mesh import make_host_mesh, visible_devices
    from repro_torch.runtime.serving import PagedServingEngine

    devs = list(devices) if devices is not None else visible_devices()
    need = replicas * model
    if replicas < 1 or model < 1 or need > len(devs):
        raise ValueError(
            f"make_replicas: {replicas} replica(s) x {model} shard(s) "
            f"need {need} device(s), have {len(devs)}")
    if need == 1:
        engine_kwargs.setdefault("device", devs[0])
        return ReplicaRouter([PagedServingEngine(cfg, params,
                                                 **engine_kwargs)],
                             policy=policy)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"make_replicas: {replicas} replica(s) x {model} shard(s) run "
            f"on a world of {need} ranks (launch.mesh.run_world); this "
            f"process is in a world of {world}")
    mesh = make_host_mesh(model, devices=devs[:need])
    engine_kwargs.setdefault("device", mesh.device)
    engines: List = [None] * replicas
    engines[mesh.data_rank] = PagedServingEngine(
        cfg, params, mesh=mesh if model > 1 else None, **engine_kwargs)
    return ReplicaRouter(engines, policy=policy)


class ReplicaRouter:
    """Dispatch requests across replica engines; one Scheduler each. An
    entry of ``engines`` that is None is a replica another rank of the
    world holds."""

    def __init__(self, engines: List, *, policy: str = "hash"):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        if policy not in _POLICIES:
            raise ValueError(
                f"policy must be one of {_POLICIES}: {policy!r}")
        if any(e is None for e in engines) and not dist.is_initialized():
            raise ValueError("replicas held by other ranks need a "
                             "torch.distributed world")
        self.engines = list(engines)
        self.scheds = [None if e is None else Scheduler(e)
                       for e in self.engines]
        self.policy = policy
        self.routed: List[int] = [0] * len(self.engines)
        self._replica_of: Dict[int, int] = {}     # rid -> replica
        self._world = any(e is None for e in engines)

    def _local(self):
        return [(i, s) for i, s in enumerate(self.scheds) if s is not None]

    # -- routing ----------------------------------------------------------
    def _load(self, i: int) -> int:
        """In-flight token estimate for local replica i: queued work plus
        what its live slots still owe."""
        sched, eng = self.scheds[i], self.engines[i]
        queued = sum(len(r.prompt) + r.max_new - len(r.generated)
                     for r in sched.pending)
        live = sum(len(r.prompt) + r.max_new
                   for r in getattr(eng, "live", []) if r is not None)
        return queued + live

    def _loads(self) -> List[int]:
        """Every replica's load; in a world, gathered from the ranks that
        hold them."""
        loads = torch.zeros(len(self.engines), dtype=torch.int64)
        for i, _ in self._local():
            loads[i] = self._load(i)
        if self._world:
            dist.all_reduce(loads, op=dist.ReduceOp.MAX)
        return loads.tolist()

    def _pick(self, req: Request) -> int:
        if self.policy == "hash":
            return req.rid % len(self.engines)
        loads = self._loads()
        return min(range(len(loads)), key=loads.__getitem__)

    def submit(self, req: Request) -> None:
        """Route and enqueue (admission happens on the replica's next tick,
        so a momentarily full replica queues rather than drops); on a rank
        that does not hold the replica, only the count moves."""
        i = self._pick(req)
        self.routed[i] += 1
        self._replica_of[req.rid] = i
        if self.scheds[i] is None:
            return
        tr = getattr(self.engines[i], "trace", None)
        if tr:
            tr.instant("dispatch", tid="router",
                       args={"rid": req.rid, "replica": i,
                             "policy": self.policy})
        self.scheds[i].add(req)

    add = submit                      # Scheduler-compatible spelling

    # -- driving ----------------------------------------------------------
    def has_work(self) -> bool:
        """Whether a local replica has queued or live requests."""
        return any(s.pending or s.engine.has_live() for _, s in self._local())

    def step(self) -> None:
        """One round: tick every local replica that has work."""
        for _, s in self._local():
            if s.pending or s.engine.has_live():
                s.tick()

    def drain(self, max_steps: int = 10_000) -> None:
        """Run until every local replica is empty; ``max_steps`` bounds
        each replica's own budget (``Scheduler.drain`` semantics), so one
        wedged replica fails loudly instead of starving the loop."""
        rounds = 0
        while self.has_work():
            if rounds >= max_steps:
                busy = [i for i, s in self._local()
                        if s.pending or s.engine.has_live()]
                raise SchedulerExhausted(
                    f"router drain exhausted {max_steps} rounds with "
                    f"replica(s) {busy} still busy")
            self.step()
            rounds += 1

    def run_to_completion(self, requests: List[Request],
                          max_steps: int = 10_000) -> List[Request]:
        """Submit, drain, and (in a world) take every request's
        ``generated`` / ``done`` / ``preemptions`` from the replica that
        served it, so every rank returns the same finished requests."""
        for r in requests:
            self.submit(r)
        self.drain(max_steps)
        if self._world:
            mine = {r.rid: (r.generated, r.done, r.preemptions)
                    for r in requests
                    if self.scheds[self._replica_of[r.rid]] is not None}
            parts: List[Dict] = [None] * dist.get_world_size()
            dist.all_gather_object(parts, mine)
            merged = {rid: v for part in parts for rid, v in part.items()}
            for r in requests:
                r.generated, r.done, r.preemptions = merged[r.rid]
        return [r for r in requests if r.done]

    # -- telemetry --------------------------------------------------------
    def _per_replica(self) -> List[Dict[str, object]]:
        """Each replica's counters, gathered in a world from its ranks."""
        local = {i: {"pool": s.engine.pool_stats(),
                     "shard": s.engine.shard_stats(),
                     "decode_steps": s.engine.decode_steps,
                     "decoded_tokens": s.engine.decoded_tokens,
                     "preempted": s.preempted}
                 for i, s in self._local()}
        if self._world:
            parts: List[Dict] = [None] * dist.get_world_size()
            dist.all_gather_object(parts, local)
            for part in parts:
                local.update(part)
        return [local[i] for i in range(len(self.engines))]

    def replica_shard_stats(self) -> List[Dict[str, object]]:
        """Each replica's ``shard_stats()``."""
        return [p["shard"] for p in self._per_replica()]

    def stats(self) -> Dict[str, object]:
        """Rolled-up telemetry: totals across replicas plus per-replica
        breakdowns (peak pages per replica per shard is the capacity-
        planning number; a total would hide the hot replica)."""
        per = self._per_replica()
        return {
            "replicas": len(self.engines),
            "policy": self.policy,
            "routed": list(self.routed),
            "decode_steps": sum(p["decode_steps"] for p in per),
            "decoded_tokens": sum(p["decoded_tokens"] for p in per),
            "preempted": sum(p["preempted"] for p in per),
            "peak_pages_per_replica": [p["pool"].peak_pages for p in per],
            "allocated_pages_per_replica": [p["pool"].allocated_pages
                                            for p in per],
            "model_shards": [p["shard"]["model_shards"] for p in per],
            "peak_pages_per_shard": [p["shard"]["peak_pages_per_shard"]
                                     for p in per],
        }
