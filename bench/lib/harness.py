"""One run of one cell: set-up, the measured window, the per-layer
readers (traced run), the correctness check, and the result line."""
from __future__ import annotations

import gc
import json
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from bench.lib import correct, devtrace, model, serve, spec, stats
from bench.reference.dims import dims

PROFILE_S = 3.0         # the profiled end of the traced window, seconds


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _spans(tracer, sync_ts: int, sync_host: float):
    """The program's complete spans as (name, start s, duration s) on the
    host clock."""
    off = sync_host - sync_ts * 1e-6
    return [(e["name"], e["ts"] * 1e-6 + off, e["dur"] * 1e-6)
            for e in tracer.events() if e.get("ph") == "X"]


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_process: float, device="cuda") -> dict:
    c = spec.cell(cell_name)
    return run_cell(
        spec.config(c["config"]), spec.traffic(c["traffic"]),
        spec.limits(cell_name), spec.end_to_end(cell_name),
        spec.per_layer(cell_name), seed, seconds, trace, t_process, device)


def setup(cfg: dict, mix: dict, seed: int, trace: bool, device):
    """The weights, the engine and its warm-up: what every window needs
    before it opens."""
    from repro_torch.runtime.trace import Tracer
    dev = torch.device(device)
    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    t_build = time.perf_counter()
    port_cfg = model.port_config(cfg)
    tree = model.make_weights(cfg, seed, dev)
    tracer = Tracer(enabled=trace)
    eng, sched = serve.make_engine(port_cfg, tree, mix,
                                   seed, tracer, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_made = time.perf_counter()
    serve.warm(eng, mix, dims(cfg).vocab, seed)
    if dev.type == "cuda":
        if trace:
            devtrace.prime()
        torch.cuda.synchronize()
    log(f"setup: build {t_build - t:.3f} s, weights and engine "
        f"{t_made - t_build:.3f} s, warm-up {time.perf_counter() - t_made:.3f} s")
    return tree, tracer, eng, sched


def run_cell(cfg: dict, mix: dict, limits: dict,
             end_to_end: List[dict], per_layer: List[dict], seed: int,
             seconds: float, trace: bool, t_process: float,
             device="cuda", control: bool = False) -> dict:
    """One run. With ``control`` the fp8 control is judged too, under the
    same limits, and its verdict comes under ``control`` (the control's
    readings; the benchmark's own runs never ask for it)."""
    dm = dims(cfg)
    cuda = torch.device(device).type == "cuda"
    tree, tracer, eng, sched = setup(cfg, mix, seed, trace, device)
    loop = serve.ClosedLoop(eng, sched, mix, seed, dm.vocab)
    t_ramp = time.perf_counter()
    loop.ramp()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    log(f"setup: ramp {time.perf_counter() - t_ramp:.3f} s, from the "
        f"process's start {setup_s:.3f} s")
    sub = devtrace.SubWindow(max(0.0, seconds - PROFILE_S), PROFILE_S) \
        if trace and cuda else None
    if sub is not None:
        sub.window_t0 = time.perf_counter()
    t0, t1, ticks = loop.window(seconds, sub.on_tick if sub else None)
    if sub is not None:
        sub.close()
        if sub.result is None:
            raise RuntimeError("the profiler recorded no device operation "
                               "in the traced window")
    if cuda:
        torch.cuda.synchronize()
    e2e = stats.end_to_end(loop.records, t0, t1)
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sent = [r for r in loop.records if r.sent < t1]
    failed = sum(1 for r in sent if r.done and len(r.tokens) < r.max_new)

    metrics: Dict[str, dict] = {}
    breakdown = None
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        tracer.instant("bench.sync")
        sync_host = time.perf_counter()
        sync_ts = tracer.events()[-1]["ts"]
        every = _spans(tracer, sync_ts, sync_host)
        spans = [s for s in every if t0 <= s[1] and s[1] + s[2] <= t1]
        prof = sub.result if sub is not None else None
        if prof is not None:
            prof.ticks = [t for t in loop.ticks
                          if prof.t0 <= t.t0 and t.t1 <= prof.t1]
            dev_info["busy_s"] = prof.busy_s
            dev_info["window_s"] = prof.window_s
            log(f"profiled {prof.window_s:.3f} s ({len(prof.ticks)} ticks, "
                f"{len(prof.events)} device operations; the session took "
                f"{sub.open_s:.3f} s to start), busy {prof.busy_s:.6f} s")
            breakdown = devtrace.breakdown(prof, every)
        ctx = SimpleNamespace(dims=dm, mix=mix, window=(t0, t1),
                              ticks=ticks, spans=spans, prof=prof)
        for m in per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in end_to_end:
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log(f"window {t1 - t0:.3f} s, {len(ticks)} ticks, "
        f"{sum(len(t.rows) for t in ticks)} decode rows, "
        f"{sum(len(t.prefills) for t in ticks)} prefills; tpot samples "
        f"{e2e['tpot_samples']}, ttft samples {e2e['ttft_samples']}; "
        f"setup {setup_s:.3f} s; peak {peak} B")
    log("tails: " + json.dumps({k: v for k, v in e2e.items()
                                if "_p" in k}))

    # the program's state goes before the reference runs
    records = loop.records
    del loop, eng, sched, ticks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    judged = correct.judge(dm, tree, mix, seed, records, control)
    prog = judged["program"]
    log(f"reference: {prog['requests']} requests, {prog['tokens']} "
        f"tokens, {time.perf_counter() - t_ref:.1f} s")
    log("judged: " + json.dumps(judged))
    ok, checks = correct.verdict(prog, limits)
    checks["failed_requests"] = {"value": failed, "limit": 0}
    ok = ok and failed == 0
    for k, v in checks.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    out = {"correct": ok, "attempted": len(sent), "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        c_ok, c_checks = correct.verdict(judged["control"], limits)
        out["control"] = {"correct": c_ok, "checks": c_checks,
                          "numbers": judged["control"], "program": prog}
    out["checks"] = checks
    return out
