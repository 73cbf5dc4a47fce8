"""Where the serving slice's time goes on the card.

``python -m repro_torch.launch.profile_serve gnn [launch.serve gnn flags]``

Runs the slice once through :func:`repro_torch.launch.serve.serve_gnn`
(which builds the kernels and warms every launch up), then profiles with
``torch.profiler`` (CPU and CUDA activity):

1. ``precompute`` — one :func:`~repro_torch.serve.precompute_embeddings`
   pass over the slice's stacked layout;
2. ``serve`` — :func:`~repro_torch.serve.serve_stream` over the slice's
   query stream again, warm-up included.

For each it prints one JSON line: the wall seconds of the profiled window,
the device-busy seconds (the sum of the device time of every kernel, copy
and memset; the slice runs on one stream, so they do not overlap), the
idle share ``1 - busy / wall``, and the operations with the most device
time and the most host time.  The device side of the port's
``record_function`` ranges (``obs.annotations.device_scope``) spans the
kernels inside it: it is listed apart (``device_ranges``), never added to
the busy time.  The profiler's own cost is inside the wall time, so the
idle share is an upper bound for the unprofiled run.
"""
from __future__ import annotations

import json
import time

import torch

from .serve import (build_parser, plan_and_stack, prepare_gnn, serve_gnn,
                    slice_stream)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


# the device activities that occupy the card; a user annotation's device
# side (a ``record_function`` range) only spans them
_BUSY_KINDS = ("kernel", "memcpy", "memset")


def device_kind(evt) -> str | None:
    """What a profiler event is on the card: ``"kernel"``, ``"memcpy"``,
    ``"memset"`` or ``"range"`` (a user annotation's device side), or
    None for a host event.  Reads the event's activity type where the
    installed profiler records one, else its annotation flag and name."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return None
    activity = (getattr(evt, "activity_type", None) or "").lower()
    if getattr(evt, "is_user_annotation", False) or "annotation" in activity:
        return "range"
    name = evt.name.lower()
    for kind in ("memcpy", "memset"):
        if kind in activity or name.startswith(kind):
            return kind
    return "kernel"


def _summary(name: str, prof, wall: float, top: int = 12) -> dict:
    """One JSON-able record of a profiled window (times in ms): the busy
    time sums kernels, copies and memsets only."""
    busy, ranges = {}, {}
    for e in prof.events():
        kind = device_kind(e)
        if kind is None:
            continue
        rows = ranges if kind == "range" else busy
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    if not busy:
        raise RuntimeError(f"{name}: the profiler recorded no device "
                           "activity; time the window with CUDA events")
    host_rows = [(e.key, e.self_cpu_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type != torch.autograd.DeviceType.CUDA
                 and e.self_cpu_time_total > 0]
    busy_ms = sum(ms for ms, _ in busy.values())
    host_rows.sort(key=lambda r: -r[1])

    def top_rows(rows):
        return [{"op": k[:120], "ms": ms, "calls": n} for k, (ms, n) in
                sorted(rows.items(), key=lambda r: -r[1][0])[:top]]
    return {
        "window": name, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_top": top_rows(busy), "device_ranges": top_rows(ranges),
        "host_top": [{"op": k[:120], "self_ms": ms, "calls": n}
                     for k, ms, n in host_rows[:top]],
    }


def profile_serve(args) -> list[dict]:
    from ..serve import BatchConfig, precompute_embeddings, serve_stream

    report, engine = serve_gnn(args)
    task, ps, profiles, cfg = prepare_gnn(args)
    xplan, sp = plan_and_stack(args, task, ps, profiles, cfg)
    stream = slice_stream(args, task.graph)
    bcfg = BatchConfig(max_batch=args.max_batch,
                       deadline_ms=args.deadline_ms)
    out = []
    prof, wall = _profiled(lambda: precompute_embeddings(
        cfg, ps, sp, xplan, engine.params, backend=args.backend,
        device=args.device))
    out.append(_summary("precompute", prof, wall))
    prof, wall = _profiled(lambda: serve_stream(engine, stream, bcfg))
    out.append({**_summary("serve", prof, wall),
                "batches": report["batches"]})
    for rec in out:
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("profile_serve measures the card: use --device cuda")
    return profile_serve(args)


if __name__ == "__main__":
    main()
