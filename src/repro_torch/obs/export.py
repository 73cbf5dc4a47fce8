"""Exporters for :class:`repro_torch.obs.Tracer` (the JAX package's
``obs/export.py``, the same files): a per-step JSONL metrics stream and a
Chrome ``trace_event`` JSON that loads directly in Perfetto
(https://ui.perfetto.dev) — spans as complete duration events (``"X"``),
counters as counter tracks (``"C"``), per-worker wire rows as one counter
track per worker process.

``validate_chrome_trace`` is the schema check the tests and the CI smoke
gate (`python -m repro_torch.obs.check`) run against every exported file.
"""
from __future__ import annotations

import dataclasses
import json

__all__ = ["chrome_trace_events", "write_chrome_trace",
           "write_metrics_jsonl", "validate_chrome_trace"]

# aggregate counter tracks emitted per StepCounters record (pid 0);
# fault/defense fields are None on clean runs, so they only render as
# tracks when a FaultPlan / guard was active
_COUNTER_FIELDS = ("wire_bytes", "wire_rows_uncached", "wire_rows_local",
                   "wire_rows_global", "host_fetch_rows",
                   "host_fetch_bytes", "host_writeback_bytes",
                   "cache_hit_rate", "planner_hit_rate", "drift",
                   "device_peak_bytes", "queries", "hot_hits", "host_hits",
                   "fresh_recomputes",
                   "faults_injected", "fetch_errors", "fetch_retries",
                   "fetch_stale_reuse", "slow_fetches",
                   "prefetch_degraded_steps", "corruptions_detected",
                   "forced_refreshes", "rollbacks", "mem_backoffs")
# serve records carry only the query-path counters — the training wire
# fields are structurally zero there and would render as flat-0 tracks
_SERVE_FIELDS = ("queries", "hot_hits", "host_hits", "fresh_recomputes",
                 "device_peak_bytes")


def chrome_trace_events(tracer) -> list[dict]:
    """Flatten a tracer into Chrome ``trace_event`` dicts.  Timestamps
    are microseconds relative to the earliest recorded event."""
    stamps = ([s.t0 for s in tracer.spans]
              + [c.t for c in tracer.counters])
    base = min(stamps) if stamps else 0.0

    def us(t: float) -> int:
        return int(round((t - base) * 1e6))

    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "train host"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "steps"}},
    ]
    for s in tracer.spans:
        ev = {"name": s.name, "cat": s.kind, "ph": "X",
              "ts": us(s.t0), "dur": max(1, int(round(s.dur * 1e6))),
              "pid": 0, "tid": 0}
        args = dict(s.args or {})
        if s.step is not None:
            args["step"] = s.step
        if args:
            ev["args"] = args
        events.append(ev)

    workers: set[int] = set()
    for c in tracer.counters:
        ts = us(c.t)
        fields = _SERVE_FIELDS if c.kind == "serve" else _COUNTER_FIELDS
        for field in fields:
            v = getattr(c, field)
            if v is None:
                continue
            events.append({"name": field, "ph": "C", "ts": ts,
                           "pid": 0, "tid": 0, "args": {field: v}})
        for w, rows in enumerate(c.wire_rows_by_worker or ()):
            workers.add(w)
            events.append({"name": "wire_rows_uncached", "ph": "C",
                           "ts": ts, "pid": 1 + w, "tid": 0,
                           "args": {"wire_rows_uncached": rows}})
    for w in sorted(workers):
        events.append({"name": "process_name", "ph": "M", "pid": 1 + w,
                       "tid": 0, "args": {"name": f"worker{w}"}})
    return events


def write_chrome_trace(tracer, path: str) -> str:
    payload = {"traceEvents": chrome_trace_events(tracer),
               "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def write_metrics_jsonl(tracer, path: str) -> str:
    """One JSON line per step: the full :class:`StepCounters` record."""
    with open(path, "w") as f:
        for c in tracer.counters:
            f.write(json.dumps(dataclasses.asdict(c)) + "\n")
    return path


def validate_chrome_trace(payload) -> dict:
    """Validate a loaded Chrome trace against the ``trace_event`` schema
    subset we emit; raises ``ValueError`` on any malformed event.
    Returns ``{"spans_by_cat": {...}, "n_spans": n, "n_counters": n}``."""
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = payload["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    spans_by_cat: dict[str, int] = {}
    n_spans = n_counters = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"event {i}: not an object with 'ph'")
        ph = ev["ph"]
        if ph not in ("X", "C", "M", "B", "E", "I"):
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        if ph in ("X", "C", "B", "E", "I"):
            if not isinstance(ev.get("name"), str):
                raise ValueError(f"event {i}: missing string 'name'")
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"event {i}: missing numeric 'ts'")
            if not isinstance(ev.get("pid"), int):
                raise ValueError(f"event {i}: missing int 'pid'")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i}: 'X' needs 'dur' >= 0")
            n_spans += 1
            cat = ev.get("cat", "")
            spans_by_cat[cat] = spans_by_cat.get(cat, 0) + 1
        elif ph == "C":
            args = ev.get("args")
            if (not isinstance(args, dict) or not args
                    or not all(isinstance(v, (int, float))
                               for v in args.values())):
                raise ValueError(f"event {i}: 'C' needs numeric 'args'")
            n_counters += 1
    return {"spans_by_cat": spans_by_cat, "n_spans": n_spans,
            "n_counters": n_counters}
