"""Host-side span/counter tracer — the core of :mod:`repro_torch.obs`
(the JAX package's ``obs/tracer.py``).

Spans nest strictly (LIFO): a step-kind span opens at depth 0 and every
sub-phase (``l0_stage``, ``h2d_prefetch``, ``writeback``, ``replan``, …)
opens inside it, so two step kinds can never interleave.  Counters are
typed :class:`StepCounters` records, one per training step, whose totals
reproduce the report/plan accounting exactly (asserted in tests).

Zero-overhead contract: a disabled tracer (``Tracer(enabled=False)`` or
the shared :data:`NULL_TRACER`) allocates nothing per call — ``span()``
returns one shared reusable no-op context manager, ``count()`` /
``fence()`` return immediately, and no stream is ever synchronised.
Fencing happens only on an *enabled* tracer, so span durations measure
completed device work rather than queued launches.
"""
from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["Tracer", "Span", "StepCounters", "NULL_TRACER",
           "STEP_KINDS", "SPAN_KINDS", "device_peak_bytes"]

# top-level step flavours of the training loop (depth-0 spans)
STEP_KINDS = ("refresh", "cached", "pipelined", "transition")
# sub-phase + out-of-loop span names; the last row are the fault/defense
# events of repro_torch.faults (integrity digests, divergence checks,
# rollback, fetch retries, memory-pressure backoff)
SPAN_KINDS = STEP_KINDS + ("replan", "h2d_prefetch", "l0_stage",
                           "writeback", "eval",
                           "integrity", "divergence_check", "rollback",
                           "fetch_retry", "mem_backoff")


def device_peak_bytes(device) -> int | None:
    """Peak device memory allocated on ``device`` (the caching
    allocator's ``max_memory_allocated``); ``None`` on the CPU, which
    does not report it."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


@dataclasses.dataclass
class Span:
    """One closed span: wall-clock interval + nesting context."""
    name: str
    kind: str              # one of SPAN_KINDS (or a free-form sub-span name)
    t0: float              # perf_counter seconds
    dur: float             # seconds
    depth: int             # 0 for step spans, >0 for nested sub-phases
    step: int | None = None
    args: dict | None = None


@dataclasses.dataclass
class StepCounters:
    """Typed per-step counter record — the one schema unifying the
    accounting of ``train_capgnn`` (wire rows/bytes), ``AdaptivePlanner``
    (hit rate), ``HostFeatureStore`` (fetch/writeback deltas) and the
    device memory watermark.  Row counts are per exchange layer, exactly
    the plan figures ``_step_rows`` sums; ``wire_bytes`` is this step's
    contribution to ``TrainReport.comm_bytes``."""
    step: int
    kind: str
    wire_rows_uncached: int = 0
    wire_rows_local: int = 0        # refreshed local-tier rows (0 on cached)
    wire_rows_global: int = 0       # refreshed dedup global rows (0 on cached)
    wire_bytes: int = 0
    wire_bytes_vanilla: int = 0
    cache_hit_rate: float | None = None   # halo rows served stale / total
    planner_hit_rate: float | None = None  # AdaptivePlanner cumulative
    drift: float | None = None
    host_fetch_rows: int = 0        # store deltas attributed to this step
    host_fetch_bytes: int = 0
    host_writeback_rows: int = 0
    host_writeback_bytes: int = 0
    device_peak_bytes: int | None = None
    wire_rows_by_worker: list | None = None  # per-worker uncached recv rows
    # serve-side records (kind="serve", one per micro-batch); None on
    # training records so the exporter emits no empty counter tracks
    queries: int | None = None
    hot_hits: int | None = None
    host_hits: int | None = None
    fresh_recomputes: int | None = None
    # fault/defense event deltas (repro_torch.faults); None on clean runs
    # so the exporter emits no flat-zero tracks and totals stay unchanged.
    # Per step, each defense field counts actions taken THIS step and
    # faults_injected counts injector firings — the two streams sum to
    # equal totals per fault class.
    faults_injected: int | None = None
    fetch_errors: int | None = None
    fetch_retries: int | None = None
    fetch_stale_reuse: int | None = None
    slow_fetches: int | None = None
    prefetch_degraded_steps: int | None = None
    corruptions_detected: int | None = None
    forced_refreshes: int | None = None
    rollbacks: int | None = None
    mem_backoffs: int | None = None
    t: float = 0.0                  # perf_counter stamp (set by count())


class _NoopSpan:
    """Shared reusable no-op context manager (disabled tracer path)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _OpenSpan:
    """Context manager recording one span on exit (enabled path)."""
    __slots__ = ("tr", "name", "kind", "step", "args", "t0", "depth")

    def __init__(self, tr: "Tracer", name: str, kind: str,
                 step: int | None, args: dict | None):
        self.tr, self.name, self.kind = tr, name, kind
        self.step, self.args = step, args

    def __enter__(self):
        self.depth = len(self.tr._stack)
        self.tr._stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        top = self.tr._stack.pop()
        if top is not self:            # interleaved exit — structural bug
            raise RuntimeError(
                f"span {self.name!r} closed while {top.name!r} is open; "
                "spans must nest strictly")
        self.tr.spans.append(Span(name=self.name, kind=self.kind,
                                  t0=self.t0, dur=dur, depth=self.depth,
                                  step=self.step, args=self.args))
        return False


class Tracer:
    """Span + counter collector.  Pass ``enabled=False`` (or use
    :data:`NULL_TRACER`) for the zero-overhead disabled mode."""

    def __init__(self, enabled: bool = True, fence: bool = True):
        self.enabled = enabled
        self.do_fence = fence
        self.spans: list[Span] = []
        self.counters: list[StepCounters] = []
        self._stack: list[_OpenSpan] = []

    # -- spans -------------------------------------------------------------

    def span(self, name: str, kind: str | None = None,
             step: int | None = None, **args):
        """Open a nested span; returns a context manager.  ``kind``
        defaults to ``name`` (the usual case for the named phases)."""
        if not self.enabled:
            return _NOOP
        return _OpenSpan(self, name, kind or name, step, args or None)

    def step_span(self, kind: str, step: int):
        """Depth-0 span for one training step of flavour ``kind``."""
        if not self.enabled:
            return _NOOP
        if self._stack:
            raise RuntimeError(
                f"step span {kind!r} opened inside {self._stack[-1].name!r};"
                " step kinds must not interleave")
        return _OpenSpan(self, kind, kind, step, None)

    def fence(self, x):
        """Wait for ``x`` *only when span timing is on* — the disabled
        tracer adds no sync points.  The wait is for the work queued on
        the current stream of ``x``'s device up to the fence (the stream
        that computed ``x``), as the reference's ``block_until_ready(x)``
        waits for ``x`` alone: work on other streams, such as the host
        store's side-stream copy of the next step's rows, stays in flight.
        A CPU tensor is complete when it is returned."""
        if self.enabled and self.do_fence and isinstance(x, torch.Tensor) \
                and x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()
        return x

    # -- counters ----------------------------------------------------------

    def count(self, rec: StepCounters) -> None:
        if not self.enabled:
            return
        rec.t = time.perf_counter()
        self.counters.append(rec)

    # -- summaries ---------------------------------------------------------

    def phase_stats(self) -> dict:
        """Per step-kind timing summary over the depth-0 spans:
        ``{kind: {count, p50_ms, p99_ms, total_s}}``."""
        by_kind: dict[str, list[float]] = {}
        for s in self.spans:
            if s.depth == 0 and s.kind in STEP_KINDS + ("eval",):
                by_kind.setdefault(s.kind, []).append(s.dur)
        out = {}
        for kind, durs in by_kind.items():
            ds = sorted(durs)
            out[kind] = {
                "count": len(ds),
                "p50_ms": 1e3 * ds[len(ds) // 2],
                "p99_ms": 1e3 * ds[min(len(ds) - 1,
                                       int(0.99 * (len(ds) - 1) + 0.5))],
                "total_s": sum(ds),
            }
        return out

    def totals(self) -> dict:
        """Sums of the additive counter fields — must equal the report
        totals exactly (``comm_bytes``, ``host_fetch_rows``, …)."""
        keys = ("wire_bytes", "wire_bytes_vanilla", "host_fetch_rows",
                "host_fetch_bytes", "host_writeback_rows",
                "host_writeback_bytes",
                # fault/defense streams (None on clean runs -> summed as 0)
                "faults_injected", "fetch_errors", "fetch_retries",
                "fetch_stale_reuse", "slow_fetches",
                "prefetch_degraded_steps", "corruptions_detected",
                "forced_refreshes", "rollbacks", "mem_backoffs")
        tot = {k: 0 for k in keys}
        for c in self.counters:
            for k in keys:
                tot[k] += getattr(c, k) or 0
        tot["steps"] = len(self.counters)
        return tot

    # -- export ------------------------------------------------------------

    def export(self, out_dir, prefix: str = "train") -> dict:
        """Write ``trace_<prefix>.json`` (Chrome trace_event, Perfetto)
        and ``metrics_<prefix>.jsonl`` under ``out_dir``; returns the
        file paths."""
        import os

        from .export import write_chrome_trace, write_metrics_jsonl
        os.makedirs(out_dir, exist_ok=True)
        trace = os.path.join(out_dir, f"trace_{prefix}.json")
        jsonl = os.path.join(out_dir, f"metrics_{prefix}.jsonl")
        write_chrome_trace(self, trace)
        write_metrics_jsonl(self, jsonl)
        return {"trace": trace, "metrics": jsonl}


NULL_TRACER = Tracer(enabled=False)
