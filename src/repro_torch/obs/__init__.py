"""repro_torch.obs — structured tracing and per-phase timing for the
runtimes (the JAX package's ``repro.obs``).

One schema unifies the counters the training loop, the adaptive planner,
the host store and the serve engine compute:

- :class:`Tracer` — nestable host-side spans (step kinds ``refresh`` /
  ``cached`` / ``pipelined`` / ``transition`` plus ``replan``,
  ``h2d_prefetch``, ``l0_stage``, ``writeback``, ``eval``) and typed
  per-step :class:`StepCounters` records (wire rows/bytes per tier,
  cache hit rate, drift, host fetch/writeback, device memory
  watermarks).  A disabled tracer is a shared no-op — no allocation, no
  stream synchronisation — so the hot path pays nothing when tracing is
  off; span timing fences via :meth:`Tracer.fence` only when enabled
  (it waits for the current stream of the fenced value's device).
- :mod:`repro_torch.obs.export` — per-step JSONL metrics stream and a
  Chrome ``trace_event`` JSON (loads in Perfetto: spans as duration
  events, counters as counter tracks, one track per worker).
- device-side visibility: :func:`device_scope`, :func:`host_annotation`
  and :func:`annotate_function` (``torch.profiler.record_function``
  ranges) and :func:`device_trace`
  (opt-in ``torch.profiler`` capture dir).

``python -m repro_torch.obs.check trace.json`` validates an exported
timeline.
"""
from .tracer import (NULL_TRACER, SPAN_KINDS, STEP_KINDS, Span,
                     StepCounters, Tracer, device_peak_bytes)
from .annotations import (annotate_function, device_scope, device_trace,
                          host_annotation)
from .export import (chrome_trace_events, validate_chrome_trace,
                     write_chrome_trace, write_metrics_jsonl)

__all__ = [
    "Tracer", "Span", "StepCounters", "NULL_TRACER",
    "STEP_KINDS", "SPAN_KINDS", "device_peak_bytes",
    "device_scope", "host_annotation", "annotate_function", "device_trace",
    "chrome_trace_events", "write_chrome_trace", "write_metrics_jsonl",
    "validate_chrome_trace",
]
