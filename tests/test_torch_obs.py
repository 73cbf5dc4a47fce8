"""The port's tracer (``repro_torch.obs``) against the JAX package's
``repro.obs``, on the CPU.

Held:

- spans nest strictly and step kinds never interleave; a disabled tracer
  is one shared no-op that allocates nothing and never synchronises (an
  enabled one fences a CUDA tensor only, by synchronising the current
  stream of its device, never the whole device);
- ``phase_stats``' percentiles and the totals;
- the Chrome trace and the JSONL stream round-trip, and the JAX
  package's ``validate_chrome_trace`` and ``python -m repro.obs.check``
  accept the port's file as ``python -m repro_torch.obs.check`` does;
- traced runs (:mod:`torch_faults_common`'s graph), device and host
  features, clean and faulted: the per-step ``StepCounters`` stream equal
  to the JAX package's field for field (times and memory aside; drift
  within 1e-5), the totals equal to the report's, the losses those of the
  untraced run bit for bit;
- ``device_trace`` captures the step code's ranges (``layer{li}/spmm``,
  the tier pulls) on the CPU.

The card tests (``device_peak_bytes``, the fence) are in
``tests/test_torch_cuda.py``, which imports no JAX.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.obs import Tracer as JTracer, validate_chrome_trace as jvalidate
from repro.obs.check import main as jcheck_main
from repro_torch.launch import train as ttrain
from repro_torch.obs import (NULL_TRACER, SPAN_KINDS, STEP_KINDS, Span,
                             StepCounters, Tracer, chrome_trace_events,
                             device_peak_bytes, device_scope, device_trace,
                             validate_chrome_trace)
from repro_torch.obs.check import main as check_main

import torch_faults_common as common
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5
FAULTED = dict(spec="fetch_drop@3;grad_nan@5",
               guard_kw=dict(guard_every=2, fetch_retries=1))
# StepCounters fields that are times or device memory, not accounting
_UNCOMPARED = ("t", "device_peak_bytes", "drift")


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lives on the card (the fence's test)."""

    @property
    def is_cuda(self):
        return True


def test_spans_nest_strictly():
    tr = Tracer()
    outer = tr.span("outer")
    inner = tr.span("inner")
    outer.__enter__()
    inner.__enter__()
    with pytest.raises(RuntimeError, match="nest strictly"):
        outer.__exit__(None, None, None)
    tr = Tracer()
    with tr.step_span("refresh", 0):
        with pytest.raises(RuntimeError, match="must not interleave"):
            tr.step_span("cached", 0).__enter__()
    with tr.span("replan"):
        with tr.span("l0_stage"):
            pass
    assert [(s.name, s.depth) for s in tr.spans[-2:]] == [("l0_stage", 1),
                                                          ("replan", 0)]


class _Stream:
    """A stand-in for the current CUDA stream of a device: its
    ``synchronize`` records the device (the fence's test)."""

    def __init__(self, device, syncs):
        self.device, self.syncs = device, syncs

    def synchronize(self):
        self.syncs.append(self.device)


def test_disabled_tracer_is_noop_and_never_syncs(monkeypatch):
    """A disabled tracer never synchronises; an enabled one fences a CUDA
    tensor by synchronising the current stream of its device, never the
    whole device."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream(device, syncs))

    def device_wide(device=None):
        raise AssertionError("the fence waited on the whole device")
    monkeypatch.setattr(torch.cuda, "synchronize", device_wide)
    x = torch.zeros(2).as_subclass(_CudaLike)
    off = Tracer(enabled=False)
    assert off.span("a") is off.span("b") is NULL_TRACER.span("c")
    assert off.step_span("refresh", 0) is NULL_TRACER.step_span("cached", 1)
    assert off.fence(x) is x and NULL_TRACER.fence(x) is x
    off.count(StepCounters(step=0, kind="refresh"))
    assert off.spans == off.counters == [] and syncs == []
    on = Tracer()
    on.fence(torch.zeros(2))            # a CPU tensor is complete
    assert syncs == []
    on.fence(x)
    assert syncs == [x.device]
    assert Tracer(fence=False).fence(x) is x and len(syncs) == 1


def _span(kind, t0, dur, depth):
    return Span(name=kind, kind=kind, t0=t0, dur=dur, depth=depth, step=0)


def test_phase_stats_percentiles():
    tr = Tracer()
    durs = {"refresh": [0.004, 0.001, 0.003], "cached": [0.002] * 5}
    t = 0.0
    for kind, ds in durs.items():
        for d in ds:
            tr.spans.append(_span(kind, t, d, 0))
            t += d
    tr.spans.append(_span("l0_stage", 0.0, 9.0, 1))   # nested: skipped
    st = tr.phase_stats()
    assert set(st) == {"refresh", "cached"}
    assert st["refresh"]["count"] == 3
    assert st["refresh"]["p50_ms"] == pytest.approx(3.0)
    assert st["refresh"]["p99_ms"] == pytest.approx(4.0)
    assert st["refresh"]["total_s"] == pytest.approx(0.008)
    assert st["cached"]["p50_ms"] == st["cached"]["p99_ms"] == \
        pytest.approx(2.0)
    # the same as the JAX package's summary of the same spans
    jtr = JTracer()
    jtr.spans = tr.spans
    assert jtr.phase_stats() == st
    assert set(SPAN_KINDS) >= set(STEP_KINDS)


def _traced(features, faulted=False):
    kw = FAULTED if faulted else {}
    return (common.torch_run(features=features, traced=True, **kw),
            common.jax_run(features=features, traced=True, **kw))


def test_chrome_trace_and_jsonl_roundtrip(tmp_path):
    (rep, tr, _), _ = _traced("host", faulted=True)
    paths = tr.export(str(tmp_path), prefix="train")
    payload = json.load(open(paths["trace"]))
    assert payload["traceEvents"] == json.loads(json.dumps(
        chrome_trace_events(tr)))
    stats = validate_chrome_trace(payload)
    assert jvalidate(payload) == stats
    assert stats["spans_by_cat"]["rollback"] == 1
    assert stats["n_spans"] == len(tr.spans)
    lines = [json.loads(x) for x in open(paths["metrics"])]
    assert lines == [dataclasses.asdict(c) for c in tr.counters]
    kinds = "--kinds=refresh,cached,rollback"
    assert check_main([paths["trace"], kinds]) == 0
    assert jcheck_main([paths["trace"], kinds]) == 0
    assert check_main([paths["trace"], "--kinds=transition"]) == 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "name": "a"}]}))
    assert check_main([str(bad)]) == 1


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("features", ["device", "host"])
def test_traced_counters_match_jax(features, faulted):
    """The per-step counter stream is the JAX package's, field for field."""
    (rep, tr, _), (jrep, jtr, _) = _traced(features, faulted)
    assert len(tr.counters) == len(jtr.counters) == common.EPOCHS
    for c, jc in zip(tr.counters, jtr.counters):
        got, want = dataclasses.asdict(c), dataclasses.asdict(jc)
        assert set(got) == set(want)
        for k in got:
            if k not in _UNCOMPARED:
                assert got[k] == want[k], (c.step, k, got[k], want[k])
        if jc.drift is None or np.isnan(jc.drift):
            assert c.drift is None or np.isnan(c.drift)
        else:
            assert abs(c.drift - jc.drift) < TOL
    assert [s.kind for s in tr.spans if s.depth == 0] == \
        [s.kind for s in jtr.spans if s.depth == 0]


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("features", ["device", "host"])
def test_traced_totals_equal_report(features, faulted):
    """The stream sums to the report exactly; the traced run's losses are
    the untraced run's bit for bit; depth-0 spans are the steps, one a
    step in order, never interleaved."""
    (rep, tr, _), _ = _traced(features, faulted)
    tot = tr.totals()
    assert tot["steps"] == common.EPOCHS
    assert tot["wire_bytes"] == rep.comm_bytes
    assert tot["wire_bytes_vanilla"] == rep.comm_bytes_vanilla
    assert tot["host_fetch_rows"] == rep.host_fetch_rows
    assert tot["host_fetch_bytes"] == rep.host_fetch_bytes
    assert tot["host_writeback_bytes"] == rep.host_writeback_bytes
    if faulted:
        for k, v in rep.fault_events.items():
            assert tot[k] == v
        assert tot["faults_injected"] == sum(rep.faults_injected.values())
    kw = FAULTED if faulted else {}
    plain = common.torch_run(features=features, **kw)[0]
    assert plain.losses == rep.losses or (faulted and np.array_equal(
        plain.losses, rep.losses, equal_nan=True))
    steps = [s for s in tr.spans if s.depth == 0 and s.kind in STEP_KINDS]
    assert [s.step for s in steps] == list(range(common.EPOCHS))
    assert [s.kind for s in steps] == rep.step_kinds
    for a, b in zip(steps, steps[1:]):
        assert a.t0 + a.dur <= b.t0
    assert rep.phase_stats == tr.phase_stats()


def test_device_trace_captures_the_step_ranges(tmp_path):
    """``--device-trace-dir`` on the CPU: the profiler's trace holds the
    step code's ranges (the layer products and the tier pulls)."""
    d = str(tmp_path / "dt")
    out, _ = ttrain.train_gnn(ttrain.build_parser().parse_args(
        ["gnn", "--device", "cpu", "--scale", "0.005", "--feat-dim", "8",
         "--hidden", "8", "--epochs", "2", "--backend", "hybrid",
         "--device-trace-dir", d]))
    names = {e.get("name") for e in json.load(open(
        out["device_trace_file"]))["traceEvents"]}
    assert {"layer0/spmm", "layer1/spmm", "layer2/spmm",
            "tier_pull_uncached", "tier_pull_refresh",
            "capgnn/step_refresh", "capgnn/step_cached"} <= names


def _backward_case(fn: str):
    """A small product through one of the three Functions with a backward
    of its own: ``(output, the input that needs a gradient)``."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(5, 4, generator=gen, requires_grad=True)
    cols = torch.tensor([[0, 1], [1, 2], [3, 4]], dtype=torch.int32)
    vals = torch.tensor([[0.5, 0.5], [1.0, 0.0], [0.25, 2.0]])
    if fn == "ell_spmm":
        return ops.ell_spmm(cols, vals, h), h
    if fn == "hybrid_spmm":
        return ops.hybrid_spmm(cols, vals, torch.tensor([4, 0]),
                               torch.tensor([0, 3]), torch.tensor([1.5, 0.0]),
                               h), h
    return ops.gather_rows(h, torch.tensor([4, 0, 4, 2])), h


@pytest.mark.parametrize("fn", ["ell_spmm", "hybrid_spmm", "gather_rows"])
def test_backward_runs_inside_transpose_range(fn):
    """Under ``torch.profiler`` on the CPU (the plain versions), the
    backward of each Function the port defines opens
    ``transpose(<the scope its forward ran under>)``, and
    ``transpose(<the op>)`` when its forward ran under none; the backward
    leaves no scope open."""
    from repro_torch.obs.annotations import current_scope
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with device_scope("layer1/spmm"):
            y, h = _backward_case(fn)
        y.square().sum().backward()
        y2, h2 = _backward_case(fn)
        y2.sum().backward()
    names = [e.name for e in prof.events()]
    assert names.count("transpose(layer1/spmm)") == 1
    assert names.count(f"transpose({fn})") == 1
    assert h.grad is not None and h2.grad is not None
    assert current_scope("none") == "none"


def test_device_scope_outside_a_capture_records_nothing():
    with device_trace(None) as path:
        assert path is None
    with device_scope("x"):
        y = torch.ones(3) * 2
    assert y.sum() == 6
    assert device_peak_bytes("cpu") is None
