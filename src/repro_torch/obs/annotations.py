"""Device-side visibility helpers (the JAX package's ``obs/annotations.py``):
named ranges around device work and host dispatch sites, and an opt-in
``torch.profiler`` capture directory.

``device_scope`` and ``host_annotation`` are ``torch.profiler.
record_function`` ranges.  With no capture running a range records
nothing: it launches no device work and synchronises nothing.  Under
:func:`device_trace` the profiler attributes the kernels launched inside a
range to it (the CUDA activity of the capture puts each kernel under the
range that launched it).
"""
from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["device_scope", "host_annotation", "device_trace"]


def device_scope(name: str):
    """Name a region of device work (layer loop, tier pulls, refresh
    rings, SpMM): the kernels it launches land under ``name`` in a
    capture."""
    return torch.profiler.record_function(name)


def host_annotation(name: str):
    """Annotate a host-side dispatch site (step call, h2d staging) so an
    active capture shows it on the host track."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device="cuda"):
    """Opt-in profiler capture: wraps the body in ``torch.profiler.
    profile`` when a directory is given and writes its Chrome trace to
    ``trace_dir/device_trace.json`` (open in Perfetto); yields that path,
    or None with no directory (no capture).  The capture asks for CUDA
    activity only when ``device`` is a CUDA device."""
    if not trace_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "device_trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
