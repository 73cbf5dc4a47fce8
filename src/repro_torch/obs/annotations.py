"""Device-side visibility helpers (the JAX package's ``obs/annotations.py``):
named ranges around device work and host dispatch sites, and an opt-in
``torch.profiler`` capture directory.

``device_scope`` and ``host_annotation`` are ``torch.profiler.
record_function`` ranges.  With no capture running a range records
nothing: it launches no device work and synchronises nothing.  Under
:func:`device_trace` the profiler attributes the kernels launched inside a
range to it (the CUDA activity of the capture puts each kernel under the
range that launched it).

The backward of an autograd Function runs on autograd's thread, outside
the ranges its forward ran under.  So ``device_scope`` also keeps a stack
of the open scopes' names per thread (:func:`current_scope`): the port's
Functions keep the innermost name at their forward and open
``transpose(<name>)`` around their backward (:func:`transpose_scope`), as
the names of JAX's transposed ops carry their forward's ``named_scope``.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch

__all__ = ["device_scope", "host_annotation", "annotate_function",
           "device_trace", "current_scope", "transpose_scope"]

_open = threading.local()


def _stack() -> list:
    stack = getattr(_open, "names", None)
    if stack is None:
        stack = _open.names = []
    return stack


class _Scope:
    """A ``record_function`` range whose name sits on this thread's stack
    of open device scopes while it is open."""

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        _stack().append(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            _stack().pop()
        return False


def device_scope(name: str):
    """Name a region of device work (layer loop, tier pulls, refresh
    rings, SpMM): the kernels it launches land under ``name`` in a
    capture."""
    return _Scope(name)


def current_scope(default: str) -> str:
    """The name of the innermost device scope open on this thread, or
    ``default`` when none is."""
    stack = _stack()
    return stack[-1] if stack else default


def transpose_scope(forward_scope: str):
    """The range of a backward whose forward ran under ``forward_scope``:
    ``transpose(<forward_scope>)``."""
    return _Scope(f"transpose({forward_scope})")


def host_annotation(name: str):
    """Annotate a host-side dispatch site (step call, h2d staging) so an
    active capture shows it on the host track."""
    return torch.profiler.record_function(name)


def annotate_function(fn, name: str | None = None):
    """``fn`` with every call inside a ``record_function`` range named
    ``name`` (``fn.__qualname__`` when None): the JAX package's
    ``jax.profiler.annotate_function``."""
    label = name if name is not None else fn.__qualname__

    @functools.wraps(fn)
    def annotated(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return annotated


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
