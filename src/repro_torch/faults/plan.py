"""Seeded, step-addressed fault injection plan (the JAX package's
``faults/plan.py``: the same spec grammar, errors and draws).

A :class:`FaultPlan` is threaded through ``train_capgnn`` / both runtimes
/ :class:`~repro_torch.dist.host_store.HostFeatureStore` and fires its
injectors only on the steps its spec marks.  Injection is
**deterministic**: the spec pins the fault steps, and any randomised
choice (which tier to corrupt) derives from ``(seed, step)`` through the
same numpy draw as the JAX package's — re-running the same plan
reproduces the same fault sequence bit-for-bit, which is what lets the
tests assert ``injected == defended`` exactly, and the same tier as the
JAX package's plan.

Spec grammar (the ``--faults`` CLI string)::

    spec      := clause (";" clause)*
    clause    := kind "@" step ("," step)* (":" key "=" value ("," ...))?
    kind      := fetch_drop | fetch_delay | halo_corrupt | grad_nan
               | mem_pressure | ckpt_truncate

e.g. ``"fetch_drop@3,7;grad_nan@5;halo_corrupt@4,9:rows=8"``.

Every injector increments :attr:`FaultPlan.injected` so the training
report can publish exact injection counts next to the defense counters.
The disabled plan (:data:`NULL_FAULTS`, or any plan outside
``begin_step``/``end_run``) never fires — stores and runtimes consult it
with one attribute check on their hot paths.  The injectors that touch
tensors write into clones and return them: a tensor the guard's snapshot
or the optimizer state still references is never written in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FAULT_KINDS", "FaultPlan", "FaultSpec", "FetchError",
           "NULL_FAULTS"]

FAULT_KINDS = ("fetch_drop", "fetch_delay", "halo_corrupt", "grad_nan",
               "mem_pressure", "ckpt_truncate")


class FetchError(RuntimeError):
    """A host-store staged fetch failed (injected drop, or a real staging
    error surfaced through the same defense path)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault clause: a kind, the steps it fires on, and knobs."""
    kind: str
    steps: tuple
    delay_s: float = 0.25     # fetch_delay: host-side stall per stage op
    rows: int = 4             # halo_corrupt: payload rows overwritten
    value: float = 1e30       # halo_corrupt: fill value (never a real row)
    frac: float = 0.5         # ckpt_truncate: fraction of the file kept

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if not self.steps or any(int(s) < 0 for s in self.steps):
            raise ValueError(f"{self.kind}: needs >=1 non-negative step, "
                             f"got {self.steps!r}")


_FLOAT_KEYS = ("delay_s", "value", "frac")
_INT_KEYS = ("rows",)


class FaultPlan:
    """Step-addressed injector set.  Hooks are consulted by the training
    loop (``corrupt_params`` / ``corrupt_caches`` / ``mem_pressure``), the
    host store (``on_fetch``) and checkpoint tooling
    (``truncate_checkpoint``); each no-ops unless the plan is enabled AND
    the current step (set via :meth:`begin_step`) is marked for that kind.
    """

    def __init__(self, specs=(), seed: int = 0, enabled: bool | None = None):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.enabled = bool(self.specs) if enabled is None else enabled
        self.injected: dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._step: int | None = None
        self._by_kind: dict[str, FaultSpec] = {}
        for s in self.specs:
            if s.kind in self._by_kind:
                raise ValueError(f"duplicate fault clause for {s.kind!r}")
            self._by_kind[s.kind] = s

    # -- spec parsing --------------------------------------------------------

    @classmethod
    def parse(cls, spec: str | None, seed: int = 0) -> "FaultPlan":
        """Build a plan from the ``--faults`` spec string (see module
        docstring); ``None``/empty returns the disabled plan."""
        if not spec:
            return cls(())
        specs = []
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            head, _, opts = clause.partition(":")
            kind, at, steps_s = head.partition("@")
            if not at or not steps_s:
                raise ValueError(
                    f"fault clause {clause!r} must be kind@step[,step...]")
            kw: dict = {"kind": kind.strip(),
                        "steps": tuple(int(s) for s in steps_s.split(",")
                                       if s.strip())}
            for kv in (o for o in opts.split(",") if o.strip()):
                key, eq, val = kv.partition("=")
                key = key.strip()
                if not eq:
                    raise ValueError(f"fault option {kv!r} must be key=value")
                if key in _FLOAT_KEYS:
                    kw[key] = float(val)
                elif key in _INT_KEYS:
                    kw[key] = int(val)
                else:
                    raise ValueError(
                        f"unknown fault option {key!r} in {clause!r}; "
                        f"expected one of {_FLOAT_KEYS + _INT_KEYS}")
            specs.append(FaultSpec(**kw))
        return cls(specs, seed=seed)

    def spec_string(self) -> str:
        """Inverse of :meth:`parse` (step lists only, default knobs elided
        when untouched) — used for provenance stamping."""
        return ";".join(f"{s.kind}@{','.join(str(t) for t in s.steps)}"
                        for s in self.specs)

    # -- step addressing -----------------------------------------------------

    def begin_step(self, step: int) -> None:
        """Arm the plan for training step ``step``; injectors fire only
        between ``begin_step`` and :meth:`end_run` (setup and post-loop
        evaluation are never faulted)."""
        self._step = int(step)

    def end_run(self) -> None:
        self._step = None

    def _active(self, kind: str) -> FaultSpec | None:
        if not self.enabled or self._step is None:
            return None
        s = self._by_kind.get(kind)
        return s if (s is not None and self._step in s.steps) else None

    def has(self, kind: str) -> bool:
        return kind in self._by_kind

    def total_injected(self) -> int:
        return sum(self.injected.values())

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng((self.seed, int(self._step or 0)))

    # -- injectors -----------------------------------------------------------

    def on_fetch(self) -> None:
        """Host-store hook, called once per stage op.  Raises
        :class:`FetchError` on a marked ``fetch_drop`` step (every stage
        attempt in that step fails — retries within the step exhaust and
        degrade to stale reuse) or stalls on a marked ``fetch_delay`` step.
        Every raise/stall is one injected event; the defenses catch each
        exactly once, so the counts match by construction."""
        s = self._active("fetch_drop")
        if s is not None:
            self.injected["fetch_drop"] += 1
            raise FetchError(
                f"injected fetch drop at step {self._step}")
        s = self._active("fetch_delay")
        if s is not None:
            import time
            self.injected["fetch_delay"] += 1
            time.sleep(s.delay_s)

    def corrupt_params(self, params):
        """``grad_nan``: poison one parameter leaf before the step — the
        step's gradients (and loss) come out non-finite, exactly what a
        bad reduction or overflowing update produces.

        The leaf is the JAX package's leaf 0 (its flatten takes the layers
        in order and each layer's keys sorted): element ``(0, ..., 0)`` of
        ``params[0][sorted(params[0])[0]]``, written into a clone under
        ``no_grad``; returns new params."""
        s = self._active("grad_nan")
        if s is None:
            return params
        self.injected["grad_nan"] += 1
        key = sorted(params[0])[0]
        with torch.no_grad():
            leaf = params[0][key].clone()
            leaf[(0,) * leaf.dim()] = float("nan")
        return [{**params[0], key: leaf}] + list(params[1:])

    def corrupt_caches(self, caches: dict, store=None):
        """``halo_corrupt``: overwrite ``rows`` payload rows of one
        (seed, step)-chosen stale tier — a device local/global cache
        entry, or a host-resident global buffer when ``store`` holds them.
        The tiers are drawn from in the JAX package's order (local layers,
        global layers, host buffers, each only if non-empty), so the same
        plan picks the same tier name.  Returns ``(caches, tier_name |
        None)``; a device tier is written into a clone."""
        s = self._active("halo_corrupt")
        if s is None:
            return caches, None
        tiers = [("local", li) for li, c in enumerate(caches["local"])
                 if c.shape[1] > 0]
        tiers += [("global", li) for li, c in enumerate(caches["global"])
                  if c.shape[0] > 0]
        if store is not None:
            tiers += [("hostbuf", li) for li in store.buf_layers()
                      if store.buf_table(li).shape[0] > 0]
        if not tiers:
            return caches, None
        where, li = tiers[int(self._rng().integers(len(tiers)))]
        self.injected["halo_corrupt"] += 1
        if where == "hostbuf":
            buf = store.buf_table(li).copy()
            buf[: max(1, min(s.rows, buf.shape[0]))] = s.value
            store.set_buf(li, buf)
            return caches, f"hostbuf{li}"
        out = dict(caches)
        out[where] = list(caches[where])
        c = caches[where][li].clone()
        k = max(1, min(s.rows, c.shape[1] if where == "local" else c.shape[0]))
        with torch.no_grad():
            if where == "local":
                c[:, :k, :] = s.value
            else:
                c[:k, :] = s.value
        out[where][li] = c
        return out, f"{where}{li}"

    def mem_pressure(self) -> bool:
        """``mem_pressure``: signal simulated device-memory pressure for
        this step (the defense shrinks the cache capacity and replans)."""
        if self._active("mem_pressure") is None:
            return False
        self.injected["mem_pressure"] += 1
        return True

    # -- file-level injector ---------------------------------------------

    def truncate_checkpoint(self, path: str) -> int:
        """``ckpt_truncate``: truncate ``path`` to ``frac`` of its size
        (step-independent — checkpoint faults address files, not steps).
        Returns the new byte length."""
        import os
        s = self._by_kind.get("ckpt_truncate")
        frac = s.frac if s is not None else 0.5
        size = os.path.getsize(path)
        keep = max(1, int(size * frac))
        with open(path, "r+b") as f:
            f.truncate(keep)
        self.injected["ckpt_truncate"] += 1
        return keep


NULL_FAULTS = FaultPlan(())
