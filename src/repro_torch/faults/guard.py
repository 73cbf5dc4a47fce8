"""Runtime defenses for the :mod:`repro_torch.faults` fault classes (the
JAX package's ``faults/guard.py``: the same knobs, counters and rules).

Three cooperating pieces, all sharing one :class:`DefenseEvents` counter
block so every degradation is exactly countable against the injector's
ledger:

- :class:`FetchGuard` — wraps the runtimes' host-store staging paths:
  bounded retry with exponential backoff on a failed fetch, degradation
  from prefetch-ahead to synchronous fetching after a slow/failed fetch,
  and past the retry budget *stale-tier reuse* — the consuming step is
  served the previous refresh's rows (DistGNN-style bounded staleness)
  instead of crashing, with the staleness event counted.
- :class:`TrainGuard` — train-loop defenses: a divergence guard (free
  per-step loss finiteness check + a fenced parameter finiteness check
  every ``guard_every`` steps) that rolls back to the last good in-memory
  snapshot and restages with a forced refresh; opt-in per-tier payload
  checksums over the exchange/stale buffers that detect corrupted rows
  before a step consumes them and force a refresh of the affected tier.
- :class:`GuardConfig` — the knobs, surfaced as ``launch.train gnn
  --guard-every k --fetch-retries n --checksums``.

Memory-pressure backoff lives in the loop itself (it needs the
``AdaptivePlanner``): see ``train_capgnn`` and
:meth:`repro_torch.core.jaca.AdaptivePlanner.shrink_capacity`.

The snapshot is a CPU clone of the parameters and the optimizer state;
a rollback puts it back on the live leaves' device.  A tier digest is a
CRC32 over the tensor's raw bytes on the host, read through an integer
view of the same width (numpy has no bfloat16): the checksum path
synchronises, which is why it runs only with ``checksums``.
"""
from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from ..optim import tree_leaves, tree_map
from .plan import FetchError

__all__ = ["DefenseEvents", "FetchGuard", "GuardConfig", "TrainGuard"]


@dataclasses.dataclass
class GuardConfig:
    """Defense knobs (see module docstring).  ``guard_every=0`` disables
    the divergence guard; ``checksums=False`` skips tier digests."""
    guard_every: int = 0        # snapshot + fenced finiteness cadence
    fetch_retries: int = 2      # extra attempts after a failed fetch
    fetch_timeout_s: float = 0.1   # gather slower than this counts as slow
    fetch_backoff_s: float = 0.01  # base retry backoff (doubles per retry)
    degrade_steps: int = 2      # steps to run synchronous after a slow fetch
    checksums: bool = False     # per-tier payload digests + verify
    mem_backoff_factor: float = 0.5  # capacity shrink per pressure event


@dataclasses.dataclass
class DefenseEvents:
    """Monotone defense counters.  Field names match the
    :class:`repro_torch.obs.StepCounters` fault fields one-to-one so the loop
    can attribute per-step deltas directly."""
    fetch_errors: int = 0            # failed stage attempts caught
    fetch_retries: int = 0           # retry attempts issued
    fetch_stale_reuse: int = 0       # consumptions served stale rows
    slow_fetches: int = 0            # gathers over the timeout
    prefetch_degraded_steps: int = 0  # steps run without prefetch-ahead
    corruptions_detected: int = 0    # tier digests that failed verify
    forced_refreshes: int = 0        # guard-forced refresh steps
    rollbacks: int = 0               # divergence rollbacks
    mem_backoffs: int = 0            # capacity-shrink replans

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def delta(self, before: dict) -> dict:
        now = self.as_dict()
        return {k: now[k] - before.get(k, 0) for k in now}


class FetchGuard:
    """Retry/degrade/stale-reuse wrapper around host-store staging (see
    module docstring).  Attached to a runtime via ``set_fault_guard``;
    with none attached the staging paths are byte-for-byte the original
    code."""

    def __init__(self, cfg: GuardConfig, events: DefenseEvents):
        self.cfg = cfg
        self.events = events
        self.last_good: dict = {}   # key -> last consumed device rows
        self._degraded = 0          # steps left with prefetch suspended

    # -- consumption ---------------------------------------------------------

    def consume(self, sf, store, key: str, account: bool = True):
        """Account one successfully staged fetch (unless ``account`` is
        False: a replica another store counts), remember its rows (the
        tensor ``store.ready`` returns, a fresh allocation) as the stale
        fallback for ``key``, and flag slow gathers (degrading to
        synchronous staging for ``degrade_steps`` steps)."""
        if account:
            store.account_fetch(sf)
        if sf.gather_s > self.cfg.fetch_timeout_s:
            self.events.slow_fetches += 1
            self._degraded = self.cfg.degrade_steps
        rows = store.ready(sf)
        self.last_good[key] = rows
        return rows

    def fetch_sync(self, stage_fn, store, key: str, account: bool = True):
        """Synchronous staged fetch with bounded retry + backoff; past the
        budget, serve the previous refresh's rows (stale-tier reuse)."""
        attempts = 1 + max(0, self.cfg.fetch_retries)
        for i in range(attempts):
            if i > 0:
                self.events.fetch_retries += 1
                with store.tracer.span("fetch_retry", attempt=i, key=key):
                    time.sleep(self.cfg.fetch_backoff_s * (2 ** (i - 1)))
            try:
                sf = stage_fn()
            except FetchError:
                self.events.fetch_errors += 1
                continue
            return self.consume(sf, store, key, account)
        stale = self.last_good.get(key)
        if stale is None:
            raise FetchError(
                f"host fetch {key!r} failed after {attempts} attempts and "
                "no previously consumed rows exist to reuse")
        self.events.fetch_stale_reuse += 1
        return stale

    # -- prefetch ------------------------------------------------------------

    def try_stage(self, stage_fn):
        """Prefetch-path staging: a failure is caught and counted, the
        ring stays short, and consumption degrades to the synchronous
        retry path above."""
        try:
            return stage_fn()
        except FetchError:
            self.events.fetch_errors += 1
            return None

    def prefetch_ok(self) -> bool:
        """One call per step from the prefetch refill: while degraded,
        skip refilling (synchronous mode) and count the step."""
        if self._degraded > 0:
            self._degraded -= 1
            self.events.prefetch_degraded_steps += 1
            return False
        return True


_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _digest(arr) -> int:
    """Content digest of one tier payload: CRC32 over its raw bytes on the
    host (a device tensor is copied back, which synchronises — the
    checksum defense is opt-in precisely because of this), read through a
    same-width integer view so every dtype, bfloat16 included, digests."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        arr = t.view(_INT_OF_WIDTH[t.element_size()]).numpy()
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def tier_digests(caches: dict, store=None) -> dict:
    """Per-tier payload digests over the stale exchange buffers: device
    local/global caches plus host-resident global buffers."""
    d = {}
    for li, c in enumerate(caches["local"]):
        d[f"local{li}"] = _digest(c)
    for li, c in enumerate(caches["global"]):
        d[f"global{li}"] = _digest(c)
    if store is not None:
        for li in store.buf_layers():
            d[f"hostbuf{li}"] = _digest(store.buf_table(li))
    return d


class TrainGuard:
    """Train-loop defense state: checksum seal/verify + divergence
    snapshot/rollback.  Owns the run's :class:`DefenseEvents` and the
    :class:`FetchGuard` the runtimes consult."""

    def __init__(self, cfg: GuardConfig, store=None):
        self.cfg = cfg
        self.store = store
        self.events = DefenseEvents()
        self.fetch_guard = FetchGuard(cfg, self.events)
        self._sealed: dict | None = None
        self._snap = None           # (params, opt_state) host copies

    # -- payload checksums -----------------------------------------------

    def seal(self, caches: dict) -> None:
        """Record the post-step tier digests (the values the next
        consuming step must still observe)."""
        if self.cfg.checksums:
            self._sealed = tier_digests(caches, self.store)

    def verify(self, caches: dict) -> list[str]:
        """Compare current tier digests against the seal; returns the
        corrupted tier names (each counted as one detection)."""
        if not self.cfg.checksums or self._sealed is None:
            return []
        now = tier_digests(caches, self.store)
        bad = [k for k, v in self._sealed.items() if now.get(k) != v]
        self.events.corruptions_detected += len(bad)
        return bad

    # -- divergence guard --------------------------------------------------

    def snapshot(self, step: int, params, opt_state) -> None:
        """CPU clones of the training state — the rollback target."""
        def host(t):
            return t.detach().to("cpu", copy=True)
        self._snap = (step, tree_map(host, params), tree_map(host, opt_state))

    def params_finite(self, params) -> bool:
        """Finiteness sweep over the parameter leaves (one read back)."""
        return bool(torch.stack([torch.isfinite(leaf).all()
                                 for leaf in tree_leaves(params)]).all())

    def rollback(self, params, opt_state):
        """Restore the last good snapshot, put back on the live leaves'
        devices (fresh tensors: nothing live is written).  The caller
        must run the next step as a plain refresh: the caches emitted
        alongside the divergent update are poisoned and a refresh
        rewrites every tier without consuming any of them."""
        if self._snap is None:
            raise RuntimeError("divergence detected before any snapshot; "
                               "guard_every must take an initial snapshot")
        _, snap_p, snap_o = self._snap

        def put(snap, like):
            return tree_map(lambda s, l: s.to(l.device, copy=True), snap,
                            like)
        self.events.rollbacks += 1
        return put(snap_p, params), put(snap_o, opt_state)

    @property
    def snap_step(self) -> int | None:
        return self._snap[0] if self._snap is not None else None
