"""Bounded-staleness control (paper §4.2 'Staleness in CaPGNN', Thm. 1).

The runtime alternates between a *refresh* step (cached halo embeddings
re-synchronised) and *cached* steps (stale values reused).  The controller
decides which step to run; the fixed-period policy is the paper's; the
adaptive policy (paper §6 'Adaptive Staleness Control' future work) shrinks
the period when the measured embedding drift approaches the epsilon_H bound
— implemented here as a beyond-paper feature.

The controller also schedules *re-planning* for the online cache
adaptation loop (:class:`~repro_torch.core.jaca.AdaptivePlanner`):
tier membership may only change at a refresh boundary (the refresh
rewrites every cache row, so a re-ranked plan never reads rows laid out
by its predecessor), and ``replan_every`` thins that further to every
k-th refresh — re-ranking costs host time, so it should pay for itself
in saved exchange rows.

A numpy copy of the JAX package's ``core/staleness.py`` (the same
schedule for the same calls).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StalenessController", "theorem1_bound"]


@dataclasses.dataclass
class StalenessController:
    refresh_every: int = 4          # tau; 1 => fully synchronous
    adaptive: bool = False
    eps_h: float = 1.0              # target staleness bound on ||H - H_hat||_inf
    shrink: float = 0.5
    grow: float = 1.25
    min_period: int = 1
    max_period: int = 64
    replan_every: int = 1           # re-rank tiers every k-th refresh
    _step: int = 0
    _period: float = 0.0
    _refreshes: int = 0

    def __post_init__(self):
        self._period = float(self.refresh_every)

    def should_refresh(self) -> bool:
        """True if the upcoming step must be a refresh step."""
        return self._step % max(1, int(round(self._period))) == 0

    def should_replan(self) -> bool:
        """True if the upcoming step is a refresh boundary at which the
        adaptive planner may install a re-ranked plan.  Never true on the
        warm-up step (step 0's refresh populates the initial plan's
        caches), then every ``replan_every``-th refresh."""
        return (self.should_refresh() and self._step > 0
                and self._refreshes % max(1, self.replan_every) == 0)

    def observe(self, drift_inf_norm: float | None = None,
                refreshed: bool | None = None) -> None:
        """Advance one step; with ``adaptive``, tune the period from the
        measured ||H - H_hat||_inf drift of the last refresh.
        ``refreshed`` records whether the executed step actually was a
        refresh (defaults to what ``should_refresh`` prescribed)."""
        was_refresh = (self.should_refresh() if refreshed is None
                       else refreshed)
        if was_refresh:
            self._refreshes += 1
        self._step += 1
        if self.adaptive and drift_inf_norm is not None:
            if drift_inf_norm > self.eps_h:
                self._period = max(self.min_period, self._period * self.shrink)
            else:
                self._period = min(self.max_period, self._period * self.grow)

    @property
    def period(self) -> int:
        return max(1, int(round(self._period)))

    @property
    def step(self) -> int:
        return self._step


def theorem1_bound(loss_gap: float, rho: float, alpha: float, t: int) -> float:
    """Paper Eq. 9: E_R ||grad L(W_R)||_F^2 <= 2(L(W1)-L(W*))/sqrt(T) +
    rho*alpha/(2 sqrt(T)).  Used by the convergence benchmark to check the
    measured gradient norms sit under the theoretical envelope."""
    t = max(1, t)
    return 2.0 * loss_gap / np.sqrt(t) + rho * alpha / (2.0 * np.sqrt(t))
