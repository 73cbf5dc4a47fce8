"""Distribution strategies of the port: ``halo_1d`` only.

The JAX package's ``dist/strategy.py`` registry with its ``halo_1d``
front door (:class:`Halo1DStrategy`): layout construction
(``stack_partitions`` + ``build_exchange_plan``), the single-process and
the SPMD runtimes, the training loop, and the modeled byte count of a
refresh step.
The 1.5D replicated-row strategy ``spmm_15d`` is not ported yet:
:func:`get_strategy` raises for it, naming the strategy.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Halo1DStrategy", "HaloLayout",
           "StrategyCapabilityError", "STRATEGY_NAMES", "get_strategy"]

STRATEGY_NAMES = ("halo_1d", "spmm_15d")


class StrategyCapabilityError(ValueError):
    """A TrainSpec/operation asks for a feature the selected distribution
    strategy does not implement."""


@dataclasses.dataclass(frozen=True)
class HaloLayout:
    """halo_1d static layout: the padded ``[P, ...]`` task stacking plus
    the compiled exchange plan (tier gather/scatter index sets)."""
    sp: object                  # StackedParts
    xplan: object               # ExchangePlan

    @property
    def num_parts(self) -> int:
        return self.sp.num_parts


class Halo1DStrategy:
    """The paper's model: 1D vertex partitioning + per-layer halo exchange
    with the JACA cache tiers, bounded staleness and pipelined refresh,
    in one process over the stacked ``[P, ...]`` layout or in one process
    per partition."""
    name = "halo_1d"

    def validate_spec(self, spec) -> None:
        if spec.replication != 1:
            raise StrategyCapabilityError(
                "halo_1d has no replication axis: replication must be 1 "
                f"(got {spec.replication}); row replication is the "
                "spmm_15d strategy")

    def build_layout(self, ps, task, spec, *, plan) -> HaloLayout:
        """``plan`` is the JACA :class:`~repro_torch.core.jaca.CachePlan`."""
        from .exchange import build_exchange_plan, stack_partitions
        sp = stack_partitions(ps, task, backend=spec.backend)
        xplan = build_exchange_plan(ps, plan)
        return HaloLayout(sp=sp, xplan=xplan)

    def make_sim_runtime(self, cfg, layout, opt, spec, **kw):
        from .capgnn_sim import make_sim_runtime
        return make_sim_runtime(cfg, layout.sp, layout.xplan, opt,
                                spec=spec, **kw)

    def make_spmd_runtime(self, cfg, layout, opt, spec, group=None, **kw):
        """This rank's :class:`~repro_torch.dist.capgnn_spmd.SpmdRuntime`
        over ``group`` (one process per partition)."""
        from .capgnn_spmd import make_spmd_runtime
        return make_spmd_runtime(cfg, layout.sp, layout.xplan, opt, group,
                                 spec=spec, **kw)

    def train(self, cfg, runtime, layout, opt, spec, epochs, **kw):
        from .capgnn_sim import train_capgnn
        return train_capgnn(cfg, runtime, layout.xplan, layout.num_parts,
                            opt, epochs=epochs, spec=spec, **kw)

    def step_bytes(self, layout, cfg, spec) -> int:
        """Modeled p2p wire bytes of one *refresh* step (cached steps move
        the uncached tier only — see ``ExchangePlan.bytes_per_step``)."""
        dtype_bytes = 2 if spec.halo_dtype == "bf16" else 4
        dims = list(cfg.feat_dims[:cfg.num_layers])
        if not spec.exchange_layer0 or spec.features == "host":
            dims = dims[1:]
        return sum(layout.xplan.bytes_per_step(d, refresh=True,
                                               dtype_bytes=dtype_bytes)
                   for d in dims)


def get_strategy(name: str) -> Halo1DStrategy:
    """Resolve a strategy by registry name; ``spmm_15d`` is not ported
    yet, and unknown names fail with the valid options spelled out."""
    if name == "halo_1d":
        return _HALO_1D
    if name == "spmm_15d":
        raise NotImplementedError(
            "strategy 'spmm_15d' (1.5D replicated-row SpMM) is not ported "
            "to repro_torch yet (see ROADMAP.md); use strategy='halo_1d'")
    raise ValueError(f"unknown distribution strategy {name!r}; "
                     f"valid strategies: {', '.join(STRATEGY_NAMES)}")


_HALO_1D = Halo1DStrategy()
