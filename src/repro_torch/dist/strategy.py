"""Pluggable distribution strategies of the port (the JAX package's
``dist/strategy.py``).

A :class:`DistStrategy` owns the three things that define how the graph
is distributed:

1. **Layout construction** — turning a ``PartitionSet`` + task into the
   stacked arrays and index programs of one model (``halo_1d``:
   ``stack_partitions`` + ``build_exchange_plan``; ``spmm_15d``: block-row
   stacking + per-replica edge chunks).
2. **Per-layer collective steps** — the runtime whose steps run that
   model's exchange (halo tier pulls vs permute/gather/all-reduce), in one
   process or one process per device over ``torch.distributed``.
3. **The byte-accounting contract** — modeled == counted bytes (the
   :class:`~.collectives.Wire` counts of the SPMD runtimes).

Strategies declare *capabilities* (:class:`StrategyCaps`): the JACA cache
tiers, bounded staleness, pipelined refresh and the host feature store
are ``halo_1d`` machinery; ``spmm_15d`` runs refresh-equivalent exact
steps with its own exact byte model.  ``TrainSpec`` validation routes
through :meth:`DistStrategy.validate_spec`, so an unsupported combination
fails at spec-build time with a message naming the strategy.

Registry::

    get_strategy("halo_1d")   # -> Halo1DStrategy
    get_strategy("spmm_15d")  # -> Spmm15DStrategy (strategy_15d.py)
    get_strategy("2d")        # -> ValueError naming valid options
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

__all__ = ["StrategyCaps", "DistStrategy", "Halo1DStrategy", "HaloLayout",
           "StrategyCapabilityError", "STRATEGY_NAMES", "get_strategy"]

STRATEGY_NAMES = ("halo_1d", "spmm_15d")


class StrategyCapabilityError(ValueError):
    """A TrainSpec/operation asks for a feature the selected distribution
    strategy does not implement (e.g. host features under spmm_15d)."""


@dataclasses.dataclass(frozen=True)
class StrategyCaps:
    """What a distribution strategy supports — the capability matrix the
    README documents and ``TrainSpec`` validates against."""
    jaca_tiers: bool            # local/global cache tiers + staleness
    pipeline: bool              # overlapped refresh (step_pipelined)
    host_features: bool         # out-of-core host feature store
    adaptive_cache: bool        # AdaptivePlanner live re-planning
    fault_guard: bool           # repro_torch.faults injection + defenses
    sim_runtime: bool           # single-process stacked oracle available
    transports: tuple           # SPMD wire lowerings
    backends: tuple             # local aggregation operators
    models: tuple               # GNN kinds the step functions implement
    replicated: bool            # uses a replication factor c > 1


@runtime_checkable
class DistStrategy(Protocol):
    """The distribution-model interface.  ``build_layout`` compiles the
    static index programs, ``make_*_runtime`` builds the steps over them,
    ``train`` runs the strategy's loop, and the ``*_bytes`` methods are
    the modeled side of the byte-accounting contract."""
    name: str
    caps: StrategyCaps

    def validate_spec(self, spec) -> None: ...
    def build_layout(self, ps, task, spec, **kw): ...
    def make_sim_runtime(self, cfg, layout, opt, spec, **kw): ...
    def make_spmd_runtime(self, cfg, layout, opt, spec, group, **kw): ...
    def train(self, cfg, runtime, layout, opt, spec, epochs, **kw): ...
    def step_bytes(self, layout, cfg, spec) -> int: ...
    def forward_collective_bytes(self, layout, cfg, spec, mesh_size) -> int: ...


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
    adaptive re-planning, the host feature store and both wire transports,
    in one process over the stacked ``[P, ...]`` layout or in one process
    per partition."""
    name = "halo_1d"
    caps = StrategyCaps(jaca_tiers=True, pipeline=True, host_features=True,
                        adaptive_cache=True, fault_guard=True,
                        sim_runtime=True,
                        transports=("allgather", "p2p"),
                        backends=("edges", "ell", "hybrid"),
                        models=("gcn", "sage", "gat", "gin"),
                        replicated=False)

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

    def forward_collective_bytes(self, layout, cfg, spec,
                                 mesh_size) -> int:
        """The modeled p2p per-device refresh figure (the SPMD runtime's
        ``Wire`` counts under ``p2p`` sum to :meth:`step_bytes` over the
        ranks)."""
        return self.step_bytes(layout, cfg, spec) // max(1, mesh_size)


def get_strategy(name: str) -> DistStrategy:
    """Resolve a strategy by registry name; unknown names fail with the
    valid options spelled out."""
    if name == "halo_1d":
        return _HALO_1D
    if name == "spmm_15d":
        from .strategy_15d import SPMM_15D
        return SPMM_15D
    raise ValueError(f"unknown distribution strategy {name!r}; "
                     f"valid strategies: {', '.join(STRATEGY_NAMES)}")


_HALO_1D = Halo1DStrategy()
