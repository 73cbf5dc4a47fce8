"""CaPGNN partition-parallel substrate of the port.

- :mod:`.exchange` — compile a JACA cache plan into static gather/scatter
  index sets; stack partitions into the padded ``[P, ...]`` layout (numpy).
- :mod:`.capgnn_sim` — the single-process stacked training runtime
  (tier primitives, aggregation backends, steps, ``train_capgnn``);
- :mod:`.capgnn_spmd` — the same steps with one process per partition
  over a ``torch.distributed`` group, both halo transports;
- :mod:`.collectives` — the exchange's collectives as autograd Functions
  and the counting :class:`~.collectives.Wire`;
- :mod:`.spec`, :mod:`.strategy` — ``TrainSpec``, the strategy interface
  and registry (``halo_1d``'s front door);
- :mod:`.strategy_15d` — the 1.5D replicated-row strategy ``spmm_15d``:
  its numpy layout and byte models, and its runtime with one process per
  device (permute, gather and all-reduce per layer).
- :mod:`.host_store` — the host-resident store (JACA's CPU tier) behind
  the runtimes' ``features="host"`` mode and the serve engine's host
  tier: a ring of pinned slots, side-stream copies, host global buffers.
"""
from .exchange import (ExchangeCapacity, ExchangePlan, ExchangeTier,
                       GlobalTier, HostTier, StackedEllPack, StackedParts,
                       build_exchange_plan, exchange_capacity,
                       stack_partitions)
from .host_store import (HostFeatureStore, StagedFetch, halo_dtype_info,
                         suggest_prefetch_depth)
from .capgnn_sim import (RUNTIME_BACKENDS, RUNTIME_FEATURES, check_backend,
                         make_adj_builder, exchange_arrays, init_caches,
                         SimRuntime, make_sim_runtime, TrainReport,
                         train_capgnn)
from .capgnn_spmd import (TRANSPORTS, SpmdRuntime, make_spmd_runtime,
                          spmd_exchange_arrays)
from .collectives import Wire
from .spec import TrainSpec
from .strategy import (DistStrategy, Halo1DStrategy, StrategyCaps,
                       StrategyCapabilityError, get_strategy)

__all__ = [
    "ExchangeCapacity", "ExchangePlan", "ExchangeTier", "GlobalTier",
    "HostTier", "StackedEllPack", "StackedParts", "build_exchange_plan",
    "exchange_capacity", "stack_partitions",
    "HostFeatureStore", "StagedFetch", "halo_dtype_info",
    "suggest_prefetch_depth", "RUNTIME_BACKENDS", "RUNTIME_FEATURES",
    "check_backend", "make_adj_builder",
    "exchange_arrays", "init_caches", "SimRuntime", "make_sim_runtime",
    "TrainReport", "train_capgnn", "TRANSPORTS", "SpmdRuntime",
    "make_spmd_runtime", "spmd_exchange_arrays", "Wire", "TrainSpec",
    "DistStrategy", "Halo1DStrategy", "StrategyCaps",
    "StrategyCapabilityError", "get_strategy",
]
