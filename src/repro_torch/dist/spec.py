"""``TrainSpec`` — the one configuration surface of the port's training
runtime.

The JAX package's ``dist/spec.py`` with every field name, default,
validation rule, ``to_dict`` and ``from_cli_args`` kept, so that a
``TrainReport.spec`` dict of either package compares equal to the other's
for the same flags.  The port builds its runtime through a spec only: the
JAX package's deprecated loose-keyword shims are not carried over.

Three fields select nothing in the port and are kept for the dict's sake:
``interpret`` (a kernel runs by its tensors' device: the plain version on
the CPU, the CUDA kernel on the card), ``donate`` (PyTorch runs eagerly;
the steps return new state and the caller drops the old) and
``pallas_pack`` (the SPMD runtime's per-peer pack is always the row
gather, ``ops.pack_rows``, dispatched by device).
"""
from __future__ import annotations

import dataclasses

__all__ = ["TrainSpec", "BACKENDS", "TRANSPORTS", "FEATURES",
           "HALO_DTYPES", "CACHE_POLICIES"]

BACKENDS = ("edges", "ell", "hybrid")
TRANSPORTS = ("allgather", "p2p")
FEATURES = ("device", "host")
HALO_DTYPES = ("f32", "bf16")
CACHE_POLICIES = ("static", "overlap", "lru", "fifo", "drift")


def _check(value, name: str, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"unknown {name} {value!r}; expected one of "
                         f"{tuple(allowed)}")


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Validated, serialisable configuration of one distributed training
    run.  Object-valued collaborators (host store, mesh, planner, tracer)
    are *not* spec fields — they stay explicit runtime arguments; the
    spec holds everything that is a choice, not a resource.
    """
    # distribution model (repro_torch.dist.strategy registry)
    strategy: str = "halo_1d"
    replication: int = 1            # 1.5D row-replication factor c
    # runtime construction
    backend: str = "edges"          # local aggregation operator
    transport: str = "allgather"    # SPMD halo transport (halo_1d)
    features: str = "device"        # feature residency: device | host
    halo_dtype: str = "f32"         # wire payload dtype (f32 | bf16)
    exchange_layer0: bool = True
    donate: bool = True             # selects nothing in the port
    interpret: bool = True          # selects nothing in the port
    pallas_pack: bool = False       # selects nothing in the port
    prefetch_depth: int = 2         # host-store double-buffer depth
    # staleness / caching schedule (halo_1d)
    pipeline: bool = False
    refresh_every: int = 1
    cache_policy: str = "static"
    replan_every: int = 1
    cpu_cache_gib: float = 4.0
    # fault injection + defenses (repro_torch.faults)
    faults: str = ""
    guard_every: int = 0
    fetch_retries: int | None = None
    checksums: bool = False
    seed: int = 0

    def __post_init__(self):
        _check(self.backend, "backend", BACKENDS)
        _check(self.transport, "transport", TRANSPORTS)
        _check(self.features, "features mode", FEATURES)
        _check(self.halo_dtype, "halo dtype", HALO_DTYPES)
        _check(self.cache_policy, "cache policy", CACHE_POLICIES)
        if self.replication < 1:
            raise ValueError(f"replication must be >= 1, got "
                             f"{self.replication}")
        if self.refresh_every < 1:
            raise ValueError(f"refresh_every must be >= 1, got "
                             f"{self.refresh_every}")
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got "
                             f"{self.prefetch_depth}")
        # strategy-capability validation (late import: strategy.py type-
        # checks against specs, keeping this module import-cycle-free)
        from .strategy import get_strategy
        get_strategy(self.strategy).validate_spec(self)

    # ------------------------------------------------------------- I/O
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_cli_args(cls, args) -> "TrainSpec":
        """Build a spec from ``launch.train gnn``-style flags.  ``args``
        is any object carrying the flag attributes (missing attributes
        fall back to the CLI defaults)."""
        def get(name, default):
            return getattr(args, name, default)

        strategy = get("strategy", "halo_1d")
        spec = dict(
            strategy=strategy,
            replication=int(get("replication", 1)),
            backend=get("backend", "edges"),
            transport=get("transport", "allgather"),
            features=get("features", "device"),
            halo_dtype=get("halo_dtype", "f32"),
            exchange_layer0=not get("jaca", True),
            donate=get("donate", True),
            interpret=get("interpret", True),
            pallas_pack=get("pallas_pack", False),
            prefetch_depth=int(get("prefetch_depth", 2)),
            pipeline=bool(get("pipeline", False)),
            refresh_every=int(get("refresh_every", 1)),
            cache_policy=get("cache_policy", "static"),
            replan_every=int(get("replan_every", 1)),
            cpu_cache_gib=float(get("cpu_cache_gib", 4.0)),
            faults=get("faults", ""),
            guard_every=int(get("guard_every", 0) or 0),
            fetch_retries=get("fetch_retries", None),
            checksums=bool(get("checksums", False)),
            seed=int(get("seed", 0)),
        )
        if strategy == "spmm_15d":
            # the JAX package's normalisation: every 1.5D step is exact, so
            # the CLI's halo-only defaults (pipelined refresh, staleness,
            # the cache policy) do not apply; an explicit halo-only request
            # that survives this is refused by Spmm15DStrategy.validate_spec
            spec.update(pipeline=False, refresh_every=1,
                        cache_policy="static", replan_every=1)
        return cls(**spec)
