"""Cost roll-up of the operations PyTorch dispatches: the JAX package's
``launch/hlo_cost.py`` for the port.  There is no HLO to parse: the port
runs eagerly, so every loop iteration (each layer, each attention chunk,
each scan step) dispatches its own operations and is counted as it runs,
and the reference's ``unresolved_loops`` is 0 by construction.

:class:`OpCounter` is a ``TorchDispatchMode``.  It lets a DTensor
operation desugar first (it returns ``NotImplemented`` for DTensor
arguments, as ``CommDebugMode`` does), so it counts what one device runs:
the local operations on each rank's shards and the collectives DTensor and
the manual regions issue.  Per operation it adds

- FLOPs from PyTorch's FLOP formulas (``torch.utils.flop_counter``):
  a matmul, ``bmm``, ``einsum``'s products and attention count
  ``2 * M * N * K`` as the reference counts a ``dot``; elementwise
  operations count none (they ride on the bytes);
- bytes: the sizes of its tensor operands and results, for every
  operation that is not a view (the reference's unfused count: nothing
  is fused in eager mode);
- collectives, by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``,
  ``broadcast``): the result bytes and the count, over the functional
  collectives (``_c10d_functional``, what DTensor and
  ``dist.collectives.mesh_*`` issue), the ``c10d`` ops of the
  process-group API and ``repro_torch::all_to_all``;
- the port's attention ops (``repro_torch::flash_attention``, its
  backward, ``repro_torch::decode_attention``): one operation each, its
  FLOPs from the formula registered beside it (``kernels.flash_attn``)
  and its bytes those of its operands and results, on every device.

DTensor derives each new operation's output shape by running it once on
fake global-shape tensors (``ShardingPropagator``, on a cache miss); those
runs are metadata, not work, and the counter pauses over them, so a cold
and a warm run count the same.

The same counter runs on the ``fake`` process group of the dry run (under
``FakeTensorMode``), on gloo ranks in the tests, and on the card, so its
figures compare across the three.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["HloCost", "OpCounter", "analyse_ops", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

# operation name (without overload) -> collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "all_to_all": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d")
# operations that move no data of their own
_FREE = {"wait_tensor", "detach", "alias", "lift_fresh", "_unsafe_view"}


@dataclasses.dataclass
class HloCost:
    """Per-device totals (the reference's record of the same name)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    unresolved_loops: int = 0

    @property
    def collective_total(self) -> float:
        return float(sum(self.collective_bytes.values()))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _tensor_bytes(tree) -> int:
    return sum(_nbytes(x) for x in tree_flatten(tree)[0])


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives of the operations one device
    runs while it is entered (``with OpCounter() as c: ...``; ``c.cost``
    is the :class:`HloCost`)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.cost = HloCost()

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def paused(self_, op_schema):
            counter._paused += 1
            try:
                return prop(self_, op_schema)
            finally:
                counter._paused -= 1

        self._paused = 0
        self._restore = prop
        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._restore
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # let DTensor desugar first
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        ns = func.namespace
        name = packet.__name__
        kind = _KINDS.get(name)
        if kind is not None or ns in _COLL_NAMESPACES:
            if kind is not None:
                self.cost.collective_bytes[kind] += _tensor_bytes(out)
                self.cost.collective_counts[kind] += 1
                self.cost.bytes_accessed += (_tensor_bytes((args, kwargs))
                                             + _tensor_bytes(out))
            return
        fn = self._flops.get(packet)
        if fn is not None:
            self.cost.flops += fn(*args, **kwargs, out_val=out)
        if func.is_view or name in _FREE or ns == "prim":
            return
        self.cost.bytes_accessed += (_tensor_bytes((args, kwargs))
                                     + _tensor_bytes(out))


def analyse_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), HloCost)``: the operations ``fn`` runs on
    this device, counted by :class:`OpCounter`."""
    with OpCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.cost
