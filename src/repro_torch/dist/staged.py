"""The ``staged`` backend: collectives of CUDA tensors over gloo, staged
through pinned host buffers, for the DTensor mesh of ranks that share one
card.

NCCL refuses two ranks on one GPU, and gloo takes the collectives a
DTensor mesh issues (all-gather, reduce-scatter, all-reduce, all-to-all)
on CPU tensors only.  :class:`StagedGroup` is a ``ProcessGroup`` written in
Python that owns a gloo backend over the same store and ranks; each
collective copies its CUDA inputs into pinned host buffers, runs the gloo
collective on them, and copies the results back into the CUDA outputs
(the same staging ``dist.collectives.Wire`` does for the GNN runtimes).
CPU tensors go to gloo directly.  Every call completes before it returns,
so the ``Work`` it hands back is already done.

:func:`register` adds ``"staged"`` for the ``cpu`` and ``cuda`` device
types: a process group of ranks sharing a card is then
``init_process_group("staged", ...)`` (``launch.mesh.spawn(...,
backend="staged")`` does both), and a ``DeviceMesh`` laid over it gives
every sub-group the same backend.  On CPU ranks it runs the same Python
path with nothing to stage, which is how the tests reach it without a
card.  :func:`host_stage_s` returns the seconds this process has spent
copying.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch._C import _distributed_c10d as c10d
from torch.futures import Future

__all__ = ["StagedGroup", "BACKEND", "register", "host_stage_s"]

BACKEND = "staged"
_STAGE_S = [0.0]


def host_stage_s(reset: bool = False) -> float:
    """Seconds this process spent in host staging copies (since the last
    reset)."""
    s = _STAGE_S[0]
    if reset:
        _STAGE_S[0] = 0.0
    return s


def _done(result=None):
    from torch._C._distributed_c10d import _create_work_from_future
    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return x
    t0 = time.perf_counter()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)                    # waits for the stream's pending work
    _STAGE_S[0] += time.perf_counter() - t0
    return host


def _host_like(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return x
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _back(out: torch.Tensor, host: torch.Tensor) -> None:
    if host is out:
        return
    t0 = time.perf_counter()
    out.copy_(host)
    torch.cuda.current_stream(out.device).synchronize()
    _STAGE_S[0] += time.perf_counter() - t0


class StagedGroup(dist.ProcessGroup):
    """A process group whose collectives run on gloo, CUDA tensors staged
    through pinned host memory."""

    def __init__(self, store, rank: int, world_size: int, timeout):
        super().__init__(rank, world_size)
        self._gloo = dist.ProcessGroupGloo(store, rank, world_size, timeout)
        self._rank, self._size = rank, world_size
        self._name = ""

    def size(self):
        return self._size

    # the group's name, which torch.distributed sets and resolves groups by
    def _set_group_name(self, name: str) -> None:
        self._name = name

    @property
    def group_name(self) -> str:
        return self._name

    @property
    def pg_name(self) -> str:
        return self._name

    def getBackendName(self):
        return "staged"

    # all-reduce
    def allreduce(self, tensors, opts=None):
        opts = opts if opts is not None else c10d.AllreduceOptions()
        hosts = [_to_host(t) for t in tensors]
        self._gloo.allreduce(hosts, opts).wait()
        for t, h in zip(tensors, hosts):
            _back(t, h)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        opts = opts if opts is not None else c10d.AllreduceCoalescedOptions()
        for t in tensors:
            o = c10d.AllreduceOptions()
            o.reduceOp = opts.reduceOp
            self.allreduce([t], o)
        return _done(tensors)

    # all-gather
    def all_gather_single(self, output, input, opts=None):
        opts = opts if opts is not None else c10d.AllgatherOptions()
        hin, hout = _to_host(input), _host_like(output)
        self._gloo._allgather_base(hout, hin, opts).wait()
        _back(output, hout)
        return _done(output)

    def allgather(self, outputs, inputs, opts=None):
        opts = opts if opts is not None else c10d.AllgatherOptions()
        hin = [_to_host(t) for t in inputs]
        hout = [[_host_like(o) for o in outs] for outs in outputs]
        self._gloo.allgather(hout, hin, opts).wait()
        for outs, houts in zip(outputs, hout):
            for o, h in zip(outs, houts):
                _back(o, h)
        return _done(outputs)

    def allgather_into_tensor_coalesced(self, outputs, inputs,
                                        opts=None):
        opts = opts if opts is not None else c10d.AllgatherOptions()
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    # reduce-scatter
    def reduce_scatter_single(self, output, input,
                              opts=None):
        opts = opts if opts is not None else c10d.ReduceScatterOptions()
        hin, hout = _to_host(input), _host_like(output)
        self._gloo._reduce_scatter_base(hout, hin, opts).wait()
        _back(output, hout)
        return _done(output)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs,
                                        opts=None):
        opts = opts if opts is not None else c10d.ReduceScatterOptions()
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    # all-to-all
    def all_to_all_single(self, output, input, output_split_sizes,
                          input_split_sizes, opts=None):
        opts = opts if opts is not None else c10d.AllToAllOptions()
        hin, hout = _to_host(input), _host_like(output)
        self._gloo.alltoall_base(hout, hin, list(output_split_sizes or []),
                                 list(input_split_sizes or []), opts).wait()
        _back(output, hout)
        return _done(output)

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        """``dist.all_to_all_single``'s entry."""
        return self.all_to_all_single(output, input, output_split_sizes,
                                      input_split_sizes, opts)

    # broadcast and barrier
    def broadcast(self, tensors, opts=None):
        opts = opts if opts is not None else c10d.BroadcastOptions()
        hosts = [_to_host(t) for t in tensors]
        self._gloo.broadcast(hosts, opts).wait()
        for t, h in zip(tensors, hosts):
            _back(t, h)
        return _done(tensors)

    def barrier(self, opts=None):
        opts = opts if opts is not None else c10d.BarrierOptions()
        self._gloo.barrier(opts).wait()
        return _done()


def _create(store, rank, world_size, timeout):
    return StagedGroup(store, rank, world_size, timeout)


def register() -> None:
    """Register the ``"staged"`` backend with ``torch.distributed`` (once
    a process; ``launch.mesh.spawn`` calls it for ``backend="staged"``)."""
    if "staged" not in dist.Backend.backend_list:
        dist.Backend.register_backend("staged", _create,
                                      devices=["cpu", "cuda"])
