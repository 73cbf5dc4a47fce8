"""The halo exchange's collectives over a ``torch.distributed`` group, with
the transposes autograd needs and one counting wrapper.

:class:`Wire` is that wrapper: every collective of the SPMD runtime
(:mod:`.capgnn_spmd`) goes through one of its methods, which records, per
``(layer, tier)`` key, the valid rows, the padded rows and the bytes
handed to the collective (:meth:`Wire.take` returns them per step).  The
three autograd Functions are the JAX package's collectives with their
transposes:

- :class:`AllGatherFn` — ``all_gather_into_tensor``; backward
  ``reduce_scatter_tensor`` (SUM);
- :class:`RotateFn` — one ring rotation (the JAX ``ppermute`` of
  ``_shift_perm``: rank ``i`` sends to ``i + shift`` and receives from
  ``i - shift``) as a ``batch_isend_irecv`` pair; backward the reverse
  rotation;
- :class:`RingBroadcastFn` — the ring broadcast of a buffer (each rank's
  payload originates once and circulates over ``P - 1`` rotations, giving
  the ``[P, ...]`` an all-gather would); backward the reverse rotations,
  each rank's share summed in a fixed order;
- :class:`PermuteFn` — a general permutation (the JAX ``ppermute`` of an
  explicit pair list: the 1.5D strategy's ``(grp, repl)`` involution):
  send to one global rank, receive from another; backward the inverse
  permutation.  A rank at a fixed point copies locally;
- :class:`AllReduceFn` — a counted ``all_reduce`` (SUM, the JAX ``psum``
  of the 1.5D partial aggregations); backward the all-reduce of the
  cotangent over the same group.

The backward's sums (the reduce-scatter, the ring broadcast's reverse)
run in f32 and round once to the payload's dtype, as the single-process
runtime's CSR backward does; on a bf16 wire that keeps the two runtimes'
gradients equal.

The transformer zoo's manual regions (the MoE dispatch, the
``shard_map`` bodies of the JAX package) run on local shards of DTensors
and call the functional collectives over a ``DeviceMesh`` axis's group,
which DTensor's own redistributions use too, so one counter
(:class:`repro_torch.launch.hlo_cost.OpCounter`) sees both:

- :func:`mesh_all_reduce` — ``psum`` over an axis, with either transpose
  (the result used per rank, or as the one value every rank holds);
- :func:`mesh_all_gather` — ``all_gather(..., tiled=True)``; backward the
  reduce-scatter;
- :func:`mesh_all_to_all` — ``all_to_all(..., split_axis=0,
  concat_axis=0, tiled=True)``; backward the reverse all-to-all (the
  operation ``repro_torch::all_to_all``, which the counter also sees).

On a ``gloo`` group a CUDA tensor is staged through the host: a copy
into a pinned host buffer, the gloo collective, a copy back; the copies'
seconds are ``host_stage_s``.  gloo takes these collectives on CPU
tensors only, so this is the wire of P ranks that share one card, which
the caller chose by asking for gloo.  Over NCCL the tensors go to the
collective directly.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["Wire", "Pending", "AllGatherFn", "RotateFn", "RingBroadcastFn",
           "PermuteFn", "AllReduceFn", "BACKWARD", "mesh_all_reduce",
           "mesh_all_gather", "mesh_all_to_all"]

# the tier key under which the backward's collectives are recorded
BACKWARD = "backward"
# gloo matches a receive to a send by tag: a backward rotation takes its
# forward's tag plus this
_BWD_TAG = 1 << 24


class Pending:
    """An issued rotation: :meth:`wait` returns the received tensor, on
    the caller's device.  The send and receive buffers stay referenced
    until then, so nothing in flight is freed or overwritten."""

    def __init__(self, wire: "Wire", works, send, recv, out):
        self.wire, self.works = wire, works
        self.send, self.recv, self.out = send, recv, out

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        if self.out is not self.recv:          # staged: host -> card
            self.wire._h2d(self.out, self.recv)
        self.works = self.send = None
        return self.out


class Wire:
    """The collectives of one process group, counted.

    ``log[(layer, tier)]`` holds ``valid_rows``, ``padded_rows``,
    ``bytes`` (valid rows times the row's bytes: the plan's accounting)
    and ``wire_bytes`` (padded rows times the row's bytes: what the
    collective carries) of every counted call since the last
    :meth:`take`.  A call without a key is a reduction of the step
    (loss, gradients, metrics) and is not counted."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.gloo = dist.get_backend(group) == "gloo"
        self.log: dict = {}
        self.host_stage_s = 0.0
        self._tag = 0

    # ---- accounting

    def record(self, key, valid_rows: int, padded_rows: int,
               row_bytes: int) -> None:
        if key is None:
            return
        c = self.log.setdefault(key, {"valid_rows": 0, "padded_rows": 0,
                                      "bytes": 0, "wire_bytes": 0})
        c["valid_rows"] += int(valid_rows)
        c["padded_rows"] += int(padded_rows)
        c["bytes"] += int(valid_rows) * row_bytes
        c["wire_bytes"] += int(padded_rows) * row_bytes

    def take(self) -> dict:
        """This rank's counts since the last call, and the host staging
        seconds; both reset."""
        out = {"counts": self.log, "host_stage_s": self.host_stage_s}
        self.log, self.host_stage_s = {}, 0.0
        return out

    def new_tag(self, n: int) -> int:
        """``n`` consecutive gloo tags; every rank draws them in the same
        order, so a tag names the same exchange on each."""
        tag = self._tag
        self._tag = (self._tag + n) % _BWD_TAG
        return tag

    # ---- host staging of CUDA tensors on a gloo group

    def _staged(self, x: torch.Tensor) -> bool:
        return self.gloo and x.is_cuda

    def _d2h(self, x: torch.Tensor) -> torch.Tensor:
        torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        self.host_stage_s += time.perf_counter() - t0
        return host

    def _host_empty(self, like: torch.Tensor, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)

    def _h2d(self, out: torch.Tensor, host: torch.Tensor) -> None:
        t0 = time.perf_counter()
        out.copy_(host)
        torch.cuda.current_stream(out.device).synchronize()
        self.host_stage_s += time.perf_counter() - t0

    def _peer(self, group_rank: int) -> int:
        return (group_rank if self.group is None
                else dist.get_global_rank(self.group, group_rank))

    # ---- raw collectives (no autograd)

    def all_gather(self, x: torch.Tensor, key=None,
                   valid_rows: int = 0) -> torch.Tensor:
        """``[n, ...] -> [size * n, ...]``, rank-major.  Counted as the
        rows landing on every rank: ``valid_rows * size`` valid,
        ``n * size`` padded."""
        x = x.contiguous()
        row = x[0].numel() * x.element_size() if x.shape[0] else 0
        self.record(key, valid_rows * self.size, x.shape[0] * self.size, row)
        shape = (self.size * x.shape[0],) + tuple(x.shape[1:])
        out = x.new_empty(shape)
        if self._staged(x):
            host_out = self._host_empty(x, shape)
            dist.all_gather_into_tensor(host_out, self._d2h(x),
                                        group=self.group)
            self._h2d(out, host_out)
        else:
            dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor, key=None) -> torch.Tensor:
        """``[size * n, ...] -> [n, ...]``: this rank's block of the sum
        over ranks."""
        x = x.contiguous()
        shape = (x.shape[0] // self.size,) + tuple(x.shape[1:])
        row = x[0].numel() * x.element_size() if x.shape[0] else 0
        self.record(key, x.shape[0], x.shape[0], row)
        out = x.new_empty(shape)
        if self._staged(x):
            host_out = self._host_empty(x, shape)
            dist.reduce_scatter_tensor(host_out, self._d2h(x),
                                       op=dist.ReduceOp.SUM,
                                       group=self.group)
            self._h2d(out, host_out)
        else:
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                       group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum",
                   key=None) -> torch.Tensor:
        """In place over ranks (``op`` ``"sum"`` or ``"max"``); returns
        ``x``.  Counted under ``key`` as its result's ``[n, ...]`` rows on
        every rank (the 1.5D aggregation's sum); without a key, as for
        the step's reductions (loss, gradients, metrics), not counted."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if key is not None:
            row = x[0].numel() * x.element_size() if x.shape[0] else 0
            self.record(key, x.shape[0], x.shape[0], row)
        if self._staged(x):
            host = self._d2h(x)
            dist.all_reduce(host, op=red, group=self.group)
            self._h2d(x, host)
        else:
            dist.all_reduce(x, op=red, group=self.group)
        return x

    def rotate(self, x: torch.Tensor, shift: int, tag: int, key=None,
               valid_rows: int = 0) -> Pending:
        """Issue one rotation: send ``x`` to rank ``rank + shift``, receive
        the same shape from ``rank - shift`` (mod size).  Returns at once;
        :meth:`Pending.wait` gives the received tensor."""
        return self.permute(x, self._peer((self.rank + shift) % self.size),
                            self._peer((self.rank - shift) % self.size),
                            tag, key, valid_rows)

    def permute(self, x: torch.Tensor, dst: int, src: int, tag: int,
                key=None, valid_rows: int = 0) -> Pending:
        """Post one permutation step: send ``x`` to global rank ``dst``,
        receive the same shape from global rank ``src``.  Counted as
        ``valid_rows`` valid and ``x``'s rows padded, on every rank, a
        rank at a fixed point (``dst`` and ``src`` itself) too: it copies
        ``x`` and posts nothing.  Returns at once; :meth:`Pending.wait`
        gives the received tensor."""
        x = x.contiguous()
        row = x[0].numel() * x.element_size() if x.shape[0] else 0
        self.record(key, valid_rows, x.shape[0], row)
        me = self._peer(self.rank)
        if dst == me or src == me:
            if (dst, src) != (me, me):
                raise ValueError(f"rank {me} sends to {dst} and receives "
                                 f"from {src}: a fixed point does both")
            out = x.clone()
            return Pending(self, [], x, out, out)
        out = torch.empty_like(x)
        if self._staged(x):
            send, recv = self._d2h(x), self._host_empty(x, x.shape)
        else:
            send, recv = x, out
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, self.group, tag),
            dist.P2POp(dist.irecv, recv, src, self.group, tag)])
        return Pending(self, works, send, recv, out)


# ---------------------------------------------------------------------------
# autograd Functions: forward a collective, backward its transpose
# ---------------------------------------------------------------------------

def _sum_in_f32(parts: list[torch.Tensor], dtype) -> torch.Tensor:
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(dtype)


class AllGatherFn(torch.autograd.Function):
    """``AllGatherFn.apply(x, wire, key, valid_rows, out_dtype)``: ``[n,
    ...] -> [size * n, ...]`` over ``wire``'s group, cast to ``out_dtype``
    when given (a wire payload dequantised after the collective); backward
    the reduce-scatter (SUM, in f32) of the cotangent, this rank's block,
    rounded once to ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, wire, key=None, valid_rows=0, out_dtype=None):
        ctx.wire, ctx.dtype = wire, x.dtype
        y = wire.all_gather(x, key, valid_rows)
        return y if out_dtype is None else y.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        d = ctx.wire.reduce_scatter(g.float(), BACKWARD)
        return d.to(ctx.dtype), None, None, None, None


class RotateFn(torch.autograd.Function):
    """``RotateFn.apply(x, wire, shift, tag, key, valid_rows)``: the
    tensor that rank ``rank - shift`` sent, this rank's ``x`` going to
    rank ``rank + shift``; backward the reverse rotation of the
    cotangent (each block back to its sender)."""

    @staticmethod
    def forward(ctx, x, wire, shift, tag, key=None, valid_rows=0):
        ctx.wire, ctx.shift, ctx.tag = wire, shift, tag
        return wire.rotate(x, shift, tag, key, valid_rows).wait()

    @staticmethod
    def backward(ctx, g):
        d = ctx.wire.rotate(g, -ctx.shift, ctx.tag + _BWD_TAG,
                            BACKWARD, g.shape[0]).wait()
        return d, None, None, None, None, None


class RingBroadcastFn(torch.autograd.Function):
    """``RingBroadcastFn.apply(x, wire, tag, key, valid_rows, out_dtype)``:
    ``[n, ...] -> [size, n, ...]``, block ``j`` the payload of rank ``j``
    (this rank's own at ``rank``), delivered by ``size - 1`` rotations of
    the same payload, cast to ``out_dtype`` when given.  Counted as the
    JAX package's ring broadcast: the valid rows once (where they
    originate), the padded rows at every rotation.  Backward: block
    ``rank - r`` of the cotangent goes back to its owner by the reverse
    rotation ``r``, and the owner sums its own block and the ``size - 1``
    received ones in f32, in rotation order, rounded once to ``x``'s
    dtype."""

    @staticmethod
    def forward(ctx, x, wire, tag, key=None, valid_rows=0, out_dtype=None):
        ctx.wire, ctx.tag, ctx.dtype = wire, tag, x.dtype
        p, i = wire.size, wire.rank
        acc = [None] * p
        acc[i] = x
        for r in range(1, p):
            acc[(i - r) % p] = wire.rotate(
                x, r, tag + r, key, valid_rows if r == 1 else 0).wait()
        y = torch.stack(acc)
        return y if out_dtype is None else y.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        wire = ctx.wire
        p, i = wire.size, wire.rank
        parts = [g[i]]
        for r in range(1, p):
            parts.append(wire.rotate(g[(i - r) % p], -r,
                                     ctx.tag + r + _BWD_TAG, BACKWARD,
                                     g.shape[1]).wait())
        return _sum_in_f32(parts, ctx.dtype), None, None, None, None, None


class PermuteFn(torch.autograd.Function):
    """``PermuteFn.apply(x, wire, dst, src, tag, key, valid_rows)``: the
    tensor global rank ``src`` sent, this rank's ``x`` going to global
    rank ``dst`` (a rank at a fixed point keeps a copy of its own);
    backward the inverse permutation of the cotangent: it goes back to
    ``src``, and the cotangent of ``x`` comes from ``dst``."""

    @staticmethod
    def forward(ctx, x, wire, dst, src, tag, key=None, valid_rows=0):
        ctx.wire, ctx.dst, ctx.src, ctx.tag = wire, dst, src, tag
        return wire.permute(x, dst, src, tag, key, valid_rows).wait()

    @staticmethod
    def backward(ctx, g):
        d = ctx.wire.permute(g, ctx.src, ctx.dst, ctx.tag + _BWD_TAG,
                             BACKWARD, g.shape[0]).wait()
        return d, None, None, None, None, None, None


class AllReduceFn(torch.autograd.Function):
    """``AllReduceFn.apply(x, wire, key)``: the sum of ``x`` over
    ``wire``'s group, counted under ``key`` (the result's rows); backward
    the all-reduce (SUM) of the cotangent over the same group: every
    rank's output depends on every rank's input, so that is the
    transpose."""

    @staticmethod
    def forward(ctx, x, wire, key=None):
        ctx.wire = wire
        return wire.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               "sum", key)

    @staticmethod
    def backward(ctx, g):
        d = ctx.wire.all_reduce(g.clone(memory_format=torch.contiguous_format),
                                "sum", BACKWARD)
        return d, None, None


# ---------------------------------------------------------------------------
# functional collectives over a DeviceMesh axis, with their transposes
# ---------------------------------------------------------------------------

def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


class _MeshAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, varying):
        ctx.group, ctx.varying = group, varying
        return _funcol().wait_tensor(_funcol().all_reduce(
            x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        if not ctx.varying:
            return g, None, None
        return _funcol().wait_tensor(_funcol().all_reduce(
            g.contiguous(), "sum", ctx.group)), None, None


def mesh_all_reduce(x: torch.Tensor, group, *, varying: bool
                    ) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (JAX's ``psum`` over one axis).
    ``varying``: the sum is then used differently on each rank (added to a
    rank's own tokens), so the backward all-reduces the cotangent (psum
    then pvary); otherwise every rank holds and uses the one value, and
    each rank's cotangent is its input's (psum to an invariant value)."""
    return _MeshAllReduce.apply(x, group, varying)


def mesh_all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x``'s blocks along ``dim`` from every rank of ``group``, in rank
    order (``all_gather(..., axis=dim, tiled=True)``); backward the
    reduce-scatter (SUM) of the cotangent."""
    funcol = _funcol()
    gather = getattr(funcol, "all_gather_single_autograd",
                     None) or funcol.all_gather_tensor_autograd
    return gather(x.contiguous(), dim, group)


@torch.library.custom_op("repro_torch::all_to_all", mutates_args=())
def _all_to_all(x: torch.Tensor, group_name: str) -> torch.Tensor:
    from torch.distributed.distributed_c10d import _resolve_process_group
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=_resolve_process_group(group_name))
    return out


@_all_to_all.register_fake
def _(x, group_name):
    return torch.empty_like(x)


class _MeshAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_name):
        ctx.group_name = group_name
        return torch.ops.repro_torch.all_to_all(x, group_name)

    @staticmethod
    def backward(ctx, g):
        return (torch.ops.repro_torch.all_to_all(g.contiguous(),
                                                 ctx.group_name), None)


def mesh_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of ``x``'s dim 0 goes to rank ``j`` of ``group``, block
    ``j`` of the result came from rank ``j`` (``all_to_all(...,
    split_axis=0, concat_axis=0, tiled=True)``); backward the reverse
    all-to-all.  An operation of its own (``repro_torch::all_to_all``, over
    ``dist.all_to_all_single``): the functional collective's all-to-all
    finds no CUDA backend on a process group written in Python (the
    ``staged`` one of ranks sharing a card)."""
    return _MeshAllToAll.apply(x.contiguous(), group.group_name)
