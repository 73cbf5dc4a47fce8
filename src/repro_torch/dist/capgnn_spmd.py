"""SPMD CaPGNN runtime: one process per partition over a
``torch.distributed`` group (the JAX package's ``capgnn_spmd``).

Layout: rank ``i`` holds partition ``i``, the ``[i]`` row of every
``[P, ...]`` leaf of the stacked layout, on its own device (kept as a
``[1, ...]`` stack, so the single-process runtime's scatter, global read
and aggregation backends run on it unchanged).  Parameters, optimizer
state and the deduplicated global-cache buffer are replicated: every rank
holds them whole and applies the same update.

Communication — two transports, selected by ``spec.transport``:

- ``"allgather"``: each tier's owners pack their (deduplicated) send rows
  into a dense payload, one ``all_gather`` delivers every payload to every
  rank, and consumers address rows by ``(src_part, src_slot)``.  Its wire
  volume is ~P x the paper's point-to-point accounting.
- ``"p2p"``: each owner packs its rows per destination (``peer_send_row``)
  and P-1 ring rotations ship block ``(i -> j)`` directly to ``j``: each
  tier row crosses the wire once per consumer, so the counted bytes equal
  :meth:`~repro_torch.dist.ExchangePlan.bytes_per_step`.  The global tier
  is a ring broadcast of the deduplicated buffer.

Every pack and every consumer's addressing is one row gather
(``ops.pack_rows``) over maps built once per plan
(:func:`spmd_exchange_arrays`): on the card the gather kernel forward and,
where differentiated, the CSR kernel over the transposed index map
backward.  The collectives are :mod:`.collectives`' autograd Functions,
whose backward is their transpose, and every one goes through the
counting :class:`~.collectives.Wire`.

Steps (the single-process runtime's numerics): ``step_refresh`` pulls
every tier fresh inside the autograd graph; ``step_cached`` exchanges the
uncached tier and reads the caches; ``step_pipelined`` does what
``step_cached`` does and also pulls this step's tier rows as the next
caches, outside autograd.  Under ``p2p`` those pulls are rings issued at
their layer boundary as async work, advanced one rotation after each
layer's aggregation and waited for after the last layer.

Each rank differentiates its share ``sum(nll * mask) / total_train`` of
the global loss; the loss and the gradients are then summed over ranks
outside autograd (the JAX package's ``_device_loss``: a sum inside the
differentiated function would inflate the gradients P-fold).

``features="host"``: each rank holds its own
:class:`~.host_store.HostFeatureStore` of its partition's halo rows and
stages only its own host tier and ``l0loc``; the replicated global
buffers are written back and staged on every rank, and counted on rank 0
only, so the counts summed over ranks equal the plan's
(``ExchangePlan.host_fetch_rows``, ``host_bytes_per_step``,
``host_writeback_bytes``) and the JAX package's single store.  Each rank
runs its own :class:`~repro_torch.core.jaca.AdaptivePlanner` on the same
observations (``drift_local_rows`` gathered over the ranks), so every
rank installs the same re-plans.

The partition axis may be a tuple of mesh axes (the JAX package's
multi-pod ``("pod", "data")``): ``group`` is then a
:class:`~repro_torch.launch.mesh.Mesh` and the runtime runs on the group
of the named axes, the whole mesh's ranks in row-major order, which is
the order the reference's collectives index the tuple in; the numerics
and counts are those of the flat group.

The tracer, the fault plan and the guard (``train_capgnn``'s ``tracer``,
``faults``, ``guard``) are one each per rank, built from the same seed:
each rank's report carries that rank's counts.  The plan is
deterministic, but the tier digests are rank-local, so with a guard
attached the ranks agree on a forced refresh through one ``max``
all-reduce of a flag a step (:meth:`SpmdRuntime.any_rank`), outside the
counted wire; with no guard nothing is added.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..launch.mesh import Mesh
from ..models.gnn import GNNConfig
from ..obs.annotations import device_scope
from ..optim import Optimizer
from .capgnn_sim import (SimRuntime, _build_runtime, _gather, _gather_map,
                         _host_dict, _idx, _mask, _Ready,
                         _StackedExchange)
from .collectives import AllGatherFn, RingBroadcastFn, RotateFn, Wire
from .exchange import ExchangePlan, ExchangeTier, StackedParts
from .host_store import halo_dtype_info
from .spec import TrainSpec

__all__ = ["TRANSPORTS", "spmd_exchange_arrays", "rank_view", "WireExchange",
           "SpmdRuntime", "make_spmd_runtime"]

TRANSPORTS = ("allgather", "p2p")


def rank_view(sp: StackedParts, rank: int) -> StackedParts:
    """Partition ``rank``'s row of the stacked layout, as a one-partition
    ``[1, ...]`` stack with the same padded widths."""
    one = slice(rank, rank + 1)
    ell = sp.ell
    if ell is not None:
        ell = dataclasses.replace(
            ell, cols=ell.cols[one], vals=ell.vals[one],
            tail_src=ell.tail_src[one], tail_dst=ell.tail_dst[one],
            tail_w=ell.tail_w[one])
    return dataclasses.replace(
        sp, num_parts=1, n_inner=sp.n_inner[one], n_halo=sp.n_halo[one],
        feats=sp.feats[one], halo_feats=sp.halo_feats[one],
        labels=sp.labels[one], train_mask=sp.train_mask[one],
        val_mask=sp.val_mask[one], test_mask=sp.test_mask[one],
        e_src=sp.e_src[one], e_dst=sp.e_dst[one], e_w=sp.e_w[one], ell=ell,
        inner_valid=sp.inner_valid[one], halo_valid=sp.halo_valid[one])


def _tier_maps(t: ExchangeTier, p2p: bool, rank: int, n_inner: int, device,
               grad: bool, halo_dtype) -> dict:
    """One tier on rank ``rank``: the owner's pack (``"send"``), the valid
    rows it hands to the wire (per destination under ``p2p``), the
    consumer's addressing of the received payload (``"addr"``) and its
    scatter positions.

    The pack is ``[S]`` ids into the owner's inner rows (its deduplicated
    send buffer) under ``allgather``, ``[P * B]`` (its per-peer blocks)
    under ``p2p``.  On a ``p2p`` wire of ``halo_dtype`` the per-peer pack
    takes two stages, the deduplicated buffer cast to the wire dtype and
    then the blocks gathered from it (``"peer"``), so that the gradient
    of a row sent to several peers sums in f32 and rounds to the wire
    dtype once, as the single-process runtime's two-stage pull does."""
    n_parts = t.send_row.shape[0]
    out = {"wire": halo_dtype,
           "recv_halo_pos": _idx(t.recv_halo_pos[rank:rank + 1], device),
           "recv_valid": _mask(t.recv_valid[rank:rank + 1], device)}
    if p2p and halo_dtype is None:
        out["send"] = _gather_map(t.peer_send_row[rank].reshape(-1),
                                  t.peer_send_valid[rank].reshape(-1),
                                  n_inner, device, grad)
    else:
        out["send"] = _gather_map(t.send_row[rank], t.send_valid[rank],
                                  n_inner, device, grad)
    if p2p:
        width = t.peer_block
        if halo_dtype is not None:
            sent = t.send_row[rank][t.send_valid[rank]]   # sorted, unique
            out["peer"] = _gather_map(
                np.searchsorted(sent, t.peer_send_row[rank].reshape(-1)),
                t.peer_send_valid[rank].reshape(-1), t.send_row.shape[1],
                device, grad)
        out["valid"] = t.peer_send_valid[rank].sum(-1).astype(np.int64)
        slot = t.recv_peer_slot[rank]
    else:
        width = t.send_row.shape[1]
        out["valid"] = int(t.send_valid[rank].sum())
        slot = t.recv_src_slot[rank]
    addr_ids = t.recv_src_part[rank].astype(np.int64) * width + slot
    out.update(width=int(width),
               addr=_gather_map(addr_ids, t.recv_valid[rank],
                                n_parts * width, device, grad))
    return out


def spmd_exchange_arrays(xplan: ExchangePlan, p2p: bool, rank: int,
                         n_inner: int, device="cuda", grad: bool = True,
                         halo_dtype=None, include_host: bool = False) -> dict:
    """One plan's exchange maps on rank ``rank``, built once per plan for
    the payload dtype ``halo_dtype`` (None for none): the rank's row of
    each sharded leaf (the uncached and local tiers' :func:`_tier_maps`;
    the global tier's send pack and reads) and the replicated global
    addressing (the buffer's fill from the gathered payloads), each a
    gather with, when ``grad`` asks for the backward, its transposed
    index map.  ``include_host`` adds the rank's row of the layer-0 host
    tier's scatter program."""
    g = xplan.glob
    sg = g.send_row.shape[1]
    fill_ids = g.src_part.astype(np.int64) * sg + g.src_slot

    def tier(t):
        return _tier_maps(t, p2p, rank, n_inner, device, grad, halo_dtype)
    out = {
        "un": tier(xplan.uncached), "loc": tier(xplan.local),
        "gl": {"send": _gather_map(g.send_row[rank], g.send_valid[rank],
                                   n_inner, device, grad),
               "width": int(sg), "valid": int(g.send_valid[rank].sum()),
               "fill": _gather_map(fill_ids, g.buf_valid,
                                   xplan.num_parts * sg, device, grad),
               "read": _gather_map(g.read_buf_idx[rank:rank + 1],
                                   g.read_valid[rank:rank + 1], g.buf_size,
                                   device, grad),
               "read_pos": _idx(g.read_pos[rank:rank + 1], device),
               "read_valid": _mask(g.read_valid[rank:rank + 1], device)}}
    if include_host:
        out["host"] = _host_dict(xplan, slice(rank, rank + 1), device)
    return out


class _Ring:
    """A ring run one rotation at a time, outside autograd (the pipelined
    step's refresh pulls under ``p2p``): ``advance()`` issues the next
    rotation as async work, ``finish()`` issues what is left, waits for
    every rotation and returns ``collect`` of the ``[P, ...]`` blocks by
    sender.

    ``payload`` is ``[P, B, d]`` per destination (a peer ring: block ``j``
    goes to rank ``j``, the own block stays zero) or ``[n, d]`` (a ring
    broadcast: the same payload to every rank, the own block is it)."""

    def __init__(self, wire: Wire, payload: torch.Tensor, per_peer: bool,
                 key, valid, collect: Callable):
        self.wire, self.payload, self.per_peer = wire, payload, per_peer
        self.key, self.valid, self.collect = key, valid, collect
        self.tag = wire.new_tag(wire.size)
        self.pending: list = []

    def advance(self) -> None:
        wire, r = self.wire, len(self.pending) + 1
        if r >= wire.size:
            return
        if self.per_peer:
            dst = (wire.rank + r) % wire.size
            x, valid = self.payload[dst], int(self.valid[dst])
        else:
            x, valid = self.payload, self.valid if r == 1 else 0
        self.pending.append(wire.rotate(x, r, self.tag + r, self.key, valid))

    def finish(self) -> torch.Tensor:
        wire = self.wire
        while len(self.pending) < wire.size - 1:
            self.advance()
        own = (torch.zeros_like(self.payload[0]) if self.per_peer
               else self.payload)
        blocks = [own] * wire.size
        for r, pend in enumerate(self.pending, start=1):
            blocks[(wire.rank - r) % wire.size] = pend.wait()
        return self.collect(torch.stack(blocks))


class WireExchange(_StackedExchange):
    """The SPMD runtime's exchange hooks over a :class:`~.collectives.Wire`:
    a tier pull is the owner's pack, the transport and the consumer's
    addressing; the global buffer is packed, all-gathered or ring
    broadcast, and filled; sums and maxima over ranks are all-reduces.
    ``log`` gets this rank's :meth:`~.collectives.Wire.take` of every
    step."""

    def __init__(self, wire: Wire, p2p: bool, halo_dtype, device="cpu"):
        super().__init__(halo_dtype)
        self.wire, self.p2p = wire, p2p
        self.device = torch.device(device)
        self.log: list = []

    def _quant(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.halo_dtype) if self.halo_dtype is not None else x

    def _tier(self, t: dict, h: torch.Tensor, key, defer: bool):
        """One tier's rows ``[1, R, d]`` from ``h [1, NI, d]``; with
        ``defer`` (``p2p`` only), the issued :class:`_Ring` that gives
        them when it finishes."""
        if t["wire"] != self.halo_dtype:
            raise ValueError(f"a pull with halo dtype {self.halo_dtype} over "
                             f"maps built for {t['wire']}")
        wire, p = self.wire, self.wire.size
        d = h.shape[-1]
        payload = self._quant(_gather(t["send"], h.reshape(-1, d)))
        if "peer" in t:
            payload = _gather(t["peer"], payload)
        n_rows = t["recv_valid"].shape[1]

        def collect(blocks):
            if not blocks.numel():
                return h.new_zeros((1, n_rows, d))
            return _gather(t["addr"], blocks.reshape(-1, d)).to(h.dtype)[None]
        if not payload.numel():
            return _Ready(collect(payload)) if defer else collect(payload)
        if not self.p2p:
            return collect(AllGatherFn.apply(payload, wire, key, t["valid"]))
        blocks = payload.view(p, t["width"], d)
        if defer:
            return _Ring(wire, blocks, True, key, t["valid"], collect)
        tag = wire.new_tag(p)
        recv = [torch.zeros_like(blocks[0])] * p
        for r in range(1, p):
            dst = (wire.rank + r) % p
            recv[(wire.rank - r) % p] = RotateFn.apply(
                blocks[dst], wire, r, tag + r, key, int(t["valid"][dst]))
        return collect(torch.stack(recv))

    def _global(self, g: dict, h: torch.Tensor, key, defer: bool):
        """The deduplicated global buffer ``[G, d]`` (replicated) from the
        owners' rows: pack, all-gather or ring broadcast, fill.

        The collective dequantises the gathered payloads itself, so the
        buffer's gradient, which every rank's reads add to, sums over the
        ranks in f32 and rounds to the wire dtype once, as the
        single-process runtime's does."""
        wire, d = self.wire, h.shape[-1]
        payload = self._quant(_gather(g["send"], h.reshape(-1, d)))

        def collect(acc):
            if not acc.numel():
                return h.new_zeros((g["fill"]["idx"].shape[0], d))
            return _gather(g["fill"], acc.to(h.dtype).reshape(-1, d))
        if not payload.numel():
            return _Ready(collect(payload)) if defer else collect(payload)
        if defer:
            return _Ring(wire, payload, False, key, g["valid"], collect)
        if self.p2p:
            acc = RingBroadcastFn.apply(payload, wire, wire.new_tag(wire.size),
                                        key, g["valid"], h.dtype)
        else:
            acc = AllGatherFn.apply(payload, wire, key, g["valid"], h.dtype)
        return collect(acc)

    def pull(self, td: dict, h: torch.Tensor, key) -> torch.Tensor:
        return self._tier(td, h, key, False)

    def build_global(self, gd: dict, h: torch.Tensor, key) -> torch.Tensor:
        return self._global(gd, h, key, False)

    def emit(self, xe: dict, h: torch.Tensor, li: int) -> tuple:
        """Under ``p2p``, rings issued here and advanced one rotation
        after each later layer's aggregation; under ``allgather``, the
        pulls themselves."""
        if not self.p2p:
            return super().emit(xe, h, li)
        with device_scope("refresh_ring_issue"):
            return (self._tier(xe["loc"], h, (li, "local"), True),
                    self._global(xe["gl"], h, (li, "global"), True))

    def sum_ranks(self, tensors: list) -> list:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.wire.all_reduce(flat, "sum")
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        return out

    def max_ranks(self, x: torch.Tensor) -> torch.Tensor:
        return self.wire.all_reduce(x, "max")

    def any_rank(self, flag: bool) -> bool:
        """``flag`` of any rank: one uncounted ``max`` all-reduce of a
        host flag (on the rank's card under NCCL)."""
        x = torch.tensor([int(flag)], dtype=torch.int32,
                         device="cpu" if self.wire.gloo else self.device)
        return bool(self.wire.all_reduce(x, "max")[0])

    def end_step(self, logged: bool) -> None:
        taken = self.wire.take()
        if logged:
            self.log.append(taken)


@dataclasses.dataclass
class SpmdRuntime(SimRuntime):
    """This rank's runtime: :class:`~.capgnn_sim.SimRuntime`'s steps on
    its partition (``caches0`` holds its ``[1, R, d]`` local tier and the
    replicated global buffers), and the wire."""
    wire: Wire | None = None
    rank: int = 0
    world_size: int = 1
    transport: str = "allgather"
    # per step, this rank's Wire.take(): counts by (layer, tier) and the
    # host staging seconds
    wire_log: list = dataclasses.field(default_factory=list)

    def wire_rows(self, refresh: bool, padded: bool = False) -> dict:
        """Rows this runtime's transport moves in one layer exchange, over
        all ranks (:meth:`repro_torch.dist.ExchangePlan.transport_rows`)."""
        return self.xplan.transport_rows(self.transport, refresh,
                                         padded=padded)

    def all_parts(self, x: torch.Tensor) -> np.ndarray:
        """``x``, this rank's ``[1, ...]`` row of a per-partition metric,
        gathered over the ranks (uncounted), on the host."""
        return self.wire.all_gather(x.contiguous()).cpu().numpy()


def make_spmd_runtime(cfg: GNNConfig, sp: StackedParts, xplan: ExchangePlan,
                      opt: Optimizer, group=None, axis="data", *,
                      spec: TrainSpec, device="cuda") -> SpmdRuntime:
    """Build this rank's runtime over ``group`` (a process group, None for
    the default one, or a :class:`~repro_torch.launch.mesh.Mesh` whose
    ``axis`` names the partition axes; the group's size must be the
    plan's partition count) on ``device`` (the card unless the caller
    asks for the CPU), from ``spec`` (a :class:`repro_torch.dist.
    TrainSpec`).

    ``sp`` and ``xplan`` are the whole layout and plan, as every rank
    builds or receives them; the rank keeps its own row.  ``spec.backend``
    picks the aggregation operator (``edges``, ``ell``, ``hybrid``: the
    same kernels as the single-process runtime, on a ``[1, ...]`` stack),
    ``spec.transport`` the halo transport, ``spec.halo_dtype="bf16"`` casts
    every payload before the wire (counted at 2 bytes an entry) and
    dequantises after.  ``spec.features="host"`` keeps the rank's halo
    rows in its own host store (see the module docstring).  ``axis``
    names the partition axis, or the tuple of a mesh's axes (the JAX
    package's multi-pod mesh), which needs ``group`` to be the mesh.
    """
    if isinstance(group, Mesh):
        group = group.group(axis)
    elif not isinstance(axis, str) and len(tuple(axis)) > 1:
        raise ValueError(f"the axis tuple {tuple(axis)} names the axes of "
                         "a mesh: pass group=launch.mesh.make_mesh(...)")
    if spec.transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {spec.transport!r}; "
                         f"expected one of {TRANSPORTS}")
    wire = Wire(group)
    if wire.size != sp.num_parts:
        raise ValueError(f"the group has {wire.size} ranks but the plan has "
                         f"{sp.num_parts} partitions")
    device = torch.device(device)
    hdt = halo_dtype_info(spec.halo_dtype)[0]
    p2p = spec.transport == "p2p"
    ex = WireExchange(wire, p2p, hdt, device)

    def maps(xp):
        return spmd_exchange_arrays(xp, p2p, wire.rank, sp.n_inner_max,
                                    device, halo_dtype=hdt,
                                    include_host=spec.features == "host")
    return _build_runtime(SpmdRuntime, cfg, sp, rank_view(sp, wire.rank),
                          xplan, opt, spec, device, ex, maps,
                          rows=slice(wire.rank, wire.rank + 1),
                          account_replicas=wire.rank == 0, wire=wire,
                          rank=wire.rank, world_size=wire.size,
                          transport=spec.transport, wire_log=ex.log)
