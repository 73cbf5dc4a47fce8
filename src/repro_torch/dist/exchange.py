"""Compile a JACA :class:`~repro_torch.core.jaca.CachePlan` into static
exchange index sets, and stack per-partition task data into the padded
``[P, ...]`` layout the partition-parallel passes consume.

A numpy copy of the JAX package's ``dist/exchange.py``: the same seed gives
byte-identical arrays (held by ``tests/test_torch_substrate.py``).

The exchange plan turns the plan's three halo tiers into gather/scatter
programs that are pure index arithmetic — no dynamic shapes, so one set of
arrays drives every partition of the stacked ``[P, ...]`` batch:

- **uncached** tier: exchanged every step (the only per-step traffic on a
  cached step);
- **local** tier: each worker's HBM-resident cache rows, refreshed every
  ``refresh_every`` steps;
- **global** tier: the shared (CPU in the paper) cache — one buffer row per
  *unique* vertex, so a vertex consumed by k workers moves once per refresh
  instead of k times (paper §4.2).

Every tier carries two send layouts compiled from the same index sets: a
deduplicated *broadcast* layout (``send_row``; consumers address rows by
``(src_part, src_slot)``) and a *per-peer packed* layout
(``peer_send_row``, one block per (owner, peer) pair) whose row counts are
what :meth:`ExchangePlan.bytes_per_step` accounts.

``pad_to=exchange_capacity(ps, capacity)`` pads every tier to capacity
widths instead of this plan's maxima, so two plans over the same
partitioning and capacity have identical shapes (slot stability).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.jaca import CachePlan
from ..data.gnn_data import FullBatchTask
from ..graph.partition import PartitionSet

__all__ = ["ExchangeTier", "GlobalTier", "HostTier", "ExchangePlan",
           "StackedParts", "StackedEllPack", "ExchangeCapacity",
           "exchange_capacity", "build_exchange_plan", "stack_partitions"]


@dataclasses.dataclass(frozen=True)
class ExchangeCapacity:
    """Fixed per-tier padded widths that upper-bound any cache plan over a
    given (partitioning, CacheCapacity) pair.

    Padding a compiled :class:`ExchangePlan` to these widths makes its
    array *shapes* a function of the capacities only — tier membership
    becomes data (indices + valid masks), so online re-planning never
    changes shapes and never reallocates a step's buffers.

    The scalar widths are the fleet maxima (rectangular arrays force a
    single shape); the ``*_w`` vectors record each worker's *tight* bound,
    so uneven (resource-aware) partitions keep exact per-worker accounting
    — the gap between ``P * scalar`` and ``sum(vector)`` is the padded-row
    waste the static shapes carry (see :meth:`padding_waste`).
    """
    un_recv: int     # uncached recv rows per consumer (<= its halo size)
    loc_recv: int    # local-tier recv rows per consumer (<= min(c_gpu, halo))
    glob_read: int   # global-tier reads per consumer (<= min(halo, c_cpu))
    send: int        # dedup send rows per owner, uncached/local tiers
    glob_send: int   # dedup send rows per owner into the global buffer
    peer: int        # per-(owner, peer) packed block width
    glob_buf: int    # unique rows resident in the global buffer (<= c_cpu)
    # per-worker tight widths (accounting; shapes always use the scalars)
    un_recv_w: np.ndarray | None = None    # [P]
    loc_recv_w: np.ndarray | None = None   # [P]
    glob_read_w: np.ndarray | None = None  # [P]
    send_w: np.ndarray | None = None       # [P]

    def __post_init__(self):
        # fleet-uniform fallback: every worker bounded by the scalar width
        def default(field, scalar):
            if getattr(self, field) is None:
                object.__setattr__(self, field,
                                   np.full(1, scalar, np.int64))
        default("un_recv_w", self.un_recv)
        default("loc_recv_w", self.loc_recv)
        default("glob_read_w", self.glob_read)
        default("send_w", self.send)

    def padding_waste(self) -> dict:
        """Padded-minus-valid row counts of the slot-stable layout, per
        tier, plus the aggregate waste fraction over all recv/send slots."""
        p = int(np.asarray(self.un_recv_w).shape[0])
        out = {}
        valid = padded = 0
        for field, scalar in (("un_recv", self.un_recv),
                              ("loc_recv", self.loc_recv),
                              ("glob_read", self.glob_read),
                              ("send", self.send)):
            v = int(np.asarray(getattr(self, field + "_w")).sum())
            tot = p * int(scalar)
            out[f"{field}_padded_rows"] = tot - v
            valid += v
            padded += tot
        out["waste_frac"] = float((padded - valid) / max(padded, 1))
        return out


def exchange_capacity(ps: PartitionSet, capacity) -> ExchangeCapacity:
    """Worst-case tier widths over ANY plan ``build_cache_plan``-shaped
    tiering can produce for ``ps`` under ``capacity``
    (:class:`repro_torch.core.jaca.CacheCapacity`).

    - a consumer's local tier holds at most ``min(c_gpu, n_halo)`` rows,
      its global tier at most ``min(n_halo, c_cpu)``, its uncached tier at
      most ``n_halo`` (empty caches);
    - an owner's deduplicated send buffer holds at most the number of its
      inner vertices that appear in *any* partition's halo;
    - block (owner -> peer) holds at most ``|halo(peer) ∩ inner(owner)|``
      rows — a plan property of the partitioning, not of the tiering.
    """
    p = ps.num_parts
    h_sizes = np.array([pt.n_halo for pt in ps.parts], np.int64)
    union = ps.halo_union()
    owner = ps.assign
    exportable = np.bincount(owner[union], minlength=p).astype(np.int64) \
        if union.size else np.zeros(p, np.int64)
    c_cpu = int(min(capacity.c_cpu, union.size))
    peer = 0
    for pt in ps.parts:
        if pt.n_halo:
            peer = max(peer, int(np.bincount(owner[pt.halo_nodes],
                                             minlength=p).max()))
    un_recv_w = h_sizes
    loc_recv_w = np.minimum(np.asarray(capacity.c_gpu, np.int64)[:p],
                            h_sizes)
    glob_read_w = np.minimum(h_sizes, c_cpu)
    return ExchangeCapacity(
        un_recv=int(un_recv_w.max(initial=0)),
        loc_recv=int(loc_recv_w.max(initial=0)),
        glob_read=int(glob_read_w.max(initial=0)),
        send=int(exportable.max(initial=0)),
        glob_send=int(min(int(exportable.max(initial=0)), c_cpu)),
        peer=peer,
        glob_buf=c_cpu,
        un_recv_w=un_recv_w, loc_recv_w=loc_recv_w,
        glob_read_w=glob_read_w, send_w=exportable)


@dataclasses.dataclass(frozen=True)
class ExchangeTier:
    """One tier's gather/scatter program (uncached or local).

    All arrays are padded to the per-partition maximum; ``*_valid`` masks
    mark real entries.  ``send_row`` holds *deduplicated* inner rows per
    owner (a row consumed by several partitions occupies one send slot) —
    the broadcast/all-gather layout.  ``peer_send_row`` holds the same
    rows re-packed per destination (a row consumed by k peers occupies
    one slot in each of the k peer blocks) — the point-to-point layout;
    consumers address block rows by ``(src_part, peer_slot)``.
    """
    name: str
    send_row: np.ndarray        # [P, S] inner row each owner contributes
    send_valid: np.ndarray      # [P, S] bool
    recv_src_part: np.ndarray   # [P, R] owning partition per received row
    recv_src_slot: np.ndarray   # [P, R] slot in the owner's send buffer
    recv_halo_pos: np.ndarray   # [P, R] halo position to scatter into
    recv_valid: np.ndarray      # [P, R] bool
    peer_send_row: np.ndarray   # [P, P, B] inner rows owner i ships to peer j
    peer_send_valid: np.ndarray  # [P, P, B] bool
    recv_peer_slot: np.ndarray  # [P, R] slot in the (owner -> me) peer block

    @property
    def n_rows(self) -> int:
        """Total un-padded received rows (one per (vertex, consumer))."""
        return int(self.recv_valid.sum())

    @property
    def n_send_rows(self) -> int:
        """Total un-padded send rows (deduplicated per owner)."""
        return int(self.send_valid.sum())

    @property
    def n_peer_rows(self) -> int:
        """Total un-padded rows across all per-peer blocks.  Equals
        ``n_rows`` — each (vertex, consumer) pair occupies exactly one
        slot of exactly one peer block (asserted by the tier-1 suite)."""
        return int(self.peer_send_valid.sum())

    @property
    def peer_block(self) -> int:
        """Padded width of one (owner, peer) block."""
        return int(self.peer_send_row.shape[2])


@dataclasses.dataclass(frozen=True)
class GlobalTier:
    """The shared global cache: one buffer row per unique consumed vertex.

    Under a capacity-padded plan the buffer itself is padded too:
    ``buf_valid`` marks the real rows (always the leading slots — buffer
    rows are sorted by gid), so ``buf_size`` (array shape) is
    plan-invariant while ``n_unique`` (accounting) tracks the membership.
    """
    send_row: np.ndarray       # [P, S] inner rows owners contribute
    send_valid: np.ndarray     # [P, S] bool
    src_part: np.ndarray       # [G] owner partition per buffer row
    src_slot: np.ndarray       # [G] slot in owner's send buffer
    read_pos: np.ndarray       # [P, RG] halo positions served from the buffer
    read_buf_idx: np.ndarray   # [P, RG] buffer row per read
    read_valid: np.ndarray     # [P, RG] bool
    buf_valid: np.ndarray | None = None   # [G] bool (None => all real)

    def __post_init__(self):
        if self.buf_valid is None:
            object.__setattr__(self, "buf_valid",
                               np.ones(self.src_part.shape[0], bool))

    @property
    def n_unique(self) -> int:
        """Unique vertices resident in (and read from) the global buffer."""
        return int(self.buf_valid.sum())

    @property
    def buf_size(self) -> int:
        """Padded buffer row count (the runtime cache allocation)."""
        return int(self.src_part.shape[0])


@dataclasses.dataclass(frozen=True)
class HostTier:
    """The out-of-core layer-0 fetch program of the ``features="host"``
    runtimes: per worker, the halo positions whose *input features* are
    fetched from the host store every step instead of living stacked on
    device.

    Membership = the uncached tier ∪ the global-tier reads (the rows not
    held in the worker's device-resident local cache; the local tier's
    layer-0 rows stay device-cached — ``cal_capacity`` already charges
    every cached vertex for the input dim).  Same valid-mask/padding
    contract as the wire tiers: under a capacity-padded plan the width is
    ``un_recv + glob_read``, so re-plans swap membership as data without
    changing shapes.
    """
    feat_pos: np.ndarray     # [P, W] halo positions staged from host
    feat_valid: np.ndarray   # [P, W] bool

    @property
    def n_fetch_rows(self) -> int:
        """Rows staged host→device per step (one per (vertex, consumer) —
        the PCIe fetch is per worker, like the uncached wire tier)."""
        return int(self.feat_valid.sum())

    @property
    def width(self) -> int:
        return int(self.feat_pos.shape[1])


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Compiled communication program for one CachePlan."""
    num_parts: int
    uncached: ExchangeTier
    local: ExchangeTier
    glob: GlobalTier
    refresh_every: int
    total_halo: int
    host: HostTier | None = None   # layer-0 out-of-core fetch program

    def bytes_per_step(self, feat_dim: int, refresh: bool,
                       dtype_bytes: int = 4) -> int:
        """Bytes of one layer exchange of width ``feat_dim`` under the
        paper's point-to-point transport model: one row per (vertex,
        consumer) for the uncached/local tiers, one row per unique vertex
        for the global tier.  The plan's index sets count these rows
        exactly; matches the JAX package's ``comm_bytes_per_step``
        (asserted by the tier-1 suite).  The ``capgnn_spmd`` runtime's
        ``transport="p2p"`` ships exactly these rows (per-peer packed
        ``ppermute`` blocks — each tier row originates once per consumer,
        each global row once total), so these figures ARE its wire
        accounting; ``transport="allgather"`` replicates every send
        buffer to all P devices and moves ~P x more.  ``dtype_bytes``
        must be the actual halo payload width (4 for f32, 2 for the
        ``halo_dtype="bf16"`` compressed transport).
        """
        row = feat_dim * dtype_bytes
        n = self.uncached.n_rows
        if refresh:
            n += self.local.n_rows + self.glob.n_unique
        return n * row

    def transport_rows(self, transport: str, refresh: bool,
                       padded: bool = False) -> dict:
        """Rows crossing the wire in one layer exchange under a transport.

        ``padded=False`` counts real (valid) rows *originated* into the
        transport — for ``"p2p"`` this equals the paper accounting of
        :meth:`bytes_per_step` exactly; for ``"allgather"`` every owner's
        send buffer lands on all P devices, hence the ~P x blow-up.
        ``padded=True`` additionally counts the static-shape padding the
        collectives actually carry (what HLO wire counters see).
        """
        if transport not in ("p2p", "allgather"):
            raise ValueError(f"unknown transport {transport!r}; "
                             "expected 'p2p' or 'allgather'")
        p = self.num_parts

        def tier_rows(t: ExchangeTier) -> int:
            if transport == "p2p":
                # one ppermute per (owner, peer != owner) block
                return (p * (p - 1) * t.peer_block if padded
                        else t.n_peer_rows)
            # all_gather: every owner's padded buffer to all P devices
            width = t.send_row.shape[1]
            return p * p * width if padded else p * t.n_send_rows

        def glob_rows() -> int:
            if transport == "p2p":
                # ring broadcast: each unique row originates once, then
                # circulates; padding rides every one of the P-1 rotations
                width = self.glob.send_row.shape[1]
                return p * (p - 1) * width if padded else self.glob.n_unique
            width = self.glob.send_row.shape[1]
            return (p * p * width if padded
                    else p * int(self.glob.send_valid.sum()))

        out = {"uncached": tier_rows(self.uncached)}
        out["local"] = tier_rows(self.local) if refresh else 0
        out["global"] = glob_rows() if refresh else 0
        out["total"] = out["uncached"] + out["local"] + out["global"]
        return out

    def host_fetch_rows(self, consume_stale: bool, stale_layers: int) -> dict:
        """Rows a ``features="host"`` step stages host→device (PCIe):
        the layer-0 host tier every step, plus — on stale-consuming
        (cached/pipelined) steps — each exchange layer's deduplicated
        global buffer.  Exact counts; the staged buffers' valid rows and
        the host store's accounted fetches must equal these (asserted by
        the out-of-core harness)."""
        if self.host is None:
            raise ValueError("plan has no host tier (built by an older "
                             "build_exchange_plan?)")
        l0 = self.host.n_fetch_rows
        gl = self.glob.n_unique * max(0, stale_layers) if consume_stale else 0
        return {"l0": l0, "global": gl, "total": l0 + gl}

    def host_bytes_per_step(self, feat_dim: int, dims,
                            consume_stale: bool,
                            dtype_bytes: int = 4) -> int:
        """Host→device bytes of one ``features="host"`` step:
        ``feat_dim``-wide layer-0 rows every step plus the staged global
        buffers (``dims`` = the stale exchange-layer widths) on
        stale-consuming steps, at the staged payload width
        (``dtype_bytes``: 2 under ``halo_dtype="bf16"``)."""
        if self.host is None:
            raise ValueError("plan has no host tier")
        n = self.host.n_fetch_rows * feat_dim
        if consume_stale:
            n += sum(self.glob.n_unique * int(d) for d in dims)
        return n * dtype_bytes

    def host_writeback_bytes(self, dims) -> int:
        """Device→host bytes of one emit (refresh/pipelined/transition)
        step: each exchange layer's freshly built global buffer is written
        back dequantised (f32), matching the device-mode cache content."""
        return sum(self.glob.n_unique * int(d) * 4 for d in dims)


def _pad2(rows: list[np.ndarray], fill: int, dtype=np.int32,
          width: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged int rows into [P, width] + validity mask (``width``
    defaults to the ragged maximum; an explicit capacity must cover it)."""
    p = len(rows)
    natural = max((r.shape[0] for r in rows), default=0)
    if width is None:
        width = natural
    elif width < natural:
        raise ValueError(f"pad width {width} < ragged maximum {natural}")
    out = np.full((p, width), fill, dtype=dtype)
    valid = np.zeros((p, width), dtype=bool)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
        valid[i, : r.shape[0]] = True
    return out, valid


def _owner_slots(op_all: np.ndarray, orow_all: np.ndarray, num_parts: int
                 ) -> tuple[list[np.ndarray], np.ndarray]:
    """Deduplicated per-owner send-slot allocation, vectorized.

    For ``(owner, row)`` request pairs, returns the unique rows each owner
    must send (sorted by row) and, per input pair, the slot of its row in
    the owner's send buffer.  O(N log N) in numpy — plan compilation stays
    cheap at million-halo scale.
    """
    if op_all.size == 0:
        return ([np.zeros(0, np.int64) for _ in range(num_parts)],
                np.zeros(0, np.int64))
    base = int(orow_all.max()) + 1
    key = op_all.astype(np.int64) * base + orow_all.astype(np.int64)
    uniq_key, inverse = np.unique(key, return_inverse=True)
    u_op = uniq_key // base
    u_row = uniq_key % base
    first = np.searchsorted(u_op, np.arange(num_parts))
    slot_of_uniq = np.arange(uniq_key.size) - first[u_op]
    send_rows = [u_row[u_op == q] for q in range(num_parts)]
    return send_rows, slot_of_uniq[inverse]


def _peer_blocks(gids_per_part: list[np.ndarray], owner_part: np.ndarray,
                 owner_row: np.ndarray, num_parts: int,
                 width: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Per-destination packed send blocks, vectorized.

    For each (owner i, consumer j) pair, the inner rows i must ship to j
    (sorted by row), padded to the fleet-wide max block; plus, per
    consumer, the slot of each of its tier gids inside its (owner -> me)
    block.  A gid consumed by k partitions occupies one slot in each of
    its k destination blocks — no cross-peer dedup, that is the
    point-to-point transport's one-row-per-(vertex, consumer) contract.
    """
    p = num_parts
    counts = [g.size for g in gids_per_part]
    total = sum(counts)
    if total == 0:
        w0 = width or 0
        return (np.zeros((p, p, w0), np.int32), np.zeros((p, p, w0), bool),
                [np.zeros(0, np.int64) for _ in range(p)])
    gids_all = np.concatenate(gids_per_part)
    cons_all = np.repeat(np.arange(p), counts)
    op_all = owner_part[gids_all]
    orow_all = owner_row[gids_all]
    base = int(orow_all.max()) + 1
    pair = op_all * p + cons_all                     # block id in [0, p*p)
    order = np.argsort(pair * base + orow_all, kind="stable")
    pair_s = pair[order]
    first = np.searchsorted(pair_s, np.arange(p * p))
    slot_s = np.arange(total) - first[pair_s]        # slot within block
    slot = np.empty(total, np.int64)
    slot[order] = slot_s
    natural = int(np.bincount(pair, minlength=p * p).max())
    if width is None:
        width = natural
    elif width < natural:
        raise ValueError(f"peer pad width {width} < block maximum {natural}")
    peer_row = np.zeros((p * p, width), np.int32)
    peer_valid = np.zeros((p * p, width), dtype=bool)
    peer_row[pair_s, slot_s] = orow_all[order]
    peer_valid[pair_s, slot_s] = True
    offsets = np.cumsum([0] + counts)
    slots_per_part = [slot[offsets[i]: offsets[i + 1]] for i in range(p)]
    return (peer_row.reshape(p, p, width), peer_valid.reshape(p, p, width),
            slots_per_part)


def build_exchange_plan(ps: PartitionSet, plan: CachePlan,
                        pad_to: ExchangeCapacity | None = None
                        ) -> ExchangePlan:
    """Compile ``plan``'s tiering into static gather/scatter index sets.

    ``pad_to`` (from :func:`exchange_capacity`) pads every tier array to
    capacity widths instead of this plan's maxima — any two plans compiled
    with the same ``pad_to`` have byte-identical shapes (the slot-stable
    layout online re-planning needs).
    """
    p = ps.num_parts
    n = ps.graph.num_nodes
    owner_row = np.full(n, -1, np.int64)
    for part in ps.parts:
        owner_row[part.inner_nodes] = np.arange(part.n_inner)
    owner_part = ps.assign.astype(np.int64)

    def build_tier(name: str, gids_per_part: list[np.ndarray],
                   pos_per_part: list[np.ndarray],
                   recv_w: int | None, send_w: int | None,
                   peer_w: int | None) -> ExchangeTier:
        counts = [g.size for g in gids_per_part]
        gids_all = (np.concatenate(gids_per_part) if sum(counts)
                    else np.zeros(0, np.int64))
        send_rows, slots_all = _owner_slots(owner_part[gids_all],
                                            owner_row[gids_all], p)
        offsets = np.cumsum([0] + counts)
        src_parts = [owner_part[g].astype(np.int32) for g in gids_per_part]
        src_slots = [slots_all[offsets[i]: offsets[i + 1]].astype(np.int32)
                     for i in range(p)]
        send_row, send_valid = _pad2([r.astype(np.int32)
                                      for r in send_rows], fill=0,
                                     width=send_w)
        recv_src_part, recv_valid = _pad2(src_parts, fill=0, width=recv_w)
        recv_src_slot, _ = _pad2(src_slots, fill=0, width=recv_w)
        recv_halo_pos, _ = _pad2([np.asarray(q, np.int32)
                                  for q in pos_per_part], fill=0,
                                 width=recv_w)
        peer_row, peer_valid, peer_slots = _peer_blocks(
            gids_per_part, owner_part, owner_row, p, width=peer_w)
        recv_peer_slot, _ = _pad2([s.astype(np.int32)
                                   for s in peer_slots], fill=0,
                                  width=recv_w)
        return ExchangeTier(name=name, send_row=send_row,
                            send_valid=send_valid,
                            recv_src_part=recv_src_part,
                            recv_src_slot=recv_src_slot,
                            recv_halo_pos=recv_halo_pos,
                            recv_valid=recv_valid,
                            peer_send_row=peer_row,
                            peer_send_valid=peer_valid,
                            recv_peer_slot=recv_peer_slot)

    pt = pad_to
    uncached = build_tier("uncached",
                          [w.uncached_gids for w in plan.workers],
                          [w.uncached_pos for w in plan.workers],
                          recv_w=pt.un_recv if pt else None,
                          send_w=pt.send if pt else None,
                          peer_w=pt.peer if pt else None)
    local = build_tier("local",
                       [w.local_gids for w in plan.workers],
                       [w.local_pos for w in plan.workers],
                       recv_w=pt.loc_recv if pt else None,
                       send_w=pt.send if pt else None,
                       peer_w=pt.peer if pt else None)

    # Global tier: unique over the gids any worker actually reads (resident
    # rows no one consumes are never refreshed, so they cost nothing).
    read_gids = [w.global_gids for w in plan.workers]
    if any(g.size for g in read_gids):
        used = np.unique(np.concatenate([g for g in read_gids if g.size]))
    else:
        used = np.zeros(0, np.int64)
    g_send_rows, g_slots = _owner_slots(owner_part[used], owner_row[used], p)
    g_src_part = owner_part[used].astype(np.int32)
    g_src_slot = g_slots.astype(np.int32)
    g_send_row, g_send_valid = _pad2([r.astype(np.int32)
                                      for r in g_send_rows], fill=0,
                                     width=pt.glob_send if pt else None)
    # pad the buffer itself: real rows occupy the leading slots
    buf = pt.glob_buf if pt else used.size
    if buf < used.size:
        raise ValueError(f"global buffer capacity {buf} < plan's "
                         f"{used.size} unique consumed vertices")
    buf_valid = np.zeros(buf, bool)
    buf_valid[: used.size] = True
    g_src_part = np.concatenate(
        [g_src_part, np.zeros(buf - used.size, np.int32)])
    g_src_slot = np.concatenate(
        [g_src_slot, np.zeros(buf - used.size, np.int32)])
    # `used` is sorted, so buffer indices come straight from searchsorted
    read_buf_idx, read_valid = _pad2(
        [np.searchsorted(used, w.global_gids).astype(np.int32)
         for w in plan.workers], fill=0,
        width=pt.glob_read if pt else None)
    read_pos, _ = _pad2([w.global_pos.astype(np.int32)
                         for w in plan.workers], fill=0,
                        width=pt.glob_read if pt else None)
    glob = GlobalTier(send_row=g_send_row, send_valid=g_send_valid,
                      src_part=g_src_part, src_slot=g_src_slot,
                      read_pos=read_pos, read_buf_idx=read_buf_idx,
                      read_valid=read_valid, buf_valid=buf_valid)

    # Host tier (out-of-core layer 0): every halo position NOT in the
    # worker's device-resident local cache — uncached ∪ global reads —
    # fetched from the host feature store each step.  Capacity width is
    # the sum of the two member tiers' widths, so it is slot-stable
    # whenever they are.
    host_pos = [np.concatenate([np.asarray(w.uncached_pos, np.int64),
                                np.asarray(w.global_pos, np.int64)])
                for w in plan.workers]
    host_w = (pt.un_recv + pt.glob_read) if pt else None
    feat_pos, feat_valid = _pad2([q.astype(np.int32) for q in host_pos],
                                 fill=0, width=host_w)
    host = HostTier(feat_pos=feat_pos, feat_valid=feat_valid)

    return ExchangePlan(num_parts=p, uncached=uncached, local=local,
                        glob=glob, refresh_every=plan.refresh_every,
                        total_halo=ps.total_halo(), host=host)


# ---------------------------------------------------------------------------
# Stacked partition layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackedEllPack:
    """Stacked blocked-ELL (+ optional COO tail) aggregation pack.

    Built from the same remapped edge lists as ``StackedParts.e_*``, so
    ``ell_spmm(cols[i], vals[i], concat([h_inner, h_halo]))`` equals the
    segment-sum over that partition's edges bit-for-bit (up to summation
    order).  ELL padding slots carry col 0 / val 0; the per-partition packs
    are padded to the fleet-wide ``max_deg`` and tail width.  For the pure
    ``"ell"`` backend the tail arrays have zero width.
    """
    backend: str               # "ell" | "hybrid"
    cols: np.ndarray           # [P, NI, K] int32 in [0, NI+NH)
    vals: np.ndarray           # [P, NI, K] float32 (0 at padding)
    tail_src: np.ndarray       # [P, MT] int32 in [0, NI+NH)
    tail_dst: np.ndarray       # [P, MT] int32 in [0, NI] (NI = padding)
    tail_w: np.ndarray         # [P, MT] float32 (0 at padding)

    @property
    def max_deg(self) -> int:
        return int(self.cols.shape[2])

    @property
    def tail_width(self) -> int:
        return int(self.tail_src.shape[1])


@dataclasses.dataclass(frozen=True)
class StackedParts:
    """Padded ``[P, ...]`` stacking of every partition's task slice.

    Local edge src ids are remapped so halo position ``q`` becomes column
    ``n_inner_max + q`` — the runtimes concatenate ``[h_inner, h_halo]``
    along rows, so the remap must target the *padded* inner width.  Padding
    edges carry ``dst = n_inner_max`` (dropped by segment ops) and zero
    weight; padded label/mask rows are zeroed so they never touch the loss.

    ``ell`` optionally carries the stacked blocked-ELL/hybrid aggregation
    pack (``stack_partitions(..., backend="ell" | "hybrid")``) consumed by
    the ELL-SpMM kernel backends; the edge-list arrays are
    always present (GAT and the reference backend need them).

    With resource-aware *uneven* partitions the per-part widths are
    ragged; ``inner_valid``/``halo_valid`` mark the real rows of each
    stacked slot (padding rows carry zero features/labels/masks and never
    touch loss or accuracy) and :meth:`padding_stats` quantifies the
    padded-row waste the rectangular layout carries.
    """
    num_parts: int
    n_inner_max: int
    n_halo_max: int
    n_inner: np.ndarray        # [P]
    n_halo: np.ndarray         # [P]
    feats: np.ndarray          # [P, NI, F] inner input features
    halo_feats: np.ndarray     # [P, NH, F] halo input features (static)
    labels: np.ndarray         # [P, NI] int32
    train_mask: np.ndarray     # [P, NI] float32
    val_mask: np.ndarray       # [P, NI] float32
    test_mask: np.ndarray      # [P, NI] float32
    e_src: np.ndarray          # [P, ME] int32 in [0, NI+NH)
    e_dst: np.ndarray          # [P, ME] int32 in [0, NI] (NI = padding)
    e_w: np.ndarray            # [P, ME] float32 (0 at padding)
    ell: StackedEllPack | None = None
    inner_valid: np.ndarray | None = None   # [P, NI] bool
    halo_valid: np.ndarray | None = None    # [P, NH] bool

    def __post_init__(self):
        if self.inner_valid is None:
            iv = (np.arange(self.n_inner_max)[None, :]
                  < np.asarray(self.n_inner)[:, None])
            object.__setattr__(self, "inner_valid", iv)
        if self.halo_valid is None:
            hv = (np.arange(self.n_halo_max)[None, :]
                  < np.asarray(self.n_halo)[:, None])
            object.__setattr__(self, "halo_valid", hv)

    @property
    def n_edges(self) -> np.ndarray:
        """Real (un-padded) edge count per part; padding slots carry
        ``dst == n_inner_max``."""
        return (self.e_dst < self.n_inner_max).sum(axis=1).astype(np.int64)

    def padding_stats(self) -> dict:
        """Valid vs padded slot counts of the rectangular stacked layout —
        the waste uneven partitioning is judged on in
        ``benchmarks/heterogeneous.py``."""
        p = self.num_parts
        rows = {
            "inner": (int(self.inner_valid.sum()), p * self.n_inner_max),
            "halo": (int(self.halo_valid.sum()), p * self.n_halo_max),
            "edges": (int(self.n_edges.sum()), p * int(self.e_src.shape[1])),
        }
        out = {}
        valid = total = 0
        for name, (v, t) in rows.items():
            out[f"{name}_valid_rows"] = v
            out[f"{name}_padded_rows"] = t - v
            valid += v
            total += t
        out["waste_frac"] = float((total - valid) / max(total, 1))
        return out


def _stack_ell(edge_lists: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
               n_inner_max: int, backend: str, quantile: float
               ) -> StackedEllPack:
    """Pack every partition's (remapped) edges to ELL/hybrid and pad the
    packs to a common ``[P, NI, K]`` (+ ``[P, MT]`` tail) layout."""
    from ..kernels.ops import ell_pack, ell_pack_hybrid

    packs = []
    for src, dst, w in edge_lists:
        if backend == "hybrid":
            packs.append(ell_pack_hybrid(src, dst, w, n_inner_max,
                                         quantile=quantile))
        else:
            c, v = ell_pack(src, dst, w, n_inner_max)
            empty = np.zeros(0, np.int32)
            packs.append((c, v, empty, empty.copy(),
                          np.zeros(0, np.float32)))

    p = len(packs)
    k = max(c.shape[1] for c, *_ in packs)
    mt = max(ts.shape[0] for _, _, ts, _, _ in packs)
    cols = np.zeros((p, n_inner_max, k), np.int32)
    vals = np.zeros((p, n_inner_max, k), np.float32)
    tail_src = np.zeros((p, mt), np.int32)
    tail_dst = np.full((p, mt), n_inner_max, np.int32)  # NI row => dropped
    tail_w = np.zeros((p, mt), np.float32)
    for i, (c, v, ts, td, tw) in enumerate(packs):
        cols[i, :, : c.shape[1]] = c
        vals[i, :, : v.shape[1]] = v
        tail_src[i, : ts.shape[0]] = ts
        tail_dst[i, : td.shape[0]] = td
        tail_w[i, : tw.shape[0]] = tw
    return StackedEllPack(backend=backend, cols=cols, vals=vals,
                          tail_src=tail_src, tail_dst=tail_dst, tail_w=tail_w)


def stack_partitions(ps: PartitionSet, task: FullBatchTask,
                     backend: str = "edges",
                     ell_quantile: float = 0.95,
                     pad_to: tuple[int, int] | None = None) -> StackedParts:
    """Stack per-partition task slices; ``backend="ell" | "hybrid"`` also
    builds the stacked ELL aggregation pack (``StackedEllPack``) the
    runtimes' non-edge-list backends consume.

    ``pad_to=(ni, nh)`` overrides the inner/halo padding widths (must
    cover the ragged maxima) — two partitionings stacked to the same
    widths produce shape-identical layouts, the stacking analogue of the
    exchange plan's slot-stable capacity padding.
    """
    if backend not in ("edges", "ell", "hybrid"):
        raise ValueError(f"unknown stacking backend {backend!r}; "
                         "expected 'edges', 'ell' or 'hybrid'")
    p = ps.num_parts
    ni = max(1, max(pt.n_inner for pt in ps.parts))
    nh = max(1, max(pt.n_halo for pt in ps.parts))
    if pad_to is not None:
        if pad_to[0] < ni or pad_to[1] < nh:
            raise ValueError(f"pad_to {pad_to} < ragged maxima ({ni}, {nh})")
        ni, nh = int(pad_to[0]), int(pad_to[1])
    f = task.features.shape[1]

    feats = np.zeros((p, ni, f), np.float32)
    halo_feats = np.zeros((p, nh, f), np.float32)
    labels = np.zeros((p, ni), np.int32)
    masks = {k: np.zeros((p, ni), np.float32)
             for k in ("train", "val", "test")}

    edge_lists = []
    for i, pt in enumerate(ps.parts):
        feats[i, : pt.n_inner] = task.features[pt.inner_nodes]
        halo_feats[i, : pt.n_halo] = task.features[pt.halo_nodes]
        labels[i, : pt.n_inner] = task.labels[pt.inner_nodes]
        masks["train"][i, : pt.n_inner] = task.train_mask[pt.inner_nodes]
        masks["val"][i, : pt.n_inner] = task.val_mask[pt.inner_nodes]
        masks["test"][i, : pt.n_inner] = task.test_mask[pt.inner_nodes]
        src, dst = pt.local_graph.edges()
        keep = dst < pt.n_inner
        src, dst = src[keep], dst[keep]
        w = (pt.local_graph.edge_weight[keep]
             if pt.local_graph.edge_weight is not None
             else np.ones(src.shape[0], np.float32))
        src = np.where(src < pt.n_inner, src, ni + (src - pt.n_inner))
        edge_lists.append((src.astype(np.int32), dst.astype(np.int32),
                           w.astype(np.float32)))

    me = max(1, max(s.shape[0] for s, _, _ in edge_lists))
    e_src = np.zeros((p, me), np.int32)
    e_dst = np.full((p, me), ni, np.int32)   # NI row => dropped by segments
    e_w = np.zeros((p, me), np.float32)
    for i, (src, dst, w) in enumerate(edge_lists):
        m = src.shape[0]
        e_src[i, :m] = src
        e_dst[i, :m] = dst
        e_w[i, :m] = w

    ell = (_stack_ell(edge_lists, ni, backend, ell_quantile)
           if backend in ("ell", "hybrid") else None)

    return StackedParts(
        num_parts=p, n_inner_max=ni, n_halo_max=nh,
        n_inner=np.array([pt.n_inner for pt in ps.parts], np.int32),
        n_halo=np.array([pt.n_halo for pt in ps.parts], np.int32),
        feats=feats, halo_feats=halo_feats, labels=labels,
        train_mask=masks["train"], val_mask=masks["val"],
        test_mask=masks["test"], e_src=e_src, e_dst=e_dst, e_w=e_w,
        ell=ell)
