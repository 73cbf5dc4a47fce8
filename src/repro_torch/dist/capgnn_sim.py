"""Single-process stacked runtime of CaPGNN training (the JAX package's
``capgnn_sim``), with device-resident features.

Every partition's state lives in one padded ``[P, ...]`` tensor; the
inter-worker exchange is gather/scatter index arithmetic over the stacked
inner matrix, compiled by :func:`repro_torch.dist.exchange.build_exchange_plan`.
The JAX package's ``vmap`` over partitions is the explicit batch: one
aggregation call per layer covers all P partitions (with ``ell`` or
``hybrid`` on the card, one ELL-SpMM kernel launch forward, for
``hybrid`` one CSR kernel launch over the COO tail, and, from layer 1
on, one CSR kernel launch backward for ``d_h``; a SAGE layer's
``degree()`` adds one ELL and one tail launch forward).  Every model of
``models.gnn`` runs here; GAT on ``edges`` only, as the reference.

From layer 1 on, each non-empty tier pull (the uncached and local tiers,
the global buffer's fill and its reads) is one row gather
(``ops.pack_rows``) over maps built once per plan
(:func:`exchange_arrays`): on the card one gather-kernel launch forward
and, where the pull is differentiated, one CSR kernel launch backward
over the transposed index map.  The owner's send pack and the consumer's
addressing are composed into one gather over the flattened inner matrix
(the rows bit for bit those of the JAX package's two-stage pull); on a
bf16 wire (``halo_dtype``) the two stages stay apart, so a payload row's
gradient rounds to bf16 as the reference's does.

Three step flavours (paper §4.2/§4.3), the same numerics as the reference:

- ``step_refresh``   — all three tiers pulled fresh (inside the autograd
  graph: gradients reach the owners' rows); caches rewritten;
- ``step_cached``    — local/global tiers read stale from the caches
  (constants); only the uncached tier is exchanged;
- ``step_pipelined`` — ``step_cached``'s numerics, and this step's fresh
  tier rows emitted as the next caches.

Stored caches are always detached.  PyTorch runs eagerly, so a cached
step pulls no fresh tier it would discard, and a pipelined step pulls its
emitted rows outside the autograd graph.  Updates return new tensors: a
step consumes nothing of its arguments.

``features="host"`` is the out-of-core mode: the halo feature table stays
in a :class:`~repro_torch.dist.host_store.HostFeatureStore`.  Layer 0's
local-tier rows are staged once per plan install (``l0loc``, the device
cached JACA local tier); the host tier's rows (uncached and global
membership) ride the store's ring, the next step's fetch gathered and its
copy issued right after this step's work is issued; the per-layer global
buffers live on the host between steps (written back on emitting steps,
staged for the stale reads).  ``train_capgnn`` takes an
:class:`~repro_torch.core.jaca.AdaptivePlanner` and swaps its re-plans in
at the controller's boundaries (``set_plan`` / ``step_transition``).

Faults, defenses and tracing (``train_capgnn``'s ``faults``, ``guard``
and ``tracer``; :mod:`repro_torch.faults`, :mod:`repro_torch.obs`) follow
the JAX package's loop step for step.  With none of them the steps run
no extra code: no sync beyond the one per step at the loss.  The step
code names its device work with ``torch.profiler`` ranges at the JAX
package's sites (``tier_pull_uncached``, ``tier_pull_refresh``,
``refresh_ring_issue``, ``layer{li}/spmm``, ``refresh_ring_advance``,
``refresh_ring_finish``): with no capture running they record nothing.

The reference drops out-of-range scatter indices (``mode="drop"``); torch
raises on them instead, so :func:`_scatter` writes into one spare row and
slices it off.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from ..core.staleness import StalenessController
from ..faults.guard import GuardConfig, TrainGuard
from ..faults.plan import NULL_FAULTS
from ..kernels.ops import (ell_row_end, gather_pack, pack_rows, tail_csr,
                           transpose_csr)
from ..models.gnn import (EdgeListAdj, EllAdj, GNNConfig, HybridAdj,
                          _layer_apply, init_gnn)
from ..obs.annotations import device_scope, host_annotation
from ..obs.tracer import NULL_TRACER, StepCounters, device_peak_bytes
from ..optim import Optimizer, tree_leaves, tree_map
from .exchange import ExchangePlan, ExchangeTier, GlobalTier, StackedParts
from .host_store import HostFeatureStore, halo_dtype_info
from .spec import TrainSpec

__all__ = ["RUNTIME_BACKENDS", "RUNTIME_FEATURES", "check_backend",
           "make_adj_builder", "exchange_arrays", "init_caches",
           "SimRuntime", "make_sim_runtime", "TrainReport", "train_capgnn"]

RUNTIME_BACKENDS = ("edges", "ell", "hybrid")
# where the input features live: stacked on the device, or host-resident
# with per-step staged fetch of the non-locally-cached halo rows
RUNTIME_FEATURES = ("device", "host")


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def _mask(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, bool), device=device)


def _gather_map(idx: np.ndarray, valid: np.ndarray, n_src: int, device,
                grad: bool) -> dict:
    """One gather of the exchange: the ids (int32, -1 where ``valid`` is
    false, which reads a zero row) and, when ``grad`` asks for the
    backward, their transposed index map (:func:`~repro_torch.kernels.ops.
    gather_pack`, invalid ids left out)."""
    ids = np.where(valid, idx, -1).astype(np.int32)
    return {"idx": torch.as_tensor(ids, device=device),
            "pack": gather_pack(ids, n_src, device=device) if grad else None}


def _pull_maps(send_row: np.ndarray, send_valid: np.ndarray,
               part: np.ndarray, slot: np.ndarray, valid: np.ndarray,
               n_inner: int, device, grad: bool, halo_dtype) -> dict:
    """The gathers of one pull: the owners' send pack ``send_row [P, S]``
    addressed by the consumers' ``(part, slot)``; ``"wire"`` records the
    payload dtype they were built for (``halo_dtype``).

    With no ``halo_dtype``, one gather from the flattened inner matrix
    ``[P * n_inner, d]`` (``"pull"``): the owner's row composed with the
    address, ``part * n_inner + send_row[part, slot]``.  With a halo dtype
    on the wire the two stages stay apart, as in the JAX package: the
    pack (``"send"``, ``[P * S]`` ids) and the addressing of the cast
    payload (``"addr"``, ``part * S + slot``), so a payload row addressed
    by several consumers sums their gradients in the wire dtype."""
    send_row = np.asarray(send_row, np.int64)
    part, slot = np.asarray(part, np.int64), np.asarray(slot, np.int64)
    n_parts, n_send = send_row.shape
    if halo_dtype is None:
        return {"wire": None,
                "pull": _gather_map(part * n_inner + send_row[part, slot],
                                    valid, n_parts * n_inner, device, grad)}
    owner = np.arange(n_parts)[:, None] * n_inner + send_row
    return {"wire": halo_dtype,
            "send": _gather_map(owner, send_valid, n_parts * n_inner,
                                device, grad),
            "addr": _gather_map(part * n_send + slot, valid,
                                n_parts * n_send, device, grad)}


def _tier_dict(t: ExchangeTier, n_inner: int, device="cpu",
               grad: bool = True, halo_dtype=None) -> dict:
    """A tier's pull (:func:`_pull_maps`) and its scatter positions."""
    return {"pull": _pull_maps(t.send_row, t.send_valid, t.recv_src_part,
                               t.recv_src_slot, t.recv_valid, n_inner,
                               device, grad, halo_dtype),
            "recv_halo_pos": _idx(t.recv_halo_pos, device),
            "recv_valid": _mask(t.recv_valid, device)}


def _glob_dict(g: GlobalTier, n_inner: int, device="cpu",
               grad: bool = True, halo_dtype=None) -> dict:
    """The global tier: the buffer's fill (:func:`_pull_maps`;
    capacity-padding slots read zero rows) and each worker's reads as one
    gather from the buffer (invalid reads too)."""
    return {"fill": _pull_maps(g.send_row, g.send_valid, g.src_part,
                               g.src_slot, g.buf_valid, n_inner, device,
                               grad, halo_dtype),
            "read": _gather_map(np.asarray(g.read_buf_idx),
                                np.asarray(g.read_valid), g.buf_size,
                                device, grad),
            "read_pos": _idx(g.read_pos, device),
            "read_valid": _mask(g.read_valid, device)}


def _gather(gm: dict, src: torch.Tensor) -> torch.Tensor:
    """``src[gm["idx"]]`` through :func:`~repro_torch.kernels.ops.pack_rows`:
    the gather kernel forward and, where autograd records, the CSR kernel
    over ``gm["pack"]`` backward."""
    return pack_rows(src, gm["idx"], gm["pack"])


def _rows(maps: dict, h: torch.Tensor, halo_dtype) -> torch.Tensor:
    """The rows a pull delivers from ``h [P, NI, d]``, in ``h.dtype``:
    one composed gather (maps built with no wire dtype), or the two
    stages with the payload cast to ``halo_dtype`` between them.  Raises
    ``ValueError`` when ``halo_dtype`` is not the dtype the maps were
    built for."""
    if halo_dtype != maps["wire"]:
        raise ValueError(f"a pull with halo dtype {halo_dtype} over maps "
                         f"built for {maps['wire']}; build them with "
                         "exchange_arrays(..., halo_dtype=...)")
    flat = h.reshape(-1, h.shape[-1])
    if halo_dtype is None:
        return _gather(maps["pull"], flat)
    payload = _gather(maps["send"], flat).reshape(-1, flat.shape[1])
    return _gather(maps["addr"], payload.to(halo_dtype)).to(h.dtype)


def _pull(td: dict, h: torch.Tensor, halo_dtype=None) -> torch.Tensor:
    """Gather one tier's rows from the stacked inner matrix ``h [P,NI,d]``.

    Owners pack their send buffers, consumers address the payload by
    (src_part, src_slot), through the gathers of :func:`_pull_maps`;
    invalid (padding) rows read zero rows.  ``halo_dtype`` casts the
    packed payload before "transport" and dequantises the addressed rows
    back to ``h.dtype``.  Returns ``[P, R, d]``.
    """
    return _rows(td["pull"], h, halo_dtype)


def _scatter(halo: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Scatter tier rows into the halo buffer ``[P, NH, d]`` at ``pos``;
    invalid entries go to a spare row ``NH`` that is sliced off."""
    n_parts, nh = halo.shape[0], halo.shape[1]
    spare = halo.new_zeros((n_parts, 1) + tuple(halo.shape[2:]))
    buf = torch.cat([halo, spare], dim=1)
    pos_eff = torch.where(valid, pos, nh)
    pidx = torch.arange(n_parts, device=halo.device)[:, None]
    buf[pidx, pos_eff] = rows.to(buf.dtype)
    return buf[:, :nh]


def _build_global(gd: dict, h: torch.Tensor, halo_dtype=None) -> torch.Tensor:
    """Fill the deduplicated global buffer ``[G, d]`` from owners' rows
    (dequantised to ``h.dtype``; capacity-padding slots zero)."""
    return _rows(gd["fill"], h, halo_dtype)


def _read_global(gd: dict, buf: torch.Tensor,
                 halo: torch.Tensor) -> torch.Tensor:
    """Serve each worker's global-tier halo positions from the buffer."""
    rows = _gather(gd["read"], buf)                              # [P, RG, d]
    return _scatter(halo, gd["read_pos"], rows, gd["read_valid"])


def check_backend(sp: StackedParts, backend: str) -> None:
    """Validate a runtime backend choice against the stacked layout."""
    if backend not in RUNTIME_BACKENDS:
        raise ValueError(f"unknown aggregation backend {backend!r}; "
                         f"expected one of {RUNTIME_BACKENDS}")
    if backend != "edges" and (sp.ell is None or sp.ell.backend != backend):
        have = sp.ell.backend if sp.ell is not None else None
        raise ValueError(
            f"backend={backend!r} needs a matching stacked aggregation pack "
            f"(found {have!r}); rebuild the stacked layout with "
            f"stack_partitions(ps, task, backend={backend!r})")


def make_adj_builder(sp: StackedParts, backend: str, device="cuda",
                     grad: bool = True):
    """Return ``(leaves, build)``: ``leaves`` is a dict of the stacked
    ``[P, ...]`` aggregation tensors on ``device`` (and, for ``ell`` and
    ``hybrid``, the CSR packs the kernels walk), and ``build(leaves)`` the
    :class:`~repro_torch.models.gnn.Adjacency` over all P partitions at
    once.

    The packs are built here once, never per step: ``row_end``, the
    hybrid tail's CSR (``tail_pack``) and, when ``grad`` asks for the
    backward, the transposed CSR of the whole adjacency (``dh_pack``).
    Every backend aggregates over the identical edge set (the packs are
    built from the same remapped edge lists at stack time), so the backend
    changes the kernel only, not the logits.
    """
    check_backend(sp, backend)
    ni, nh = sp.n_inner_max, sp.n_halo_max

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    if backend == "edges":
        leaves = {"src": put(sp.e_src, torch.int64),
                  "dst": put(sp.e_dst, torch.int64),
                  "w": put(sp.e_w, torch.float32)}

        def build(lv):
            return EdgeListAdj(lv["src"], lv["dst"], lv["w"], ni, ni + nh)
        return leaves, build

    ell = sp.ell
    leaves = {"cols": put(ell.cols, torch.int32),
              "vals": put(ell.vals, torch.float32),
              "row_end": put(ell_row_end(ell.vals), torch.int32)}
    tail = ((ell.tail_src, ell.tail_dst, ell.tail_w) if backend == "hybrid"
            else ())
    leaves["dh_pack"] = (transpose_csr(ell.cols, ell.vals, ni + nh, *tail,
                                       device=device) if grad else None)
    if backend == "ell":
        def build(lv):
            return EllAdj(lv["cols"], lv["vals"], ni + nh, lv["row_end"],
                          lv["dh_pack"])
        return leaves, build

    leaves.update(tail_src=put(ell.tail_src, torch.int64),
                  tail_dst=put(ell.tail_dst, torch.int64),
                  tail_w=put(ell.tail_w, torch.float32),
                  tail_pack=tail_csr(*tail, ni, ni + nh, device=device))

    def build(lv):
        return HybridAdj(lv["cols"], lv["vals"], lv["tail_src"],
                         lv["tail_dst"], lv["tail_w"], ni + nh,
                         lv["row_end"], lv["tail_pack"], lv["dh_pack"])
    return leaves, build


def _host_dict(xplan: ExchangePlan, rows: slice, device) -> dict:
    """The layer-0 host tier's scatter program on ``device`` (the rows
    ``rows`` of its ``[P, W]`` arrays)."""
    if xplan.host is None:
        raise ValueError("features='host' needs a plan with a host tier "
                         "(rebuild via build_exchange_plan)")
    return {"feat_pos": _idx(xplan.host.feat_pos[rows], device),
            "feat_valid": _mask(xplan.host.feat_valid[rows], device)}


def exchange_arrays(xplan: ExchangePlan, n_inner: int, device="cuda",
                    grad: bool = True, halo_dtype=None,
                    include_host: bool = False) -> dict:
    """One plan's tier maps on ``device``, built once per plan: each
    tier's gathers (:func:`_pull_maps`, for the payload dtype
    ``halo_dtype``, None for none) over the flattened inner matrix
    (``n_inner`` rows per partition) with, when ``grad`` asks for the
    backward, their transposed index maps; scatter positions and valid
    masks.  ``include_host`` adds the layer-0 host tier's scatter program
    of the ``features="host"`` runtimes."""
    out = {"un": _tier_dict(xplan.uncached, n_inner, device, grad,
                            halo_dtype),
           "loc": _tier_dict(xplan.local, n_inner, device, grad,
                             halo_dtype),
           "gl": _glob_dict(xplan.glob, n_inner, device, grad, halo_dtype)}
    if include_host:
        out["host"] = _host_dict(xplan, slice(None), device)
    return out


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_caches(cfg: GNNConfig, xplan: ExchangePlan, num_parts: int,
                features: str = "device", device="cuda") -> dict:
    """Zero-filled stale tiers, one entry per cached exchange layer.

    Entry ``l-1`` holds the halo inputs of layer ``l`` (layers ``1..L-1``);
    layer 0 consumes the static input features, which never go stale.

    With ``features="host"`` the global tier lives in the runtime's
    :class:`~repro_torch.dist.host_store.HostFeatureStore` and is staged
    per step, so the device caches carry only the local tier.
    """
    if features not in RUNTIME_FEATURES:
        raise ValueError(f"unknown features mode {features!r}; "
                         f"expected one of {RUNTIME_FEATURES}")
    dims = cfg.feat_dims[1: cfg.num_layers]
    r_local = int(np.asarray(xplan.local.recv_halo_pos).shape[1])
    g = xplan.glob.buf_size
    return {
        "local": [torch.zeros((num_parts, r_local, d), device=device)
                  for d in dims],
        "global": ([] if features == "host" else
                   [torch.zeros((g, d), device=device) for d in dims]),
    }


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimRuntime:
    cfg: GNNConfig
    xplan: ExchangePlan
    comm_dims: list        # per-exchange-layer feature dims (byte accounting)
    forward_fresh: Callable
    step_refresh: Callable
    step_cached: Callable
    step_pipelined: Callable
    evaluate: Callable
    # (params, caches, use_stale) -> (loss, grads): one step's loss and
    # parameter gradients without the update (card-vs-CPU checks)
    loss_and_grads: Callable
    caches0: dict
    backend: str = "edges"
    halo_dtype_bytes: int = 4   # actual wire width per halo payload entry
    # feature residency: "device" (stacked on the device) or "host"
    # (out-of-core: host store + per-step staged fetch)
    features: str = "device"
    device: torch.device = torch.device("cpu")
    host_store: HostFeatureStore | None = dataclasses.field(default=None,
                                                            repr=False)
    _state: dict | None = dataclasses.field(default=None, repr=False)
    stacked: StackedParts | None = dataclasses.field(default=None, repr=False)
    spec: TrainSpec | None = dataclasses.field(default=None, repr=False)

    def padding_stats(self) -> dict:
        """Valid vs padded stacked-row counts (see
        :meth:`repro_torch.dist.StackedParts.padding_stats`)."""
        return self.stacked.padding_stats() if self.stacked else {}

    def all_parts(self, x: torch.Tensor) -> np.ndarray:
        """``x``, a per-partition ``[n_parts, ...]`` metric of this
        process (``drift_local_rows``), over every partition, on the
        host."""
        return x.cpu().numpy()

    @property
    def maps_s(self) -> float:
        """Host seconds of the last exchange-maps build (a plan install:
        the index tensors and the gathers' transposed maps)."""
        return self._state["maps_s"]

    def set_plan(self, xplan: ExchangePlan) -> None:
        """Install a re-ranked plan.  Under a capacity-padded
        (slot-stable) layout every per-step tensor keeps its shape; only
        the index data changes.  The caches' content still reflects the
        old tiering, so the next step must be a refresh (or have been
        emitted by :meth:`step_transition`).  In ``features="host"`` mode
        this also flushes the staged-fetch ring (unaccounted) and
        restages the layer-0 local tier for the new plan."""
        self._state["set_plan"](xplan)
        self.xplan = xplan

    def set_tracer(self, tracer) -> None:
        """Attach a :class:`repro_torch.obs.Tracer`: the steps record
        their staging sub-spans (``l0_stage``, ``h2d_prefetch``,
        ``writeback``) on it and the host store its ``h2d_put`` copies.
        Default is the shared no-op tracer — detaching is
        ``set_tracer(NULL_TRACER)``."""
        self._state["tracer"] = tracer
        if self.host_store is not None:
            self.host_store.set_tracer(tracer)

    def set_fault_guard(self, guard) -> None:
        """Attach a :class:`repro_torch.faults.FetchGuard`: the host-mode
        staging routes through its retry/degrade/stale-reuse paths.
        ``None`` (the default) keeps the unguarded staging code.  No-op
        in device-feature mode."""
        self._state["fetch_guard"] = guard
        if guard is not None and "l0loc" in self._state:
            # the resident layer-0 local rows are the natural stale
            # fallback for a failed re-stage at the next plan install
            guard.last_good.setdefault("l0loc", self._state["l0loc"])

    def any_rank(self, flag: bool) -> bool:
        """``flag`` of this process, or of any rank of the SPMD group: the
        guard's step-kind decisions (a forced refresh) must be the same
        on every rank."""
        return self._state["ex"].any_rank(flag)

    def step_transition(self, params, opt_state, caches,
                        new_xplan: ExchangePlan):
        """Pipelined plan switch: consume the current plan's stale tiers
        (and its uncached exchange) while pulling the **new** plan's tier
        rows; the emitted caches are laid out for ``new_xplan``, which
        becomes the installed plan.  In host mode the stale global tier
        is staged on the old plan's layout, the emitted buffers are
        written back under the new plan's membership, and the ring is
        flushed unaccounted (its prefetches carry old-plan rows)."""
        out = self._state["transition"](params, opt_state, caches,
                                        new_xplan)
        self.xplan = new_xplan
        return out


class _Ready:
    """An emitted pull that is complete when it is issued."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows

    def advance(self) -> None:
        pass

    def finish(self) -> torch.Tensor:
        return self.rows


class _StackedExchange:
    """How the single-process runtime moves tier rows: gathers over the
    stacked inner matrix (:func:`_pull`, :func:`_build_global`).  Every
    partition is in one tensor, so a sum or a max over workers is the
    identity.  The SPMD runtime puts the same hooks on a process group
    (:class:`repro_torch.dist.capgnn_spmd.WireExchange`).  ``key``, the
    ``(layer, tier)`` a wire counts a pull under, is unused here."""

    def __init__(self, halo_dtype):
        self.halo_dtype = halo_dtype

    def pull(self, td: dict, h: torch.Tensor, key) -> torch.Tensor:
        return _pull(td, h, self.halo_dtype)

    def build_global(self, gd: dict, h: torch.Tensor, key) -> torch.Tensor:
        return _build_global(gd, h, self.halo_dtype)

    def emit(self, xe: dict, h: torch.Tensor, li: int) -> tuple:
        """Layer ``li``'s refresh pulls on the emit maps ``xe``, outside
        autograd: the local tier's and the global buffer's, each with
        ``advance()`` (called after every later layer) and ``finish()``
        (after the last, giving the rows)."""
        with device_scope("tier_pull_refresh"):
            return (_Ready(self.pull(xe["loc"], h, (li, "local"))),
                    _Ready(self.build_global(xe["gl"], h, (li, "global"))))

    def sum_ranks(self, tensors: list) -> list:
        return tensors

    def max_ranks(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def any_rank(self, flag: bool) -> bool:
        return bool(flag)

    def end_step(self, logged: bool) -> None:
        """Called once a step (``logged``), a fresh forward or a
        ``loss_and_grads`` has run."""


def _build_runtime(cls, cfg: GNNConfig, sp: StackedParts,
                   view: StackedParts, xplan: ExchangePlan, opt: Optimizer,
                   spec: TrainSpec, device, ex: _StackedExchange,
                   maps: Callable, rows: slice = slice(None),
                   account_replicas: bool = True, **fields):
    """The runtime ``cls`` over the partitions of ``view`` (all of ``sp``
    in one process; one of them on an SPMD rank), which ``ex`` exchanges
    halo rows between.  ``maps(xplan)`` builds a plan's exchange maps;
    ``rows`` selects ``view``'s rows of a plan's ``[P, ...]`` arrays.

    The loss is differentiated as this process's share ``sum(nll * mask)
    / total_train``; ``ex.sum_ranks`` then sums the loss, the correct
    count and the gradients over processes outside autograd (a sum inside
    the differentiated function would inflate the gradients P-fold, as
    the JAX package's ``_device_loss`` records).

    With ``spec.features == "host"`` the halo table of ``view`` lives in a
    :class:`~.host_store.HostFeatureStore` (see the module docstring).
    ``account_replicas`` False leaves the replicated global buffers'
    writebacks and stages uncounted (an SPMD rank other than the one that
    counts them)."""
    ni, nh, n_parts = sp.n_inner_max, sp.n_halo_max, view.num_parts
    layers = cfg.num_layers
    total_train = float(max(float(np.asarray(sp.train_mask).sum()), 1.0))
    if spec.features not in RUNTIME_FEATURES:
        raise ValueError(f"unknown features mode {spec.features!r}; "
                         f"expected one of {RUNTIME_FEATURES}")
    host_mode = spec.features == "host"

    def put(a):
        return torch.as_tensor(np.asarray(a), device=device)

    feats = put(view.feats)
    # in host mode the halo table never touches device memory
    halo_feats = None if host_mode else put(view.halo_feats)
    labels = put(view.labels).reshape(-1).long()
    masks = {k: put(m).reshape(-1)
             for k, m in (("train", view.train_mask),
                          ("val", view.val_mask), ("test", view.test_mask))}
    adj_leaves, build_adj = make_adj_builder(view, spec.backend, device)
    adj = build_adj(adj_leaves)
    state: dict = {"tracer": NULL_TRACER, "fetch_guard": None, "ex": ex}

    def layer0_halo(xr, hostd):
        """Layer 0's halo inputs: the resident table, or in host mode the
        plan's ``l0loc`` scattered at the local tier's positions and this
        step's host fetch at the host tier's."""
        if hostd is None:
            return halo_feats
        halo = feats.new_zeros((n_parts, nh, feats.shape[-1]))
        halo = _scatter(halo, xr["loc"]["recv_halo_pos"],
                        state["l0loc"].to(feats.dtype), xr["loc"]["recv_valid"])
        return _scatter(halo, xr["host"]["feat_pos"],
                        hostd["l0"].to(feats.dtype), xr["host"]["feat_valid"])

    def forward(params, caches, xr, xe, use_stale: bool, emit_fresh: bool,
                hostd=None):
        """``xr`` is the installed (read) plan: stale caches are scattered
        at its positions and its uncached tier is exchanged.  ``xe`` is
        the emit plan whose tier rows are pulled fresh (``xr`` except on a
        plan-transition step).  ``hostd`` (host mode) holds this step's
        staged host fetch (``"l0"``) and, on a stale step, the staged
        global buffers (``"gl"``).  Returns the logits and the fresh tier
        rows (empty lists unless ``emit_fresh``)."""
        h = feats
        fresh = {"local": [], "global": []}
        emitted = []       # per layer: the (local, global) pulls in flight
        for li, lp in enumerate(params):
            if li == 0:
                halo = layer0_halo(xr, hostd)
            else:
                halo = h.new_zeros((n_parts, nh, h.shape[-1]))
                with device_scope("tier_pull_uncached"):
                    halo = _scatter(halo, xr["un"]["recv_halo_pos"],
                                    ex.pull(xr["un"], h, (li, "uncached")),
                                    xr["un"]["recv_valid"])
                if use_stale:
                    if emit_fresh:
                        # emitted only: pulled outside the autograd graph
                        with torch.no_grad():
                            emitted.append(ex.emit(xe, h, li))
                    loc_use, loc_t = caches["local"][li - 1], xr["loc"]
                    buf_use = (hostd["gl"][li - 1].to(h.dtype) if host_mode
                               else caches["global"][li - 1])
                    gl_t = xr["gl"]
                else:
                    # fresh tiers feed the loss: gradients reach the owners
                    with device_scope("tier_pull_refresh"):
                        loc_use = ex.pull(xe["loc"], h, (li, "local"))
                        buf_use = ex.build_global(xe["gl"], h, (li, "global"))
                    loc_t, gl_t = xe["loc"], xe["gl"]
                    fresh["local"].append(loc_use.detach())
                    fresh["global"].append(buf_use.detach())
                halo = _scatter(halo, loc_t["recv_halo_pos"], loc_use,
                                loc_t["recv_valid"])
                halo = _read_global(gl_t, buf_use, halo)
            h_local = torch.cat([h, halo], dim=1)
            with device_scope(f"layer{li}/spmm"):
                h = _layer_apply(cfg, lp, adj, h_local, ni,
                                 is_last=(li == layers - 1))
            if emitted:
                with device_scope("refresh_ring_advance"):
                    for pulls in emitted:
                        for pend in pulls:
                            pend.advance()
        if emitted:
            with torch.no_grad(), device_scope("refresh_ring_finish"):
                for loc, glob in emitted:
                    fresh["local"].append(loc.finish())
                    fresh["global"].append(glob.finish())
        return h, fresh

    def share_and_correct(logits: torch.Tensor, mask: torch.Tensor):
        """``sum(nll * mask)`` and ``sum(correct * mask)`` over ``view``."""
        flat = logits.reshape(-1, logits.shape[-1])
        logp = torch.log_softmax(flat, -1)
        nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
        correct = (torch.argmax(flat, -1) == labels).float()
        return torch.sum(nll * mask), torch.sum(correct * mask)

    def value_and_grad(params, caches, xr, xe, use_stale, emit_fresh,
                       hostd=None):
        """The loss, accuracy and gradients summed over processes, and the
        fresh rows."""
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        logits, fresh = forward(live, caches, xr, xe, use_stale, emit_fresh,
                                hostd)
        nll_sum, correct = share_and_correct(logits, masks["train"])
        share = nll_sum / total_train
        grads = torch.autograd.grad(share, leaves)
        loss, correct, *grads = ex.sum_ranks(
            [share.detach(), correct] + list(grads))
        gl = iter(grads)
        return (loss, correct / total_train, fresh,
                tree_map(lambda _: next(gl), params))

    @torch.no_grad()
    def drift_metrics(fresh, stale_local, stale_global) -> dict:
        """The fresh rows against this step's stale source: ``drift`` and
        ``drift_global_rows`` (max over layers and features) reduced with
        MAX over processes; ``drift_local_rows`` ``[n_parts, Rloc]``."""
        pairs = list(zip(fresh["local"] + fresh["global"],
                         stale_local + stale_global))
        drifts = [torch.max(torch.abs(a - b)) for a, b in pairs if a.numel()]
        local_max = (torch.max(torch.stack(drifts)) if drifts
                     else torch.zeros((), device=device))
        out = {}
        n_ex = len(fresh["local"])
        if n_ex:
            rows = [torch.amax(torch.abs(a - b), dim=-1) for a, b in pairs]
            out["drift_local_rows"] = torch.stack(rows[:n_ex]).amax(0)
            glob = torch.stack(rows[n_ex:]).amax(0)              # [G]
            red = ex.max_ranks(torch.cat([local_max.reshape(1), glob]))
            out["drift"], out["drift_global_rows"] = red[0], red[1:]
        else:
            out["drift"] = ex.max_ranks(local_max.reshape(1))[0]
        return out

    def step(use_stale, emit_fresh, params, opt_state, caches, xr, xe,
             hostd=None):
        """One step: the new parameters and optimizer state, the fresh
        rows (None unless ``emit_fresh``) and the metrics.  Drift compares
        the fresh rows with this step's stale source; a host-mode refresh
        has no staged stale global, so it emits none (as the reference)."""
        loss, acc, fresh, grads = value_and_grad(params, caches, xr, xe,
                                                 use_stale, emit_fresh, hostd)
        new_params, new_state = opt.update(grads, opt_state, params)
        metrics = {"loss": loss, "acc": acc}
        if emit_fresh and (use_stale or not host_mode):
            stale_gl = ([g.float() for g in hostd["gl"]] if host_mode
                        else caches["global"])
            metrics.update(drift_metrics(fresh, caches["local"], stale_gl))
        ex.end_step(True)
        return new_params, new_state, (fresh if emit_fresh else None), \
            metrics

    def timed_maps(xp):
        t0 = time.perf_counter()
        out = maps(xp)
        state["maps_s"] = time.perf_counter() - t0
        return out

    caches0 = init_caches(cfg, xplan, n_parts, features=spec.features,
                          device=device)
    state["xarr"] = timed_maps(xplan)
    store = None

    # the feature residency's hooks around a step: ``take(stale)`` the
    # step's staged host payloads off the ring (None with device
    # features), ``fetch(stale)`` the same staged apart from the ring (a
    # fresh forward's, unguarded as the JAX package's), ``install(xp)``
    # after a plan install, ``prefetch()`` once the step's work is issued
    # and ``writeback(fresh)`` after it, ``out_caches`` the caches a step
    # hands on.  With a fault guard attached (``set_fault_guard``) the
    # host staging goes through it where the JAX package's does.
    if not host_mode:
        def take(use_stale=False):
            return None

        def install(xp):
            pass

        def writeback(fresh):
            pass

        def out_caches(caches, fresh):
            return fresh if fresh is not None else caches

        fetch = take
    else:
        store = HostFeatureStore(view.halo_feats, halo_dtype=spec.halo_dtype,
                                 prefetch_depth=spec.prefetch_depth,
                                 device=device)
        n_ex = layers - 1
        parts_idx = np.arange(n_parts)[:, None]

        def host_np(xp: ExchangePlan) -> dict:
            """The host-side gather programs of one plan (``view``'s rows;
            numpy: they index the host table)."""
            return {"feat_pos": np.asarray(xp.host.feat_pos[rows], np.int64),
                    "feat_valid": np.asarray(xp.host.feat_valid[rows], bool),
                    "loc_pos": np.asarray(xp.local.recv_halo_pos[rows],
                                          np.int64),
                    "loc_valid": np.asarray(xp.local.recv_valid[rows], bool),
                    "gl_rows": int(xp.glob.n_unique)}

        def stage_l0():
            hn = state["hostnp"]
            return store.stage_rows((parts_idx, hn["feat_pos"]),
                                    valid=hn["feat_valid"])

        def prefetch():
            """Refill the ring: keep the next steps' host rows in flight
            while the current step computes.  Under a fault guard a
            failed or slow fetch suspends the refill (consumption degrades
            to synchronous staging)."""
            ring, g = state["l0_ring"], state["fetch_guard"]
            if g is not None and not g.prefetch_ok():
                return
            while len(ring) < max(1, store.prefetch_depth - 1):
                if g is None:
                    ring.append(stage_l0())
                    continue
                sf = g.try_stage(stage_l0)
                if sf is None:
                    return
                ring.append(sf)

        def take_l0():
            """The oldest prefetched layer-0 fetch (or one staged cold),
            accounted here, at consumption, so flushed prefetches never
            count.  Under a fault guard the cold path retries with backoff
            and past the budget serves the previous step's rows."""
            ring, g = state["l0_ring"], state["fetch_guard"]
            if g is None:
                sf = ring.popleft() if ring else stage_l0()
                store.account_fetch(sf)
                return store.ready(sf)
            if ring:
                return g.consume(ring.popleft(), store, "l0")
            return g.fetch_sync(stage_l0, store, "l0")

        def take_gl():
            """A stale step's global buffers, staged from the host."""
            g, out = state["fetch_guard"], []
            for li in range(n_ex):
                if g is not None:
                    out.append(g.fetch_sync(lambda li=li: store.stage_buf(li),
                                            store, f"gl{li}",
                                            account=account_replicas))
                    continue
                sf = store.stage_buf(li)
                if account_replicas:
                    store.account_fetch(sf)
                out.append(store.ready(sf))
            return out

        def take(use_stale=False):
            """The payloads of a step: the layer-0 fetch and, on a stale
            step, the global buffers."""
            with state["tracer"].span("l0_stage"):
                hostd = {"l0": take_l0()}
                if use_stale:
                    hostd["gl"] = take_gl()
            return hostd

        def fetch(use_stale=False):
            sf = stage_l0()
            store.account_fetch(sf)
            hostd = {"l0": store.ready(sf)}
            if use_stale:
                hostd["gl"] = take_gl()
            return hostd

        def stage_l0loc():
            """(Re)stage the layer-0 local-tier rows, the device-cached
            slice of the host table: one accounted fetch an install."""
            hn = state["hostnp"]

            def stage():
                return store.stage_rows((parts_idx, hn["loc_pos"]),
                                        valid=hn["loc_valid"])
            g = state["fetch_guard"]
            if g is not None:
                state["l0loc"] = g.fetch_sync(stage, store, "l0loc")
                return
            sf = stage()
            store.account_fetch(sf)
            state["l0loc"] = store.ready(sf)

        def install(xp):
            """A plan install: flush the ring unaccounted (its prefetches
            carry the old plan's rows), then (re)stage ``l0loc`` and
            refill the ring.  The host global buffers keep their
            old-tiering content: the next step refreshes them, or is the
            transition that emits them."""
            tr = state["tracer"]
            state["hostnp"] = host_np(xp)
            state["l0_ring"].clear()
            with tr.span("l0_stage"):
                stage_l0loc()
            with tr.span("h2d_prefetch"):
                prefetch()

        def writeback(fresh):
            """This step's emitted global buffers, written back under the
            installed plan's membership."""
            if fresh is None:
                return
            with state["tracer"].span("writeback"):
                for li, buf in enumerate(fresh["global"]):
                    store.write_buf(li, buf, state["hostnp"]["gl_rows"],
                                    account=account_replicas)

        def out_caches(caches, fresh):
            return {"local": fresh["local"] if fresh is not None
                    else caches["local"], "global": []}

        state["l0_ring"] = deque()
        install(xplan)
        for li, d in enumerate(cfg.feat_dims[1:layers]):
            store.init_buf(li, (xplan.glob.buf_size, d), xplan.glob.n_unique)

    def wrap(name, use_stale, emit_fresh):
        def stepper(params, opt_state, caches):
            hostd = take(use_stale)
            xa = state["xarr"]
            with host_annotation(f"capgnn/step_{name}"):
                new_p, new_s, fresh, m = step(use_stale, emit_fresh, params,
                                              opt_state, caches, xa, xa,
                                              hostd)
            if host_mode:
                # the next step's host rows, gathered and copied while
                # this step's work runs; then the writeback
                with state["tracer"].span("h2d_prefetch"):
                    prefetch()
            writeback(fresh)
            return new_p, new_s, out_caches(caches, fresh), m
        return stepper

    def set_plan(xp):
        state["xarr"] = timed_maps(xp)
        install(xp)

    def transition(params, opt_state, caches, new_xp):
        # the stale tiers are read on the old plan's layout, the fresh
        # tier rows pulled (and emitted) on the new plan's
        hostd = take(True)
        xe = timed_maps(new_xp)
        with host_annotation("capgnn/step_transition"):
            new_p, new_s, fresh, m = step(True, True, params, opt_state,
                                          caches, state["xarr"], xe, hostd)
        state["xarr"] = xe
        install(new_xp)
        writeback(fresh)
        return new_p, new_s, out_caches(caches, fresh), m

    state.update(set_plan=set_plan, transition=transition)

    @torch.no_grad()
    def forward_fresh(params):
        """The logits ``[n_parts, NI, out]`` with every tier fresh."""
        xa = state["xarr"]
        logits = forward(params, caches0, xa, xa, False, False, fetch())[0]
        ex.end_step(False)
        return logits

    def evaluate(params, split: str = "val"):
        """Loss and accuracy on ``split`` over every partition."""
        m = masks[split]
        nll_sum, correct = share_and_correct(forward_fresh(params), m)
        sums = ex.sum_ranks([torch.stack([nll_sum, correct, m.sum()])])[0]
        n = torch.clamp(sums[2], min=1.0)
        return float(sums[0] / n), float(sums[1] / n)

    def loss_and_grads(params, caches, use_stale: bool = False):
        xa = state["xarr"]
        loss, _, _, grads = value_and_grad(params, caches, xa, xa,
                                           use_stale, False,
                                           fetch(use_stale))
        ex.end_step(False)
        return loss, grads

    comm_dims = list(cfg.feat_dims[:layers])
    if not spec.exchange_layer0 or host_mode:
        # host mode: layer-0 rows arrive from the host store (accounted
        # by the store), not over the inter-worker wire
        comm_dims = comm_dims[1:]

    return cls(cfg=cfg, xplan=xplan, comm_dims=comm_dims,
               forward_fresh=forward_fresh,
               step_refresh=wrap("refresh", False, True),
               step_cached=wrap("cached", True, False),
               step_pipelined=wrap("pipelined", True, True),
               evaluate=evaluate, loss_and_grads=loss_and_grads,
               caches0=caches0, backend=spec.backend,
               halo_dtype_bytes=halo_dtype_info(spec.halo_dtype)[1],
               features=spec.features, device=device, host_store=store,
               _state=state, stacked=sp, spec=spec, **fields)


def make_sim_runtime(cfg: GNNConfig, sp: StackedParts, xplan: ExchangePlan,
                     opt: Optimizer, *, spec: TrainSpec,
                     device="cuda") -> SimRuntime:
    """Build the stacked runtime on ``device`` (the card unless the caller
    asks for the CPU) from ``spec`` (a :class:`repro_torch.dist.TrainSpec`,
    the only configuration surface).

    ``spec.exchange_layer0=False`` models pre-replicated input features:
    layer 0 drops out of the byte accounting, the numerics are unchanged.
    ``spec.backend`` picks the aggregation operator (``edges``,
    ``ell`` or ``hybrid``; the latter two need the matching stacked pack).
    ``spec.halo_dtype="bf16"`` casts every tier's payload before the
    exchange and dequantises on scatter; in host mode the same cast
    compresses the staged payloads.  ``spec.features="host"`` keeps the
    halo table in a :class:`~.host_store.HostFeatureStore` of
    ``spec.prefetch_depth`` ring slots (the plan must carry a host tier:
    ``build_exchange_plan`` always emits one).
    """
    device = torch.device(device)
    hdt = halo_dtype_info(spec.halo_dtype)[0]

    def maps(xp):
        return exchange_arrays(xp, sp.n_inner_max, device, halo_dtype=hdt,
                               include_host=spec.features == "host")
    return _build_runtime(SimRuntime, cfg, sp, sp, xplan, opt, spec, device,
                          _StackedExchange(hdt), maps)


# ---------------------------------------------------------------------------
# Training loop with exact byte accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainReport:
    losses: list
    val_acc: list
    comm_bytes: int
    comm_bytes_vanilla: int
    comm_reduction: float
    refresh_steps: int
    cached_steps: int
    wall_time_s: float
    replan_events: int = 0
    hit_rate: float | None = None    # planner-observed (adaptive runs only)
    final_opt_state: object = None
    # out-of-core (features="host") traffic over the training loop, from
    # the store's consumption-driven counters; zero in device mode
    host_fetch_rows: int = 0
    host_fetch_bytes: int = 0
    host_writeback_bytes: int = 0
    # step 0 wall time, fenced separately so ``wall_time_s`` above is
    # steady-state only; on the card it holds the first-use kernel builds
    # and the CUDA context's first work
    compile_s: float = 0.0
    # per step-kind {count, p50_ms, p99_ms, total_s} from the tracer's
    # depth-0 spans; None on untraced runs (timing them adds syncs)
    phase_stats: dict | None = None
    # fault-injection accounting (repro_torch.faults): per-kind injected
    # event counts and the run's DefenseEvents totals; None on clean runs.
    # The matched pairs are EQUAL: fetch_drop==fetch_errors,
    # fetch_delay==slow_fetches, halo_corrupt==corruptions_detected,
    # grad_nan==rollbacks, mem_pressure==mem_backoffs.
    faults_injected: dict | None = None
    fault_events: dict | None = None
    # per halo_corrupt injection: (step, the corrupted tier's name)
    fault_tiers: list = dataclasses.field(default_factory=list)
    # the serialised TrainSpec (spec.to_dict()) of the run
    spec: dict | None = None
    # per step: its kind (refresh / cached / pipelined / transition) and
    # host wall seconds, each step fenced by reading its loss
    step_kinds: list = dataclasses.field(default_factory=list)
    step_s: list = dataclasses.field(default_factory=list)
    # per re-plan event: the step, the planner's host ms (replan and the
    # exchange plan's compile) and the runtime's exchange-maps build ms
    replan_ms: list = dataclasses.field(default_factory=list)


def _step_rows(x_read: ExchangePlan, x_emit: ExchangePlan,
               refresh: bool) -> int:
    """Exact per-layer wire rows of one step: the *read* plan's uncached
    tier moves every step; on a refresh the *emit* plan's cached tiers are
    (pre)fetched.  ``x_read is x_emit`` except on a plan-transition step."""
    n = x_read.uncached.n_rows
    if refresh:
        n += x_emit.local.n_rows + x_emit.glob.n_unique
    return n


def train_capgnn(cfg: GNNConfig, runtime, xplan: ExchangePlan,
                 num_parts: int, opt: Optimizer, epochs: int = 100,
                 eval_every: int = 0,
                 controller: StalenessController | None = None,
                 params0=None, opt_state0=None, planner=None, tracer=None,
                 faults=None, guard=None,
                 spec: TrainSpec | None = None) -> tuple[list, TrainReport]:
    """Full-batch CaPGNN training under the staleness schedule, on a
    :class:`SimRuntime` or, on each rank of its group, a
    :class:`~repro_torch.dist.capgnn_spmd.SpmdRuntime` (every rank's
    report is the same, except the host counts and the fault and defense
    counts: each rank's store, plan and guard count its own).

    ``spec`` (default: the runtime's) supplies ``pipeline`` and ``seed``
    and is recorded into ``report.spec``.  One step per epoch (full
    batch).  Per-step bytes are the plan's exact figures: a vanilla
    runtime would move every halo row at every layer of every step;
    CaPGNN moves only the uncached tier on cached steps and a
    deduplicated refresh on refresh steps.  With ``spec.pipeline`` the
    scheduled refreshes after warm-up run as ``step_pipelined``; bytes are
    identical.

    ``planner`` (a :class:`repro_torch.core.jaca.AdaptivePlanner`)
    switches on online cache adaptation: at the controller's re-plan
    boundaries (refresh steps, thinned by ``controller.replan_every``) the
    planner's live eviction state is materialised into a new plan and
    swapped into the runtime — via :meth:`SimRuntime.step_transition`
    when pipelining, ``set_plan`` and a plain refresh otherwise.  The
    runtime must have been built on the planner's capacity-padded
    exchange layout (``planner.exchange_plan()``), so a swap changes index
    data, not tensor shapes; byte accounting follows the active plan(s)
    per step and stays exact across re-plan events.

    ``params0``/``opt_state0`` start from given state (the parity tests
    pass the JAX package's initial parameters; ``launch.train --resume`` a
    checkpoint's); otherwise the parameters are initialised from
    ``spec.seed`` with a ``torch.Generator``, which does not replay the
    reference's ``jax.random`` draw.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) records one depth-0
    span per step — kind ``refresh``/``cached``/``pipelined``/
    ``transition``, with the ``replan``/``l0_stage``/``writeback``/
    ``h2d_prefetch``/``eval`` sub-phases nested inside — plus one typed
    :class:`repro_torch.obs.StepCounters` record per step whose totals
    equal this report's ``comm_bytes`` / ``host_fetch_*`` figures
    exactly.  Traced steps are fenced (:meth:`~repro_torch.obs.Tracer.
    fence`: the loss's stream synchronised) so span durations measure
    completed device work.

    ``faults`` (a :class:`repro_torch.faults.FaultPlan`) arms
    deterministic fault injection; ``guard`` (a
    :class:`repro_torch.faults.GuardConfig`) configures the defenses —
    fetch retry/stale-reuse (via the runtime's ``set_fault_guard``), the
    divergence guard (per-step loss finiteness plus a parameter sweep and
    snapshot every ``guard_every`` steps, rolling back and forcing a
    plain refresh on divergence), opt-in per-tier payload checksums
    (corruption forces a refresh) and memory-pressure capacity backoff
    (requires ``planner``).  Guard-forced refreshes are *plain*
    refreshes: a poisoned stale tier is never consumed.  Under the SPMD
    runtime the forced-refresh decision is agreed over the ranks (one
    uncounted ``max`` all-reduce a step, only with a guard attached).
    Injected and defended event counts land in the report
    (``faults_injected`` / ``fault_events``) and as per-step
    :class:`~repro_torch.obs.StepCounters` fields.  With no tracer, no
    plan and no guard the loop adds nothing: one sync a step, at the
    loss.

    Step 0 is timed separately (``report.compile_s``); ``wall_time_s``
    covers the remaining steps.
    """
    spec = spec if spec is not None else runtime.spec
    pipeline = spec.pipeline
    if controller is None:
        controller = StalenessController(refresh_every=xplan.refresh_every)
    params = params0 if params0 is not None else init_gnn(
        cfg, torch.Generator().manual_seed(spec.seed), runtime.device)
    opt_state = opt_state0 if opt_state0 is not None else opt.init(params)
    # the runtime's own starting caches: [P, ...] in one process, the
    # rank's [1, ...] local tier under the SPMD runtime (never written to)
    caches = runtime.caches0
    store = runtime.host_store
    store_snap = store.snapshot() if store is not None else None
    dims = runtime.comm_dims
    # actual wire width of one halo payload entry (2 under bf16); the
    # vanilla baseline ships the same payload dtype
    dim_bytes = sum(d * runtime.halo_dtype_bytes for d in dims)

    tr = tracer if tracer is not None else NULL_TRACER
    if tr.enabled:
        runtime.set_tracer(tr)
    fa = faults if faults is not None else NULL_FAULTS
    if fa.enabled and fa.has("mem_pressure") and planner is None:
        raise ValueError(
            "mem_pressure faults need an AdaptivePlanner: the backoff "
            "defense shrinks capacity and replans through it")
    gd = None
    ev_snap = inj_snap = None
    if fa.enabled or guard is not None:
        gd = TrainGuard(guard if guard is not None else GuardConfig(),
                        store=store)
        runtime.set_fault_guard(gd.fetch_guard)
        if fa.enabled and store is not None:
            store.set_faults(fa)
        if gd.cfg.guard_every > 0:
            gd.snapshot(-1, params, opt_state)   # rollback floor
        gd.seal(caches)                          # checksum baseline
        ev_snap = gd.events.as_dict()
        inj_snap = fa.total_injected()

    losses: list[float] = []
    val_acc: list[float] = []
    kinds: list[str] = []
    step_s: list[float] = []
    replan_ms: list[dict] = []
    fault_tiers: list = []
    comm = vanilla = refresh_steps = replan_events = 0
    x_active = xplan
    rows_by_worker = None   # per-worker uncached recv rows (traced runs)
    step_snap = (store.snapshot()
                 if store is not None and tr.enabled else None)
    compile_s = 0.0
    pending_refresh = False   # guard-forced refresh for the NEXT step
    t0 = time.perf_counter()
    for e in range(epochs):
        ts = time.perf_counter()
        force_refresh, pending_refresh = pending_refresh, False
        mem = False
        if fa.enabled:
            fa.begin_step(e)
            params = fa.corrupt_params(params)
            caches, tier = fa.corrupt_caches(caches, store)
            if tier is not None:
                fault_tiers.append((e, tier))
            mem = fa.mem_pressure()
        if gd is not None:
            if gd.cfg.checksums:
                with tr.span("integrity", step=e):
                    if gd.verify(caches):
                        force_refresh = True
            # the step's kind must be the same on every rank
            force_refresh = runtime.any_rank(force_refresh)
        refresh = controller.should_refresh()
        replan = planner is not None and controller.should_replan()
        if mem:
            # memory-pressure backoff: shrink the cache capacity and
            # replan through the slot-stable machinery this very step
            with tr.span("mem_backoff", step=e):
                planner.shrink_capacity(gd.cfg.mem_backoff_factor)
            gd.events.mem_backoffs += 1
            replan = True
        if force_refresh:
            gd.events.forced_refreshes += 1
        refresh = refresh or force_refresh or mem
        # a guard-forced refresh must be a PLAIN refresh: pipelined /
        # transition flavours consume the stale tiers being quarantined
        if replan:
            kind = ("transition" if pipeline and not force_refresh
                    else "refresh")
        elif refresh and pipeline and controller.step > 0 \
                and not force_refresh:
            kind = "pipelined"
        elif refresh:
            kind = "refresh"
        else:
            kind = "cached"
        with tr.step_span(kind, e):
            if replan:
                tp = time.perf_counter()
                with tr.span("replan", step=e):
                    x_next = planner.exchange_plan(planner.replan())
                plan_ms = 1e3 * (time.perf_counter() - tp)
                if kind == "transition":
                    # consume and exchange on the old plan, pull the new
                    # plan's tier rows
                    params, opt_state, caches, m = runtime.step_transition(
                        params, opt_state, caches, x_next)
                    x_read, x_emit = x_active, x_next
                else:
                    runtime.set_plan(x_next)
                    params, opt_state, caches, m = runtime.step_refresh(
                        params, opt_state, caches)
                    x_read = x_emit = x_next
                replan_ms.append({"step": e, "plan_ms": plan_ms,
                                  "maps_ms": 1e3 * runtime.maps_s})
                refreshed_tiers = True
                x_active = x_next
                replan_events += 1
            else:
                step_fn = {"pipelined": runtime.step_pipelined,
                           "refresh": runtime.step_refresh,
                           "cached": runtime.step_cached}[kind]
                params, opt_state, caches, m = step_fn(params, opt_state,
                                                       caches)
                x_read = x_emit = x_active
                refreshed_tiers = refresh
            step_rows = _step_rows(x_read, x_emit, refresh=refreshed_tiers)
            tr.fence(m["loss"])
        losses.append(float(m["loss"]))      # fences the step
        step_s.append(time.perf_counter() - ts)
        kinds.append(kind)
        if e == 0:
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        comm += step_rows * dim_bytes
        vanilla += xplan.total_halo * dim_bytes
        refresh_steps += int(refresh)
        # divergence guard: the loss is already a host float (a free check
        # every step); the parameter sweep and snapshot run on the
        # guard_every cadence.  Divergence rolls back to the last good
        # snapshot and forces the next step to be a plain refresh.  The
        # loss is summed over ranks and the parameters are replicated, so
        # every rank decides the same.
        diverged = False
        if gd is not None and gd.cfg.guard_every > 0:
            diverged = not np.isfinite(losses[-1])
            if not diverged and (e + 1) % gd.cfg.guard_every == 0:
                with tr.span("divergence_check", step=e):
                    diverged = not gd.params_finite(params)
                if not diverged:
                    gd.snapshot(e, params, opt_state)
            if diverged:
                with tr.span("rollback", step=e):
                    params, opt_state = gd.rollback(params, opt_state)
                pending_refresh = True
        # a transition's fresh rows follow the NEW plan while the compared
        # caches hold the OLD plan's rows: its drift compares different
        # vertices and is skipped (as is a diverged step's, non-finite)
        drift = (float(m["drift"])
                 if "drift" in m and not replan and not diverged else None)
        if planner is not None:
            planner.observe_step(layers=max(1, len(dims)))
            if "drift_local_rows" in m and not replan and not diverged:
                planner.observe_drift(
                    runtime.all_parts(m["drift_local_rows"]),
                    m["drift_global_rows"].cpu().numpy())
        controller.observe(drift, refreshed=refresh)
        if eval_every and (e + 1) % eval_every == 0:
            with tr.span("eval", step=e):
                val_acc.append(runtime.evaluate(params, "val")[1])
        if tr.enabled:
            # counters are recorded at iteration end so the store deltas
            # (step + any eval fetches) attribute to this step exactly —
            # the per-step stream sums to the report totals
            sd = {}
            if store is not None:
                sd = store.delta(step_snap)
                step_snap = store.snapshot()
            if refreshed_tiers or rows_by_worker is None:
                rows_by_worker = [int(n) for n in np.asarray(
                    x_read.uncached.recv_valid).sum(axis=1)]
            extra = {}
            if gd is not None:
                # per-step defense/injection deltas: the stream sums to
                # the report's fault_events / faults_injected exactly
                extra = gd.events.delta(ev_snap)
                ev_snap = gd.events.as_dict()
                extra["faults_injected"] = fa.total_injected() - inj_snap
                inj_snap = fa.total_injected()
            tr.count(StepCounters(
                step=e, kind=kind,
                wire_rows_uncached=x_read.uncached.n_rows,
                wire_rows_local=(x_emit.local.n_rows
                                 if refreshed_tiers else 0),
                wire_rows_global=(x_emit.glob.n_unique
                                  if refreshed_tiers else 0),
                wire_bytes=step_rows * dim_bytes,
                wire_bytes_vanilla=xplan.total_halo * dim_bytes,
                cache_hit_rate=(None if refreshed_tiers else
                                1.0 - x_read.uncached.n_rows
                                / max(1, x_read.total_halo)),
                planner_hit_rate=(planner.hit_rate()
                                  if planner is not None else None),
                drift=drift,
                host_fetch_rows=int(sd.get("fetch_rows", 0)),
                host_fetch_bytes=int(sd.get("fetch_bytes", 0)),
                host_writeback_rows=int(sd.get("writeback_rows", 0)),
                host_writeback_bytes=int(sd.get("writeback_bytes", 0)),
                device_peak_bytes=device_peak_bytes(runtime.device),
                wire_rows_by_worker=rows_by_worker, **extra))
        if gd is not None and gd.cfg.checksums:
            # seal the post-step tier payloads: the digests the next
            # consuming step must still observe
            with tr.span("integrity", step=e):
                gd.seal(caches)
    wall = time.perf_counter() - t0
    fa.end_run()

    # eval_every runs also consume accounted host fetches
    hostd = store.delta(store_snap) if store is not None else {}
    report = TrainReport(
        losses=losses, val_acc=val_acc, comm_bytes=comm,
        comm_bytes_vanilla=vanilla,
        comm_reduction=1.0 - comm / max(vanilla, 1),
        refresh_steps=refresh_steps, cached_steps=epochs - refresh_steps,
        wall_time_s=wall, replan_events=replan_events,
        hit_rate=planner.hit_rate() if planner is not None else None,
        final_opt_state=opt_state,
        host_fetch_rows=int(hostd.get("fetch_rows", 0)),
        host_fetch_bytes=int(hostd.get("fetch_bytes", 0)),
        host_writeback_bytes=int(hostd.get("writeback_bytes", 0)),
        compile_s=compile_s,
        phase_stats=tr.phase_stats() if tr.enabled else None,
        faults_injected=dict(fa.injected) if fa.enabled else None,
        fault_events=gd.events.as_dict() if gd is not None else None,
        fault_tiers=fault_tiers, spec=spec.to_dict(), step_kinds=kinds,
        step_s=step_s, replan_ms=replan_ms)
    return params, report
