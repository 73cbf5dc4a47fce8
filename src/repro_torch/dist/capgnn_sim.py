"""Single-process stacked runtime of CaPGNN training (the JAX package's
``capgnn_sim``), with device-resident features.

Every partition's state lives in one padded ``[P, ...]`` tensor; the
inter-worker exchange is gather/scatter index arithmetic over the stacked
inner matrix, compiled by :func:`repro_torch.dist.exchange.build_exchange_plan`.
The JAX package's ``vmap`` over partitions is the explicit batch: one
aggregation call per layer covers all P partitions (with ``ell`` or
``hybrid`` on the card, one ELL-SpMM kernel launch forward, for
``hybrid`` one CSR kernel launch over the COO tail, and, from layer 1
on, one CSR kernel launch backward for ``d_h``).

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

Not ported yet: ``features="host"``, the adaptive planner, the tracer and
the fault guard; asking for one raises.

The reference drops out-of-range scatter indices (``mode="drop"``); torch
raises on them instead, so :func:`_scatter` writes into one spare row and
slices it off.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core.staleness import StalenessController
from ..kernels.ops import (ell_row_end, gather_pack, pack_rows, tail_csr,
                           transpose_csr)
from ..models.gnn import (EdgeListAdj, EllAdj, GNNConfig, HybridAdj,
                          _layer_apply, accuracy, cross_entropy_loss,
                          init_gnn)
from ..optim import Optimizer, tree_leaves, tree_map
from .exchange import ExchangePlan, ExchangeTier, GlobalTier, StackedParts
from .host_store import halo_dtype_info
from .spec import TrainSpec

__all__ = ["RUNTIME_BACKENDS", "check_backend", "make_adj_builder",
           "exchange_arrays", "init_caches", "SimRuntime",
           "make_sim_runtime", "TrainReport", "train_capgnn"]

RUNTIME_BACKENDS = ("edges", "ell", "hybrid")


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


def make_adj_builder(sp: StackedParts, backend: str, device="cpu",
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


def exchange_arrays(xplan: ExchangePlan, n_inner: int, device="cpu",
                    grad: bool = True, halo_dtype=None) -> dict:
    """One plan's tier maps on ``device``, built once per plan: each
    tier's gathers (:func:`_pull_maps`, for the payload dtype
    ``halo_dtype``, None for none) over the flattened inner matrix
    (``n_inner`` rows per partition) with, when ``grad`` asks for the
    backward, their transposed index maps; scatter positions and valid
    masks."""
    return {"un": _tier_dict(xplan.uncached, n_inner, device, grad,
                             halo_dtype),
            "loc": _tier_dict(xplan.local, n_inner, device, grad,
                              halo_dtype),
            "gl": _glob_dict(xplan.glob, n_inner, device, grad, halo_dtype)}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               "(see ROADMAP.md)")


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_caches(cfg: GNNConfig, xplan: ExchangePlan, num_parts: int,
                features: str = "device", device="cuda") -> dict:
    """Zero-filled stale tiers, one entry per cached exchange layer.

    Entry ``l-1`` holds the halo inputs of layer ``l`` (layers ``1..L-1``);
    layer 0 consumes the static input features, which never go stale.
    """
    if features != "device":
        raise _not_ported(f"features={features!r}")
    dims = cfg.feat_dims[1: cfg.num_layers]
    r_local = int(np.asarray(xplan.local.recv_halo_pos).shape[1])
    g = xplan.glob.buf_size
    return {
        "local": [torch.zeros((num_parts, r_local, d), device=device)
                  for d in dims],
        "global": [torch.zeros((g, d), device=device) for d in dims],
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
    features: str = "device"
    device: torch.device = torch.device("cpu")
    _state: dict | None = dataclasses.field(default=None, repr=False)
    stacked: StackedParts | None = dataclasses.field(default=None, repr=False)
    spec: TrainSpec | None = dataclasses.field(default=None, repr=False)

    def padding_stats(self) -> dict:
        """Valid vs padded stacked-row counts (see
        :meth:`repro_torch.dist.StackedParts.padding_stats`)."""
        return self.stacked.padding_stats() if self.stacked else {}

    def set_plan(self, xplan: ExchangePlan) -> None:
        """Install a re-ranked plan.  The caches' content still reflects
        the old tiering, so the next step must be a refresh (or have been
        emitted by :meth:`step_transition`)."""
        self.xplan = xplan
        self._state["xarr"] = self._state["maps"](xplan)

    def step_transition(self, params, opt_state, caches,
                        new_xplan: ExchangePlan):
        """Pipelined plan switch: consume the current plan's stale tiers
        (and its uncached exchange) while pulling the **new** plan's tier
        rows; the emitted caches are laid out for ``new_xplan``, which
        becomes the installed plan."""
        xe = self._state["maps"](new_xplan)
        out = self._state["step"](True, True, params, opt_state, caches,
                                  self._state["xarr"], xe)
        self._state["xarr"] = xe
        self.xplan = new_xplan
        return out


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
    exchange and dequantises on scatter.  ``spec.features="host"`` is not
    ported yet and raises.
    """
    if spec.features != "device":
        raise _not_ported(f"features={spec.features!r}")
    device = torch.device(device)
    p, ni, nh = sp.num_parts, sp.n_inner_max, sp.n_halo_max
    hdt, hd_bytes = halo_dtype_info(spec.halo_dtype)
    layers = cfg.num_layers

    def put(a):
        return torch.as_tensor(np.asarray(a), device=device)

    feats, halo_feats = put(sp.feats), put(sp.halo_feats)
    labels = put(sp.labels).reshape(-1)
    masks = {k: put(m).reshape(-1)
             for k, m in (("train", sp.train_mask), ("val", sp.val_mask),
                          ("test", sp.test_mask))}
    adj_leaves, build_adj = make_adj_builder(sp, spec.backend, device)
    adj = build_adj(adj_leaves)

    def forward(params, caches, xr, xe, use_stale: bool, emit_fresh: bool):
        """``xr`` is the installed (read) plan: stale caches are scattered
        at its positions and its uncached tier is exchanged.  ``xe`` is
        the emit plan whose tier rows are pulled fresh (``xr`` except on a
        plan-transition step).  Returns the logits and the fresh tier rows
        (empty lists unless ``emit_fresh``)."""
        h = feats
        fresh = {"local": [], "global": []}
        for li, lp in enumerate(params):
            if li == 0:
                halo = halo_feats
            else:
                halo = h.new_zeros((p, nh, h.shape[-1]))
                halo = _scatter(halo, xr["un"]["recv_halo_pos"],
                                _pull(xr["un"], h, hdt),
                                xr["un"]["recv_valid"])
                if use_stale:
                    if emit_fresh:
                        # emitted only: pulled outside the autograd graph
                        with torch.no_grad():
                            fresh["local"].append(_pull(xe["loc"], h, hdt))
                            fresh["global"].append(
                                _build_global(xe["gl"], h, hdt))
                    loc_use, loc_t = caches["local"][li - 1], xr["loc"]
                    buf_use, gl_t = caches["global"][li - 1], xr["gl"]
                else:
                    # fresh tiers feed the loss: gradients reach the owners
                    loc_use, loc_t = _pull(xe["loc"], h, hdt), xe["loc"]
                    buf_use, gl_t = _build_global(xe["gl"], h, hdt), xe["gl"]
                    fresh["local"].append(loc_use.detach())
                    fresh["global"].append(buf_use.detach())
                halo = _scatter(halo, loc_t["recv_halo_pos"], loc_use,
                                loc_t["recv_valid"])
                halo = _read_global(gl_t, buf_use, halo)
            h_local = torch.cat([h, halo], dim=1)
            h = _layer_apply(cfg, lp, adj, h_local, ni,
                             is_last=(li == layers - 1))
        return h, fresh

    def loss_fn(params, caches, xr, xe, use_stale, emit_fresh):
        logits, fresh = forward(params, caches, xr, xe, use_stale,
                                emit_fresh)
        flat = logits.reshape(-1, logits.shape[-1])
        loss = cross_entropy_loss(flat, labels, masks["train"])
        return loss, flat, fresh

    def value_and_grad(params, caches, xr, xe, use_stale, emit_fresh):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, flat, fresh = loss_fn(live, caches, xr, xe, use_stale,
                                    emit_fresh)
        gl = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(gl), params)
        return loss.detach(), flat.detach(), fresh, grads

    @torch.no_grad()
    def _metrics_and_caches(loss, flat, fresh, caches, use_stale: bool,
                            emit_fresh: bool):
        metrics = {"loss": loss,
                   "acc": accuracy(flat, labels, masks["train"])}
        # drift compares the fresh rows against this step's stale source
        if emit_fresh:
            pairs = list(zip(fresh["local"] + fresh["global"],
                             caches["local"] + caches["global"]))
            drifts = [torch.max(torch.abs(a - b)) for a, b in pairs
                      if a.numel()]
            metrics["drift"] = (torch.max(torch.stack(drifts)) if drifts
                                else loss.new_zeros(()))
            # per-row drift stats (max over layers and feature dim)
            n_ex = len(fresh["local"])
            if n_ex:
                rows = [torch.amax(torch.abs(a - b), dim=-1)
                        for a, b in pairs]
                metrics["drift_local_rows"] = torch.stack(
                    rows[:n_ex]).amax(0)                      # [P, Rloc]
                metrics["drift_global_rows"] = torch.stack(
                    rows[n_ex:]).amax(0)                      # [G]
        return metrics, (fresh if emit_fresh else caches)

    def step(use_stale, emit_fresh, params, opt_state, caches, xr, xe):
        loss, flat, fresh, grads = value_and_grad(params, caches, xr, xe,
                                                  use_stale, emit_fresh)
        new_params, new_state = opt.update(grads, opt_state, params)
        metrics, out_caches = _metrics_and_caches(loss, flat, fresh, caches,
                                                  use_stale, emit_fresh)
        return new_params, new_state, out_caches, metrics

    caches0 = init_caches(cfg, xplan, p, device=device)

    def maps(xp):
        return exchange_arrays(xp, ni, device, halo_dtype=hdt)
    state = {"xarr": maps(xplan), "maps": maps, "step": step}

    def wrap(use_stale, emit_fresh):
        def stepper(params, opt_state, caches):
            xa = state["xarr"]
            return step(use_stale, emit_fresh, params, opt_state, caches,
                        xa, xa)
        return stepper

    @torch.no_grad()
    def forward_fresh(params):
        xa = state["xarr"]
        return forward(params, caches0, xa, xa, False, False)[0]

    def evaluate(params, split: str = "val"):
        flat = forward_fresh(params).reshape(-1, cfg.out_dim)
        m = masks[split]
        return (float(cross_entropy_loss(flat, labels, m)),
                float(accuracy(flat, labels, m)))

    def loss_and_grads(params, caches, use_stale: bool = False):
        xa = state["xarr"]
        loss, _, _, grads = value_and_grad(params, caches, xa, xa,
                                           use_stale, False)
        return loss, grads

    comm_dims = list(cfg.feat_dims[:layers])
    if not spec.exchange_layer0:
        comm_dims = comm_dims[1:]

    return SimRuntime(cfg=cfg, xplan=xplan, comm_dims=comm_dims,
                      forward_fresh=forward_fresh,
                      step_refresh=wrap(False, True),
                      step_cached=wrap(True, False),
                      step_pipelined=wrap(True, True),
                      evaluate=evaluate, loss_and_grads=loss_and_grads,
                      caches0=caches0, backend=spec.backend,
                      halo_dtype_bytes=hd_bytes, features=spec.features,
                      device=device, _state=state, stacked=sp, spec=spec)


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
    # out-of-core traffic: zero in device mode (the only mode ported)
    host_fetch_rows: int = 0
    host_fetch_bytes: int = 0
    host_writeback_bytes: int = 0
    # step 0 wall time, fenced separately so ``wall_time_s`` above is
    # steady-state only; on the card it holds the first-use kernel builds
    # and the CUDA context's first work
    compile_s: float = 0.0
    # the serialised TrainSpec (spec.to_dict()) of the run
    spec: dict | None = None
    # per step: its kind (refresh / cached / pipelined) and host wall
    # seconds, each step fenced by reading its loss
    step_kinds: list = dataclasses.field(default_factory=list)
    step_s: list = dataclasses.field(default_factory=list)


def _step_rows(x_read: ExchangePlan, x_emit: ExchangePlan,
               refresh: bool) -> int:
    """Exact per-layer wire rows of one step: the *read* plan's uncached
    tier moves every step; on a refresh the *emit* plan's cached tiers are
    (pre)fetched.  ``x_read is x_emit`` except on a plan-transition step."""
    n = x_read.uncached.n_rows
    if refresh:
        n += x_emit.local.n_rows + x_emit.glob.n_unique
    return n


def train_capgnn(cfg: GNNConfig, runtime: SimRuntime, xplan: ExchangePlan,
                 num_parts: int, opt: Optimizer, epochs: int = 100,
                 eval_every: int = 0,
                 controller: StalenessController | None = None,
                 params0=None, opt_state0=None, planner=None, tracer=None,
                 faults=None, guard=None,
                 spec: TrainSpec | None = None) -> tuple[list, TrainReport]:
    """Full-batch CaPGNN training under the staleness schedule.

    ``spec`` (default: the runtime's) supplies ``pipeline`` and ``seed``
    and is recorded into ``report.spec``.  One step per epoch (full
    batch).  Per-step bytes are the plan's exact figures: a vanilla
    runtime would move every halo row at every layer of every step;
    CaPGNN moves only the uncached tier on cached steps and a
    deduplicated refresh on refresh steps.  With ``spec.pipeline`` the
    scheduled refreshes after warm-up run as ``step_pipelined``; bytes are
    identical.

    ``params0``/``opt_state0`` start from given state (the parity tests
    pass the JAX package's initial parameters); otherwise the parameters
    are initialised from ``spec.seed`` with a ``torch.Generator``, which
    does not replay the reference's ``jax.random`` draw.

    Step 0 is timed separately (``report.compile_s``); ``wall_time_s``
    covers the remaining steps.  ``planner``, ``tracer``, ``faults`` and
    ``guard`` are not ported yet and raise when given.
    """
    for name, obj in (("the adaptive planner", planner),
                      ("the tracer", tracer), ("fault injection", faults),
                      ("the fault guard", guard)):
        if obj is not None:
            raise _not_ported(name)
    spec = spec if spec is not None else runtime.spec
    pipeline = spec.pipeline
    if controller is None:
        controller = StalenessController(refresh_every=xplan.refresh_every)
    params = params0 if params0 is not None else init_gnn(
        cfg, torch.Generator().manual_seed(spec.seed), runtime.device)
    opt_state = opt_state0 if opt_state0 is not None else opt.init(params)
    caches = init_caches(cfg, xplan, num_parts, device=runtime.device)
    dims = runtime.comm_dims
    # actual wire width of one halo payload entry (2 under bf16); the
    # vanilla baseline ships the same payload dtype
    dim_bytes = sum(d * runtime.halo_dtype_bytes for d in dims)

    losses: list[float] = []
    val_acc: list[float] = []
    kinds: list[str] = []
    step_s: list[float] = []
    comm = vanilla = refresh_steps = 0
    compile_s = 0.0
    t0 = time.perf_counter()
    for e in range(epochs):
        ts = time.perf_counter()
        refresh = controller.should_refresh()
        if refresh and pipeline and controller.step > 0:
            kind, step_fn = "pipelined", runtime.step_pipelined
        elif refresh:
            kind, step_fn = "refresh", runtime.step_refresh
        else:
            kind, step_fn = "cached", runtime.step_cached
        params, opt_state, caches, m = step_fn(params, opt_state, caches)
        losses.append(float(m["loss"]))      # fences the step
        step_s.append(time.perf_counter() - ts)
        kinds.append(kind)
        if e == 0:
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        comm += _step_rows(xplan, xplan, refresh=refresh) * dim_bytes
        vanilla += xplan.total_halo * dim_bytes
        refresh_steps += int(refresh)
        drift = float(m["drift"]) if "drift" in m else None
        controller.observe(drift, refreshed=refresh)
        if eval_every and (e + 1) % eval_every == 0:
            val_acc.append(runtime.evaluate(params, "val")[1])
    wall = time.perf_counter() - t0

    report = TrainReport(
        losses=losses, val_acc=val_acc, comm_bytes=comm,
        comm_bytes_vanilla=vanilla,
        comm_reduction=1.0 - comm / max(vanilla, 1),
        refresh_steps=refresh_steps, cached_steps=epochs - refresh_steps,
        wall_time_s=wall, final_opt_state=opt_state, compile_s=compile_s,
        spec=spec.to_dict(), step_kinds=kinds, step_s=step_s)
    return params, report
