"""``spmm_15d``: communication-avoiding 1.5D replicated-row block SpMM, one
process per device over ``torch.distributed`` (the JAX package's
``dist/strategy_15d.py``).

The halo model's wire volume tracks the partition cut, which grows with P
until nearly every boundary vertex is consumed remotely.  Tripathy,
Yelick & Buluç ("Reducing Communication in Graph Neural Network
Training", PAPERS.md) avoid that wall by trading memory for bandwidth:
replicate block rows of H over a replication axis of size ``c`` and
aggregate partial SpMM products with an all-reduce, cutting the gathered
volume by ``c`` at the cost of an ``[NI, d]`` all-reduce per layer.

Layout (numpy, byte-identical to the JAX package's).  The graph is split
into ``pr = P / c`` block rows (the ordinary 1D partitioner — RAPA/METIS
reuse).  The ``P`` ranks form the paper's 2D ``(P/c, c)`` grid with the
block-row axis factored into two named axes, ``("grp", "sub")`` of sizes
``(c, g = pr/c)`` (hence the classic ``P % c**2 == 0`` constraint), plus
the replication axis ``("repl", c)``: :func:`~repro_torch.launch.mesh.
make_mesh` of ``(c, g, c)``, rank ``(a, s, j)`` at ``a*g*c + s*c + j``.
Rank ``(a, s, j)`` holds block row ``i = a*g + s`` of H (replicated over
``j``) and the edges of block row ``i`` whose *source* block belongs to
group ``j`` (blocks ``j*g .. j*g+g-1``), with source indices remapped to
``(k % g) * NI + owner_row`` — positions in the gathered group buffer.

Per layer, each rank (:class:`Spmm15dRuntime`):

1. casts its ``[ni, d]`` rows to the halo dtype;
2. permutes over ``(grp, repl)`` — the involution ``(a, s, j) -> (j, s,
   a)``, named by global ranks on the world group (:class:`~.collectives.
   PermuteFn`) — after which rank ``(a, s, j)`` holds block ``j*g + s``
   (skipped when ``c == 1``: the permutation is the identity);
3. all-gathers over ``"sub"`` (:class:`~.collectives.AllGatherFn`): now it
   holds all ``g`` blocks of group ``j``, exactly the rows its edge chunk
   reads (skipped when ``g == 1``), and casts back;
4. aggregates its chunk (:func:`chunk_adj`: an ``EdgeListAdj`` whose CSR
   packs, and their transpose for the backward, are built once with the
   runtime; the CSR kernel on the card, ``ops.coo_spmm`` on the CPU, for
   the reference's ``segment_sum``; padding rows dropped);
5. all-reduces over ``"repl"`` (:class:`~.collectives.AllReduceFn`), which
   sums the ``c`` partial aggregations into the exact neighbourhood sum of
   block row ``i`` (skipped when ``c == 1``), after which the (replicated)
   GCN or GIN transform applies.

``c == 1`` degenerates to the dense 1D baseline (full-H all-gather);
``c > 1`` gathers ``1/c`` of H per rank.  Every step is refresh-equivalent
and exact — the JACA tiers, staleness and the host store are ``halo_1d``
capabilities (see :class:`~.strategy.StrategyCaps`).  With
``exchange_layer0=False`` (the CLI's default: JACA on) each rank holds its
group's gathered layer-0 block from the start and layer 0 exchanges
nothing but its all-reduce.

Gradients.  Each collective's backward is its transpose (the inverse
permutation, the reduce-scatter, the all-reduce of the cotangent), so
autograd on each rank differentiates the all-rank sum of what the ranks
differentiate.  Each rank differentiates its block row's loss share
``sum(nll * mask) / total_train`` divided by ``c`` (the block row sits on
``c`` replicas) and the parameter gradients are summed over the world
group outside autograd, as ``capgnn_spmd`` does: the result is the
oracle's mean-loss gradient.  The JAX package instead divides its psummed
loss and gradients by ``c``, undoing an artefact of ``shard_map``'s
transpose of ``psum``; nothing here has that artefact, so nothing divides
it out.

Byte accounting.  :func:`forward_collective_bytes_per_device` models the
result-shape bytes of the collectives above per rank: the ``[ni, d]``
permute (a rank at a fixed point copies and is counted all the same, as
an HLO ``collective-permute`` counts on every device), the ``[g*ni, d]``
gather (wire dtype) and the ``[ni, d]`` f32 all-reduce.  The runtime's
:class:`~.collectives.Wire` counts equal it on every rank for every
forward (the tests and ``chip_smoke.py`` hold them equal).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..obs.annotations import device_scope
from .strategy import StrategyCapabilityError, StrategyCaps

__all__ = ["Spmm15dLayout", "Spmm15dRuntime", "Spmm15DStrategy",
           "build_spmm15d_layout", "make_spmm15d_mesh", "chunk_adj",
           "make_spmm15d_runtime", "train_spmm15d",
           "forward_collective_bytes_per_device", "step_bytes_total",
           "vanilla_bytes_total", "counted_forward_bytes", "check_model",
           "AXES_15D", "SPMM_15D"]

AXES_15D = ("grp", "sub", "repl")


@dataclasses.dataclass(frozen=True)
class Spmm15dLayout:
    """Static 1.5D layout: the ``pr``-block stacking (reused from
    ``stack_partitions``) plus per-device edge chunks with gathered-buffer
    source indices.  Flat device order is row-major over
    ``(grp, sub, repl)`` — device ``i*c + j`` serves block row ``i``,
    replica ``j``."""
    c: int                      # replication factor
    g: int                      # blocks per group (= pr / c)
    pr: int                     # block rows (= P / c)
    ni: int                     # padded rows per block (sp.n_inner_max)
    sp: object                  # StackedParts over the pr block rows
    chunk_src: np.ndarray       # [P, ME] int32 into [0, g*ni)
    chunk_dst: np.ndarray       # [P, ME] int32 into [0, ni]; ni = padding
    chunk_w: np.ndarray         # [P, ME] float32; 0 at padding
    n_edges_dev: np.ndarray     # [P] real edges per device chunk

    @property
    def n_devices(self) -> int:
        return self.pr * self.c

    @property
    def block_of_dev(self) -> np.ndarray:
        return np.repeat(np.arange(self.pr), self.c)

    @property
    def edges_total(self) -> int:
        return int(self.n_edges_dev.sum())


def build_spmm15d_layout(ps, task, spec) -> Spmm15dLayout:
    """Compile the 1.5D layout from an ordinary ``pr``-way partition.

    ``ps.num_parts`` is the block-row count ``pr``; the run needs
    ``pr * c`` devices and ``pr % c == 0`` (i.e. ``P % c**2 == 0``)."""
    from .exchange import stack_partitions

    c = spec.replication
    pr = ps.num_parts
    if pr % c:
        raise StrategyCapabilityError(
            f"spmm_15d with replication c={c} needs the block-row count "
            f"divisible by c (P % c**2 == 0); got pr={pr} block rows — "
            f"use {pr * c} devices with pr a multiple of {c}")
    g = pr // c
    sp = stack_partitions(ps, task, backend="edges")
    ni = sp.n_inner_max

    n = ps.graph.num_nodes
    owner_row = np.full(n, -1, np.int64)
    for part in ps.parts:
        owner_row[part.inner_nodes] = np.arange(part.n_inner)
    owner_part = ps.assign.astype(np.int64)

    chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for pt in ps.parts:
        src, dst = pt.local_graph.edges()
        keep = dst < pt.n_inner
        src, dst = src[keep], dst[keep]
        w = (pt.local_graph.edge_weight[keep]
             if pt.local_graph.edge_weight is not None
             else np.ones(src.shape[0], np.float32))
        gid = np.empty(src.shape[0], np.int64)
        inner = src < pt.n_inner
        gid[inner] = pt.inner_nodes[src[inner]]
        gid[~inner] = pt.halo_nodes[src[~inner] - pt.n_inner]
        k = owner_part[gid]
        src15 = ((k % g) * ni + owner_row[gid]).astype(np.int32)
        grp = k // g
        for j in range(c):
            sel = grp == j
            chunks.append((src15[sel], dst[sel].astype(np.int32),
                           w[sel].astype(np.float32)))

    p_dev = pr * c
    me = max(1, max(s.shape[0] for s, _, _ in chunks))
    chunk_src = np.zeros((p_dev, me), np.int32)
    chunk_dst = np.full((p_dev, me), ni, np.int32)   # ni row => dropped
    chunk_w = np.zeros((p_dev, me), np.float32)
    for d, (s, t, w) in enumerate(chunks):
        m = s.shape[0]
        chunk_src[d, :m] = s
        chunk_dst[d, :m] = t
        chunk_w[d, :m] = w
    n_edges_dev = np.array([s.shape[0] for s, _, _ in chunks], np.int64)
    return Spmm15dLayout(c=c, g=g, pr=pr, ni=ni, sp=sp,
                         chunk_src=chunk_src, chunk_dst=chunk_dst,
                         chunk_w=chunk_w, n_edges_dev=n_edges_dev)


def forward_collective_bytes_per_device(layout: Spmm15dLayout, cfg,
                                        spec) -> int:
    """Modeled per-device result-shape bytes of the forward collectives:
    per layer one permute (``[ni, d]``, wire dtype; c > 1), one
    all-gather (``[g*ni, d]``, wire dtype; g > 1) and one all-reduce
    (``[ni, d]``, f32; c > 1).  With ``exchange_layer0=False`` layer 0's
    permute/gather drop out (the gathered input features are
    pre-replicated at build time) while its partial-aggregation
    all-reduce remains."""
    wire = 2 if spec.halo_dtype == "bf16" else 4
    c, g, ni = layout.c, layout.g, layout.ni
    total = 0
    for li, d in enumerate(cfg.feat_dims[:cfg.num_layers]):
        ship = spec.exchange_layer0 or li > 0
        if c > 1 and ship:
            total += ni * d * wire              # permute(grp<->repl)
        if g > 1 and ship:
            total += g * ni * d * wire          # all_gather(sub)
        if c > 1:
            total += ni * d * 4                 # all_reduce(repl), f32
    return total


def step_bytes_total(layout: Spmm15dLayout, cfg, spec) -> int:
    """Modeled all-device wire bytes of one (refresh-equivalent) step."""
    return layout.n_devices * forward_collective_bytes_per_device(
        layout, cfg, spec)


def vanilla_bytes_total(layout: Spmm15dLayout, cfg, spec) -> int:
    """The dense 1D baseline on the same block partitioning: every device
    all-gathers every block of H each layer (CAGNET 1D; what ``c == 1``
    costs).  The report's ``comm_reduction`` therefore isolates the
    replication benefit."""
    wire = 2 if spec.halo_dtype == "bf16" else 4
    dims = [d for li, d in enumerate(cfg.feat_dims[:cfg.num_layers])
            if spec.exchange_layer0 or li > 0]
    per_dev = sum(layout.pr * layout.ni * d * wire for d in dims)
    return layout.n_devices * per_dev


def counted_forward_bytes(counts: dict) -> int:
    """The bytes of a :class:`~.collectives.Wire` count dict
    (``wire_log[step]["counts"]``) that the forward's collectives moved:
    every key but the backward's."""
    from .collectives import BACKWARD
    return sum(c["bytes"] for k, c in counts.items() if k != BACKWARD)


def check_model(cfg) -> None:
    """Raise :class:`~.strategy.StrategyCapabilityError` for a model the
    1.5D step functions do not implement (the JAX package's message)."""
    if cfg.model not in Spmm15DStrategy.caps.models:
        raise StrategyCapabilityError(
            f"spmm_15d implements models {Spmm15DStrategy.caps.models}, "
            f"not {cfg.model!r}; use strategy='halo_1d' for the others")


def make_spmm15d_mesh(c: int, g: int):
    """The ``(grp, sub, repl)`` = ``(c, g, c)`` mesh over the default
    process group (row-major — the order :class:`Spmm15dLayout`'s flat
    device index assumes).  Every rank calls it (``new_group`` is
    collective); a caller that builds several runtimes of one shape
    passes one mesh to each."""
    from ..launch.mesh import make_mesh
    return make_mesh((c, g, c), AXES_15D)


@dataclasses.dataclass
class Spmm15dRuntime:
    """This rank's 1.5D runtime.  All step flavours are the same exact
    step (no staleness axis); the names exist so generic tooling can poke
    it like the halo runtimes."""
    cfg: object
    layout: Spmm15dLayout
    mesh: object
    spec: object
    rank: int
    world_size: int
    device: torch.device
    step: Callable                  # (params, opt_state) -> (p, s, metrics)
    forward_fresh: Callable         # params -> this rank's [ni, out] logits
    evaluate: Callable              # (params, split) -> (loss, acc)
    loss_and_grads: Callable        # params -> (loss, grads) summed
    step_bytes: int                 # modeled all-device bytes per step
    vanilla_bytes: int              # dense-1D baseline bytes per step
    forward_bytes_per_device: int   # modeled forward collective bytes
    # per step, the Wire counts of this rank's three groups merged by key
    # ((layer, "permute" | "all_gather" | "all_reduce"), and the
    # backward's) and their host staging seconds
    wire_log: list = dataclasses.field(default_factory=list)

    # step-flavour aliases: every 1.5D step is exact
    @property
    def step_refresh(self):
        return self.step

    @property
    def step_cached(self):
        return self.step

    @property
    def step_pipelined(self):
        return self.step


def _merge_takes(wires) -> dict:
    """One ``Wire.take()`` of several wires: counts summed field by field
    where two wires share a key (the backward's), staging seconds
    summed."""
    counts, stage = {}, 0.0
    for w in wires:
        t = w.take()
        stage += t["host_stage_s"]
        for k, c in t["counts"].items():
            acc = counts.setdefault(k, dict.fromkeys(c, 0))
            for f, v in c.items():
                acc[f] += v
    return {"counts": counts, "host_stage_s": stage}


def chunk_adj(layout: Spmm15dLayout, rank: int, device="cuda",
              grad: bool = True):
    """Rank ``rank``'s edge chunk as an :class:`~repro_torch.models.gnn.
    EdgeListAdj` ``[ni, g * ni]`` over its gathered group buffer, on
    ``device``, with the chunk's CSR packs (and, with ``grad``, their
    transpose) built here once: the aggregation of every step."""
    from ..kernels import ops
    from ..models.gnn import EdgeListAdj
    m = int(layout.n_edges_dev[rank])       # the chunk's real edges
    src, dst, w = (torch.as_tensor(np.ascontiguousarray(a[rank, :m]),
                                   dtype=dt, device=device)
                   for a, dt in ((layout.chunk_src, torch.int64),
                                 (layout.chunk_dst, torch.int64),
                                 (layout.chunk_w, torch.float32)))
    n_cols = layout.g * layout.ni
    return EdgeListAdj(src, dst, w, layout.ni, n_cols,
                       ops.edge_packs(src, dst, w, layout.ni, n_cols,
                                      grad=grad))


def make_spmm15d_runtime(cfg, layout: Spmm15dLayout, opt, spec, mesh=None,
                         device="cuda") -> Spmm15dRuntime:
    """Build this rank's 1.5D runtime over ``mesh`` (a :class:`~repro_torch.
    launch.mesh.Mesh` of ``(c, g, c)`` over the default group, built from
    the layout's shape when omitted) on ``device`` (the card unless the
    caller asks for the CPU).  The default group must have
    ``layout.n_devices`` ranks; each rank keeps its own block row, edge
    chunk and (``exchange_layer0=False``) its group's layer-0 block."""
    import torch.distributed as dist

    from ..optim import tree_leaves, tree_map
    from .collectives import AllGatherFn, AllReduceFn, PermuteFn, Wire
    from .host_store import halo_dtype_info

    check_model(cfg)
    c, g, pr, ni = layout.c, layout.g, layout.pr, layout.ni
    p_dev = layout.n_devices
    if dist.get_world_size() != p_dev:
        raise StrategyCapabilityError(
            f"spmm_15d with pr={pr}, c={c} needs {p_dev} ranks, the group "
            f"has {dist.get_world_size()}")
    if mesh is None:
        mesh = make_spmm15d_mesh(c, g)
    if tuple(mesh.axis_names) != AXES_15D or tuple(mesh.shape) != (c, g, c):
        raise ValueError(f"spmm_15d needs a {AXES_15D} = ({c}, {g}, {c}) "
                         f"mesh, got axes {mesh.axis_names} of shape "
                         f"{mesh.shape}")
    device = torch.device(device)
    hdt = halo_dtype_info(spec.halo_dtype)[0]
    layers = cfg.num_layers
    sp = layout.sp
    world = Wire(None)
    sub = Wire(mesh.axis_groups["sub"])
    repl = Wire(mesh.axis_groups["repl"])
    wires = (world, sub, repl)
    rank = world.rank
    i, j = divmod(rank, c)                  # block row, replica
    a, s = divmod(i, g)
    peer = j * g * c + s * c + a            # (a, s, j) <-> (j, s, a)
    # an all-reduce on the world group first: every NCCL communicator of
    # the group exists before the permute, whose fixed points post nothing
    world.all_reduce(torch.zeros(1, device=device))

    def put(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), device=device,
                               dtype=dtype)

    feats = put(sp.feats[i])                                  # [ni, f]
    labels = put(sp.labels[i], torch.long)
    masks = {k: put(m[i]) for k, m in (("train", sp.train_mask),
                                       ("val", sp.val_mask),
                                       ("test", sp.test_mask))}
    adj = chunk_adj(layout, rank, device)
    hg0 = None
    if not spec.exchange_layer0:
        # pre-replicated inputs: this rank ships with its group's
        # gathered layer-0 block instead of exchanging it per step
        f = sp.feats.shape[-1]
        hg0 = put(sp.feats[j * g:(j + 1) * g].reshape(g * ni, f))
    total_train = float(max(float(np.asarray(sp.train_mask).sum()), 1.0))

    def gather_group(h: torch.Tensor, li: int) -> torch.Tensor:
        """permute(grp<->repl) + all_gather(sub): ``[ni, d] -> [g*ni, d]``
        holding every block of this rank's source group."""
        hw = h.to(hdt) if hdt is not None else h
        if c > 1:
            hw = PermuteFn.apply(hw, world, peer, peer, world.new_tag(1),
                                 (li, "permute"), ni)
        if g > 1:
            hw = AllGatherFn.apply(hw, sub, (li, "all_gather"), ni)
        return hw.to(h.dtype)

    def forward(params) -> torch.Tensor:
        h = feats
        for li, lp in enumerate(params):
            with device_scope(f"layer{li}/group_gather"):
                hg = hg0 if li == 0 and hg0 is not None else \
                    gather_group(h, li)
            with device_scope(f"layer{li}/spmm"):
                agg = adj.spmm(hg)
                if c > 1:
                    agg = AllReduceFn.apply(agg, repl, (li, "all_reduce"))
                if cfg.model == "gcn":
                    z = agg @ lp["w"] + lp["b"]
                else:                                          # gin
                    z = (1.0 + lp["eps"]) * h + agg
                    z = torch.relu(z @ lp["w1"] + lp["b1"]) @ lp["w2"] \
                        + lp["b2"]
            h = z if li == layers - 1 else torch.relu(z)
        return h

    def nll_and_correct(logits, mask):
        logp = torch.log_softmax(logits, -1)
        nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
        correct = (torch.argmax(logits, -1) == labels).float()
        return torch.sum(nll * mask), torch.sum(correct * mask)

    def end_step(logged: bool) -> None:
        taken = _merge_takes(wires)
        if logged:
            wire_log.append(taken)

    def value_and_grad(params):
        """This rank's share of the loss (its block row's over ``c``),
        differentiated; the loss, the correct count and the gradients
        then summed over the world group outside autograd."""
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        nll_sum, correct = nll_and_correct(forward(live), masks["train"])
        share = nll_sum / total_train / c
        grads = torch.autograd.grad(share, leaves)
        parts = [share.detach().reshape(1), correct.reshape(1)] + \
            [gr.reshape(-1) for gr in grads]
        flat = world.all_reduce(torch.cat(parts), "sum")
        loss, correct = flat[0], flat[1]
        out, off = [], 2
        for gr in grads:
            out.append(flat[off:off + gr.numel()].view_as(gr))
            off += gr.numel()
        gl = iter(out)
        return loss, correct / (c * total_train), \
            tree_map(lambda _: next(gl), params)

    def step(params, opt_state):
        loss, acc, grads = value_and_grad(params)
        new_params, new_state = opt.update(grads, opt_state, params)
        end_step(True)
        return new_params, new_state, {"loss": loss, "acc": acc}

    def loss_and_grads(params):
        loss, _, grads = value_and_grad(params)
        end_step(False)
        return loss, grads

    @torch.no_grad()
    def forward_fresh(params) -> torch.Tensor:
        logits = forward(params)
        end_step(False)
        return logits

    def evaluate(params, split: str = "val"):
        # rows are c-fold replicated; the masked means are unaffected
        mask = masks[split]
        nll_sum, correct = nll_and_correct(forward_fresh(params), mask)
        sums = world.all_reduce(torch.stack([nll_sum, correct, mask.sum()]))
        n = torch.clamp(sums[2], min=1.0)
        return float(sums[0] / n), float(sums[1] / n)

    wire_log: list = []
    return Spmm15dRuntime(
        cfg=cfg, layout=layout, mesh=mesh, spec=spec, rank=rank,
        world_size=p_dev, device=device, step=step,
        forward_fresh=forward_fresh, evaluate=evaluate,
        loss_and_grads=loss_and_grads,
        step_bytes=step_bytes_total(layout, cfg, spec),
        vanilla_bytes=vanilla_bytes_total(layout, cfg, spec),
        forward_bytes_per_device=forward_collective_bytes_per_device(
            layout, cfg, spec),
        wire_log=wire_log)


def train_spmm15d(cfg, runtime: Spmm15dRuntime, opt, spec, epochs: int,
                  eval_every: int = 0, seed: int = 0, params0=None,
                  opt_state0=None):
    """The 1.5D training loop on this rank: every step is an exact
    refresh-equivalent step; byte accounting is the modeled figure (equal
    to the counted one).  Returns the same :class:`~repro_torch.dist.
    capgnn_sim.TrainReport` shape as ``train_capgnn`` (``comm_bytes_vanilla``
    is the dense-1D baseline on the same blocks), with each step's kind
    and host seconds (fenced by reading its loss).  Without ``params0``
    the parameters are ``init_gnn`` of ``seed``, the same on every
    rank."""
    from ..models.gnn import init_gnn
    from .capgnn_sim import TrainReport

    params = params0 if params0 is not None else init_gnn(
        cfg, torch.Generator().manual_seed(seed), runtime.device)
    opt_state = opt_state0 if opt_state0 is not None else opt.init(params)
    losses: list[float] = []
    val_acc: list[float] = []
    step_s: list[float] = []
    compile_s = 0.0
    t0 = time.perf_counter()
    for e in range(epochs):
        ts = time.perf_counter()
        params, opt_state, m = runtime.step(params, opt_state)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - ts)
        if e == 0:
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        if eval_every and (e + 1) % eval_every == 0:
            val_acc.append(runtime.evaluate(params, "val")[1])
    wall = time.perf_counter() - t0
    comm = runtime.step_bytes * epochs
    vanilla = runtime.vanilla_bytes * epochs
    report = TrainReport(
        losses=losses, val_acc=val_acc, comm_bytes=comm,
        comm_bytes_vanilla=vanilla,
        comm_reduction=1.0 - comm / max(vanilla, 1),
        refresh_steps=epochs, cached_steps=0, wall_time_s=wall,
        final_opt_state=opt_state, compile_s=compile_s,
        spec=spec.to_dict() if spec is not None else None,
        step_kinds=["refresh"] * epochs, step_s=step_s)
    return params, report


class Spmm15DStrategy:
    """Registry entry for the 1.5D replicated-row SpMM model."""
    name = "spmm_15d"
    caps = StrategyCaps(jaca_tiers=False, pipeline=False,
                        host_features=False, adaptive_cache=False,
                        fault_guard=False, sim_runtime=False,
                        transports=("mesh_collectives",),
                        backends=("edges",),
                        models=("gcn", "gin"),
                        replicated=True)

    def validate_spec(self, spec) -> None:
        def deny(cond: bool, what: str):
            if cond:
                raise StrategyCapabilityError(
                    f"spmm_15d does not support {what} — that is halo_1d "
                    "machinery (see the strategy capability matrix in the "
                    "README); every spmm_15d step is refresh-equivalent "
                    "and exact")
        deny(spec.features != "device", f"features={spec.features!r}")
        deny(spec.pipeline, "pipeline=True (overlapped refresh)")
        deny(spec.cache_policy != "static",
             f"cache_policy={spec.cache_policy!r} (adaptive caching)")
        deny(spec.refresh_every != 1,
             f"refresh_every={spec.refresh_every} (bounded staleness)")
        deny(spec.backend != "edges", f"backend={spec.backend!r}")
        deny(bool(spec.faults) or spec.guard_every > 0 or spec.checksums
             or spec.fetch_retries is not None,
             "fault injection / guard defenses")
        deny(spec.pallas_pack, "pallas_pack (p2p peer packing)")

    def build_layout(self, ps, task, spec, **kw) -> Spmm15dLayout:
        return build_spmm15d_layout(ps, task, spec)

    def make_sim_runtime(self, cfg, layout, opt, spec, **kw):
        raise StrategyCapabilityError(
            "spmm_15d has no single-device sim runtime; parity checks "
            "run against the halo_1d sim oracle at refresh_every=1 "
            "(see tests/spmm15d_parity_script.py)")

    def make_spmd_runtime(self, cfg, layout, opt, spec, mesh=None, **kw):
        return make_spmm15d_runtime(cfg, layout, opt, spec, mesh=mesh, **kw)

    def train(self, cfg, runtime, layout, opt, spec, epochs, **kw):
        return train_spmm15d(cfg, runtime, opt, spec, epochs, **kw)

    def step_bytes(self, layout, cfg, spec) -> int:
        return step_bytes_total(layout, cfg, spec)

    def forward_collective_bytes(self, layout, cfg, spec,
                                 mesh_size=None) -> int:
        return forward_collective_bytes_per_device(layout, cfg, spec)


SPMM_15D = Spmm15DStrategy()
