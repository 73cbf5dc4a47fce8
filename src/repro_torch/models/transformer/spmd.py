"""SPMD context for the transformer zoo, the JAX package's
``models/transformer/spmd.py`` over a ``torch.distributed`` ``DeviceMesh``.

The model code is mesh-agnostic; the launcher installs an :class:`SpmdCtx`
that tells it (a) how activations are sharded (so it can place layout
constraints) and (b) which axes are data-parallel (so the MoE dispatch can
run per dp group — GShard-style per-group capacity instead of an
infeasible global dispatch tensor).

Where the reference's GSPMD inserts collectives from sharding hints, the
port's parameters and activations are DTensors: :func:`constrain` is a
``redistribute`` to the context's layout, and DTensor's sharding
propagation places the collectives between constraints.  A layout is
written as the reference writes it, a :class:`P` with one entry per
tensor dim naming the mesh axes it is sharded over (a tuple for several,
major first); :func:`placements` is the one translation to DTensor's
placements, one per mesh dim.  Without a context every function here
returns its input: no DTensor appears and the model is the single-device
code.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Optional

import torch

__all__ = ["P", "SpmdCtx", "use_spmd", "current_spmd", "constrain",
           "constrain_to", "block_sp_active", "block_sp_dp", "placements",
           "is_dtensor", "spmd_region", "to_local_as", "from_local_as",
           "matmul", "heads_reshape", "spec_of", "shard_offset",
           "gather_rows"]

# Process-wide, not per thread as the reference's: autograd runs a CUDA
# backward (and remat's recomputation) on its own device threads, which
# must see the context the forward ran under.
_state = types.SimpleNamespace(ctx=None)


class P(tuple):
    """A PartitionSpec: ``P(dp, "model", None)``, one entry per tensor dim
    (``None``, a mesh axis name, or a tuple of names sharding that dim
    over several axes, major first).  Compares equal to the tuple of its
    entries, so specs compare with the reference's ``tuple(spec)``; as
    the reference's, a one-name tuple entry is that name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1
            else None if e == () else e for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec, ndim: int) -> list:
    """DTensor placements on ``mesh`` of the spec ``spec`` for a tensor of
    ``ndim`` dims (the spec padded with ``None`` or trimmed to ``ndim``,
    as the reference's ``constrain`` trims it): ``Shard(i)`` on each mesh
    dim that dim ``i`` names, ``Replicate()`` on the rest.  A dim sharded
    over several axes must name them in the mesh's order (DTensor splits
    over the mesh dims left to right, as a tuple entry is major first).
    Uneven dims shard unevenly (DTensor's chunks, ceil-sized first, the
    sizes GSPMD pads each shard to)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    entries = (list(spec) + [None] * ndim)[:ndim]
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(entries):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} of spec {spec} names axes {axes} "
                             f"out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} named twice in "
                                 f"{spec}")
            out[i] = Shard(dim)
    return out


def spec_of(x) -> P:
    """The spec of a DTensor's placements (the inverse of
    :func:`placements` for Shard and Replicate)."""
    from torch.distributed.tensor import Shard
    names = tuple(x.device_mesh.mesh_dim_names)
    axes = [[] for _ in range(x.ndim)]
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    return P(*(None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in axes))


def shard_offset(x, dim: int) -> int:
    """Where this rank's shard of the DTensor ``x`` starts along ``dim``
    (DTensor's chunks: ceil-sized, split over the mesh dims left to
    right); computed from the mesh coordinates alone."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    off, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            k, r = mesh.size(i), mesh.get_local_rank(i)
            c = -(-size // k)
            start = min(r * c, size)
            off, size = off + start, min(start + c, size) - start
    return off


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    mesh: object                        # torch DeviceMesh with axis names
    dp_axes: tuple[str, ...]            # axes sharding tokens (batch or seq)
    act_spec: P                         # spec for [B, S, D] hiddens
    logits_spec: Optional[P] = None     # for [B, S, V] logits
    moe_group: bool = True              # run MoE dispatch per dp group
    # Block-level sequence parallelism: residuals stay seq-sharded between
    # blocks, but q/k/v (and SSM internals) are constrained to a seq-FULL,
    # head-(or channel-)sharded layout ONCE per block, so the attention
    # chunk loops and recurrent scans run on local tensors with zero
    # per-iteration collectives (one all-gather in, one reduce-scatter out).
    block_sp: bool = False

    @property
    def sizes(self) -> dict:
        """``{axis name: size}``, the reference's ``dict(mesh.shape)``."""
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))


def use_spmd(ctx: Optional[SpmdCtx]):
    @contextlib.contextmanager
    def cm():
        prev = getattr(_state, "ctx", None)
        _state.ctx = ctx
        try:
            yield ctx
        finally:
            _state.ctx = prev
    return cm()


def current_spmd() -> Optional[SpmdCtx]:
    return getattr(_state, "ctx", None)


def constrain(x, spec_name: str = "act"):
    """Redistribute ``x`` to the context's activation (or logits) layout
    if a ctx is installed and ``x`` is a DTensor (no-op otherwise)."""
    ctx = current_spmd()
    if ctx is None or not is_dtensor(x):
        return x
    spec = ctx.act_spec if spec_name == "act" else ctx.logits_spec
    if spec is None:
        return x
    return x.redistribute(ctx.mesh, placements(ctx.mesh, spec, x.ndim))


def constrain_to(x, spec: P):
    """Explicit-spec constraint (no-op without a ctx or on a plain
    tensor)."""
    ctx = current_spmd()
    if ctx is None or not is_dtensor(x):
        return x
    return x.redistribute(ctx.mesh, placements(ctx.mesh, spec, x.ndim))


def block_sp_active() -> bool:
    ctx = current_spmd()
    return bool(ctx is not None and ctx.block_sp)


def block_sp_dp() -> tuple[str, ...]:
    ctx = current_spmd()
    return ctx.dp_axes if ctx is not None else ()


def spmd_region():
    """The context the sharded model runs in: with a ctx installed, DTensor's
    implicit replication (plain tensors the model makes — rope tables,
    masks, positions — act as replicated); without one, nothing.  Unlike
    ``torch.distributed.tensor.experimental.implicit_replication`` it
    nests: leaving an inner region restores the outer one's setting (the
    backward of ``loss_and_grads`` runs in the region its forward left)."""
    if current_spmd() is None:
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def to_local_as(x, spec: P, partial_over: tuple = ()) -> torch.Tensor:
    """The local shard of the DTensor ``x`` redistributed to ``spec``: the
    entry to a manual region (a ``shard_map`` body).  The gradient each
    rank's region gives the shard is taken to have the same layout, except
    over the mesh axes ``partial_over``, where it is a partial sum (a
    replicated weight used on each rank's own tokens, or a replicated
    input whose use is split over those ranks)."""
    from torch.distributed.tensor import Partial
    ctx = current_spmd()
    pl = placements(ctx.mesh, spec, x.ndim)
    y = x.redistribute(ctx.mesh, pl)
    if not partial_over:
        return y.to_local()
    names = tuple(ctx.mesh.mesh_dim_names)
    grad = [Partial() if n in partial_over else p for n, p in zip(names, pl)]
    return y.to_local(grad_placements=grad)


def from_local_as(t: torch.Tensor, spec: P, shape) -> torch.Tensor:
    """The DTensor of global ``shape`` whose local shard under ``spec`` is
    ``t``: the exit of a manual region."""
    from torch.distributed.tensor import DTensor
    ctx = current_spmd()
    shape = torch.Size(shape)
    return DTensor.from_local(t.contiguous(), ctx.mesh,
                              placements(ctx.mesh, spec, len(shape)),
                              run_check=False, shape=shape,
                              stride=_contig_stride(shape))


def _contig_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def matmul(x, w):
    """``x @ w`` (x [..., K], w [K, N]).  For DTensors the product is
    taken on the local shards: on each mesh dim, x's leading dims sharded
    with w replicated give the rows, w's columns sharded with x replicated
    the columns, both K-split a partial sum.  Where the two layouts clash
    on a mesh dim, one side is replicated over it first by a fixed rule,
    whatever the sizes: x where its rows and w's columns are both sharded
    there (the activation is gathered, as sequence parallelism does), and
    the split side where only one side of K is split.  DTensor's own
    ``matmul`` flattens x's leading dims and cannot view the product back
    when two of them are sharded and the batch does not divide the mesh.
    Plain tensors (and a partial-sum operand) go to ``x @ w``."""
    if not (is_dtensor(x) and is_dtensor(w)) or w.ndim != 2:
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    last = x.ndim - 1
    xp, wp = list(x.placements), list(w.placements)
    if any(isinstance(p, Partial) for p in xp + wp):
        return x @ w
    for i, (px, pw) in enumerate(zip(xp, wp)):
        x_rows = isinstance(px, Shard) and px.dim < last
        x_k = isinstance(px, Shard) and px.dim == last
        w_k = isinstance(pw, Shard) and pw.dim == 0
        if x_k != w_k:                      # one side of K split
            if x_k:
                xp[i] = Replicate()
            else:
                wp[i] = Replicate()
        elif x_rows and isinstance(pw, Shard):
            xp[i] = Replicate()
    if xp != list(x.placements):
        x = x.redistribute(x.device_mesh, xp)
    if wp != list(w.placements):
        w = w.redistribute(w.device_mesh, wp)
    out, gx, gw = [], [], []        # the product's placements, the grads'
    for px, pw in zip(xp, wp):
        if isinstance(px, Shard) and px.dim < last:
            out.append(Shard(px.dim))           # rows: w's grad a part
            gx.append(px)
            gw.append(Partial())
        elif isinstance(pw, Shard) and pw.dim == 1:
            out.append(Shard(last))             # columns: x's grad a part
            gx.append(Partial())
            gw.append(pw)
        elif isinstance(px, Shard):
            out.append(Partial())               # K split: a partial sum
            gx.append(px)
            gw.append(pw)
        else:
            out.append(Replicate())
            gx.append(px)
            gw.append(pw)
    shape = torch.Size(tuple(x.shape[:-1]) + (w.shape[1],))
    y = x.to_local(grad_placements=gx) @ w.to_local(grad_placements=gw)
    return DTensor.from_local(y, x.device_mesh, out, run_check=False,
                              shape=shape, stride=_contig_stride(shape))


def gather_rows(x, *ws):
    """``x`` gathered over the mesh dims where its leading dims are sharded
    and some of ``ws`` has its columns sharded: the one all-gather in of
    sequence parallelism, shared by the column-parallel products that
    follow (``matmul`` would repeat it for each).  A plain ``x`` returns
    as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    pl = list(x.placements)
    for i, px in enumerate(pl):
        if isinstance(px, Shard) and px.dim < last and any(
                isinstance(w.placements[i], Shard)
                and w.placements[i].dim == 1 for w in ws):
            pl[i] = Replicate()
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def heads_reshape(t, shape):
    """``t.reshape(shape)`` splitting the last dim into (heads, head_dim)
    or merging the last two.  For a DTensor whose heads dim (or the dim
    being split) is sharded over more ranks than the head count divides (5
    heads over 2, 40 over 16), or whose head_dim is sharded in a merge,
    those dims are replicated first and the reshape runs on the local
    shards: DTensor can view such dims neither forward nor in the
    backward."""
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    shape = tuple(shape)
    split = len(shape) > t.ndim
    heads = shape[-2] if split else t.shape[-2]
    dim = t.ndim - 1 if split else t.ndim - 2
    mesh = t.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    n, inner = 1, False
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard) and p.dim >= dim:
            n *= sizes[name]
            inner |= p.dim > dim        # merging a sharded head_dim
    if heads % n == 0 and not inner:
        return t.reshape(shape)
    pl = [Replicate() if isinstance(p, Shard) and p.dim >= dim else p
          for p in t.placements]
    local = t.redistribute(mesh, pl).to_local()
    lshape = (tuple(local.shape[:-1]) + shape[-2:] if split
              else tuple(local.shape[:-2]) + shape[-1:])
    gshape = torch.Size(shape)
    return DTensor.from_local(local.reshape(lshape), mesh, pl,
                              run_check=False, shape=gshape,
                              stride=_contig_stride(gshape))
