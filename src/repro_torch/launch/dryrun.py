"""Multi-pod dry run: one step of every (architecture x input shape) on the
production meshes with no real devices, and its per-device memory, cost
and collective figures — the JAX package's ``launch/dryrun.py`` for the
port.

Where the reference lowers and compiles for 256 or 512 forced host
devices, the port brings up a ``fake`` process group of 256 or 512 ranks
(this process is rank 0: ``torch.distributed``'s ``FakeStore``, whose
collectives move nothing), lays the production ``DeviceMesh`` over it,
and runs the step once under ``FakeTensorMode``: every tensor is a fake
of its local shard's shape on ``--device`` (``cuda`` by default, also on
a machine without one), so no device memory is touched.  The step is the
reference's: training with ``adam(3e-4)``, ZeRO-1 moments and ``remat``
forced; prefill's last-token logits; decode's ``serve_step`` with sharded
caches at the cache's last position.  ``long_500k`` uses
``long_context_variant``.

The figures come from :class:`~repro_torch.launch.hlo_cost.OpCounter` over
that run: FLOPs, bytes and collectives per device (rank 0's shards, the
largest where a dim shards unevenly), counts not timings.  ``trace_s`` is
the run's wall time on the host (the reference's ``lower_s`` and
``compile_s``).  ``memory`` holds the argument and output bytes per
device (the local shards) and the peak bytes of the step's other tensors
alive at once (``temp_size``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import weakref

import torch
import torch.distributed as dist

from ..configs import (ARCH_IDS, INPUT_SHAPES, canonical, get_config,
                       long_context_variant)
from ..models.transformer import (ModelConfig, forward, serve_step,
                                  train_step_fn, use_spmd)
from ..optim import adam
from ..optim.optimizers import tree_leaves, tree_map
from . import sharding as shd
from .hlo_cost import OpCounter
from .mesh import dp_axes, make_production_mesh, mesh_sizes

__all__ = ["build_step", "run_one", "run_counted", "materialize",
           "collective_bytes", "main", "fake_group"]


def fake_group(world_size: int) -> None:
    """Bring up (or resize) the ``fake`` process group of ``world_size``
    ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def collective_bytes(cost) -> dict:
    """Per-device collective result bytes by kind, their counts and total
    (the reference's function of the same name, over a counted run)."""
    return {"per_kind": dict(cost.collective_bytes),
            "counts": dict(cost.collective_counts),
            "total": cost.collective_total}


def build_step(cfg: ModelConfig, shape_name: str, mesh,
               act_mode: str = "baseline"):
    """Returns (fn, example_args_shape_structs, ctx, meta); the structs are
    :class:`~repro_torch.launch.sharding.ShapeDtypeStruct` trees (plain
    ints pass through).  ``shape_name`` names an ``INPUT_SHAPES`` entry,
    or is a ``(seq_len, batch, kind)`` tuple of its own."""
    seq_len, batch, kind = (INPUT_SHAPES[shape_name]
                            if isinstance(shape_name, str) else shape_name)
    seq_shard = (batch == 1)
    if shape_name == "long_500k":
        cfg = long_context_variant(cfg)
    if kind == "train" and not cfg.remat:
        # block-level activation checkpointing is mandatory at these shapes
        cfg = dataclasses.replace(cfg, remat=True)
    ctx = shd.make_spmd_ctx(mesh, cfg, kind, seq_shard, act_mode=act_mode)
    p_shapes = shd.abstract_params(cfg)
    p_structs = shd.attach(p_shapes, shd.param_shardings(mesh, cfg, p_shapes))

    if kind == "train":
        opt = adam(3e-4)
        o_shapes = opt.init(p_shapes)
        o_structs = shd.attach(o_shapes,
                               shd.param_shardings(mesh, cfg, o_shapes,
                                                   zero_data=True))
        batch_structs = shd.batch_specs(mesh, cfg, seq_len, batch, kind,
                                        seq_shard)
        fn = train_step_fn(cfg, opt)
        args = (p_structs, o_structs, batch_structs)
    elif kind == "prefill":
        batch_structs = shd.batch_specs(mesh, cfg, seq_len, batch, kind,
                                        seq_shard)

        def fn(params, b):
            logits, _ = forward(cfg, params, b)
            return logits[:, -1]        # next-token logits only

        args = (p_structs, batch_structs)
    else:  # decode
        cache_structs = shd.decode_state_specs(mesh, cfg, batch, seq_len,
                                               seq_shard)
        dp = dp_axes(mesh)
        tok = shd.ShapeDtypeStruct((batch, 1), torch.int32,
                                   shd.P(None if seq_shard else dp, None))

        def fn(params, caches, tokens, position):
            return serve_step(cfg, params, caches, tokens, position)

        args = (p_structs, cache_structs, tok, seq_len - 1)
    return fn, args, ctx, {"cfg": cfg, "seq_len": seq_len, "batch": batch,
                           "kind": kind}


def materialize(structs, mesh, device, generator=None):
    """DTensors of a struct tree (plain ints pass through): without a
    ``generator`` empty (inside ``FakeTensorMode``, fakes), with one
    floats from its normal draws and integers zero (the counted figures
    depend on neither).  Every rank builds the whole tree and keeps its
    shards."""
    def one(s):
        if not isinstance(s, shd.ShapeDtypeStruct):
            return s
        if generator is None:
            t = torch.empty(s.shape, dtype=s.dtype, device=device)
        elif s.dtype.is_floating_point:
            t = torch.randn(s.shape, generator=generator).to(s.dtype)
        else:
            t = torch.zeros(s.shape, dtype=s.dtype)
        return shd.place(t.to(device), mesh, s)
    if isinstance(structs, shd.ShapeDtypeStruct):
        return one(structs)
    return tree_map(one, structs)


def run_counted(cfg: ModelConfig, shape, mesh, device,
                act_mode: str = "baseline", seed: int = 0):
    """The step of :func:`build_step` run for real on this rank's shards
    (every rank of ``mesh`` calls it), counted by ``OpCounter``:
    ``(outputs, HloCost)``.  The dry run's figures for the same config,
    shape and mesh equal these."""
    fn, args, ctx, _ = build_step(cfg, shape, mesh, act_mode=act_mode)
    gen = torch.Generator().manual_seed(seed)
    inputs = tuple(materialize(a, mesh, device, gen) for a in args)
    with use_spmd(ctx), OpCounter() as counter:
        out = fn(*inputs)
    return out, counter.cost


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


class _LiveBytes(OpCounter):
    """:class:`OpCounter` that also tracks the bytes of the non-view
    results alive at once (each released when its tensor is)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0

    def _count(self, func, args, kwargs, out) -> None:
        super()._count(func, args, kwargs, out)
        if func.is_view:
            return
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                n = t.numel() * t.element_size()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            cfg_override: ModelConfig | None = None,
            ctx_override=None, act_mode: str = "baseline",
            device: str = "cuda", mesh=None) -> dict:
    """One step of ``arch`` x ``shape_name`` on the production mesh (or on
    ``mesh``, a DeviceMesh over the group that is up), counted on rank 0.
    Brings up the fake group of the mesh's size unless ``mesh`` is
    given."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if mesh is None:
        fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=torch.device(device).type)
    cfg = cfg_override or get_config(arch)
    fn, args, ctx, meta = build_step(cfg, shape_name, mesh, act_mode=act_mode)
    if ctx_override is not None:
        ctx = ctx_override(mesh, meta)
    sizes = mesh_sizes(mesh)
    n_dev = 1
    for v in sizes.values():
        n_dev *= v
    with FakeTensorMode(allow_non_fake_inputs=True):
        inputs = tuple(materialize(a, mesh, device) for a in args)
        t0 = time.perf_counter()
        with use_spmd(ctx), _LiveBytes() as counter:
            out = fn(*inputs)
        trace_s = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
    acc = counter.cost
    mesh_tag = "x".join(str(v) for v in sizes.values())
    return {
        "arch": meta["cfg"].name,
        "shape": shape_name if isinstance(shape_name, str) else list(
            shape_name),
        "mesh": mesh_tag,
        "act_mode": act_mode,
        "devices": int(n_dev),
        "seq_len": meta["seq_len"], "batch": meta["batch"],
        "kind": meta["kind"],
        "device": str(device),
        "trace_s": round(trace_s, 1),
        "hlo_flops_per_device": acc.flops,
        "hlo_bytes_per_device": acc.bytes_accessed,
        "collective_bytes_per_device": acc.collective_total,
        "collectives": dict(acc.collective_bytes),
        "collective_counts": dict(acc.collective_counts),
        "unresolved_loops": acc.unresolved_loops,
        "memory": {
            "argument_size": sum(shd.per_device_bytes(a, sizes)
                                 for a in args
                                 if not isinstance(a, int)),
            "output_size": out_bytes,
            "temp_size": counter.peak,
        },
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--act-mode", default="baseline",
                    choices=["baseline", "block_sp"])
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (no memory is touched)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else [canonical(args.arch)]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                if args.act_mode != "baseline":
                    tag += f"_{args.act_mode}"
                try:
                    res = run_one(arch, shape, multi_pod=mp,
                                  act_mode=args.act_mode, device=args.device)
                except Exception as exc:  # noqa: BLE001 - report and continue
                    failures.append((tag, str(exc)[:200]))
                    print(f"FAIL {tag}: {exc}")
                    continue
                path = os.path.join(args.out, tag + ".json")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                print(f"OK   {tag}  flops/dev={res['hlo_flops_per_device']:.3e} "
                      f"coll/dev={res['collective_bytes_per_device']:.3e} "
                      f"temp={res['memory']['temp_size']}")
    if failures:
        print(f"{len(failures)} FAILURES")
        for tag, msg in failures:
            print(" ", tag, msg)
        raise SystemExit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
