"""Rank functions of the transformer zoo's SPMD tests: the port's model
sharded on a ``("data", "model")`` DeviceMesh of gloo ranks on the CPU,
the results gathered (``full_tensor``) and returned by rank 0 as numpy.

A case is a dict: ``arch``, ``mesh`` (D, M), ``kind`` (``"fwd"``: logits,
aux, loss and ``loss_and_grads``'s gradients; ``"decode"``: 8
``serve_step``s; ``"train"``: one AdamW ``train_step_fn`` step with
ZeRO-1 moments), ``mode`` (``"baseline"`` or ``"block_sp"``),
``seq_shard``, the JAX parameters as numpy (``params``) and the batch
(``batch``, or ``tokens`` for decode).  Every case of one spawn has a
mesh of the spawn's world size.
"""
import dataclasses

import torch


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _flat(tree, prefix):
    from repro_torch.launch.sharding import tree_map_with_path
    out = {}
    tree_map_with_path(
        lambda n, leaf: out.__setitem__(prefix + "/" + "/".join(n), _np(leaf)),
        tree)
    return out


def _tokens(mesh, tok, seq_shard):
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.sharding import place
    from repro_torch.models.transformer.spmd import P
    return place(torch.from_numpy(tok), mesh,
                 P(None if seq_shard else dp_axes(mesh), None))


def run_case(case):
    from repro_torch.configs import get_reduced
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.transformer import (
        init_decode_cache, loss_and_grads, forward, serve_step,
        train_step_fn, use_spmd)
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_reduced(case["arch"]), dtype="float32")
    mesh = make_device_mesh(case["mesh"], ("data", "model"), "cpu")
    seq_shard = case.get("seq_shard", False)
    params = lm_params_from_reference(case["params"], "cpu")
    dparams = shd.shard_params(params, mesh, cfg)
    out = {}
    if case["kind"] == "decode":
        b, w = case["batch_size"], case["cache_len"]
        ctx = shd.make_spmd_ctx(mesh, cfg, "decode", seq_shard)
        caches = shd.place(init_decode_cache(cfg, b, w, device="cpu"), mesh,
                           shd.decode_state_specs(mesh, cfg, b, w, seq_shard))
        toks = case["tokens"]
        with use_spmd(ctx):
            for i in range(toks.shape[1]):
                logits, caches = serve_step(
                    cfg, dparams, caches,
                    _tokens(mesh, toks[:, i:i + 1], seq_shard), i)
                out[f"logits{i}"] = _np(logits)
        out.update(_flat(caches, "caches"))
        return out
    arrs = case["batch"]
    s, b = arrs["tokens"].shape[1], arrs["tokens"].shape[0]
    kind = "train" if case["kind"] != "prefill" else "prefill"
    structs = shd.batch_specs(mesh, cfg, s, b, kind, seq_shard)
    batch = shd.place({k: torch.from_numpy(v) for k, v in arrs.items()},
                      mesh, structs)
    ctx = shd.make_spmd_ctx(mesh, cfg, kind, seq_shard,
                            act_mode=case.get("mode", "baseline"))
    with use_spmd(ctx):
        if case["kind"] == "train":
            opt = adamw(case["lr"], eps=case["eps"])
            state = shd.shard_params(opt.init(params), mesh, cfg,
                                     zero_data=True)
            p2, _, met = train_step_fn(cfg, opt)(dparams, state, batch)
            out.update(_flat(p2, "params"))
            out["loss"] = _np(met["loss"])
            return out
        logits, aux = forward(cfg, dparams, batch)
        out["logits"], out["aux"] = _np(logits), _np(aux)
        if case["kind"] == "fwd":
            total, met, grads = loss_and_grads(cfg, dparams, batch)
            out["total"], out["loss"] = _np(total), _np(met["loss"])
            out.update(_flat(grads, "grads"))
    return out


def lm_cases_rank(rank, world_size, device, cases):
    """Every case in turn on this rank; rank 0 returns ``{name: result}``."""
    import logging
    import warnings
    warnings.filterwarnings("ignore")
    # DTensor warns at each two-axis all-reduce that a flattened mesh
    # would take one collective
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    got = {}
    for case in cases:
        got[case["name"]] = run_case(case)
    return got if rank == 0 else None


def counted_rank(rank, world_size, device, cases, mesh_shape):
    """``dryrun.run_counted`` of each ``(arch, shape)`` case (the reduced
    config in f32) on a real gloo mesh; rank 0 returns its counted
    figures, a list in the cases' order."""
    import logging
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from repro_torch.configs import get_reduced
    from repro_torch.launch.dryrun import run_counted
    from repro_torch.launch.mesh import make_device_mesh
    mesh = make_device_mesh(mesh_shape, ("data", "model"), "cpu")
    out = []
    for arch, shape in cases:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        _, cost = run_counted(cfg, shape, mesh, "cpu")
        out.append(dict(flops=cost.flops, bytes=cost.bytes_accessed,
                        collectives=dict(cost.collective_bytes),
                        counts=dict(cost.collective_counts)))
    return out if rank == 0 else None


def shards_rank(rank, world_size, device, arch, params, mesh_shape):
    """Every rank's local shard of each leaf of ``shard_params`` (the JAX
    parameters, reduced config of ``arch``), gathered to rank 0 as
    ``{path: [shard of rank 0, 1, ...]}``."""
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_device_mesh
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    mesh = make_device_mesh(mesh_shape, ("data", "model"), "cpu")
    placed = shd.shard_params(lm_params_from_reference(params, "cpu"), mesh,
                              cfg)
    mine = {}
    shd.tree_map_with_path(
        lambda n, t: mine.__setitem__("/".join(n), t.to_local().numpy()),
        placed)
    every = [None] * world_size
    dist.all_gather_object(every, mine)
    return ({k: [r[k] for r in every] for k in mine} if rank == 0 else None)


def staged_collectives_rank(rank, world_size, device):
    """All-gather, reduce-scatter, all-reduce and all-to-all over the
    ``staged`` group, of CUDA tensors and of the same tensors on the CPU
    (which the group hands to gloo as they are): rank 0 returns the
    largest difference between the two results of each."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.dist.collectives import mesh_all_to_all
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(world_size * 3, 5, generator=gen)
    group = dist.group.WORLD
    gather = getattr(funcol, "all_gather_single",
                     None) or funcol.all_gather_tensor

    def run(t):
        return {
            "all-gather": funcol.wait_tensor(gather(t, 0, group)),
            "reduce-scatter": funcol.wait_tensor(
                funcol.reduce_scatter_tensor(t, "sum", 0, group)),
            "all-reduce": funcol.wait_tensor(funcol.all_reduce(t, "sum",
                                                               group)),
            "all-to-all": mesh_all_to_all(t, group),
        }
    on_card = {k: v.cpu() for k, v in run(x.to(device)).items()}
    on_host = run(x)
    diffs = {k: float((on_card[k] - on_host[k]).abs().max())
             for k in on_host}
    return diffs if rank == 0 else None


def cuda_shards_rank(rank, world_size, device, mesh_shape):
    """``shard_params`` of the reduced qwen3 (f32, the CPU generator's
    seed 0) on a CUDA mesh: each leaf's local shard against DTensor's
    chunk of the whole leaf, and its device; rank 0 returns the largest
    difference and the devices seen."""
    import dataclasses as dc
    from repro_torch.configs import get_reduced
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizers import tree_leaves
    from torch.distributed.tensor import distribute_tensor
    cfg = dc.replace(get_reduced("qwen3-1.7b"), dtype="float32")
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_device_mesh(mesh_shape, ("data", "model"), "cuda")
    placed = shd.shard_params(params, mesh, cfg)
    err, devices = 0.0, set()
    for got, whole in zip(tree_leaves(placed), tree_leaves(params)):
        want = distribute_tensor(whole, mesh, got.placements,
                                 src_data_rank=None).to_local()
        err = max(err, float((got.to_local().cpu() - want.cpu())
                             .abs().max()) if want.numel() else 0.0)
        devices.add(str(got.to_local().device))
    return (err, sorted(devices)) if rank == 0 else None
