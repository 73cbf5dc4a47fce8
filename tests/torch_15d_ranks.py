"""Rank-side program of the port's 1.5D strategy tests, run by
``repro_torch.launch.mesh.spawn`` in worker processes (module-level, so a
spawned worker can import it by name; torch and the port only).

It returns numpy arrays and plain numbers, which the test process holds
against JAX ``capgnn_sim``.
"""
import torch

from repro_torch.convert import params_from_reference
from repro_torch.dist import TrainSpec
from repro_torch.dist.strategy_15d import (counted_forward_bytes,
                                           make_spmm15d_mesh,
                                           make_spmm15d_runtime,
                                           train_spmm15d)
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam, sgd

EPOCHS = 6


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree


def run_15d(rank, world_size, device, layout, cfg_kw, spec_kw, params_np,
            meshes):
    """One configuration on this rank, from the JAX package's parameters
    (``params_np``, through ``repro_torch.convert``): ``forward_fresh``'s
    logits; one ``sgd(1.0)`` step (its new parameters: the parameter
    delta is the gradient) and that step's counts; an ``EPOCHS``-step
    ``train_spmm15d`` with ``adam(1e-2)``, its losses, accuracy and every
    step's counted forward bytes."""
    cfg, spec = GNNConfig(**cfg_kw), TrainSpec(**spec_kw)
    shape = (layout.c, layout.g)
    if shape not in meshes:
        meshes[shape] = make_spmm15d_mesh(*shape)
    mesh = meshes[shape]
    params = params_from_reference(params_np, device)
    rt = make_spmm15d_runtime(cfg, layout, sgd(1.0), spec, mesh=mesh,
                              device=device)
    out = {"rank": rank, "logits": _np(rt.forward_fresh(params))}
    p1, _, m1 = rt.step(params, ())
    out["sgd"] = {"loss": float(m1["loss"]), "acc": float(m1["acc"]),
                  "params": _np(p1), "counts": rt.wire_log[-1]["counts"]}
    opt = adam(1e-2)
    rt = make_spmm15d_runtime(cfg, layout, opt, spec, mesh=mesh,
                              device=device)
    p6, rep = train_spmm15d(cfg, rt, opt, spec, EPOCHS, params0=params)
    out["train"] = {"losses": rep.losses, "comm_bytes": rep.comm_bytes,
                    "comm_bytes_vanilla": rep.comm_bytes_vanilla,
                    "refresh_steps": rep.refresh_steps,
                    "cached_steps": rep.cached_steps,
                    "params": _np(p6), "test": rt.evaluate(p6, "test"),
                    "forward_bytes": [counted_forward_bytes(w["counts"])
                                      for w in rt.wire_log],
                    "model_bytes": rt.forward_bytes_per_device}
    return out


def run_15d_cases(rank, world_size, device, cases):
    """Every configuration of ``cases`` (id -> :func:`run_15d`'s
    arguments after the device), one after another in one group; the
    meshes are built once per shape."""
    meshes: dict = {}
    return {cid: run_15d(rank, world_size, device, *args, meshes)
            for cid, args in cases.items()}
