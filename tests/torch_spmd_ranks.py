"""Rank-side programs of the port's SPMD tests, run by
``repro_torch.launch.mesh.spawn`` in worker processes (module-level, so a
spawned worker can import them by name; torch and the port only).

Each returns numpy arrays and plain numbers, which the test process holds
against the single-process runtimes.
"""
import torch

from repro_torch.dist import TrainSpec, make_spmd_runtime, train_capgnn
from repro_torch.dist.collectives import (AllGatherFn, RingBroadcastFn,
                                          RotateFn, Wire)
from repro_torch.optim import adam, sgd

SCHEDULE = ("refresh", "cached", "pipelined", "cached")


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree


def _params(params_np, device):
    return [{k: torch.as_tensor(v, device=device) for k, v in layer.items()}
            for layer in params_np]


def _switch(rt, params, opt_state, xplan, xplan2):
    """A plan switch on a runtime installed on ``xplan``: a refresh step,
    ``step_transition`` to ``xplan2`` (stale reads and the uncached
    exchange on ``xplan``, the refresh pulls on ``xplan2``), a cached step
    reading the emitted caches on ``xplan2``, then ``set_plan(xplan)`` and
    a refresh step.  Each step's loss, parameters and caches, and whether
    the plan it ran on was installed after it."""
    out = []
    state = (params, opt_state, rt.caches0)
    for kind, plan, installed in (("refresh", None, xplan),
                                  ("transition", xplan2, xplan2),
                                  ("cached", None, xplan2),
                                  ("refresh", xplan, xplan)):
        if kind == "transition":
            *state, m = rt.step_transition(*state, plan)
        else:
            if plan is not None:
                rt.set_plan(plan)
            *state, m = getattr(rt, f"step_{kind}")(*state)
        out.append({"kind": kind, "loss": float(m["loss"]),
                    "params": _np(state[0]), "caches": _np(state[2]),
                    "installed": rt.xplan is installed})
    return out


def run_spmd(rank, world_size, device, cfg, sp, xplan, spec_kw, params_np,
             epochs, switch, planner=None):
    """One configuration's every check on this rank: ``forward_fresh``;
    one ``sgd(1.0)`` refresh step; the steps of :data:`SCHEDULE` with
    ``adam`` and their wire counts; a switch between the two plans of
    ``switch`` (:func:`_switch`) with ``adam``; the loss and gradients of
    a refresh step; an ``epochs``-step ``train_capgnn`` with ``adam``,
    re-planned by ``planner`` (this rank's copy) when one is given."""
    spec = TrainSpec(**spec_kw)
    out = {"rank": rank}
    rt = make_spmd_runtime(cfg, sp, xplan, sgd(1.0), spec=spec,
                           device=device)
    params = _params(params_np, device)
    out["logits"] = _np(rt.forward_fresh(params))[0]
    p1, _, c1, m1 = rt.step_refresh(params, (), rt.caches0)
    out["sgd"] = {"loss": float(m1["loss"]), "params": _np(p1),
                  "caches": _np(c1), "wire": rt.wire_log[-1]}
    loss, grads = rt.loss_and_grads(params, rt.caches0)
    out["grads"] = {"loss": float(loss), "grads": _np(grads)}

    opt = adam(1e-2)
    rt = make_spmd_runtime(cfg, sp, xplan, opt, spec=spec, device=device)
    state = (params, opt.init(params), rt.caches0)
    steps = []
    for kind in SCHEDULE:
        *state, m = getattr(rt, f"step_{kind}")(*state)
        steps.append({"kind": kind, "loss": float(m["loss"]),
                      "acc": float(m["acc"]), "params": _np(state[0]),
                      "caches": _np(state[2]), "wire": rt.wire_log[-1],
                      "metrics": _np({k: v for k, v in m.items()
                                      if k not in ("loss", "acc")})})
    out["steps"] = steps
    # a plan switch to the installed plan is the pipelined step
    _, _, pc, pm = rt.step_pipelined(*state)
    _, _, tc, tm = rt.step_transition(*state, xplan)
    rt.set_plan(xplan)
    out["transition"] = {"pipelined": (float(pm["loss"]), _np(pc)),
                         "transition": (float(tm["loss"]), _np(tc)),
                         "plan_kept": rt.xplan is xplan}
    rt = make_spmd_runtime(cfg, sp, switch[0], opt, spec=spec,
                           device=device)
    out["switch"] = _switch(rt, params, opt.init(params), *switch)
    for step, wire in zip(out["switch"], rt.wire_log):
        step["wire"] = wire

    rt = make_spmd_runtime(cfg, sp, xplan, opt, spec=spec, device=device)
    p8, rep = train_capgnn(cfg, rt, xplan, world_size, opt, epochs=epochs,
                           params0=params, planner=planner, spec=spec)
    out["train"] = {**train_fields(rep), "params": _np(p8),
                    "test": rt.evaluate(p8, "test"), "wire": rt.wire_log}
    return out


def train_fields(rep) -> dict:
    """The fields of a :class:`~repro_torch.dist.TrainReport` the SPMD
    tests hold against the single-process runtime's."""
    return {f: getattr(rep, f) for f in (
        "losses", "comm_bytes", "comm_bytes_vanilla", "refresh_steps",
        "cached_steps", "step_kinds", "replan_events", "hit_rate",
        "host_fetch_rows", "host_fetch_bytes", "host_writeback_bytes")}


def run_collectives(rank, world_size, device, xs_np, shift, valid):
    """Each collective Function, forward and backward, on the whole group
    and on the subgroup of ranks 0 and 1, counted under the key ``(1,
    "t")`` with ``valid`` valid rows: ``xs_np[fn]["x"][r]`` is rank
    ``r``'s input and ``xs_np[fn]["g<size>"][r]`` the cotangent of its
    output (the test process made them all)."""
    import torch.distributed as dist
    out = {}
    sub = dist.new_group([0, 1])
    for name, group, size in (("all", None, world_size), ("pair", sub, 2)):
        if rank >= size:
            continue
        wire = Wire(group)
        res = {}
        for fn in ("all_gather", "rotate", "ring_broadcast"):
            x = torch.as_tensor(xs_np[fn]["x"][rank], device=device)
            x.requires_grad_(True)
            if fn == "all_gather":
                y = AllGatherFn.apply(x, wire, (1, "t"), valid)
            elif fn == "rotate":
                y = RotateFn.apply(x, wire, shift, wire.new_tag(1), (1, "t"),
                                   valid)
            else:
                y = RingBroadcastFn.apply(x, wire, wire.new_tag(size),
                                          (1, "t"), valid)
            g = torch.as_tensor(xs_np[fn][f"g{size}"][rank], device=device)
            (dx,) = torch.autograd.grad(y, x, g)
            res[fn] = {"y": _np(y), "dx": _np(dx)}
        res["counts"] = wire.take()["counts"]
        out[name] = res
    return out


def run_refresh(rank, world_size, device, cfg, sp, xplan, spec_kw,
                params_np):
    """One refresh step on this rank: its wire counts and host staging
    seconds, then the summed loss and gradients of the same step."""
    rt = make_spmd_runtime(cfg, sp, xplan, sgd(1.0),
                           spec=TrainSpec(**spec_kw), device=device)
    params = _params(params_np, device)
    rt.step_refresh(params, (), rt.caches0)
    loss, grads = rt.loss_and_grads(params, rt.caches0)
    return {"loss": float(loss), "grads": _np(grads),
            "wire": rt.wire_log[-1]}


MODEL_EPOCHS = 4      # refresh, cached, pipelined, cached at refresh_every=2


def run_models(rank, world_size, device, cases):
    """Each of ``cases`` (name, cfg, stacked layout, plan, spec kwargs,
    numpy parameters, mesh shape or None) on this rank: one refresh
    step's loss and gradients, then a :data:`MODEL_EPOCHS`-step
    ``train_capgnn`` with ``sgd(0.5)``: its losses, parameters, report
    counts and every step's wire counts.  A case with a mesh shape runs
    over ``make_mesh(shape, ("pod", "data"))`` on the axis tuple, and its
    rank also sums the ranks along ``"data"`` alone (``data_axis_sum``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for name, cfg, sp, xplan, spec_kw, params_np, mesh_shape in cases:
        spec = TrainSpec(**spec_kw)
        group, axis, res = None, "data", {}
        if mesh_shape is not None:
            group, axis = make_mesh(mesh_shape, ("pod", "data")), \
                ("pod", "data")
            t = torch.tensor([float(rank)])
            dist.all_reduce(t, group=group.group("data"))
            res["data_axis_sum"] = float(t)
        opt = sgd(0.5)
        rt = make_spmd_runtime(cfg, sp, xplan, opt, group, axis, spec=spec,
                               device=device)
        params = _params(params_np, device)
        loss, grads = rt.loss_and_grads(params, rt.caches0)
        p, rep = train_capgnn(cfg, rt, xplan, world_size, opt,
                              epochs=MODEL_EPOCHS, params0=params, spec=spec)
        res.update(loss=float(loss), grads=_np(grads),
                   train=train_fields(rep), params=_np(p),
                   wire=[w["counts"] for w in rt.wire_log])
        out[name] = res
    return out


def run_spmd_cases(rank, world_size, device, cases):
    """:func:`run_spmd` for each of ``cases`` (name -> its arguments after
    ``device``) on this rank, in one group: one spawn for every
    configuration."""
    return {name: run_spmd(rank, world_size, device, *args)
            for name, args in cases.items()}


def run_faults(rank, world_size, device, cfg, sp, xplan, cases, params_np,
               epochs):
    """Each of ``cases`` (name -> (spec kwargs, fault spec, guard kwargs))
    on this rank: an ``epochs``-step ``train_capgnn`` with ``adam`` under
    this rank's own fault plan (seed 0), guard and tracer; its losses,
    report counts, fault and defense counts, and the tracer's per-step
    records and totals."""
    import dataclasses

    from repro_torch.faults import FaultPlan, GuardConfig
    from repro_torch.obs import Tracer
    out = {}
    for name, (spec_kw, fault_spec, guard_kw) in cases.items():
        spec = TrainSpec(**spec_kw)
        opt = adam(1e-2)
        rt = make_spmd_runtime(cfg, sp, xplan, opt, spec=spec, device=device)
        tr = Tracer()
        _, rep = train_capgnn(cfg, rt, xplan, world_size, opt, epochs=epochs,
                              params0=_params(params_np, device), tracer=tr,
                              faults=FaultPlan.parse(fault_spec, seed=0),
                              guard=GuardConfig(**guard_kw), spec=spec)
        out[name] = {**train_fields(rep),
                     "faults_injected": rep.faults_injected,
                     "fault_events": rep.fault_events,
                     "counters": [dataclasses.asdict(c) for c in tr.counters],
                     "totals": tr.totals(),
                     "wire": [w["counts"] for w in rt.wire_log]}
    return out
