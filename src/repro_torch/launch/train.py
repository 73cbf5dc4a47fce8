"""Training entry point of the port.

``python -m repro_torch.launch.train gnn ...`` — CaPGNN full-batch GNN
training (the paper's workload): partitions, RAPA balance, JACA plan,
staleness schedule and exact byte accounting, in the single-process
stacked runtime (:mod:`repro_torch.dist.capgnn_sim`), with the features on
the device or, with ``--features host``, in the host store (JACA's CPU
tier: the host fetch rides a prefetch ring, the global buffers live on
the host).  ``--cache-policy`` other than ``static`` re-plans the cache
tiers online (:class:`repro_torch.core.jaca.AdaptivePlanner`).  It prints
one JSON object with the keys of the JAX package's ``repro.launch.train
gnn``.

It runs on ``--device cuda`` (the default) or ``--device cpu``.  With
``--backend ell`` or ``hybrid`` on the card, every layer's aggregation is
the hand-written ELL-SpMM kernel, and its backward the ``d_h`` kernel.
f32 matrix products run in full f32: TF32 is off.  ``compile_s`` is the
first step's wall time; on the card it holds the first-use ``nvcc`` builds
of the kernels and the CUDA context's first work.

Robustness and observability, as the JAX package's CLI:

- ``--faults SPEC`` arms seeded fault injection
  (:class:`repro_torch.faults.FaultPlan`); ``--guard-every``,
  ``--fetch-retries`` and ``--checksums`` configure the defenses (any of
  them builds the guard, also with no fault injected); the JSON gains
  ``faults``, ``faults_injected`` and ``fault_events``;
- ``--trace`` records per-step spans and counters
  (:class:`repro_torch.obs.Tracer`), written as ``trace_train.json`` (a
  Chrome trace, ``python -m repro_torch.obs.check`` validates it) and
  ``metrics_train.jsonl`` under ``--trace-dir``; the JSON gains
  ``phase_stats``, ``trace_file`` and ``metrics_file``;
- ``--device-trace-dir`` captures a ``torch.profiler`` trace of the run
  (the kernels by name under the step code's ranges) into that directory;
- ``--ckpt-dir`` saves the parameters and the optimizer state after the
  run (the JAX package's checkpoint format); ``--resume`` restores the
  latest valid checkpoint there and trains the remaining epochs up to
  ``--epochs`` (the total across runs).

``--strategy spmm_15d --replication c`` is the 1.5D replicated-row
strategy (:mod:`repro_torch.dist.strategy_15d`): ``--parts`` is then the
device count ``P`` (``P % c**2 == 0``), the graph is partitioned into
``P / c`` block rows, and ``P`` ranks start through
:func:`repro_torch.launch.mesh.spawn` — gloo ranks on the CPU with
``--device cpu``; on the card, NCCL with one card per rank when ``P``
cards are visible, else gloo ranks sharing the cards.  The launching
process prints rank 0's report (the JAX package's keys); rank 0 saves the
checkpoint and every rank resumes from it.  A halo-only flag (host
features, the cache policies, faults, a backend other than ``edges``)
exits with the strategy's message.

``python -m repro_torch.launch.train lm --arch <id> ...`` — token-LM
training of the architecture-zoo configs (``--reduced``, the default, or
``--full``, the published widths) with the port's ``adamw`` on the
synthetic token stream, the JAX package's ``repro.launch.train lm``:
``--ckpt-dir`` saves ``{"params", "opt_state"}`` after the run and
``--resume`` restores the latest valid checkpoint there (the data stream
skips the batches already trained on) and runs the remaining steps up to
``--steps``; checkpoints cross between the two packages.  The loop is
:func:`train_lm`, which takes any ``ModelConfig``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .serve import resolve_device, set_fp32_numerics


def prepare_train(args) -> dict:
    """The host pipeline of ``run_gnn``: task, profile-weighted partition,
    RAPA, JACA capacity and cache plan, exchange plan and stacked layout.
    Returns them with their spec and the seconds the pipeline took
    (``host_plan_s``).  With ``--cache-policy`` other than ``static`` the
    :class:`~repro_torch.core.jaca.AdaptivePlanner` (``planner``) owns the
    initial plan and the slot-stable padding, so the runtime's installed
    plan and the planner's accounting cannot drift apart.

    Under ``--strategy spmm_15d`` the partition has ``P / c`` block rows
    and the dict holds the 1.5D ``layout`` instead of a plan and a
    stacking."""
    from ..core import (PROFILES, PAPER_GROUPS, make_group, do_partition,
                        RapaConfig, capability_weights)
    from ..data import make_task
    from ..dist import stack_partitions
    from ..dist.spec import TrainSpec
    from ..dist.strategy import StrategyCapabilityError, get_strategy
    from ..graph import metis_partition, random_partition, build_partition
    from ..models.gnn import GNNConfig

    t0 = time.perf_counter()
    p = args.parts
    try:
        spec = TrainSpec.from_cli_args(args)
    except ValueError as e:       # includes StrategyCapabilityError
        raise SystemExit(str(e))
    is_15d = spec.strategy == "spmm_15d"
    c = spec.replication
    if is_15d and p % (c * c):
        raise SystemExit(
            f"spmm_15d needs --parts divisible by replication**2 "
            f"(P % c**2 == 0): got --parts={p} --replication={c}")
    # under spmm_15d --parts is the total device count P; the graph is
    # partitioned into the pr = P / c block rows
    n_parts = p // c if is_15d else p
    task = make_task(args.dataset, scale=args.scale, feat_dim=args.feat_dim,
                     seed=args.seed)
    g = task.graph

    group = args.group
    if group == "auto":
        group = f"x{n_parts}" if f"x{n_parts}" in PAPER_GROUPS else "uniform"
    profiles = ([PROFILES["rtx3090"]] * n_parts if group == "uniform"
                else make_group(PAPER_GROUPS[group]))
    if len(profiles) != n_parts:
        raise SystemExit(f"device group {group!r} has {len(profiles)} "
                         f"devices but the run needs {n_parts} partitions")
    weights = capability_weights(profiles) if args.uneven else None
    part_fn = {"metis": metis_partition,
               "random": random_partition}[args.partitioner]
    assign = part_fn(g, n_parts, seed=args.seed, weights=weights)
    ps = build_partition(g, assign, hops=1, parts=n_parts)
    if args.rapa:
        ps = do_partition(ps, profiles,
                          RapaConfig(feat_dim=args.feat_dim)).partition_set

    cfg = GNNConfig(model=args.model, in_dim=task.features.shape[1],
                    hidden_dim=args.hidden, out_dim=task.num_classes,
                    num_layers=args.layers)
    if is_15d:
        from ..dist.strategy_15d import check_model
        try:
            check_model(cfg)
            layout = get_strategy("spmm_15d").build_layout(ps, task, spec)
        except StrategyCapabilityError as e:
            raise SystemExit(str(e))
        return {"task": task, "ps": ps, "profiles": profiles,
                "group": group, "cfg": cfg, "spec": spec, "layout": layout,
                "host_plan_s": time.perf_counter() - t0}
    planner, xplan = plan_exchange(args, ps, profiles, cfg)
    sp = stack_partitions(ps, task, backend=args.backend)
    return {"task": task, "ps": ps, "profiles": profiles, "group": group,
            "cfg": cfg, "spec": spec, "planner": planner,
            "xplan": xplan, "sp": sp,
            "host_plan_s": time.perf_counter() - t0}


def plan_exchange(args, ps, profiles, cfg) -> tuple:
    """JACA's capacity for ``ps`` (none with ``--no-jaca``: every halo
    row is then uncached, pulled fresh every step) and its cache plan
    compiled to the exchange plan: ``(planner, xplan)``, ``planner`` the
    :class:`~repro_torch.core.jaca.AdaptivePlanner` that owns the plan
    under a ``--cache-policy`` other than ``static``, else None."""
    from ..core import (AdaptivePlanner, CacheCapacity, build_cache_plan,
                        cal_capacity)
    from ..dist import build_exchange_plan

    if args.jaca:
        cap = cal_capacity(ps, cfg.feat_dims, profiles,
                           m_cpu_gib=args.cpu_cache_gib)
    else:
        cap = CacheCapacity(c_gpu=[0] * ps.num_parts, c_cpu=0)
    if args.cache_policy != "static":
        planner = AdaptivePlanner(ps, cap, refresh_every=args.refresh_every,
                                  policy=args.cache_policy, seed=args.seed)
        return planner, planner.exchange_plan()
    plan = build_cache_plan(ps, cap, refresh_every=args.refresh_every)
    return None, build_exchange_plan(ps, plan)


def fault_options(args) -> tuple:
    """``(faults, guard)`` of the flags: a ``--faults`` spec enables the
    seeded injectors; any of the defense knobs builds a
    :class:`~repro_torch.faults.GuardConfig` even without injected
    faults (a defense-only run)."""
    from ..faults import FaultPlan, GuardConfig
    faults = guard = None
    if args.faults:
        faults = FaultPlan.parse(args.faults, seed=args.seed)
    if (faults is not None or args.guard_every or args.checksums
            or args.fetch_retries is not None):
        guard = GuardConfig(
            guard_every=args.guard_every,
            fetch_retries=(2 if args.fetch_retries is None
                           else args.fetch_retries),
            checksums=args.checksums)
    return faults, guard


def resume_state(args, cfg, opt, device) -> tuple:
    """``(start_epoch, params0, opt_state0)``: with ``--resume``, the
    latest valid checkpoint in ``--ckpt-dir`` (a corrupt or partial one
    is skipped), else a fresh start."""
    from ..checkpoint import latest_step, load_checkpoint
    from ..models.gnn import init_gnn
    if not (args.resume and args.ckpt_dir):
        return 0, None, None
    step = latest_step(args.ckpt_dir)
    if step is None:
        return 0, None, None
    like = init_gnn(cfg, torch.Generator().manual_seed(args.seed), device)
    state = load_checkpoint(args.ckpt_dir, step,
                            {"params": like, "opt_state": opt.init(like)})
    return step, state["params"], state["opt_state"]


def train_gnn(args, ctx: dict | None = None):
    """Run the ``gnn`` training slice: ``(out, ctx)`` with ``out`` the
    JSON report and ``ctx`` :func:`prepare_train`'s dict plus the runtime,
    the final parameters, the :class:`TrainReport` and the tracer (None
    without ``--trace``).  A ``ctx`` given is :func:`prepare_train`'s dict
    for these ``args`` (a caller that already ran the host pipeline); it
    is built when None.  With ``--trace`` the trace files are written,
    with ``--ckpt-dir`` the checkpoint."""
    from ..checkpoint import save_checkpoint
    from ..core import StalenessController
    from ..dist.capgnn_sim import make_sim_runtime, train_capgnn
    from ..obs import Tracer, device_trace
    from ..optim import adam

    device = resolve_device(args.device)
    set_fp32_numerics()
    ctx = prepare_train(args) if ctx is None else dict(ctx)
    if "layout" in ctx:
        return train_gnn_15d(args, ctx, device)
    cfg, spec, xplan, ps = ctx["cfg"], ctx["spec"], ctx["xplan"], ctx["ps"]
    opt = adam(args.lr)
    runtime = make_sim_runtime(cfg, ctx["sp"], xplan, opt, spec=spec,
                               device=device)
    ctl = StalenessController(refresh_every=args.refresh_every,
                              adaptive=args.adaptive_staleness,
                              replan_every=args.replan_every)
    # --epochs is the total budget across runs
    start_epoch, params0, opt_state0 = resume_state(args, cfg, opt, device)
    run_epochs = max(0, args.epochs - start_epoch)
    faults, guard = fault_options(args)
    tracer = Tracer() if args.trace else None
    with device_trace(args.device_trace_dir, device) as device_trace_file:
        params, report = train_capgnn(cfg, runtime, xplan, args.parts, opt,
                                      epochs=run_epochs, controller=ctl,
                                      params0=params0, opt_state0=opt_state0,
                                      planner=ctx.get("planner"),
                                      tracer=tracer, faults=faults,
                                      guard=guard, spec=spec)
    _, test_acc = runtime.evaluate(params, "test")
    out = {
        "dataset": args.dataset, "model": args.model, "parts": args.parts,
        "strategy": spec.strategy, "replication": spec.replication,
        "group": ctx["group"], "uneven": bool(args.uneven),
        "inner_sizes": [pt.n_inner for pt in ps.parts],
        "stack_waste_frac": runtime.padding_stats().get("waste_frac"),
        "epochs": args.epochs, "resumed_from": start_epoch,
        "final_loss": report.losses[-1] if report.losses else None,
        "halo_dtype": spec.halo_dtype,
        "features": spec.features, "prefetch_depth": spec.prefetch_depth,
        "host_fetch_rows": report.host_fetch_rows,
        "host_fetch_bytes": report.host_fetch_bytes,
        "host_writeback_bytes": report.host_writeback_bytes,
        "cache_policy": spec.cache_policy,
        "replan_events": report.replan_events,
        "planner_hit_rate": report.hit_rate,
        "test_acc": test_acc, "comm_bytes": report.comm_bytes,
        "comm_reduction_vs_vanilla": report.comm_reduction,
        "refresh_steps": report.refresh_steps,
        "cached_steps": report.cached_steps,
        # compile_s is the fenced step-0 time; wall_time_s is steady state
        "compile_s": round(report.compile_s, 3),
        "wall_time_s": round(report.wall_time_s, 2),
    }
    if report.fault_events is not None:
        out["faults"] = faults.spec_string() if faults is not None else ""
        out["faults_injected"] = report.faults_injected
        out["fault_events"] = report.fault_events
    if tracer is not None:
        paths = tracer.export(args.trace_dir, prefix="train")
        out["phase_stats"] = report.phase_stats
        out["trace_file"] = paths["trace"]
        out["metrics_file"] = paths["metrics"]
    if device_trace_file is not None:
        out["device_trace_file"] = device_trace_file
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, start_epoch + run_epochs,
                        {"params": params,
                         "opt_state": report.final_opt_state})
    ctx.update(runtime=runtime, params=params, report=report, tracer=tracer)
    return out, ctx


def train_15d_rank(rank: int, world_size: int, device, jobs: list) -> list:
    """One rank of ``--strategy spmm_15d``: for each job (``args``,
    ``layout``, ``cfg``, ``spec``, as :func:`prepare_train` gives them)
    the 1.5D runtime on this rank, ``--resume``'s checkpoint, the
    training loop and the test evaluation; rank 0 saves ``--ckpt-dir``'s
    checkpoint.  Returns per job the report (``out``, the JAX package's
    keys) and this rank's measurements: losses, each step's host seconds,
    counted forward bytes and host-staging seconds, and the peak device
    memory.  The meshes are built once per shape."""
    from ..checkpoint import save_checkpoint
    from ..dist.strategy import get_strategy
    from ..dist.strategy_15d import counted_forward_bytes, make_spmm15d_mesh
    from ..obs import device_peak_bytes
    from ..optim import adam

    set_fp32_numerics()
    strat = get_strategy("spmm_15d")
    meshes: dict = {}
    results = []
    for job in jobs:
        args, layout, cfg, spec = (job["args"], job["layout"], job["cfg"],
                                   job["spec"])
        shape = (layout.c, layout.g)
        if shape not in meshes:
            meshes[shape] = make_spmm15d_mesh(*shape)
        opt = adam(args.lr)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        runtime = strat.make_spmd_runtime(cfg, layout, opt, spec,
                                          mesh=meshes[shape], device=device)
        start_epoch, params0, opt_state0 = resume_state(args, cfg, opt,
                                                        device)
        run_epochs = max(0, args.epochs - start_epoch)
        params, report = strat.train(cfg, runtime, layout, opt, spec,
                                     epochs=run_epochs, seed=args.seed,
                                     params0=params0, opt_state0=opt_state0)
        _, test_acc = runtime.evaluate(params, "test")
        out = {
            "dataset": args.dataset, "model": args.model, "parts": args.parts,
            "strategy": spec.strategy, "replication": spec.replication,
            "block_rows": layout.pr, "group_size": layout.g,
            "group": job["group"], "uneven": bool(args.uneven),
            "inner_sizes": job["inner_sizes"],
            "epochs": args.epochs, "resumed_from": start_epoch,
            "final_loss": report.losses[-1] if report.losses else None,
            "halo_dtype": spec.halo_dtype,
            "test_acc": test_acc, "comm_bytes": report.comm_bytes,
            # vanilla = dense 1D full-H all-gather on the same block rows,
            # so the reduction isolates the replication benefit
            "comm_reduction_vs_vanilla": report.comm_reduction,
            "fwd_collective_bytes_per_device":
                runtime.forward_bytes_per_device,
            "refresh_steps": report.refresh_steps,
            "cached_steps": report.cached_steps,
            "compile_s": round(report.compile_s, 3),
            "wall_time_s": round(report.wall_time_s, 2),
        }
        if args.ckpt_dir and rank == 0:
            save_checkpoint(args.ckpt_dir, start_epoch + run_epochs,
                            {"params": params,
                             "opt_state": report.final_opt_state})
        peak = device_peak_bytes(device)
        results.append({
            "out": out, "rank": rank, "losses": report.losses,
            "step_s": report.step_s,
            "forward_bytes": [counted_forward_bytes(w["counts"])
                              for w in runtime.wire_log],
            "host_stage_s": [w["host_stage_s"] for w in runtime.wire_log],
            "peak_mem_gb": None if peak is None else peak / 1e9})
        del runtime, params, report
    return results


def spmm15d_backend(device: torch.device, world_size: int) -> str:
    """The process-group backend of ``world_size`` ranks on ``device``:
    gloo on the CPU; on the card NCCL when every rank has a card of its
    own, else gloo with the ranks sharing the cards."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def train_gnn_15d(args, ctx: dict, device) -> tuple:
    """The ``--strategy spmm_15d`` branch of :func:`train_gnn`: ``P``
    ranks of :func:`train_15d_rank` through ``launch.mesh.spawn``, on
    ``device``'s kind (the ranks never run on the CPU when the card was
    asked for: ``spawn`` raises without CUDA).  Returns rank 0's report
    and ``ctx`` with every rank's result (``ranks``)."""
    from .mesh import spawn
    job = {"args": args, "layout": ctx["layout"], "cfg": ctx["cfg"],
           "spec": ctx["spec"], "group": ctx["group"],
           "inner_sizes": [pt.n_inner for pt in ctx["ps"].parts]}
    p = ctx["layout"].n_devices
    ranks = spawn(train_15d_rank, p, backend=spmm15d_backend(device, p),
                  devices=device.type, args=([job],))
    ctx.update(ranks=[r[0] for r in ranks])
    return ranks[0][0]["out"], ctx


def run_gnn(args) -> dict:
    out, _ = train_gnn(args)
    print(json.dumps(out, indent=1))
    return out


def lm_config(args):
    """``train lm``'s ``ModelConfig``: the reduced or the published one."""
    from ..configs import get_config, get_reduced
    return get_reduced(args.arch) if args.reduced else get_config(args.arch)


def train_lm(cfg, args) -> tuple[dict, dict]:
    """``train lm``'s loop for any ``ModelConfig`` on ``args.device``:
    ``init_model`` of ``args.seed``, ``adamw(args.lr)``, the resume, the
    synthetic stream (VLM configs get zero patches) and ``args.steps``
    steps in all, then the checkpoint.  Returns ``(out, detail)``:
    ``out`` the CLI's JSON, ``detail`` the ``losses``, each step's
    ``step_ms`` (host clock, the step ending in its loss read) and the
    final ``params`` and ``opt_state``."""
    from ..checkpoint import latest_step, load_checkpoint, save_checkpoint
    from ..data import synthetic_token_batches
    from ..models.transformer import init_model, train_step_fn
    from ..models.transformer.blocks import torch_dtype
    from ..optim import adamw

    device = resolve_device(args.device)
    set_fp32_numerics()
    params = init_model(cfg, torch.Generator().manual_seed(args.seed),
                        device)
    opt = adamw(args.lr)
    opt_state = opt.init(params)
    start_step = 0
    if args.resume and args.ckpt_dir:
        s = latest_step(args.ckpt_dir)
        if s is not None:
            state = load_checkpoint(args.ckpt_dir, s,
                                    {"params": params,
                                     "opt_state": opt_state})
            params, opt_state = state["params"], state["opt_state"]
            start_step = s
    run_steps = max(0, args.steps - start_step)
    step = train_step_fn(cfg, opt)
    gen = synthetic_token_batches(cfg.vocab_size, args.seq_len, args.batch,
                                  seed=args.seed)
    for _ in range(start_step):   # resume the data stream where it stopped
        next(gen)
    losses, step_ms = [], []
    t0 = time.perf_counter()
    for _, host_batch in zip(range(run_steps), gen):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(host_batch[k]).to(device)
                 for k in ("tokens", "labels")}
        if cfg.vision_tokens:
            batch["patches"] = torch.zeros(
                (args.batch, cfg.vision_tokens, cfg.d_model),
                dtype=torch_dtype(cfg), device=device)
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    wall = time.perf_counter() - t0
    out = {"arch": cfg.name, "steps": args.steps,
           "resumed_from": start_step,
           "loss_first": losses[0] if losses else None,
           "loss_last": losses[-1] if losses else None,
           "tokens_per_s":
           round(run_steps * args.batch * args.seq_len / max(wall, 1e-9), 1)}
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, start_step + run_steps,
                        {"params": params, "opt_state": opt_state})
    return out, {"losses": losses, "step_ms": step_ms, "params": params,
                 "opt_state": opt_state}


def run_lm(args) -> dict:
    out, _ = train_lm(lm_config(args), args)
    print(json.dumps(out, indent=1))
    return out


def build_parser() -> argparse.ArgumentParser:
    from ..core.device_profile import PAPER_GROUPS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gnn")
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu runs "
                        "their plain versions")
    g.add_argument("--dataset", default="flickr")
    g.add_argument("--scale", type=float, default=0.02)
    g.add_argument("--feat-dim", type=int, default=64)
    g.add_argument("--model", default="gcn",
                   choices=["gcn", "sage", "gat", "gin"],
                   help="gat needs --backend edges (its edge softmax)")
    g.add_argument("--strategy", default="halo_1d",
                   choices=["halo_1d", "spmm_15d"],
                   help="halo_1d: the paper's 1D partition + halo "
                        "exchange; spmm_15d: 1.5D replicated-row block "
                        "SpMM on --parts ranks (P / c block rows)")
    g.add_argument("--replication", type=int, default=1,
                   help="1.5D row-replication factor c (spmm_15d only; "
                        "needs P %% c**2 == 0); c=1 is the dense 1D "
                        "all-gather")
    g.add_argument("--backend", default="edges",
                   choices=["edges", "ell", "hybrid"],
                   help="local aggregation backend (ell/hybrid run the "
                        "ELL-SpMM kernels on the card)")
    g.add_argument("--halo-dtype", default="f32", choices=["f32", "bf16"],
                   help="halo payload dtype on the wire: bf16 halves every "
                        "tier's exchange bytes (dequantised on scatter)")
    g.add_argument("--features", default="device",
                   choices=["device", "host"],
                   help="host: the halo feature table and the global "
                        "cache stay in host memory (JACA's CPU tier)")
    g.add_argument("--prefetch-depth", type=int, default=2)
    g.add_argument("--hidden", type=int, default=256)
    g.add_argument("--layers", type=int, default=3)
    g.add_argument("--parts", type=int, default=4)
    g.add_argument("--partitioner", default="metis",
                   choices=["metis", "random"])
    g.add_argument("--epochs", type=int, default=200)
    g.add_argument("--lr", type=float, default=0.01)
    g.add_argument("--jaca", action="store_true", default=True)
    g.add_argument("--no-jaca", dest="jaca", action="store_false")
    g.add_argument("--rapa", action="store_true", default=True)
    g.add_argument("--no-rapa", dest="rapa", action="store_false")
    g.add_argument("--uneven", action="store_true", default=True,
                   help="profile-weighted uneven partition sizes")
    g.add_argument("--even", dest="uneven", action="store_false")
    g.add_argument("--group", default="auto",
                   choices=["auto", "uniform"] + sorted(PAPER_GROUPS))
    g.add_argument("--pipeline", action="store_true", default=True)
    g.add_argument("--no-pipeline", dest="pipeline", action="store_false")
    g.add_argument("--refresh-every", type=int, default=4)
    g.add_argument("--cache-policy", default="static",
                   choices=["static", "overlap", "lru", "fifo", "drift"],
                   help="online cache adaptation policy (static: the "
                        "frozen overlap plan)")
    g.add_argument("--replan-every", type=int, default=1)
    g.add_argument("--adaptive-staleness", action="store_true")
    g.add_argument("--cpu-cache-gib", type=float, default=4.0)
    g.add_argument("--trace", action="store_true",
                   help="per-step spans + typed counters, exported as a "
                        "Perfetto-loadable Chrome trace and a JSONL "
                        "metrics stream")
    g.add_argument("--trace-dir", default="experiments",
                   help="directory for trace_train.json / "
                        "metrics_train.jsonl (with --trace)")
    g.add_argument("--device-trace-dir", default="",
                   help="torch.profiler capture directory "
                        "(device_trace.json: the kernels by name)")
    g.add_argument("--faults", default="",
                   help="fault-injection spec, e.g. "
                        "'grad_nan@3;fetch_drop@2,5' — clauses "
                        "kind@step,step[:key=val,...] joined by ';' "
                        "(kinds: fetch_drop fetch_delay halo_corrupt "
                        "grad_nan mem_pressure ckpt_truncate); seeded "
                        "by --seed, deterministic")
    g.add_argument("--guard-every", type=int, default=0,
                   help="divergence guard cadence: check parameter "
                        "finiteness and snapshot a rollback point every k "
                        "steps (0 = guard off)")
    g.add_argument("--fetch-retries", type=int, default=None,
                   help="bounded retries for failed host-store fetches "
                        "before stale-tier reuse (default 2 when any "
                        "fault/guard flag is set)")
    g.add_argument("--checksums", action="store_true",
                   help="per-tier payload checksums: verify before each "
                        "step, force a plain refresh of corrupted tiers "
                        "(reads every tier back each step)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--ckpt-dir", default="",
                   help="save (params, opt_state) here after the run")
    g.add_argument("--resume", action="store_true",
                   help="restore the latest valid checkpoint in "
                        "--ckpt-dir and train the remaining epochs up to "
                        "--epochs")
    g.set_defaults(fn=run_gnn)

    lm = sub.add_parser("lm")
    lm.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    lm.add_argument("--arch", required=True)
    lm.add_argument("--reduced", action="store_true", default=True)
    lm.add_argument("--full", dest="reduced", action="store_false")
    lm.add_argument("--steps", type=int, default=20)
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--seq-len", type=int, default=128)
    lm.add_argument("--lr", type=float, default=3e-4)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--ckpt-dir", default="")
    lm.add_argument("--resume", action="store_true",
                    help="restore (params, opt_state, step) from the "
                         "latest checkpoint in --ckpt-dir and run the "
                         "remaining steps up to --steps")
    lm.set_defaults(fn=run_lm)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
