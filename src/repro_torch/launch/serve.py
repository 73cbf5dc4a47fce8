"""Serving entry point of the port.

``python -m repro_torch.launch.serve gnn ...`` — partitioned GNN query
serving: precompute per-layer embeddings through the CaPGNN exchange
machinery, stand up the two-tier cache engine, and drive a synthetic query
stream through the micro-batcher; prints QPS, latency percentiles and
per-tier hit rates as one JSON object (the fields of the JAX package's
``repro.launch.serve gnn``).

It runs on ``--device cuda`` (the default) or ``--device cpu``.  With
``--backend ell`` or ``hybrid`` on the card, every layer's aggregation is
the hand-written ELL-SpMM kernel, and hot-tier queries go through the
row-gather kernel.  f32 matrix products run in full f32: TF32 is off.

As the JAX package's CLI: ``--ckpt-dir`` loads the parameters that
``launch.train gnn --ckpt-dir`` saved (the latest valid checkpoint);
``--store-dir`` saves the precomputed embedding store there, and
``--load-store`` loads it instead of precomputing (the model config and
backend then come from the store); ``--trace`` records one
``serve_batch`` span and one counter record a micro-batch, written as
``trace_serve.json`` / ``metrics_serve.jsonl`` under ``--trace-dir``
(the JSON gains ``trace_file`` and ``metrics_file``).

``python -m repro_torch.launch.serve lm ...`` — batched greedy transformer
decode against the KV / SSM cache (the architecture-zoo serve path), the
JAX package's ``repro.launch.serve lm``: the reduced config of ``--arch``,
``--batch`` sequences, ``--steps`` one-token steps against a
``--cache-len`` cache, printing ``tokens_per_s`` and ``logits_finite``.
The loop is :func:`decode_lm`, which takes any ``ModelConfig``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request on a machine
    without CUDA raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_fp32_numerics() -> None:
    """Full-f32 matrix products and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def prepare_gnn(args, cfg=None):
    """The slice's task, partition set, device profiles and model config
    (``cfg``, when given: a loaded store's): ``(task, ps, profiles,
    cfg)``, the same for the same ``args.seed``."""
    from ..core import PROFILES, PAPER_GROUPS, make_group
    from ..data import make_task
    from ..graph import metis_partition, random_partition, build_partition
    from ..models.gnn import GNNConfig

    task = make_task(args.dataset, scale=args.scale, feat_dim=args.feat_dim,
                     seed=args.seed)
    g = task.graph
    p = args.parts
    part_fn = {"metis": metis_partition,
               "random": random_partition}[args.partitioner]
    ps = build_partition(g, part_fn(g, p, seed=args.seed), hops=1)
    profiles = make_group(PAPER_GROUPS[f"x{p}"]) if f"x{p}" in PAPER_GROUPS \
        else [PROFILES["rtx3090"]] * p
    if cfg is None:
        cfg = GNNConfig(model=args.model, in_dim=task.features.shape[1],
                        hidden_dim=args.hidden, out_dim=task.num_classes,
                        num_layers=args.layers)
    return task, ps, profiles, cfg


def plan_and_stack(args, task, ps, profiles, cfg):
    """JACA capacity and cache plan compiled to the exchange plan, and the
    stacked ``[P, ...]`` layout with ``args.backend``'s pack:
    ``(xplan, sp)``."""
    from ..core import cal_capacity, build_cache_plan
    from ..dist import build_exchange_plan, stack_partitions

    cap = cal_capacity(ps, cfg.feat_dims, profiles,
                       m_cpu_gib=args.cpu_cache_gib)
    plan = build_cache_plan(ps, cap, refresh_every=args.refresh_every)
    xplan = build_exchange_plan(ps, plan)
    sp = stack_partitions(ps, task, backend=args.backend)
    return xplan, sp


def slice_stream(args, g):
    """The query stream ``args`` asks for over graph ``g``."""
    from ..serve import make_stream, rank_hot_nodes

    if args.popularity == "degree":
        # popularity rank == hot-tier degree rank: the zipf head hits HBM
        rank_to_node = rank_hot_nodes(g, g.num_nodes, policy="degree")
    else:
        rank_to_node = None
    return make_stream(args.workload, g.num_nodes, args.queries,
                       qps=args.qps, alpha=args.alpha, seed=args.seed,
                       rank_to_node=rank_to_node)


def serve_gnn(args):
    """Run the ``gnn`` serving slice; returns ``(report, engine)``."""
    from ..checkpoint import latest_step, load_checkpoint
    from ..models.gnn import init_gnn
    from ..obs import Tracer
    from ..optim import adam
    from ..serve import (BatchConfig, GNNServeEngine, load_store,
                         precompute_embeddings, rank_hot_nodes, save_store,
                         serve_stream)

    device = resolve_device(args.device)
    set_fp32_numerics()

    # a loaded store fixes the model config and backend (it was
    # precomputed with them); otherwise they come from the flags
    store = None
    if args.load_store:
        if not args.store_dir:
            raise SystemExit("--load-store requires --store-dir")
        store = load_store(args.store_dir)
    task, ps, profiles, cfg = prepare_gnn(
        args, store.cfg if store is not None else None)
    g = task.graph
    p = args.parts
    backend = store.backend if store is not None else args.backend
    if store is not None and store.num_nodes != g.num_nodes:
        raise SystemExit(
            f"store in {args.store_dir} was precomputed over "
            f"{store.num_nodes} nodes but this task has {g.num_nodes}; "
            "re-run precompute (drop --load-store)")
    params = init_gnn(cfg, torch.Generator().manual_seed(args.seed), device)
    if args.ckpt_dir:
        # weights trained by `repro_torch.launch.train gnn --ckpt-dir ...`
        step = latest_step(args.ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
        like = {"params": params, "opt_state": adam(1e-2).init(params)}
        params = load_checkpoint(args.ckpt_dir, step, like)["params"]

    t0 = time.perf_counter()
    if store is None:
        xplan, sp = plan_and_stack(args, task, ps, profiles, cfg)
        store = precompute_embeddings(cfg, ps, sp, xplan, params,
                                      backend=backend, device=device)
        if args.store_dir:
            save_store(args.store_dir, store)
    precompute_s = time.perf_counter() - t0

    hot_capacity = int(round(args.hot_frac * g.num_nodes))
    hot = rank_hot_nodes(g, hot_capacity, ps=ps, policy=args.hot_rank)
    engine = GNNServeEngine(store, params, g, hot, features=task.features,
                            fresh_hops=args.fresh_hops, device=device)

    rng = np.random.default_rng(args.seed)
    if args.update_frac > 0:
        upd = rng.choice(g.num_nodes,
                         max(1, int(args.update_frac * g.num_nodes)),
                         replace=False)
        engine.update_features(
            upd, task.features[upd]
            + rng.normal(scale=0.5, size=(upd.size,
                                          task.features.shape[1])))

    tracer = Tracer() if args.trace else None
    report = serve_stream(engine, slice_stream(args, g),
                          BatchConfig(max_batch=args.max_batch,
                                      deadline_ms=args.deadline_ms),
                          tracer=tracer)
    out = {
        "dataset": args.dataset, "model": cfg.model,
        "backend": backend, "parts": p,
        "nodes": g.num_nodes, "layers": cfg.num_layers,
        "hot_capacity": hot_capacity, "hot_rank": args.hot_rank,
        "stale_nodes": int(engine.stale.sum()),
        "precompute_s": round(precompute_s, 3),
        **{k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in report.items()},
    }
    if tracer is not None:
        paths = tracer.export(args.trace_dir, prefix="serve")
        out["trace_file"] = paths["trace"]
        out["metrics_file"] = paths["metrics"]
    return out, engine


def run_gnn(args) -> dict:
    out, _ = serve_gnn(args)
    print(json.dumps(out, indent=1))
    return out


def decode_lm(cfg, params, args) -> tuple[dict, dict]:
    """``serve lm``'s loop for any ``ModelConfig``: ``args.batch`` random
    first tokens (numpy, ``args.seed``), one warm-up step at position 0,
    then ``args.steps - 1`` greedy steps (ids past ``vocab_size``, the
    padded vocabulary's rows, fold to 0), under ``inference_mode``.
    Returns ``(out, detail)``: ``out`` the CLI's JSON, ``detail`` the
    token fed at each step (``tokens`` [steps, batch]) and the ms of each
    timed step (``step_ms``)."""
    from ..models.transformer import init_decode_cache, serve_step

    device = params["embed"].device
    caches = init_decode_cache(cfg, args.batch, args.cache_len, device)
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (args.batch, 1))).to(
        device=device, dtype=torch.int32)
    fed = [tokens]
    # each step's end: a CUDA event on the card (read after the loop's
    # one synchronize), the host clock on the CPU
    cuda = device.type == "cuda"
    marks: list = []

    def mark():
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    with torch.inference_mode():
        # warm up, then sync before starting the clock
        logits, caches = serve_step(cfg, params, caches, tokens, 0)
        synchronize(device)
        t0 = time.perf_counter()
        mark()
        for i in range(1, args.steps):
            nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
            nxt = torch.where(nxt >= cfg.vocab_size, 0, nxt)
            fed.append(nxt)
            logits, caches = serve_step(cfg, params, caches, nxt, i)
            mark()
        synchronize(device)
        wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3
               for a, b in zip(marks, marks[1:])]
    out = {
        "arch": cfg.name, "batch": args.batch, "steps": args.steps,
        "tokens_per_s": round(args.batch * (args.steps - 1)
                              / max(wall, 1e-9), 1),
        "logits_finite": bool(torch.isfinite(logits).all()),
    }
    return out, {"tokens": torch.cat(fed, 1).T.cpu().numpy(),
                 "step_ms": step_ms}


def run_lm(args) -> dict:
    from ..configs import get_reduced
    from ..models.transformer import init_model

    device = resolve_device(args.device)
    set_fp32_numerics()
    cfg = get_reduced(args.arch)
    params = init_model(cfg, torch.Generator().manual_seed(args.seed),
                        device)
    out, _ = decode_lm(cfg, params, args)
    print(json.dumps(out, indent=1))
    return out



def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
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
    g.add_argument("--backend", default="edges",
                   choices=["edges", "ell", "hybrid"],
                   help="aggregation backend for the precompute pass "
                        "(ell/hybrid run the ELL-SpMM kernel on the card)")
    g.add_argument("--hidden", type=int, default=64)
    g.add_argument("--layers", type=int, default=3)
    g.add_argument("--parts", type=int, default=4)
    g.add_argument("--partitioner", default="metis",
                   choices=["metis", "random"])
    g.add_argument("--refresh-every", type=int, default=4)
    g.add_argument("--cpu-cache-gib", type=float, default=4.0)
    g.add_argument("--ckpt-dir", default="",
                   help="load trained params from "
                        "repro_torch.launch.train gnn --ckpt-dir")
    g.add_argument("--store-dir", default="",
                   help="persist the precomputed embedding store here")
    g.add_argument("--load-store", action="store_true",
                   help="skip precompute; load the store from --store-dir")
    g.add_argument("--hot-frac", type=float, default=0.1,
                   help="fraction of nodes resident in the device hot tier")
    g.add_argument("--hot-rank", default="degree",
                   choices=["degree", "overlap"])
    g.add_argument("--workload", default="zipf",
                   choices=["uniform", "zipf", "bursty"])
    g.add_argument("--queries", type=int, default=2048)
    g.add_argument("--qps", type=float, default=500.0,
                   help="mean simulated arrival rate (keep below the "
                        "engine's service QPS to measure latency rather "
                        "than queue backlog)")
    g.add_argument("--alpha", type=float, default=1.1,
                   help="zipf popularity exponent")
    g.add_argument("--popularity", default="degree",
                   choices=["degree", "random"],
                   help="map popularity ranks to node ids by degree "
                        "(aligned with the hot tier) or a random permutation")
    g.add_argument("--max-batch", type=int, default=64)
    g.add_argument("--deadline-ms", type=float, default=2.0)
    g.add_argument("--update-frac", type=float, default=0.0,
                   help="perturb this fraction of node features before "
                        "serving (exercises the fresh=k recompute path)")
    g.add_argument("--fresh-hops", type=int, default=None,
                   help="k for the fresh recompute (default: num layers, "
                        "which is exact)")
    g.add_argument("--trace", action="store_true",
                   help="per-batch spans + hit/miss counters, exported as "
                        "a Perfetto-loadable Chrome trace")
    g.add_argument("--trace-dir", default="experiments",
                   help="directory for trace_serve.json / "
                        "metrics_serve.jsonl (with --trace)")
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=run_gnn)

    lm = sub.add_parser("lm")
    lm.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    lm.add_argument("--arch", default="qwen3-1.7b")
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--steps", type=int, default=32)
    lm.add_argument("--cache-len", type=int, default=256)
    lm.add_argument("--seed", type=int, default=0)
    lm.set_defaults(fn=run_lm)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
