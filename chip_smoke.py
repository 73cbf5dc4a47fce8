#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); a phase that fails
raises, and the script exits non-zero:

1. ``device`` - the card's name and power limit (the ``nvidia-smi`` line is
   also printed as it is).  Without CUDA the script stops here, before any
   result, with a non-zero exit.
2. ``build`` - both kernels compiled from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a``.
3. ``kernel`` lines - each kernel against its plain PyTorch version on the
   card, at the shapes the serving slice gives it (the slice's own hybrid
   ELL pack) and at a few ragged shapes; kernel, plain and library-call
   times (CUDA events) beside the least time the card could take.
4. ``main_path`` - the serving slice through ``repro_torch.launch.serve``
   on ``cuda``: GCN 500 -> 256 -> 256 -> 7 over Flickr at scale 1.0 in 4
   METIS partitions with the hybrid backend, then a 2048-query zipf stream.
   The launch counters are zeroed just before and read just after; the
   precompute's tables are held against the same pass on the CPU (plain
   versions, same parameters).
5. ``kernels`` - every ported kernel with its launches on the main path,
   its largest error against the plain version and its times.

The last line is ``{"ok": true, "device": {...}}``.  TF32 is off for every
f32 product here, as in the port's entry points.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# The serving slice: the paper's GCN width on Flickr's published feature
# width, full graph scale (launch/serve.py's flags).
SLICE_ARGV = [
    "gnn", "--device", "cuda", "--dataset", "flickr", "--scale", "1.0",
    "--feat-dim", "500", "--model", "gcn", "--hidden", "256", "--layers", "3",
    "--parts", "4", "--partitioner", "metis", "--backend", "hybrid",
    "--refresh-every", "4", "--cpu-cache-gib", "4", "--hot-frac", "0.1",
    "--hot-rank", "degree", "--workload", "zipf", "--alpha", "1.1",
    "--queries", "2048", "--qps", "500", "--popularity", "degree",
    "--max-batch", "64", "--deadline-ms", "2", "--seed", "0",
]

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth and
# f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

ELL_ATOL, ELL_RTOL = 1e-4, 1e-5   # f32 sums in another order than the plain loop
LOGITS_ATOL = 1e-4                # card pass vs CPU pass of the whole slice

ELL_SOURCE = "src/repro_torch/kernels/csrc/ell_spmm.cu"
GATHER_SOURCE = "src/repro_torch/kernels/csrc/gather_rows.cu"
ELL_REPLACES = "src/repro/kernels/ell_spmm.py:116"
GATHER_REPLACES = "src/repro/kernels/cache_gather.py:38"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over HBM bandwidth and
    f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_calls(fns: dict, reps: int, rounds: int = 3) -> dict:
    """Median over ``rounds`` of the mean CUDA-event time of ``reps``
    back-to-back calls, the callables taken in turns within each round."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {k: statistics.median(v) for k, v in times.items()}


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, **device)
    return device


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    emit("build", seconds=time.perf_counter() - t0,
         sources=[f"csrc/{n}.cu" for n in build.SOURCES],
         flags=" ".join(build.NVCC_FLAGS))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def ell_csr(cols: torch.Tensor, vals: torch.Tensor, n_cols: int):
    """The stacked ELL operands as one block-diagonal CSR matrix
    ``[P * n_rows, P * n_cols]`` (padding slots dropped), for the library
    yardstick ``torch.sparse.mm``."""
    n_parts, n_rows, _ = cols.shape
    live = vals != 0
    crow = torch.zeros(n_parts * n_rows + 1, dtype=torch.int64,
                       device=cols.device)
    crow[1:] = live.sum(-1).reshape(-1).cumsum(0)
    offs = torch.arange(n_parts, device=cols.device)[:, None, None] * n_cols
    col = (cols.long() + offs)[live]
    return torch.sparse_csr_tensor(crow, col, vals[live],
                                   size=(n_parts * n_rows, n_parts * n_cols),
                                   check_invariants=True)


def ell_work(cols: torch.Tensor, vals: torch.Tensor, n_cols: int,
             d: int) -> tuple[float, float, int]:
    """(bytes, flops, nnz) the ELL product needs on these inputs: cols and
    vals read once, each h row that a live slot names read once, the output
    written once; two operations per live slot and feature column."""
    live = vals != 0
    nnz = int(live.sum())
    offs = torch.arange(cols.shape[0], device=cols.device)[:, None, None]
    rows = torch.unique((cols.long() + offs * n_cols)[live]).numel()
    out_elems = cols.shape[0] * cols.shape[1] * d
    nbytes = cols.numel() * 4 + vals.numel() * 4 + rows * d * 4 + out_elems * 4
    return float(nbytes), 2.0 * nnz * d, nnz


def check_ell(cols, vals, h) -> float:
    from repro_torch.kernels import ell_spmm as kell, ref
    got = kell.ell_spmm(cols, vals, h)
    want = ref.ell_spmm_ref(cols, vals, h)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"ell_spmm: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} float32")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, atol=ELL_ATOL, rtol=ELL_RTOL):
        raise AssertionError(f"ell_spmm disagrees with its plain version: "
                             f"max abs err {err}")
    return err


def phase_ell(sp, gen) -> dict:
    """ELL SpMM at the slice's shapes (its own hybrid pack, h random) and at
    ragged shapes; returns the kernels-line entry."""
    from repro_torch.kernels import ell_spmm as kell, ref
    dev = torch.device("cuda")
    # ragged shapes: rows, slots, h rows and widths that fit no block,
    # several feature blocks (d=700), and one unstacked 2-D call
    for p, n, k, nc, d in [(1, 70, 5, 90, 48), (3, 33, 37, 50, 7),
                           (2, 1000, 144, 1500, 500), (2, 100, 20, 300, 700)]:
        cols = torch.randint(0, nc, (p, n, k), generator=gen, device=dev,
                             dtype=torch.int32)
        vals = torch.randn((p, n, k), generator=gen, device=dev)
        vals[torch.rand((p, n, k), generator=gen, device=dev) < 0.9] = 0.0
        h = torch.randn((p, nc, d), generator=gen, device=dev)
        err = check_ell(cols, vals, h)
        emit("kernel", name="ell_spmm", shape=[p, n, k, nc, d], max_abs_err=err)
    err2d = check_ell(cols[0], vals[0], h[0])
    emit("kernel", name="ell_spmm", shape=[n, k, nc, d], unstacked=True,
         max_abs_err=err2d)

    cols = torch.as_tensor(sp.ell.cols, device=dev)
    vals = torch.as_tensor(sp.ell.vals, device=dev)
    n_cols = sp.n_inner_max + sp.n_halo_max
    csr = ell_csr(cols, vals, n_cols)
    per_width = {}
    for d in (500, 256):     # layer 0 reads the features, layers 1-2 hidden
        h = torch.randn((sp.num_parts, n_cols, d), generator=gen, device=dev)
        err = check_ell(cols, vals, h)
        lib_out = torch.sparse.mm(csr, h.view(-1, d))
        lib_err = float((lib_out.view(sp.num_parts, -1, d)
                         - kell.ell_spmm(cols, vals, h)).abs().max())
        t = time_calls({
            "kernel_ms": lambda: kell.ell_spmm(cols, vals, h),
            "plain_ms": lambda: ref.ell_spmm_ref(cols, vals, h),
            "library_ms": lambda: torch.sparse.mm(csr, h.view(-1, d)),
        }, reps=5)
        nbytes, flops, nnz = ell_work(cols, vals, n_cols, d)
        b, by = bound_ms(nbytes, flops)
        per_width[d] = dict(max_abs_err=err, bound_ms=b, bound_by=by,
                            bytes=nbytes, flops=flops, **t)
        emit("kernel", name="ell_spmm", shape=[*cols.shape, n_cols, d],
             nnz=nnz, slots=cols.numel(), library_max_abs_diff=lib_err,
             **per_width[d])
        del h, lib_out
    # one precompute pass launches it once at d=500 and twice at d=256
    mix = {500: 1, 256: 2}

    def total(key):
        return sum(per_width[d][key] * c for d, c in mix.items())

    return {"name": "ell_spmm", "route": "cuda", "source": ELL_SOURCE,
            "replaces": ELL_REPLACES,
            "max_abs_err": max(v["max_abs_err"] for v in per_width.values()),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": per_width[500]["bound_by"],
            "library_ms": total("library_ms"),
            "per_launch": {str(d): {k: v[k] for k in
                                    ("kernel_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
                           for d, v in per_width.items()},
            "timed_over": "one precompute pass: d=500 once, d=256 twice"}


def check_gather(src, idx) -> float:
    from repro_torch.kernels import cache_gather as kgather, ref
    got = kgather.gather_rows(src, idx)
    want = ref.gather_rows_ref(src, idx)
    torch.cuda.synchronize()
    word = torch.int16 if src.element_size() == 2 else torch.int32
    if got.shape != want.shape or got.dtype != src.dtype \
            or not torch.equal(got.view(word), want.view(word)):
        raise AssertionError(f"gather_rows is not bit-exact at "
                             f"{tuple(src.shape)} {src.dtype}")
    return float((got.float() - want.float()).abs().max())


def phase_gather(n_hot: int, out_dim: int, max_batch: int, gen) -> dict:
    """Row gather bit-exact at d in {7, 500}, f32 and bf16, an empty index,
    and timed at the slice's hot tier ``[n_hot, out_dim]`` f32 with one
    full micro-batch of hits."""
    from repro_torch.kernels import cache_gather as kgather, ref
    dev = torch.device("cuda")
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (out_dim, 500):
            src = torch.randn((n_hot, d), generator=gen,
                              device=dev).to(dtype)
            idx = torch.randint(0, n_hot, (max_batch,), generator=gen,
                                device=dev, dtype=torch.int32)
            errs.append(check_gather(src, idx))
            emit("kernel", name="gather_rows", shape=[n_hot, d, max_batch],
                 dtype=str(dtype), bit_exact=True)
    before = kgather.gather_rows.launches
    empty = kgather.gather_rows(src, idx[:0])
    if empty.shape != (0, src.shape[1]) or \
            kgather.gather_rows.launches != before:
        raise AssertionError("gather_rows with an empty index must return "
                             "[0, d] and launch nothing")
    emit("kernel", name="gather_rows", shape=[n_hot, 500, 0],
         empty_launches=0)

    src = torch.randn((n_hot, out_dim), generator=gen, device=dev)
    idx = torch.randint(0, n_hot, (max_batch,), generator=gen, device=dev,
                        dtype=torch.int32)
    errs.append(check_gather(src, idx))
    t = time_calls({
        "kernel_ms": lambda: kgather.gather_rows(src, idx),
        "plain_ms": lambda: ref.gather_rows_ref(src, idx),
        "library_ms": lambda: src.index_select(0, idx),
    }, reps=200)
    nbytes = idx.numel() * 4 + 2 * max_batch * out_dim * 4
    b, by = bound_ms(nbytes, 0.0)
    emit("kernel", name="gather_rows", shape=[n_hot, out_dim, max_batch],
         dtype="torch.float32", bound_ms=b, bound_by=by, bytes=nbytes, **t)
    return {"name": "gather_rows", "route": "cuda", "source": GATHER_SOURCE,
            "replaces": GATHER_REPLACES, "max_abs_err": max(errs),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"],
            "bound_ms": b, "bound_by": by,
            "timed_over": f"one micro-batch: {max_batch} rows of "
                          f"[{n_hot}, {out_dim}] f32"}


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------

def hot_batches(engine, args) -> int:
    """Micro-batches of the slice's stream with at least one hot-tier hit
    (each launches the row gather once)."""
    from repro_torch.launch.serve import slice_stream
    from repro_torch.serve import BatchConfig, plan_batches
    stream = slice_stream(args, engine.graph)
    batches = plan_batches(stream.t, BatchConfig(args.max_batch,
                                                 args.deadline_ms))
    return sum(int((engine.hot_slot[stream.node[b.idx]] >= 0).any())
               for b in batches)


def phase_main(args, ctx) -> dict:
    from repro_torch.kernels import cache_gather as kgather, ell_spmm as kell
    from repro_torch.launch.serve import serve_gnn
    from repro_torch.serve import precompute_embeddings

    kell.ell_spmm.launches = 0
    kgather.gather_rows.launches = 0
    t0 = time.perf_counter()
    report, engine = serve_gnn(args)
    wall_s = time.perf_counter() - t0
    launches = {"ell_spmm": kell.ell_spmm.launches,
                "gather_rows": kgather.gather_rows.launches}

    cfg, store = engine.cfg, engine.store
    task, ps, xplan, sp = ctx["task"], ctx["ps"], ctx["xplan"], ctx["sp"]
    n = task.graph.num_nodes
    want_dims = cfg.feat_dims
    if store.num_nodes != n or store.dims != want_dims:
        raise AssertionError(f"store is [{store.num_nodes}, {store.dims}], "
                             f"want [{n}, {want_dims}]")
    for i, table in enumerate(store.tables):
        if not np.isfinite(table).all():
            raise AssertionError(f"table {i} has non-finite values")
    if report["queries"] != args.queries:
        raise AssertionError(f"served {report['queries']} of {args.queries}")
    if launches["ell_spmm"] < cfg.num_layers:
        raise AssertionError(f"ell_spmm launched {launches['ell_spmm']} "
                             f"times on the main path, want >= "
                             f"{cfg.num_layers} (one per layer)")
    n_hot_batches = hot_batches(engine, args)
    if n_hot_batches == 0 or launches["gather_rows"] < n_hot_batches:
        raise AssertionError(f"gather_rows launched "
                             f"{launches['gather_rows']} times for "
                             f"{n_hot_batches} micro-batches with hot hits")

    # the device pass alone, for the breakdown of precompute_s
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    precompute_embeddings(cfg, ps, sp, xplan, engine.params,
                          backend=args.backend, device=args.device)
    device_pass_s = time.perf_counter() - t0

    # the same pass on the CPU with the plain versions and the same params
    cpu_params = [{k: v.cpu() for k, v in p.items()} for p in engine.params]
    t0 = time.perf_counter()
    cpu_store = precompute_embeddings(cfg, ps, sp, xplan, cpu_params,
                                      backend=args.backend, device="cpu")
    cpu_pass_s = time.perf_counter() - t0
    errs = [float(np.abs(a - b).max())
            for a, b in zip(store.tables, cpu_store.tables)]
    if errs[-1] > LOGITS_ATOL:
        raise AssertionError(f"card logits differ from the CPU pass by "
                             f"{errs[-1]} > {LOGITS_ATOL}")
    # served answers: hot hits (row gather) and host misses (host store)
    rng = np.random.default_rng(args.seed)
    sample = np.concatenate([engine.hot_ids[:64],
                             rng.choice(n, 64, replace=False)])
    served = engine.lookup(sample)
    serve_err = float(np.abs(served - cpu_store.logits[sample]).max())
    if serve_err > LOGITS_ATOL:
        raise AssertionError(f"served logits differ from the CPU pass by "
                             f"{serve_err}")

    fields = ("precompute_s", "qps", "p50_ms", "p99_ms", "hot_hit_rate",
              "host_hit_rate", "host_fetch_ms", "batches", "mean_batch",
              "busy_s")
    emit("main_path", argv=SLICE_ARGV, nodes=n, parts=sp.num_parts,
         hybrid_pack=list(sp.ell.cols.shape), tail_width=sp.ell.tail_width,
         launches=launches, hot_batches=n_hot_batches,
         **{k: report[k] for k in fields},
         wall_s=wall_s, host_plan_s=ctx["host_plan_s"],
         device_pass_s=device_pass_s, cpu_pass_s=cpu_pass_s,
         compared_at_scale=args.scale, table_max_abs_err=errs,
         served_max_abs_err=serve_err)
    return launches


def main() -> None:
    device = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    from repro_torch.launch.serve import (build_parser, plan_and_stack,
                                          prepare_gnn)
    args = build_parser().parse_args(SLICE_ARGV)
    task, ps, profiles, cfg = prepare_gnn(args)
    t0 = time.perf_counter()
    xplan, sp = plan_and_stack(args, task, ps, profiles, cfg)
    ctx = {"task": task, "ps": ps, "xplan": xplan, "sp": sp,
           "host_plan_s": time.perf_counter() - t0}

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = [phase_ell(sp, gen),
               phase_gather(int(round(args.hot_frac * task.graph.num_nodes)),
                            cfg.out_dim, args.max_batch, gen)]
    torch.cuda.empty_cache()

    launches = phase_main(args, ctx)
    for e in entries:
        e["launches"] = launches[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys}, **e}
                                  for e in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
