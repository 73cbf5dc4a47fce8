#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--sweep]

Phases, each printing one JSON line (``{"phase": ...}``); a phase that fails
raises, and the script exits non-zero:

1. ``device`` - the card's name and power limit (the ``nvidia-smi`` line is
   also printed as it is).  Without CUDA the script stops here, before any
   result, with a non-zero exit.
2. ``build`` - every kernel source of ``src/repro_torch/kernels/csrc``
   compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all at
   once.
3. ``kernel`` lines - the ELL forward (f32 and bf16 h) and the row gather
   against their plain PyTorch versions on the card, at the shapes the
   serving slice gives them (its own hybrid ELL pack and ``row_end``, as
   the main path passes them) and at ragged shapes; kernel, plain and
   library-call times (CUDA events) beside the least time the card could
   take.  The gather's time is split into host microseconds per call
   (``perf_counter`` over 1,000 calls, then one synchronize), device
   microseconds per call (CUDA events around a CUDA graph of 1,000 calls)
   and the host cost of each piece of its wrapper.
4. ``main_path`` - the serving slice through ``repro_torch.launch.serve``
   on ``cuda``: GCN 500 -> 256 -> 256 -> 7 over Flickr at scale 1.0 in 4
   METIS partitions with the hybrid backend, then a 2048-query zipf stream.
   The launch counters are zeroed just before and read just after; the
   precompute's tables are held against the same pass on the CPU (plain
   versions, same parameters).
5. ``train`` - the training slice through ``repro_torch.launch.train``'s
   own entry on ``cuda``: the same GCN over Flickr at scale 1.0, 4 METIS
   partitions weighted by the x4 device group, RAPA, JACA, hybrid backend,
   8 epochs of Adam (refresh, 3 cached, pipelined, 3 cached).  Counters
   zeroed just before and read just after: 3 ELL-forward launches per step
   and per evaluation, 2 ``d_h`` launches per step, no ``d_vals``.  Losses
   finite and falling; byte counts equal to the exchange plan's; one
   refresh step's loss and gradients equal to the CPU's at full scale; an
   8-step SGD run equal to the CPU's at scale 0.1.
6. ``kernel`` lines - the ELL forward at d = 500 and 256, the ``d_h`` and
   ``d_vals`` backward kernels and the column-chunked forward against their
   plain versions at the training slice's shapes (its hybrid pack), timed
   as in phase 3.
7. ``kernels`` - every ported kernel with its launches on the main paths,
   its largest error against the plain version and its times.

``--sweep`` adds ``sweep`` lines: every feature stripe of the ELL forward
(and the chosen one without ``row_end``) checked against the plain version
and timed in turns on both slices' packs, and ``ptxas`` lines: each
kernel's registers, shared memory and spills as ``nvcc -Xptxas -v``
reports them, with the occupancy they allow.

The last line is ``{"ok": true, "device": {...}}``.  TF32 is off for every
f32 product here, as in the port's entry points.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
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

# The training slice: launch/train.py's flags with the ELL backend (all
# others at their defaults: JACA, RAPA, uneven x4 group, pipelined refresh,
# static cache policy, f32 halo).
TRAIN_ARGV = [
    "gnn", "--device", "cuda", "--dataset", "flickr", "--scale", "1.0",
    "--feat-dim", "500", "--model", "gcn", "--hidden", "256", "--layers", "3",
    "--parts", "4", "--partitioner", "metis", "--backend", "hybrid",
    "--refresh-every", "4", "--epochs", "8", "--lr", "0.01", "--seed", "0",
]
TRAIN_SGD_SCALE = "0.1"   # the card-vs-CPU trajectory check
COL_CHUNK = 8192          # 8 MB of h rows at d = 256: an L2 tile

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth and
# f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

ELL_ATOL, ELL_RTOL = 1e-4, 1e-5   # f32 sums in another order than the plain loop
BF16_TOL = 1e-2                   # one bf16 rounding of the output
LOGITS_ATOL = 1e-4                # card pass vs CPU pass of the whole slice
# training, card vs CPU (same parameters): f32 sums in other orders, the
# d_h kernel's atomics in an order that changes from run to run
LOSS_ATOL = 1e-5                  # one refresh step at full scale
# of each gradient's largest magnitude: a ReLU whose input lies within
# rounding of 0 on one device and not the other passes or drops one
# row's whole term of a weight gradient that sums ~1e5 rows
GRAD_RTOL = 2e-3
TRAJ_ATOL = 1e-5                  # 8 SGD steps at scale 0.1

ELL_SOURCE = "src/repro_torch/kernels/csrc/ell_spmm.cu"
BWD_SOURCE = "src/repro_torch/kernels/csrc/ell_spmm_bwd.cu"
GATHER_SOURCE = "src/repro_torch/kernels/csrc/gather_rows.cu"
ELL_REPLACES = "src/repro/kernels/ell_spmm.py:116"
CHUNK_REPLACES = "src/repro/kernels/ell_spmm.py:154"
BWD_REPLACES = "src/repro/kernels/ell_spmm.py:80"   # _spmm_vjp.bwd (jnp)
GATHER_REPLACES = "src/repro/kernels/cache_gather.py:38"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over HBM bandwidth and
    f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_calls(fns: dict, reps: int, rounds: int = 4) -> dict:
    """Median over ``rounds`` of the mean CUDA-event time of ``reps``
    back-to-back calls, the callables taken in turns within each round, in
    reverse order every other round (a, b, b, a, ...)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for r in range(rounds):
        order = list(fns.items())
        for name, fn in (order if r % 2 == 0 else order[::-1]):
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


def referenced_rows(cols: torch.Tensor, live: torch.Tensor,
                    n_cols: int) -> int:
    """Distinct h rows (over all partitions) that the slots in ``live``
    name."""
    offs = torch.arange(cols.shape[0], device=cols.device)[:, None, None]
    return torch.unique((cols.long() + offs * n_cols)[live]).numel()


def ell_work(cols: torch.Tensor, vals: torch.Tensor, row_end: torch.Tensor,
             n_cols: int, d: int, elem: int = 4) -> tuple[float, float, int]:
    """(bytes, flops, nnz) the ELL product needs on these inputs, given the
    per-row slot bound ``row_end``: ``row_end`` read once, the cols and
    vals of each row's slots below it read once (those past it are known
    padding), each h row that a live slot names read once, the output
    written once (``elem`` bytes per h and output value); two operations
    per live slot and feature column."""
    live = vals != 0
    nnz = int(live.sum())
    rows = referenced_rows(cols, live, n_cols)
    out_elems = cols.shape[0] * cols.shape[1] * d
    nbytes = (row_end.numel() * 4 + int(row_end.long().sum()) * 8
              + rows * d * elem + out_elems * elem)
    return float(nbytes), 2.0 * nnz * d, nnz


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float = ELL_ATOL, rtol: float = ELL_RTOL) -> float:
    """Largest abs difference of a kernel's result from its plain
    version's; raises past the tolerance."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs err {err}")
    return err


def ell_tol(dtype) -> dict:
    return ({"atol": BF16_TOL, "rtol": BF16_TOL} if dtype == torch.bfloat16
            else {})


def check_ell(cols, vals, h, row_end=None, want=None) -> float:
    from repro_torch.kernels import ell_spmm as kell, ref
    if want is None:
        want = ref.ell_spmm_ref(cols, vals, h)
    return check_close(f"ell_spmm ({h.dtype})",
                       kell.ell_spmm(cols, vals, h, row_end), want,
                       **ell_tol(h.dtype))


def row_end_of(vals: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import ops
    return torch.as_tensor(ops.ell_row_end(vals.cpu().numpy()),
                           device=vals.device)


def phase_ell_ragged(gen) -> None:
    """The ELL forward at ragged shapes: rows, slots, h rows and widths that
    fit no block or vector (d = 7, 130, 499), several stripes (d = 700),
    with and without ``row_end``, and one unstacked 2-D call."""
    dev = torch.device("cuda")
    for p, n, k, nc, d in [(1, 70, 5, 90, 48), (3, 33, 37, 50, 7),
                           (2, 1000, 144, 1500, 500), (2, 100, 20, 300, 700),
                           (2, 257, 40, 300, 499), (1, 90, 70, 200, 130)]:
        cols = torch.randint(0, nc, (p, n, k), generator=gen, device=dev,
                             dtype=torch.int32)
        vals = torch.randn((p, n, k), generator=gen, device=dev)
        vals[torch.rand((p, n, k), generator=gen, device=dev) < 0.9] = 0.0
        h = torch.randn((p, nc, d), generator=gen, device=dev)
        row_end = row_end_of(vals)
        err = max(check_ell(cols, vals, h), check_ell(cols, vals, h, row_end))
        errb = check_ell(cols, vals, h.to(torch.bfloat16), row_end)
        emit("kernel", name="ell_spmm", shape=[p, n, k, nc, d],
             max_abs_err=err, bf16_max_abs_err=errb)
    err2d = check_ell(cols[0], vals[0], h[0], row_end[0])
    emit("kernel", name="ell_spmm", shape=[n, k, nc, d], unstacked=True,
         max_abs_err=err2d)


def ell_case(pack: str, cols, vals, row_end, csr, n_cols: int, d: int,
             dtype, gen) -> dict:
    """The ELL forward on one pack at one width: the kernel (with the
    pack's ``row_end``, as on the main path) against its plain version,
    timed in turns with the plain version and ``torch.sparse.mm``, beside
    the bound."""
    from repro_torch.kernels import ell_spmm as kell, ref
    n_parts = cols.shape[0]
    h = torch.randn((n_parts, n_cols, d), generator=gen,
                    device=cols.device).to(dtype)
    want = ref.ell_spmm_ref(cols, vals, h)
    err = check_ell(cols, vals, h, row_end, want)
    fns = {"kernel_ms": lambda: kell.ell_spmm(cols, vals, h, row_end),
           "plain_ms": lambda: ref.ell_spmm_ref(cols, vals, h)}
    extra = {}
    if dtype != torch.float32:
        csr = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      csr.values().to(dtype), size=csr.shape)
    try:
        lib_out = torch.sparse.mm(csr, h.view(-1, d))
    except RuntimeError as exc:    # the library may not take bf16 CSR
        extra["library"] = f"none: {str(exc).splitlines()[0]}"
    else:
        extra["library_max_abs_diff"] = float(
            (lib_out.view(n_parts, -1, d).float() - want.float()).abs().max())
        fns["library_ms"] = lambda: torch.sparse.mm(csr, h.view(-1, d))
        del lib_out
    t = time_calls(fns, reps=5)
    t.setdefault("library_ms", None)
    nbytes, flops, nnz = ell_work(cols, vals, row_end, n_cols, d,
                                  h.element_size())
    b, by = bound_ms(nbytes, flops)
    rec = dict(pack=pack, dtype=str(dtype).replace("torch.", ""),
               shape=[*cols.shape, n_cols, d], nnz=nnz, slots=cols.numel(),
               max_abs_err=err, bound_ms=b, bound_by=by, bytes=nbytes,
               **t, **extra)
    emit("kernel", name="ell_spmm", **rec)
    return rec


def ell_pack_cases(pack: str, sp, gen) -> dict:
    """:func:`ell_case` at the slices' widths on one slice's pack: f32 at
    d = 500 (layer 0 reads the features) and 256 (layers 1 and 2), bf16 at
    d = 500; keyed ``f32_500``, ``f32_256``, ``bf16_500``."""
    dev = torch.device("cuda")
    cols = torch.as_tensor(sp.ell.cols, device=dev)
    vals = torch.as_tensor(sp.ell.vals, device=dev)
    row_end = row_end_of(vals)
    n_cols = sp.n_inner_max + sp.n_halo_max
    csr = ell_csr(cols, vals, n_cols)
    out = {}
    for dtype, d in ((torch.float32, 500), (torch.float32, 256),
                     (torch.bfloat16, 500)):
        key = f"{'f32' if dtype == torch.float32 else 'bf16'}_{d}"
        out[key] = ell_case(pack, cols, vals, row_end, csr, n_cols, d, dtype,
                            gen)
        torch.cuda.empty_cache()
    return out


# ELL forward launches on the main paths, by pack and width: one precompute
# pass (layer 0 at d = 500, layers 1-2 at 256) and the 8-epoch training run
# with its closing evaluation (9 passes of the same three layers)
ELL_LAUNCH_MIX = {("serve", "f32_500"): 1, ("serve", "f32_256"): 2,
                  ("train", "f32_500"): 9, ("train", "f32_256"): 18}


def ell_entry(cases: dict) -> dict:
    """The ELL forward's kernels-line entry: ``ms``, ``plain_ms``,
    ``bound_ms`` and ``library_ms`` over one serving precompute pass (as in
    earlier runs), the training pack's per-launch numbers, and every time
    weighted by the main paths' launches."""
    serve = cases["serve"]

    def total(key, mix):
        """Sum of launches x time; None where a time is (no library call)."""
        times = [case[key] for case, _ in mix]
        if None in times:
            return None
        return sum(t * c for t, (_, c) in zip(times, mix))

    path_mix = [(cases[p][w], c) for (p, w), c in ELL_LAUNCH_MIX.items()]
    serve_mix = [(cases[p][w], c) for (p, w), c in ELL_LAUNCH_MIX.items()
                 if p == "serve"]
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "library")
    return {"name": "ell_spmm", "route": "cuda", "source": ELL_SOURCE,
            "replaces": ELL_REPLACES,
            "max_abs_err": max(c["max_abs_err"] for p in cases.values()
                               for c in p.values()),
            "ms": total("kernel_ms", serve_mix),
            "plain_ms": total("plain_ms", serve_mix),
            "bound_ms": total("bound_ms", serve_mix),
            "bound_by": serve["f32_500"]["bound_by"],
            "library_ms": total("library_ms", serve_mix),
            "timed_over": "one precompute pass: d=500 once, d=256 twice "
                          "(serving pack)",
            "per_launch": {p: {w: {k: c[k] for k in keys if k in c}
                               for w, c in pc.items()}
                           for p, pc in cases.items()},
            "main_paths_ms": {k: total(k, path_mix) for k in
                              ("kernel_ms", "library_ms", "bound_ms")},
            "main_paths_mix": {f"{p}/{w}": c
                               for (p, w), c in ELL_LAUNCH_MIX.items()}}


def check_gather(src, idx) -> float:
    from repro_torch.kernels import cache_gather as kgather, ref
    got = kgather.gather_rows(src, idx)
    want = ref.gather_rows_ref(src, idx.clamp(0, src.shape[0] - 1))
    want[(idx < 0) | (idx >= src.shape[0])] = 0
    torch.cuda.synchronize()
    word = torch.int16 if src.element_size() == 2 else torch.int32
    if got.shape != want.shape or got.dtype != src.dtype \
            or not torch.equal(got.view(word), want.view(word)):
        raise AssertionError(f"gather_rows is not bit-exact at "
                             f"{tuple(src.shape)} {src.dtype}")
    return float((got.float() - want.float()).abs().max())


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call: ``perf_counter`` over ``calls`` calls,
    then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def device_us(fn, calls: int = 1000) -> float:
    """Device microseconds per call: CUDA events around one replay of a
    CUDA graph of ``calls`` calls, which takes the host out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def gather_host_pieces(src, idx) -> dict:
    """Host microseconds of each piece of a gather call."""
    from repro_torch.kernels import cache_gather as kgather
    di = src.get_device()
    n_out, d = idx.shape[0], src.shape[1]
    out = src.new_empty((n_out, d))
    fn = kgather._entry()
    stream = torch._C._cuda_getCurrentRawStream(di)
    args = (src.data_ptr(), idx.data_ptr(), out.data_ptr(), n_out,
            src.shape[0], d * src.element_size(), di, stream)
    pieces = {
        "check": lambda: kgather._takes(src, idx),
        "new_empty": lambda: src.new_empty((n_out, d)),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(di),
        "pointers_and_device": lambda: (src.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), src.get_device()),
        "ctypes_call": lambda: fn(*args),
    }
    return {k: host_us(f) for k, f in pieces.items()}


def phase_gather(n_hot: int, out_dim: int, max_batch: int, gen) -> dict:
    """Row gather bit-exact at d in {7, 500}, f32 and bf16, at aligned and
    unaligned base addresses, with indices out of range, an empty index;
    timed at the slice's hot tier ``[n_hot, out_dim]`` f32 with one full
    micro-batch of hits."""
    from repro_torch.kernels import cache_gather as kgather, ref
    dev = torch.device("cuda")
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (out_dim, 500):
            base = torch.randn((n_hot + 1, d), generator=gen,
                               device=dev).to(dtype)
            for offset in (0, 1):    # row 1 on: an unaligned base address
                src = base[offset:offset + n_hot]
                idx = torch.randint(-2, n_hot + 2, (max_batch,),
                                    generator=gen, device=dev,
                                    dtype=torch.int32)
                errs.append(check_gather(src, idx))
                emit("kernel", name="gather_rows",
                     shape=[n_hot, d, max_batch], dtype=str(dtype),
                     base_offset_bytes=offset * d * src.element_size(),
                     bit_exact=True)
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
    calls = {"kernel": lambda: kgather.gather_rows(src, idx),
             "plain": lambda: ref.gather_rows_ref(src, idx),
             "library": lambda: src.index_select(0, idx)}
    t = time_calls({f"{k}_ms": f for k, f in calls.items()}, reps=200)
    hosts = {f"{k}_host_us": host_us(f) for k, f in calls.items()}
    devices = {f"{k}_device_us": device_us(f) for k, f in calls.items()}
    pieces = gather_host_pieces(src, idx)
    nbytes = idx.numel() * 4 + 2 * max_batch * out_dim * 4
    b, by = bound_ms(nbytes, 0.0)
    emit("kernel", name="gather_rows", shape=[n_hot, out_dim, max_batch],
         dtype="torch.float32", bound_ms=b, bound_by=by, bytes=nbytes, **t,
         **hosts, **devices, host_pieces_us=pieces)
    return {"name": "gather_rows", "route": "cuda", "source": GATHER_SOURCE,
            "replaces": GATHER_REPLACES, "max_abs_err": max(errs),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"],
            "bound_ms": b, "bound_by": by, **hosts, **devices,
            "timed_over": f"one micro-batch: {max_batch} rows of "
                          f"[{n_hot}, {out_dim}] f32"}


# ---------------------------------------------------------------------------
# --sweep: the ELL forward's feature stripes, and ptxas's report
# ---------------------------------------------------------------------------

SWEEP_STRIPE_BYTES = (256, 512, 1024, 2048)


def sweep_ell(packs: dict, gen) -> None:
    """Every feature stripe of the ELL forward at the slices' widths on
    each pack (``STRIPE_BYTES`` set to it for the call), each checked
    against the plain version, timed in turns; plus the chosen stripe
    without ``row_end``."""
    from repro_torch.kernels import ell_spmm as kell, ref
    dev = torch.device("cuda")
    chosen_bytes = kell.STRIPE_BYTES

    def with_stripe(stripe_bytes, *args):
        kell.STRIPE_BYTES = stripe_bytes
        try:
            return kell.ell_spmm(*args)
        finally:
            kell.STRIPE_BYTES = chosen_bytes

    for pack, sp in packs.items():
        cols = torch.as_tensor(sp.ell.cols, device=dev)
        vals = torch.as_tensor(sp.ell.vals, device=dev)
        row_end = row_end_of(vals)
        n_cols = sp.n_inner_max + sp.n_halo_max
        for dtype, d in ((torch.float32, 500), (torch.float32, 256),
                         (torch.bfloat16, 500)):
            h = torch.randn((cols.shape[0], n_cols, d), generator=gen,
                            device=dev).to(dtype)
            want = ref.ell_spmm_ref(cols, vals, h)
            elem = h.element_size()
            vec, chosen = kell.ell_launch_config(d, elem, 0)
            fns = {f"stripe{sb}B": (lambda sb=sb: with_stripe(
                sb, cols, vals, h, row_end)) for sb in SWEEP_STRIPE_BYTES
                if sb // (vec * elem) in kell.STRIPE_VECTORS}
            fns["chosen_without_row_end"] = lambda: kell.ell_spmm(cols, vals,
                                                                  h)
            errs = {k: check_close(f"ell_spmm {k}", f(), want,
                                   **ell_tol(dtype)) for k, f in fns.items()}
            t = time_calls(fns, reps=5)
            emit("sweep", name="ell_spmm", pack=pack,
                 dtype=str(dtype).replace("torch.", ""), d=d, vec=vec,
                 chosen=f"stripe{chosen * vec * elem}B", ms=t,
                 max_abs_err=errs)
            del h, want
            torch.cuda.empty_cache()


def ptxas_report() -> None:
    """Each kernel's registers, shared memory and spills as ``nvcc -Xptxas
    -v`` reports them, and the occupancy its registers allow (4-warp
    blocks for the ELL forward, 8 for the others)."""
    from repro_torch.kernels import build
    nvcc = build._nvcc()
    cuda_filt = Path(nvcc).with_name("cu++filt")
    demangle = (str(cuda_filt) if cuda_filt.exists()
                else shutil.which("c++filt"))
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    entry = re.compile(r"Function properties for (\S+)\n\s*\d+ bytes stack "
                       r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                       r"loads\n[^\n]*Used (\d+) registers([^\n]*)")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in build.SOURCES:
        proc = subprocess.run(
            [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o",
             str(build.BUILD_DIR / f"{name}.ptxas.cubin"),
             str(build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
        for m in entry.finditer(proc.stdout + proc.stderr):
            fn, st, ld, regs, rest = m.groups()
            smem = re.search(r"(\d+) bytes smem", rest)
            if demangle:
                fn = subprocess.run([demangle, fn], capture_output=True,
                                    text=True).stdout.strip() or fn
            regs = int(regs)
            warps = 4 if name == "ell_spmm" else 8
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(32, 65536 // (per_warp * warps))
            emit("ptxas", source=f"csrc/{name}.cu", kernel=fn,
                 registers=regs, smem_bytes=int(smem[1]) if smem else 0,
                 spill_stores=int(st), spill_loads=int(ld),
                 warps_per_sm=min(64, blocks * warps))


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


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------

def plan_bytes(cfg, spec, xplan, kinds: list[str]) -> tuple[int, int]:
    """(comm_bytes, comm_bytes_vanilla) of a run with these step kinds,
    from the exchange plan's own per-step byte model."""
    dims = cfg.feat_dims[:cfg.num_layers]
    if not spec.exchange_layer0:
        dims = dims[1:]
    width = 2 if spec.halo_dtype == "bf16" else 4
    comm = sum(xplan.bytes_per_step(d, refresh=k != "cached",
                                    dtype_bytes=width)
               for k in kinds for d in dims)
    vanilla = len(kinds) * sum(xplan.total_halo * d * width for d in dims)
    return comm, vanilla


def grads_err(got, want) -> list[dict]:
    """Per layer and parameter: the largest abs gradient difference over
    the gradient's largest magnitude (``max_rel``, raises past
    ``GRAD_RTOL``) and the difference's Frobenius norm over the
    gradient's (``fro_rel``)."""
    out = []
    for li, (gl, wl) in enumerate(zip(got, want)):
        for k in wl:
            diff = gl[k].cpu() - wl[k]
            rel = float(diff.abs().max()) / (float(wl[k].abs().max()) + 1e-12)
            fro = float(diff.norm()) / (float(wl[k].norm()) + 1e-12)
            if rel > GRAD_RTOL:
                raise AssertionError(f"layer {li} gradient {k!r} differs "
                                     f"from the CPU's by {rel} of its "
                                     "magnitude")
            out.append({"layer": li, "param": k, "max_rel": rel,
                        "fro_rel": fro})
    return out


def phase_train() -> tuple[dict, dict]:
    """The training slice through launch.train's entry; returns the kernel
    launches on it and its context (stacked layout, plan, runtime)."""
    from repro_torch.core import StalenessController
    from repro_torch.dist import make_sim_runtime, train_capgnn
    from repro_torch.kernels import ell_spmm as kell
    from repro_torch.launch.train import build_parser, prepare_train, train_gnn
    from repro_torch.models.gnn import init_gnn
    from repro_torch.optim import adam, sgd

    args = build_parser().parse_args(TRAIN_ARGV)
    counters = {"ell_spmm": kell.ell_spmm,
                "ell_spmm_chunked": kell.ell_spmm_chunked,
                "ell_spmm_dh": kell.ell_spmm_dh,
                "ell_spmm_dvals": kell.ell_spmm_dvals}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, ctx = train_gnn(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    rep, cfg, spec, xplan = ctx["report"], ctx["cfg"], ctx["spec"], ctx["xplan"]
    epochs, layers = args.epochs, cfg.num_layers
    # each step and the closing evaluation run every layer's forward once;
    # the backward needs d_h from layer 1 on (layer 0's input is constant)
    # and d_vals never (the ELL values are constants of the graph)
    want = {"ell_spmm": layers * (epochs + 1), "ell_spmm_chunked": 0,
            "ell_spmm_dh": (layers - 1) * epochs, "ell_spmm_dvals": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    losses = rep.losses
    if len(losses) != epochs or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    kinds = rep.step_kinds
    if kinds != ["refresh", "cached", "cached", "cached", "pipelined",
                 "cached", "cached", "cached"]:
        raise AssertionError(f"step kinds {kinds}")
    comm, vanilla = plan_bytes(cfg, spec, xplan, kinds)
    if (rep.comm_bytes, rep.comm_bytes_vanilla) != (comm, vanilla):
        raise AssertionError(f"bytes {rep.comm_bytes}/{rep.comm_bytes_vanilla}"
                             f", the plan gives {comm}/{vanilla}")

    # one refresh step's loss and gradients, card vs CPU, same parameters
    rt = ctx["runtime"]
    params0 = init_gnn(cfg, torch.Generator().manual_seed(args.seed),
                       rt.device)
    cpu_rt = make_sim_runtime(cfg, ctx["sp"], xplan, adam(args.lr),
                              spec=spec, device="cpu")
    loss_g, grads_g = rt.loss_and_grads(params0, rt.caches0)
    t0 = time.perf_counter()
    loss_c, grads_c = cpu_rt.loss_and_grads(
        [{k: v.cpu() for k, v in p.items()} for p in params0],
        cpu_rt.caches0)
    cpu_step_s = time.perf_counter() - t0
    loss_err = abs(float(loss_g) - float(loss_c))
    if loss_err > LOSS_ATOL:
        raise AssertionError(f"refresh-step loss differs from the CPU's by "
                             f"{loss_err}")
    grad_err = grads_err(grads_g, grads_c)
    del cpu_rt, grads_c

    # an 8-step SGD trajectory at scale 0.1, card vs CPU
    argv01 = list(TRAIN_ARGV)
    argv01[argv01.index("--scale") + 1] = TRAIN_SGD_SCALE
    args01 = build_parser().parse_args(argv01)
    ctx01 = prepare_train(args01)
    trajs = {}
    for dev in (rt.device.type, "cpu"):
        rt01 = make_sim_runtime(ctx01["cfg"], ctx01["sp"], ctx01["xplan"],
                                sgd(args.lr), spec=ctx01["spec"], device=dev)
        _, r01 = train_capgnn(
            ctx01["cfg"], rt01, ctx01["xplan"], args.parts, sgd(args.lr),
            epochs=epochs,
            controller=StalenessController(refresh_every=args.refresh_every),
            spec=ctx01["spec"])
        trajs[dev] = r01.losses
    traj_err = float(np.abs(np.subtract(trajs[rt.device.type],
                                        trajs["cpu"])).max())
    if traj_err > TRAJ_ATOL:
        raise AssertionError(f"SGD trajectory differs from the CPU's by "
                             f"{traj_err}: {trajs}")

    step_ms = {k: statistics.median(1e3 * t for t, kk in
                                    zip(rep.step_s, kinds) if kk == k)
               for k in sorted(set(kinds))}
    emit("train", argv=TRAIN_ARGV, nodes=ctx["task"].graph.num_nodes,
         hybrid_pack=list(ctx["sp"].ell.cols.shape),
         tail_width=ctx["sp"].ell.tail_width,
         n_inner_max=ctx["sp"].n_inner_max, n_halo_max=ctx["sp"].n_halo_max,
         total_halo=xplan.total_halo,
         tier_rows={"uncached": xplan.uncached.n_rows,
                    "local": xplan.local.n_rows,
                    "global": xplan.glob.n_unique},
         losses=losses, final_loss=losses[-1], test_acc=out["test_acc"],
         comm_bytes=rep.comm_bytes, comm_bytes_vanilla=rep.comm_bytes_vanilla,
         comm_reduction=rep.comm_reduction,
         refresh_steps=rep.refresh_steps, cached_steps=rep.cached_steps,
         step_kinds=kinds, compile_s=rep.compile_s,
         wall_time_s=rep.wall_time_s,
         wall_time_per_epoch_s=rep.wall_time_s / (epochs - 1),
         step_ms=[1e3 * t for t in rep.step_s], median_step_ms=step_ms,
         host_plan_s=ctx["host_plan_s"], launch_wall_s=wall_s,
         launches=launches, refresh_loss_card=float(loss_g),
         refresh_loss_cpu=float(loss_c), refresh_loss_err=loss_err,
         refresh_grad_err=grad_err, cpu_refresh_step_s=cpu_step_s,
         sgd_scale=float(TRAIN_SGD_SCALE), sgd_losses=trajs,
         sgd_traj_err=traj_err,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, ctx


# ---------------------------------------------------------------------------
# phase 6: the backward kernels and the chunked forward, training shapes
# ---------------------------------------------------------------------------

def ell_csr_t(cols: torch.Tensor, vals: torch.Tensor, n_cols: int):
    """The transpose of :func:`ell_csr`'s matrix, ``[P * n_cols,
    P * n_rows]`` as CSR, for the library yardstick of ``d_h = A^T g``."""
    n_parts, n_rows, _ = cols.shape
    live = vals != 0
    offs = torch.arange(n_parts, device=cols.device)[:, None, None]
    col = (cols.long() + offs * n_cols)[live]
    row = (torch.arange(n_rows, device=cols.device)[None, :, None]
           + offs * n_rows).expand_as(cols)[live]
    coo = torch.sparse_coo_tensor(torch.stack([col, row]), vals[live],
                                  size=(n_parts * n_cols, n_parts * n_rows),
                                  check_invariants=True)
    return coo.coalesce().to_sparse_csr()


def phase_backward(sp, gen) -> list[dict]:
    """d_h, d_vals and the chunked forward at the training slice's shapes
    (its hybrid pack, d = 256, random g and h); returns their kernels-line
    entries.  (The unchunked forward on this pack: :func:`ell_pack_cases`.)"""
    from repro_torch.kernels import ell_spmm as kell, ref
    dev = torch.device("cuda")
    cols = torch.as_tensor(sp.ell.cols, device=dev)
    vals = torch.as_tensor(sp.ell.vals, device=dev)
    n_parts, n_rows, k = cols.shape
    n_cols = sp.n_inner_max + sp.n_halo_max
    d = 256
    live = vals != 0
    nnz = int(live.sum())
    g = torch.randn((n_parts, n_rows, d), generator=gen, device=dev)
    h = torch.randn((n_parts, n_cols, d), generator=gen, device=dev)
    entries = []

    # d_h = A^T g: the step's backward through layers 1 and 2
    err = check_close("ell_spmm_dh", kell.ell_spmm_dh(cols, vals, g, n_cols),
                      ref.ell_spmm_bwd_ref(cols, vals, None, g, n_cols,
                                           need_vals=False)[1])
    csr_t = ell_csr_t(cols, vals, n_cols)
    lib = torch.sparse.mm(csr_t, g.view(-1, d)).view(n_parts, n_cols, d)
    lib_err = float((lib - kell.ell_spmm_dh(cols, vals, g, n_cols))
                    .abs().max())
    del lib
    t = time_calls({
        "kernel_ms": lambda: kell.ell_spmm_dh(cols, vals, g, n_cols),
        "plain_ms": lambda: ref.ell_spmm_bwd_ref(cols, vals, None, g, n_cols,
                                                 need_vals=False),
        "library_ms": lambda: torch.sparse.mm(csr_t, g.view(-1, d)),
    }, reps=5)
    nbytes = cols.numel() * 8 + g.numel() * 4 + n_parts * n_cols * d * 4
    b, by = bound_ms(nbytes, 2.0 * nnz * d)
    emit("kernel", name="ell_spmm_dh", shape=[n_parts, n_rows, k, n_cols, d],
         nnz=nnz, max_abs_err=err, library_max_abs_diff=lib_err,
         bound_ms=b, bound_by=by, bytes=nbytes, **t)
    entries.append({"name": "ell_spmm_dh", "route": "cuda",
                    "source": BWD_SOURCE, "replaces": BWD_REPLACES,
                    "max_abs_err": err, "ms": t["kernel_ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
                    "library_ms": t["library_ms"],
                    "timed_over": f"one launch at d={d} (layers 1 and 2 of "
                                  "a step launch it once each)"})
    del csr_t

    # d_vals: every slot's <g[i], h[cols[i, k]]>, padding slots included
    err = check_close("ell_spmm_dvals", kell.ell_spmm_dvals(cols, g, h),
                      ref.ell_spmm_bwd_ref(cols, vals, h, g, n_cols,
                                           need_h=False)[0])
    t = time_calls({
        "kernel_ms": lambda: kell.ell_spmm_dvals(cols, g, h),
        "plain_ms": lambda: ref.ell_spmm_bwd_ref(cols, vals, h, g, n_cols,
                                                 need_h=False),
    }, reps=5)
    rows = referenced_rows(cols, torch.ones_like(live), n_cols)
    nbytes = cols.numel() * 4 + g.numel() * 4 + rows * d * 4 + cols.numel() * 4
    b, by = bound_ms(nbytes, 2.0 * cols.numel() * d)
    emit("kernel", name="ell_spmm_dvals",
         shape=[n_parts, n_rows, k, n_cols, d], max_abs_err=err, bound_ms=b,
         bound_by=by, bytes=nbytes, **t)
    entries.append({"name": "ell_spmm_dvals", "route": "cuda",
                    "source": BWD_SOURCE, "replaces": BWD_REPLACES,
                    "max_abs_err": err, "ms": t["kernel_ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
                    "library_ms": None,
                    "timed_over": f"one launch at d={d}, every slot (on no "
                                  "path of the slice: the ELL values are "
                                  "constants)"})

    # the column-chunked forward, h rows padded to a multiple of COL_CHUNK;
    # timed with the pack's row_end, as the unchunked kernel beside it
    n_pad = -(-n_cols // COL_CHUNK) * COL_CHUNK
    hp = torch.zeros((n_parts, n_pad, d), device=dev)
    hp[:, :n_cols] = h
    del h
    from repro_torch.kernels import ops
    row_end = row_end_of(vals)
    want = ref.ell_spmm_chunked_ref(cols, vals, hp, COL_CHUNK)
    err = max(check_close("ell_spmm_chunked",
                          ops.ell_spmm(cols, vals, hp, col_chunk=COL_CHUNK),
                          want),
              check_close("ell_spmm_chunked (row_end)",
                          kell.ell_spmm_chunked(cols, vals, hp, COL_CHUNK,
                                                row_end), want))
    unchunked_diff = float((kell.ell_spmm_chunked(cols, vals, hp, COL_CHUNK)
                            - kell.ell_spmm(cols, vals, hp)).abs().max())
    csr = ell_csr(cols, vals, n_pad)
    t = time_calls({
        "kernel_ms": lambda: kell.ell_spmm_chunked(cols, vals, hp, COL_CHUNK,
                                                   row_end),
        "unchunked_ms": lambda: kell.ell_spmm(cols, vals, hp, row_end),
        "plain_ms": lambda: ref.ell_spmm_chunked_ref(cols, vals, hp,
                                                     COL_CHUNK),
        "library_ms": lambda: torch.sparse.mm(csr, hp.view(-1, d)),
    }, reps=5)
    nbytes, flops, _ = ell_work(cols, vals, row_end, n_pad, d)
    b, by = bound_ms(nbytes, flops)
    emit("kernel", name="ell_spmm_chunked",
         shape=[n_parts, n_rows, k, n_pad, d], col_chunk=COL_CHUNK,
         n_chunks=n_pad // COL_CHUNK, max_abs_err=err,
         unchunked_max_abs_diff=unchunked_diff, bound_ms=b, bound_by=by,
         bytes=nbytes, **t)
    entries.append({"name": "ell_spmm_chunked", "route": "cuda",
                    "source": ELL_SOURCE, "replaces": CHUNK_REPLACES,
                    "max_abs_err": err, "ms": t["kernel_ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
                    "library_ms": t["library_ms"],
                    "unchunked_ms": t["unchunked_ms"],
                    "timed_over": f"one launch at d={d}, col_chunk="
                                  f"{COL_CHUNK} (reached through "
                                  "ops.ell_spmm(col_chunk=); on no path of "
                                  "the slice)"})
    return entries


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", action="store_true",
                   help="time every feature stripe of the ELL forward and "
                        "print ptxas's report of every kernel")
    return p.parse_args(argv)


def main(argv=None) -> None:
    opts = parse_args(argv)
    device = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if opts.sweep:
        ptxas_report()

    from repro_torch.launch.serve import (build_parser, plan_and_stack,
                                          prepare_gnn)
    args = build_parser().parse_args(SLICE_ARGV)
    task, ps, profiles, cfg = prepare_gnn(args)
    t0 = time.perf_counter()
    xplan, sp = plan_and_stack(args, task, ps, profiles, cfg)
    ctx = {"task": task, "ps": ps, "xplan": xplan, "sp": sp,
           "host_plan_s": time.perf_counter() - t0}

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_ell_ragged(gen)
    ell_cases = {"serve": ell_pack_cases("serve", sp, gen)}
    gather = phase_gather(int(round(args.hot_frac * task.graph.num_nodes)),
                          cfg.out_dim, args.max_batch, gen)
    torch.cuda.empty_cache()

    serve_launches = phase_main(args, ctx)
    torch.cuda.empty_cache()
    train_launches, tctx = phase_train()
    del tctx["runtime"]
    torch.cuda.empty_cache()
    ell_cases["train"] = ell_pack_cases("train", tctx["sp"], gen)
    if opts.sweep:
        sweep_ell({"serve": sp, "train": tctx["sp"]}, gen)
    entries = [ell_entry(ell_cases), gather] + phase_backward(tctx["sp"], gen)
    # launches: the serving path's plus the training path's
    by_path = {"serve": serve_launches, "train": train_launches}
    for e in entries:
        e["launches_by_path"] = {k: v[e["name"]] for k, v in by_path.items()
                                 if e["name"] in v}
        e["launches"] = sum(e["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys}, **e}
                                  for e in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
