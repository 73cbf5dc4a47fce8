#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--sweep | --kernels-only | --spmd-nccl |
                           --spmd-nccl-pair]

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
   The launch counters are zeroed just before and read just after (one ELL
   forward and one CSR tail launch per layer, no pack built in a
   wrapper); the precompute's tables are held against the same pass on
   the CPU (plain versions, same parameters; on a thread of its own
   beside the later phases, compared in ``main_path_cpu_check``).
   ``serve_sage`` - the same
   with ``--model sage``: SAGE's ``degree()`` adds one ELL forward and
   one tail launch a layer (recomputed per call, as the reference does);
   its card-vs-CPU pass runs at scale ``SERVE_SAGE_CHECK_SCALE`` (the
   same flags and parameters; the served answers against the card's own
   tables).
   ``serve_fresh`` - the serving slice with ``--update-frac 0.005`` (446
   of 89,250 nodes' features updated, every query of a stale node
   recomputed over its ``fresh_hops``-hop in-neighbourhood), traced: the
   stale set and every count of the stream worked out from the ids, the
   launches counted from zero, a fixed batch of stale nodes served on
   the card against a CPU engine's recompute (``LOGITS_ATOL``), qps,
   p50 / p99 and the ``fresh_recompute`` spans.
   ``examples`` - ``examples/heterogeneous_rapa_torch.py`` and
   ``serve_gnn_torch.py`` at their defaults on the card and, in a child
   process beside it, on the CPU: the lambda table, the x8 run's bytes,
   reduction, step kinds and spec, and the serving walkthrough's counts
   equal; the card's losses finite and falling.
5. ``train`` - the training slice through ``repro_torch.launch.train``'s
   own entry on ``cuda``: the same GCN over Flickr at scale 1.0, 4 METIS
   partitions weighted by the x4 device group, RAPA, JACA, hybrid backend,
   8 epochs of Adam (refresh, 3 cached, pipelined, 3 cached).  Counters
   zeroed just before and read just after: 3 ELL-forward and 3 CSR-tail
   launches per step and per evaluation, 2 CSR ``d_h`` launches per step,
   no ``d_vals``, the row gather's forward and its CSR backward at the
   counts each step kind gives them, worked out from the exchange plan
   (one forward per non-empty tier pull and exchanged layer, one backward
   per differentiated one: 6 and 2 in this cell), no pack built in a
   wrapper.  Losses finite and falling; byte counts equal to the
   exchange plan's; one refresh step's loss and gradients equal to the
   CPU's at full scale (through the gather's backward); an 8-step SGD run
   equal to the CPU's at scale 0.1; each step kind timed again in steady
   state; the phase's peak device memory.
   ``train_sage`` and ``train_gin`` - the same flags with ``--model sage``
   / ``gin`` on the same host plan (every model has the same widths):
   the same checks, SAGE with two ELL forward and tail launches a layer.
   ``train_gat`` - ``--model gat --backend edges --lr 0.001``
   (:data:`GAT_LR`; GAT's edge softmax runs on the edge list only): four
   heads a layer in one ``edge_spmm`` forward and, every step, one
   ``edge_spmm_dh`` and one ``edge_dvals`` launch from layer 0 on; no ELL,
   tail or ELL ``d_h`` launch, the gathers 6 / 2.
   ``train_vanilla``, ``train_jaca``, ``train_rapa``, ``train_jaca_rapa``,
   ``train_adaptive`` and ``train_x8`` - the paper's ablation rows (Table
   8: Vanilla is no JACA, no RAPA, no pipeline, a refresh every step),
   ``--adaptive-staleness`` (traced: the kinds follow the measured
   drifts) and the x8 group's 8 partitions on the card (:data:`ABLATION`),
   with ``train``'s checks but the CPU pass, which ``train_vanilla`` and
   ``train_x8`` run at ``TRAIN_SGD_SCALE``; the runs that share a
   partition reuse its host plan.  ``train_ablation`` - the reduction
   exactly 0.0 for the zero-capacity rows, the vanilla halo rows equal
   on one partition, every row's bytes and step ms by kind.
   ``train_edges`` - the same flags with ``--backend edges`` (the CLI's
   default), on the same host plan: the same checks, the edge list's CSR
   kernel once a layer a pass (``edge_spmm``: 27) and over the transposed
   pack from layer 1 a step (``edge_spmm_dh``: 16), no ELL, tail or ELL
   ``d_h`` launch, the gathers 6 / 2.  ``coo_spmm`` - its aggregation at
   that edge list's packs, d = 256: the forward and ``d_h`` against the
   plain version ``ops.coo_spmm`` (and its autograd backward), twice bit
   for bit, timed beside it and ``torch.sparse.mm``; ``edge_dvals`` (a
   ``kernel`` line) at d = 64 on the same pack against its plain version
   and ``coo_spmm``'s autograd in its weights, beside
   ``torch.sparse.sampled_addmm``.
   ``train_ell`` - ``--backend ell`` at scale 0.3 (the pure ELL pack's
   shape and bytes printed: 0.73 GB there, ~7 GB at scale 1.0), its
   refresh step held against the CPU at scale 0.1.
   ``spmd`` - the SPMD runtime (``repro_torch.dist.capgnn_spmd``) at the
   training slice's flags, 4 ranks sharing the card over gloo (the wire
   staged through pinned host buffers: ``"wire": "gloo-host"``, a measure
   of correctness and compute, not of NVLink), once per transport (both
   in one spawn): the
   refresh step's loss and gradients against the card's single-process
   runtime on the same parameters, every step's counted rows and bytes
   equal to the plan's, the launches summed over the ranks, the step and
   host-staging ms per kind.  ``spmd_tiers`` - the SPMD runtime on a
   small graph whose forced-capacity plans fill every tier, 4 ranks over
   gloo on the card, under both transports and a bf16 ``p2p`` wire:
   refresh, cached, pipelined and cached steps, a transition to a second
   ranking, a cached step on it, ``set_plan`` back and a refresh, each
   step's loss, parameters and caches against the card's single-process
   runtime and its counted rows against the plans'.  ``spmd_nccl`` and
   ``spmd_tiers_nccl`` - the same two over NCCL, one card per rank,
   where 4 cards are visible; otherwise their lines say ``"ran": false``
   and the card count.  ``spmd_models`` (``spmd_models_nccl`` over
   NCCL) - the SPMD runtime on that graph with SAGE (``hybrid``,
   ``p2p``), GIN (``ell``, ``allgather``) and GAT (``edges``, ``p2p``):
   a refresh step's loss and gradients and four steps against the card's
   single-process runtime, the counted rows against the plan's, the
   launches summed over ranks.
   ``spmm15d`` - the 1.5D replicated-row strategy (``--strategy spmm_15d``)
   at the train cell's width through the CLI's own host pipeline and rank
   program (``launch.train.prepare_train`` / ``train_15d_rank``), ``c=2,
   pr=2`` and ``c=1, pr=4`` on 4 ranks, GCN and GIN, 6 Adam steps, the
   ranks sharing the card over gloo (all cases in one spawn; the 8-rank
   ``c=2, pr=4`` case runs in the CPU tests): the losses against the card's
   ``capgnn_sim`` at ``refresh_every=1`` on the same block rows, every
   rank's counted forward bytes equal to the byte model, every rank's
   launches those of its chunk (``edge_spmm`` once a layer a pass,
   ``edge_spmm_dh`` from layer 1 a step, nothing else); steady step and
   host-staging ms per rank, peak memory
   (``spmm15d_nccl``: the two 4-rank shapes with GCN over NCCL on four
   cards).  ``coo_spmm_15d`` - rank 0's chunk aggregation of ``c=2,
   pr=2`` through the runtime's own ``chunk_adj`` (the CSR kernel over
   its packs) at d = 500 and 256 (forward and backward) against
   ``ops.coo_spmm``, timed beside it, ``torch.sparse.mm`` and the bound.
   JACA's CPU tier and online adaptation, on the train cell's host plan
   under a forced capacity (``forced_capacity``: half the widest worker's
   halo rows on the host) that fills every tier: ``train_host`` - a
   device-features and a host-features runtime, f32 and bf16, 8 steps
   from the same parameters (f32 bit for bit, bf16 within 5e-3), each
   host step's counted rows and bytes against the plan's, its host
   gather ms, the copies' and the compute stream's waits' device ms, its
   launches; ``train_host_cli`` - ``launch.train`` with ``--features
   host`` at the default capacity (losses those of the ``train`` run bit
   for bit; the ``l0loc`` install timed); ``train_adaptive`` -
   ``--cache-policy lru`` (host features) and ``drift`` with a
   ``step_transition`` to the re-plan (``replan_ms``, ``hit_rate``; at
   scale 0.1 the card's ``lru`` re-plans equal the CPU's);
   ``spmd_host`` - the SPMD runtime, 4 ranks on the card over gloo,
   ``p2p``, one host store per rank, against the card's host run, the
   host counts summed over the ranks equal to the plan's (in one spawn
   with ``spmd_faults``; ``spmd_host_nccl`` and ``spmd_lru_nccl`` over
   NCCL on four cards);
   ``profile`` - ``measure_profile()`` on the card.
   Faults and defenses, the tracer and checkpoints: ``train_faults`` -
   the slice's path, ``launch.train --backend hybrid --features host
   --refresh-every 2 --faults FAULT_SPEC --checksums --guard-every 2
   --fetch-retries 1 --trace --ckpt-dir`` on the forced plan, after the
   same flags with no fault (every injected class matched by exactly as
   many counted defenses, the final loss within ``FAULT_LOSS_TOL`` of the
   clean run's, the corrupted tier and the rollback step), and ``lru``
   with ``mem_pressure@4``; ``train_traced`` - device and host features
   on the forced plan, untraced, traced, traced with a fence on the whole
   device (twice), traced, untraced (the traced totals equal the
   report's, every step's launches equal, the trace valid, the steady
   step ms of the three); ``device_trace`` - ``--device-trace-dir`` over
   3 steps of the train cell (the kernels by name inside the
   ``layer{li}/spmm`` and tier-pull ranges, every CSR launch inside a
   range, the backward's inside ``transpose(...)``);
   ``spmd_faults`` - 4 gloo ranks on the card, host features, both
   transports in one spawn, ``fetch_drop@3;grad_nan@5`` under the guard,
   against the card's single-process run under the same faults
   (``spmd_faults_nccl`` on four cards); ``checkpoint`` - the
   kill-and-resume scenario of ``tests/test_system.py`` at the train
   cell's width, then ``launch.serve`` with ``--ckpt-dir`` and
   ``--store-dir`` and with ``--load-store`` (the tables equal bit for
   bit).
   The transformer zoo (plain torch: the reference's attention, MoE
   dispatch and scans are jnp, so no kernel of the port runs there; the
   counters are zeroed before each phase and must read 0 after it):
   ``lm_reduced`` - every architecture's reduced config, card against
   CPU from one CPU generator's parameters, in f32 (prefill logits and
   ``aux``, one step's loss and gradients at 520 tokens, 8 decode steps
   and their caches, within 1e-4 of the largest magnitude) and in bf16
   (finite; decode against prefill at the reference's bar);
   ``lm_serve`` - ``launch.serve``'s decode loop (``decode_lm``) at
   qwen3-1.7b's published width in bf16, batch 4, cache 256, 32 greedy
   steps: tokens/s, the steady step beside its bound (the weights read
   once), peak memory, a profiled window (device-busy ms, idle share,
   kernels a step), ``blocked_attention`` at a 4,096-token prefill and the
   ring decode attention beside their bounds and
   ``scaled_dot_product_attention``; then f32 decode against the card's
   own prefill; ``lm_train`` - ``launch.train lm --arch qwen3-1.7b --full
   --steps 8 --batch 4 --seq-len 128`` through the CLI's parser and loop
   (``train_lm``): falling finite losses, step ms, tokens/s, peak memory
   and one profiled step.
   The transformer zoo sharded (DTensor on a ``("data", "model")``
   DeviceMesh; plain torch, the counters read 0): ``lm_spmd`` -
   qwen3-1.7b at its published CONFIG, full depth, on 4 ranks sharing the
   card as a 2 x 2 mesh over the ``staged`` backend (gloo, CUDA tensors
   through pinned host buffers): one f32 forward and backward against
   the card's single-device one (the logits, and rank 0's shard of every
   gradient), 4 bf16 AdamW steps with ZeRO-1 moments (remat on)
   at ``lm_train``'s batch against its losses, 16 decode steps at batch 4
   and cache 256 teacher-forced on the single-device greedy tokens (top-1
   agreement), step ms, peak memory and the op counter's collective
   bytes per kind per rank, rank 0's equal to the dry run's for the same
   step and mesh; ``lm_spmd_moe`` - mixtral-8x7b at its published widths,
   2 of 32 layers, f32, expert-parallel on the 2 x 2 mesh: logits,
   ``aux``, loss and one backward's gradients against the per-block plain
   version in one process, each MoE layer's all-to-all and FSDP
   all-gather bytes against the byte model from the shapes;
   ``lm_dryrun`` - ``launch.dryrun.run_one`` of qwen3-14b ``train_4k`` on
   ``(16, 16)`` and mixtral-8x7b ``decode_32k`` on ``(2, 16, 16)`` (a
   ``fake`` group, fake tensors; run on the CPU in a child process from
   the start, beside the card's phases): per-device FLOPs, bytes,
   collectives and memory, and the roofline terms over the card's
   constants.  ``lm_spmd_nccl`` and ``lm_spmd_moe_nccl`` - the two over
   NCCL, a card per rank, where 4 cards are visible.  ``spmd_vanilla_nccl``
   - the Vanilla row through the SPMD runtime over NCCL (``p2p``; run by
   ``--spmd-nccl`` and ``--spmd-nccl-pair``, which runs ``spmd_nccl``'s
   ``p2p`` and it alone).
6. ``kernel`` lines - the ELL forward at d = 500 and 256, the CSR kernel
   as ``d_h`` over the training slice's transposed pack (twice, bit for
   bit) and as the hybrid tail's forward on both slices' tails, the row
   gather over the training slice's local-tier map (forward bit for bit,
   backward twice bit for bit), ``d_vals`` (twice, bit for bit) and the
   column-chunked forward against their plain versions, timed as in
   phase 3 beside the routes they replaced (the tail's ``coo_spmm``
   forward and its autograd backward; the tier pulls' indexing backward
   and an ``index_select`` route), and a tier pull, forward and backward,
   as one composed gather and as two stages.  ``ell_spmm_at`` -
   ``EllAdj.spmm_at`` (trained ELL values) on the training pack at d = 64:
   one forward and backward, its ``d_vals`` and ``d_h`` launches counted
   and held against their plain versions.
7. ``kernels`` - every ported kernel with its launches on each path
   (``launches_by_path``: serve, serve_sage, serve_fresh, the two
   examples, train, the ablation rows, train_sage,
   train_gin, train_edges, train_gat, train_ell, the SPMD runs summed over
   ranks (spmd_models_<model> per model, spmm15d), train_host,
   train_host_cli, train_adaptive_lru, train_adaptive_drift, spmd_host,
   ell_spmm_at, and 0 on lm_reduced, lm_serve, lm_train), its largest
   error against the plain version and its times; the edge list's route
   (``edge_spmm``, ``edge_spmm_dh``, ``edge_dvals``) from the
   ``coo_spmm`` phase.

``--kernels-only`` runs only the edge route's kernels at the train cell:
``csr_variants`` lines (the CSR kernel on each route it serves, the 1.5D
chunk's too, in every row order, stripe and load mode, beside
``l2_fit_default``: the same launch over an x folded into 8,192 rows,
which the L2 holds: the floor probe; the ring and four register steps
over x folded into 8k and 48k rows; medians and spread over 8 rounds;
the default under each timing protocol), ``dvals_variants``
(``edge_dvals`` with GAT's 4 heads: one pass, head by head, one launch a
head, the floor probe) and the ``coo_spmm``, ``csr_spmm_tail``,
``csr_spmm_dh`` and ``gather_rows_bwd`` lines.

Every kernel time is CUDA events around a run of calls queued behind a
~1 ms spin of the card (``time_calls``), so it holds no host time: it
equals a CUDA graph's device time within 1% (``--kernels-only``'s
``protocols``), where events that start on an idle card add the first
call's host time.

``--sweep`` adds ``sweep`` lines: every feature stripe of the ELL forward
(and the chosen one without ``row_end``) checked against the plain version
and timed in turns on both slices' packs; the CSR kernel's long-row
threshold ``L`` (64 to 1,024) on the ``d_h`` pack and both tails; every
stripe and lanes-per-slot of the ``d_vals`` kernel on the training pack;
and
``ptxas`` lines: each kernel's registers, shared memory and spills as
``nvcc -Xptxas -v`` reports them, with the occupancy they allow.

The last line is ``{"ok": true, "device": {...}}``.  TF32 is off for every
f32 product here, as in the port's entry points.
"""
from __future__ import annotations

import argparse
import json
import os
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
# GAT's cell runs Adam at 0.001: at the train cell's 0.01 its loss rises
# over the 8 steps (and so does the JAX package's, on the whole graph
# with no staleness)
GAT_LR = "0.001"
# the pure-ELL cell: at scale 1.0 the largest in-degree (8,886) makes the
# pack [4, 24.5k, 8.9k], ~7 GB, and its plain version's CPU reference out
# of reach; at 0.3 the pack is [4, 7335, 3089], 0.73 GB (its refresh step
# is held against the CPU at TRAIN_SGD_SCALE)
TRAIN_ELL_SCALE = "0.3"
# serve_sage's card-vs-CPU pass (at 1.0 the CPU's plain pass took ~81 s)
SERVE_SAGE_CHECK_SCALE = "0.1"
SPMD_RANKS = 4
# the card-vs-CPU passes' intra-op threads, on their thread beside the
# card's phases: half the host's cores, the rest for the phases' ranks
CPU_CHECK_THREADS = max(1, (os.cpu_count() or 2) // 2)
COL_CHUNK = 8192          # 8 MB of h rows at d = 256: an L2 tile

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth and
# f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

ELL_ATOL, ELL_RTOL = 1e-4, 1e-5   # f32 sums in another order than the plain loop
BF16_TOL = 1e-2                   # one bf16 rounding of the output
CSR_TOL_OF_MAX = 1e-5             # of the largest magnitude, f32 (csr_tol)
LOGITS_ATOL = 1e-4                # card pass vs CPU pass of the whole slice
# training, card vs CPU (same parameters): f32 sums in other orders
LOSS_ATOL = 1e-5                  # one refresh step at full scale
# of each gradient's largest magnitude: a ReLU whose input lies within
# rounding of 0 on one device and not the other passes or drops one
# row's whole term of a weight gradient that sums ~1e5 rows
GRAD_RTOL = 2e-3
TRAJ_ATOL = 1e-5                  # 8 SGD steps at scale 0.1

ELL_SOURCE = "src/repro_torch/kernels/csrc/ell_spmm.cu"
BWD_SOURCE = "src/repro_torch/kernels/csrc/ell_spmm_bwd.cu"
CSR_SOURCE = "src/repro_torch/kernels/csrc/csr_spmm.cu"
GATHER_SOURCE = "src/repro_torch/kernels/csrc/gather_rows.cu"
ELL_REPLACES = "src/repro/kernels/ell_spmm.py:116"
CHUNK_REPLACES = "src/repro/kernels/ell_spmm.py:154"
BWD_REPLACES = "src/repro/kernels/ell_spmm.py:80"   # _spmm_vjp.bwd (jnp)
# hybrid_spmm's segment-sum tail (jnp, no pallas_call): TPU kernel #1's
# second phase
TAIL_REPLACES = "src/repro/kernels/ops.py:73"
GATHER_REPLACES = "src/repro/kernels/cache_gather.py:38"
# the gather's VJP: XLA's transpose of the jnp.take route of pack_rows (the
# Pallas route has none: jax.grad does not linearise through it)
GATHER_BWD_REPLACES = "src/repro/kernels/ops.py:128"
# the edges backend's aggregation, EdgeListAdj.spmm (segment_sum, no
# pallas_call; also the 1.5D chunk's, src/repro/dist/strategy_15d.py:327),
# and the autodiff of its spmm_at in the per-edge values (GAT)
EDGE_REPLACES = "src/repro/models/gnn.py:99"
EDGE_DVALS_REPLACES = "src/repro/models/gnn.py:103"
EDGE_DVALS_SOURCE = "src/repro_torch/kernels/csrc/edge_dvals.cu"


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started
    (``elapsed_s``: the run's time budget by phase)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _T0}), flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over HBM bandwidth and
    f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the card's idle spin before each timed run of calls (~1 ms): the host
# enqueues the calls meanwhile, so no host time between the events
FILL_CYCLES = 2_000_000


def time_runs(fns: dict, reps: int, rounds: int = 4,
              spin: bool = True) -> dict:
    """Each round's mean CUDA-event time of ``reps`` back-to-back calls,
    the callables taken in turns within each round, in reverse order
    every other round (a, b, b, a, ...).  With ``spin`` each run of calls
    is queued behind a spin of :data:`FILL_CYCLES` (``torch.cuda._sleep``)
    so that the events time the device's work, not the host's launches
    (else a wrapper's host time lands between the start event and its
    first kernel); without it, the events start on an idle card (the
    earlier protocol, kept to compare the two)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for r in range(rounds):
        order = list(fns.items())
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(FILL_CYCLES)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return times


def time_calls(fns: dict, reps: int, rounds: int = 4,
               spin: bool = True) -> dict:
    """The median over the rounds of :func:`time_runs`."""
    return {k: statistics.median(v)
            for k, v in time_runs(fns, reps, rounds, spin).items()}


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    smi = nvidia_smi()
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


def csr_tol(want: torch.Tensor) -> dict:
    """The CSR kernel's tolerance: f32 within 1e-5 of the largest magnitude
    (rows of up to 8,865 entries summed in another order than the plain
    version's), bf16 within the ELL forward's bf16 tolerance."""
    if want.dtype == torch.float32:
        return {"atol": CSR_TOL_OF_MAX * float(want.abs().max()), "rtol": 0.0}
    return {"atol": BF16_TOL, "rtol": BF16_TOL}


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
# with its closing evaluation (9 passes of the same three layers); the
# hybrid tail's CSR launches follow the same mix
ELL_LAUNCH_MIX = {("serve", "f32_500"): 1, ("serve", "f32_256"): 2,
                  ("train", "f32_500"): 9, ("train", "f32_256"): 18}


def weighted_entry(name: str, source: str, replaces: str,
                   cases: dict) -> dict:
    """A kernels-line entry for a kernel timed per pack and width (the ELL
    forward, the hybrid tail): ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` over one serving precompute pass, the per-launch
    numbers of both packs, and every time weighted by the main paths'
    launches."""
    serve = cases["serve"]

    def total(key, mix):
        """Sum of launches x time; None where a time is (no library call)."""
        times = [case.get(key) for case, _ in mix]
        if None in times:
            return None
        return sum(t * c for t, (_, c) in zip(times, mix))

    path_mix = [(cases[p][w], c) for (p, w), c in ELL_LAUNCH_MIX.items()]
    serve_mix = [(cases[p][w], c) for (p, w), c in ELL_LAUNCH_MIX.items()
                 if p == "serve"]
    keys = ("kernel_ms", "plain_ms", "library_ms", "old_route_ms",
            "bound_ms", "bound_by", "max_abs_err", "library")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
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
                              ("kernel_ms", "library_ms", "old_route_ms",
                               "bound_ms")},
            "main_paths_mix": {f"{p}/{w}": c
                               for (p, w), c in ELL_LAUNCH_MIX.items()}}


def check_gather(src, idx) -> float:
    from repro_torch.kernels import cache_gather as kgather, ref
    got = kgather.gather_rows(src, idx)
    want = ref.gather_rows_ref(src, idx)     # zero rows out of range
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


def enqueue_us(fn, calls: int = 20) -> float:
    """Host microseconds a call takes to enqueue its work, while the card
    is kept busy (so no call waits for it): ``perf_counter`` over
    ``calls`` calls behind a spin of 4 x :data:`FILL_CYCLES`."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(4 * FILL_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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
        # the test ops.gather_rows makes before the raw call, whether
        # autograd records (False here, as under the engine's
        # inference_mode: src needs no gradient)
        "autograd_check": lambda: src.requires_grad
        and torch.is_grad_enabled(),
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
    micro-batch of hits (the wrapper, and the engine's ``ops.gather_rows``
    under ``inference_mode``, host microseconds a call)."""
    from repro_torch.kernels import cache_gather as kgather, ops, ref
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
    # the engine's call: ops.gather_rows under inference_mode, with the
    # test that keeps autograd out of it
    with torch.inference_mode():
        hosts["ops_host_us"] = host_us(lambda: ops.gather_rows(src, idx))
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
                          f"[{n_hot}, {out_dim}] f32 (the engine's call); "
                          "per_launch.train: the training slice's "
                          "local-tier pull",
            "per_launch": {"serve": {
                "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
                "library_ms": t["library_ms"], "bound_ms": b,
                "bound_by": by, "shape": [n_hot, out_dim, max_batch]}}}


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


SWEEP_DVALS_LANES = (8, 16, 32)


def sweep_dvals(sp, gen) -> None:
    """Every feature stripe and lanes-per-slot of the ``d_vals`` kernel on
    the training slice's pack at d = 256 (``DVALS_STRIPE_BYTES`` and
    ``DVALS_LANES`` set to it for the call), each checked against the plain
    version, timed in turns."""
    from repro_torch.kernels import ell_spmm as kell, ref
    dev = torch.device("cuda")
    cols = torch.as_tensor(sp.ell.cols, device=dev)
    vals = torch.as_tensor(sp.ell.vals, device=dev)
    n_parts, n_rows, _ = cols.shape
    n_cols, d = sp.n_inner_max + sp.n_halo_max, 256
    g = torch.randn((n_parts, n_rows, d), generator=gen, device=dev)
    h = torch.randn((n_parts, n_cols, d), generator=gen, device=dev)
    want = ref.ell_spmm_bwd_ref(cols, vals, h, g, n_cols, need_h=False)[0]
    chosen = (kell.DVALS_STRIPE_BYTES, kell.DVALS_LANES)

    def with_config(stripe_bytes, lanes):
        kell.DVALS_STRIPE_BYTES, kell.DVALS_LANES = stripe_bytes, lanes
        try:
            return kell.ell_spmm_dvals(cols, g, h)
        finally:
            kell.DVALS_STRIPE_BYTES, kell.DVALS_LANES = chosen

    fns, errs, used = {}, {}, {}
    for sb in SWEEP_STRIPE_BYTES:
        for lanes in SWEEP_DVALS_LANES:
            kell.DVALS_STRIPE_BYTES, kell.DVALS_LANES = sb, lanes
            config = kell.dvals_launch_config(d, 0)
            kell.DVALS_STRIPE_BYTES, kell.DVALS_LANES = chosen
            if config in used.values():
                continue
            key = f"stripe{sb}B_lanes{lanes}"
            used[key] = config
            fns[key] = lambda sb=sb, lanes=lanes: with_config(sb, lanes)
            errs[key] = check_close(f"ell_spmm_dvals {key}", fns[key](), want)
    t = time_calls(fns, reps=5)
    for key, (vec, stripe, lanes) in used.items():
        emit("sweep", name="ell_spmm_dvals", config=key, vec=vec,
             stripe_bytes=stripe * vec * 4, lanes_per_slot=lanes,
             stripes=-(-d // (stripe * vec)), ms=t[key],
             max_abs_err=errs[key],
             chosen=(key == f"stripe{chosen[0]}B_lanes{chosen[1]}"))
    del g, h, want
    torch.cuda.empty_cache()


def ptxas_report(names=None) -> None:
    """Each kernel's registers, shared memory and spills as ``nvcc -Xptxas
    -v`` reports them, and the occupancy its registers allow (4-warp
    blocks for the ELL forward and the CSR long rows' sums, 8 for the
    others), for the sources ``names`` (all by default)."""
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
    for name in names or build.SOURCES:
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
            warps = (4 if name in ("ell_spmm", "ell_spmm_bwd")
                     and "sum_stripes" not in fn or "long_rows" in fn
                     else 8)
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(32, 65536 // (per_warp * warps))
            emit("ptxas", source=f"csrc/{name}.cu", kernel=fn,
                 registers=regs, smem_bytes=int(smem[1]) if smem else 0,
                 spill_stores=int(st), spill_loads=int(ld),
                 warps_per_sm=min(64, blocks * warps))


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------

class CpuChecks:
    """The card-vs-CPU checks' CPU passes, one after another on a thread
    of their own beside the card's later phases (torch's CPU operations
    release the GIL), each with ``CPU_CHECK_THREADS`` intra-op threads.
    :meth:`finish` waits for each, holds it against the card's result and
    prints it as ``{name}_cpu_check``; a check that fails fails the
    script there."""

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor
        self.pool = ThreadPoolExecutor(1, initializer=torch.set_num_threads,
                                       initargs=(CPU_CHECK_THREADS,))
        self.pending = []

    def submit(self, name: str, cpu_pass, compare) -> None:
        """Run ``cpu_pass()`` on the thread; :meth:`finish` calls
        ``compare`` on its result and its seconds, which raises past its
        tolerance and returns the fields to print."""
        def timed():
            t0 = time.perf_counter()
            return cpu_pass(), time.perf_counter() - t0
        self.pending.append((name, self.pool.submit(timed), compare))

    def finish(self) -> None:
        t0 = time.perf_counter()
        for name, fut, compare in self.pending:
            res, seconds = fut.result()
            emit(f"{name}_cpu_check", **compare(res, seconds),
                 waited_s=time.perf_counter() - t0)
        self.pending.clear()
        self.pool.shutdown()


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


def phase_main(name: str, argv: list[str], ctx, checks: CpuChecks,
               check_scale: str | None = None) -> dict:
    """The serving slice of ``argv`` through ``launch.serve``'s own entry
    (``ctx``: the host plan of its flags, for the CPU pass), its launches
    counted from zero: per layer one ELL forward and one CSR tail launch
    (SAGE two of each: its ``degree()``), no backward, no pack built for
    a call, a gather per micro-batch with hot hits; its tables against
    the same pass on the CPU, and served answers against the CPU's
    logits (the CPU pass and both comparisons through ``checks``).  With
    ``check_scale``, the card's and the CPU's passes run the same flags
    and parameters at that scale (their own host plan), and the served
    answers are held against the card's own tables."""
    from repro_torch.kernels import cache_gather as kgather
    from repro_torch.kernels import csr_spmm as kcsr, ell_spmm as kell, ops
    from repro_torch.launch.serve import (build_parser, plan_and_stack,
                                          prepare_gnn, serve_gnn)
    from repro_torch.serve import precompute_embeddings

    args = build_parser().parse_args(argv)

    counters = {"ell_spmm": kell.ell_spmm,
                "csr_spmm_tail": kcsr.csr_spmm_accumulate,
                "csr_spmm_dh": kcsr.csr_spmm,
                "gather_rows": kgather.gather_rows}
    for fn in counters.values():
        fn.launches = 0
    ops.pack_for_call.builds = 0
    t0 = time.perf_counter()
    report, engine = serve_gnn(args)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["packs_built_for_a_call"] = ops.pack_for_call.builds

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
    # one precompute pass: per layer one ELL forward and one CSR launch over
    # the COO tail (SAGE: and its degree's); no backward, and every pack
    # built in make_adj_builder
    per_pass = cfg.num_layers * (2 if cfg.model == "sage" else 1)
    want = {"ell_spmm": per_pass, "csr_spmm_tail": per_pass,
            "csr_spmm_dh": 0, "packs_built_for_a_call": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"serving launches {launches}, want {want}")
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
    # (at check_scale: both passes on that scale's host plan)
    card_tables = store.tables
    if check_scale is not None:
        cargs = build_parser().parse_args(
            with_backend(argv, args.backend, check_scale))
        ctask, ps, cprofiles, _ = prepare_gnn(cargs)
        xplan, sp = plan_and_stack(cargs, ctask, ps, cprofiles, cfg)
        card_tables = precompute_embeddings(
            cfg, ps, sp, xplan, engine.params, backend=args.backend,
            device=args.device).tables
    cpu_params = [{k: v.cpu() for k, v in p.items()} for p in engine.params]
    # served answers: hot hits (row gather) and host misses (host store)
    rng = np.random.default_rng(args.seed)
    sample = np.concatenate([engine.hot_ids[:64],
                             rng.choice(n, 64, replace=False)])
    served = engine.lookup(sample)
    served_against = "card tables" if check_scale else "CPU pass"

    def compare(cpu_store, cpu_pass_s):
        errs = [float(np.abs(a - b).max())
                for a, b in zip(card_tables, cpu_store.tables)]
        if errs[-1] > LOGITS_ATOL:
            raise AssertionError(f"{name}: card logits differ from the CPU "
                                 f"pass by {errs[-1]} > {LOGITS_ATOL}")
        want_logits = store.logits if check_scale else cpu_store.logits
        serve_err = float(np.abs(served - want_logits[sample]).max())
        if serve_err > LOGITS_ATOL:
            raise AssertionError(f"{name}: served logits differ from the "
                                 f"{served_against} by {serve_err}")
        return {"cpu_pass_s": cpu_pass_s,
                "compared_at_scale": float(check_scale or args.scale),
                "table_max_abs_err": errs, "served_max_abs_err": serve_err,
                "served_held_against": served_against}
    checks.submit(name, lambda: precompute_embeddings(
        cfg, ps, sp, xplan, cpu_params, backend=args.backend, device="cpu"),
        compare)

    fields = ("precompute_s", "qps", "p50_ms", "p99_ms", "hot_hit_rate",
              "host_hit_rate", "host_fetch_ms", "batches", "mean_batch",
              "busy_s")
    emit(name, argv=argv, model=cfg.model, nodes=n, parts=sp.num_parts,
         hybrid_pack=list(sp.ell.cols.shape), tail_width=sp.ell.tail_width,
         launches=launches, hot_batches=n_hot_batches,
         **{k: report[k] for k in fields},
         wall_s=wall_s, host_plan_s=ctx["host_plan_s"],
         device_pass_s=device_pass_s)
    return launches


# the serving slice's freshness path: 0.5% of the nodes' features updated
# (446 of 89,250), stale queries recomputed over their fresh_hops-hop
# in-neighbourhood (fresh_hops: the layer count)
SERVE_FRESH_FLAGS = ["--update-frac", "0.005"]
FRESH_CHECK_ROWS = 64     # stale nodes served on the card, recomputed on the CPU


def stale_by_ids(graph, updated: np.ndarray, hops: int) -> np.ndarray:
    """The nodes within ``hops`` forward hops of ``updated`` (along
    src -> dst, the updates included), as products of a boolean vector
    with the graph's sparse matrix: the stale set an update gives,
    worked out apart from the engine's BFS."""
    import scipy.sparse as sps
    n = graph.num_nodes
    a = sps.csr_matrix((np.ones(graph.indices.size, np.float32),
                        graph.indices, graph.indptr), shape=(n, n))
    seen = np.zeros(n, bool)
    seen[updated] = True
    frontier = seen.astype(np.float32)
    for _ in range(hops):
        frontier = (a.T @ frontier > 0) & ~seen
        seen |= frontier
        frontier = frontier.astype(np.float32)
    return seen


def phase_serve_fresh(ctx: dict, checks: CpuChecks) -> dict:
    """The serving slice with :data:`SERVE_FRESH_FLAGS` through
    ``launch.serve``'s entry, traced, its launches counted from zero: the
    precompute's ELL and tail launches, and a gather for the precompute's
    tier pulls, the warm-up and each micro-batch with a clean hot hit.
    The update replayed from the seed gives the engine's stale set
    (:func:`stale_by_ids`), and the ids give every count of the stream
    (recomputes, hot and host hits, batches).  A fixed batch of
    :data:`FRESH_CHECK_ROWS` stale nodes served on the card is held
    within ``LOGITS_ATOL`` of a CPU engine's recompute on the same store,
    parameters and updated features (through ``checks``).  Prints qps,
    p50 / p99 and the ``fresh_recompute`` spans' count and total."""
    from repro_torch.launch.serve import build_parser, serve_gnn, slice_stream
    from repro_torch.serve import BatchConfig, GNNServeEngine, plan_batches

    argv = SLICE_ARGV + SERVE_FRESH_FLAGS + [
        "--trace", "--trace-dir", str(OUT_DIR / "serve_fresh")]
    args = build_parser().parse_args(argv)
    zero_counts()
    t0 = time.perf_counter()
    report, engine = serve_gnn(args)
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    task, g, cfg = ctx["task"], engine.graph, engine.cfg
    n = g.num_nodes
    # the CLI's update, replayed from its seed
    rng = np.random.default_rng(args.seed)
    upd = rng.choice(n, max(1, int(args.update_frac * n)), replace=False)
    new_feats = task.features[upd] + rng.normal(
        scale=0.5, size=(upd.size, task.features.shape[1]))
    stale = stale_by_ids(g, upd, cfg.num_layers)
    if not np.array_equal(stale, engine.stale):
        raise AssertionError(f"the engine marks {int(engine.stale.sum())} "
                             f"nodes stale, the update gives "
                             f"{int(stale.sum())}")
    # every count of the stream, from the ids
    stream = slice_stream(args, g)
    batches = plan_batches(stream.t, BatchConfig(args.max_batch,
                                                 args.deadline_ms))
    q, hot = stream.node, engine.hot_slot >= 0
    want = {"queries": int(q.size), "hot_hits": int((~stale[q] & hot[q]).sum()),
            "host_hits": int((~stale[q] & ~hot[q]).sum()),
            "fresh_recomputes": int(stale[q].sum()), "batches": len(batches)}
    got = {k: engine.stats[k] for k in want}
    if got != want or not report["fresh_rate"] > 0:
        raise AssertionError(f"serve_fresh: counts {got}, the ids give "
                             f"{want}; fresh_rate {report['fresh_rate']}")
    # launches: the precompute's (one ELL and one tail launch a layer, its
    # tier pulls), then a gather for the warm-up and each micro-batch
    # with a clean hot hit ...
    hot_batches_clean = sum(int((~stale[q[b.idx]] & hot[q[b.idx]]).any())
                            for b in batches)
    pulls = gather_launches(ctx["xplan"], cfg.num_layers - 1)[
        "evaluation"]["gather_rows"]
    spans = [sp.dur for sp in engine.tracer.spans
             if sp.name == "fresh_recompute"]
    if len(spans) != sum(int(stale[q[b.idx]].any()) for b in batches):
        raise AssertionError(f"{len(spans)} fresh_recompute spans")
    # and each recompute's layers over its subgraph's pack, built on the
    # card: one edge-list CSR launch a layer
    want_l = {**{k: 0 for k in launches}, "ell_spmm": cfg.num_layers,
              "csr_spmm_tail": cfg.num_layers,
              "gather_rows": pulls + 1 + hot_batches_clean,
              "edge_spmm": cfg.num_layers * len(spans)}
    if launches != want_l:
        raise AssertionError(f"serve_fresh: launches {launches}, want "
                             f"{want_l}")

    # a fixed batch of stale nodes: served on the card, recomputed on the CPU
    _, first = np.unique(q[stale[q]], return_index=True)
    rows = q[stale[q]][np.sort(first)][:FRESH_CHECK_ROWS]
    served = engine.query(rows)
    cpu_params = [{k: v.cpu() for k, v in p.items()} for p in engine.params]
    cpu_engine = GNNServeEngine(engine.store, cpu_params, g, engine.hot_ids,
                                features=task.features, device="cpu")
    cpu_engine.update_features(upd, new_feats)
    if not (np.array_equal(cpu_engine.features, engine.features)
            and np.array_equal(cpu_engine.stale, engine.stale)):
        raise AssertionError("the CPU engine's update differs from the "
                             "card's")

    def compare(cpu_rows, cpu_s):
        err = float(np.abs(served - cpu_rows).max())
        if err > LOGITS_ATOL:
            raise AssertionError(f"serve_fresh: recomputed rows differ from "
                                 f"the CPU engine's by {err}")
        return {"rows": int(rows.size), "rows_max_abs_err": err,
                "cpu_recompute_s": cpu_s}
    checks.submit("serve_fresh", lambda: cpu_engine.query(rows), compare)

    fields = ("precompute_s", "qps", "p50_ms", "p99_ms", "fresh_rate",
              "hot_hit_rate", "host_hit_rate", "batches", "mean_batch",
              "busy_s", "stale_nodes")
    emit("serve_fresh", argv=argv, nodes=n, updated=int(upd.size),
         stale_frac=float(stale.mean()), counts=got, launches=launches,
         **{k: report[k] for k in fields},
         fresh_recompute={"spans": len(spans), "total_s": float(sum(spans)),
                          "p50_ms": 1e3 * float(np.median(spans)),
                          "max_ms": 1e3 * float(max(spans))},
         wall_s=wall_s)
    return launches


# the two GNN example twins at their defaults, on the card and (in a child
# process, beside the card) on the CPU
EXAMPLES = ("heterogeneous_rapa_torch", "serve_gnn_torch")
EXAMPLE_THREADS = 2


def load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_cpu_child() -> subprocess.Popen:
    """Both example twins' ``main(device="cpu")`` in a child process with
    :data:`EXAMPLE_THREADS` threads; its last line is their figures as
    one JSON object."""
    code = ("import json, sys, torch\n"
            f"torch.set_num_threads({EXAMPLE_THREADS})\n"
            "sys.path[:0] = ['src', '.']\n"
            "import chip_smoke\n"
            "out = {n: chip_smoke.load_example(n).main(device='cpu')\n"
            "       for n in chip_smoke.EXAMPLES}\n"
            "print(json.dumps(out, default=float))\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


SERVE_EXAMPLE_FIELDS = ("queries", "batches", "mean_batch", "hot_hit_rate",
                        "host_hit_rate", "fresh_rate")


def phase_examples() -> dict:
    """``examples/heterogeneous_rapa_torch.py`` and ``serve_gnn_torch.py``
    at their defaults on the card, each with its launches counted from
    zero and its printed lines kept, against the same twins on the CPU:
    the lambda table (uniform and RAPA max-cost of x2 to x8, host numpy)
    and the x8 run's bytes, reduction, step kinds and spec equal, its
    losses finite and falling; the serving walkthrough's counts equal."""
    import contextlib
    import io
    child = examples_cpu_child()
    card, printed, by_path = {}, {}, {}
    for name in EXAMPLES:
        zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = load_example(name).main(device="cuda")
        torch.cuda.synchronize()
        card[name] = json.loads(json.dumps(res, default=float))
        card[name]["wall_s"] = time.perf_counter() - t0
        printed[name] = buf.getvalue().splitlines()
        by_path["example_" + name.removesuffix("_torch")] = read_counts()
    out, err = child.communicate(timeout=600)
    if child.returncode:
        raise AssertionError(f"examples' CPU pass failed: {err[-2000:]}")
    cpu = json.loads(out.strip().splitlines()[-1])

    het, het_cpu = card[EXAMPLES[0]], cpu[EXAMPLES[0]]
    for k in ("groups", "comm_bytes", "comm_bytes_vanilla", "comm_reduction",
              "step_kinds", "spec"):
        if het[k] != het_cpu[k]:
            raise AssertionError(f"heterogeneous_rapa: {k} {het[k]} on the "
                                 f"card, {het_cpu[k]} on the CPU")
    losses = het["losses"]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"heterogeneous_rapa: losses {losses}")
    srv, srv_cpu = card[EXAMPLES[1]], cpu[EXAMPLES[1]]
    for k in ("tables", "nodes", "updated", "stale"):
        if srv[k] != srv_cpu[k]:
            raise AssertionError(f"serve_gnn: {k} {srv[k]} on the card, "
                                 f"{srv_cpu[k]} on the CPU")
    for rep in ("report", "fresh_report"):
        got = {k: srv[rep][k] for k in SERVE_EXAMPLE_FIELDS}
        want = {k: srv_cpu[rep][k] for k in SERVE_EXAMPLE_FIELDS}
        if got != want:
            raise AssertionError(f"serve_gnn {rep}: {got} on the card, "
                                 f"{want} on the CPU")
    # both twins run the edges backend: the edge list's CSR kernel
    for path, counts in by_path.items():
        if counts["gather_rows"] == 0 or counts["ell_spmm"] != 0 or \
                counts["edge_spmm"] == 0:
            raise AssertionError(f"{path}: launches {counts}")
    emit("examples", printed=printed, launches=by_path,
         heterogeneous_rapa={
             "groups": het["groups"], "comm_reduction": het["comm_reduction"],
             "losses": losses, "loss_max_abs_err_vs_cpu": float(np.abs(
                 np.subtract(losses, het_cpu["losses"])).max()),
             "test_acc": het["test_acc"], "test_acc_cpu": het_cpu["test_acc"],
             "wall_s": het["wall_s"]},
         serve_gnn={rep: {k: srv[rep][k] for k in
                          SERVE_EXAMPLE_FIELDS + ("qps", "p50_ms", "p99_ms")}
                    for rep in ("report", "fresh_report")}
         | {"stale": srv["stale"], "wall_s": srv["wall_s"]})
    return by_path


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


def gather_launches(xplan, n_exchanged: int) -> dict:
    """The row gather's launches a step of each kind (and an evaluation)
    gives, worked out from the exchange plan's arrays (not from the
    runtime's maps): per exchanged layer, one forward for each tier pull
    with a non-empty index (the uncached and local tiers, the global
    buffer's fill and its reads; one gather each on an f32 halo), and one
    CSR backward for each of those the step differentiates.  A refresh
    step differentiates every pull; a cached step the uncached tier (the
    local and global tiers are constant caches); a pipelined step the
    uncached tier too, its fresh local and global rows pulled outside
    autograd; an evaluation none."""
    size = {k: int(np.asarray(a).size > 0) for k, a in (
        ("un", xplan.uncached.recv_src_part),
        ("loc", xplan.local.recv_src_part), ("fill", xplan.glob.src_part),
        ("read", xplan.glob.read_buf_idx))}
    every = sum(size.values())
    fwd = {"refresh": every, "cached": size["un"] + size["read"],
           "pipelined": every, "evaluation": every}
    bwd = {"refresh": every, "cached": size["un"], "pipelined": size["un"],
           "evaluation": 0}
    return {k: {"gather_rows": n_exchanged * fwd[k],
                "gather_rows_bwd": n_exchanged * bwd[k]} for k in fwd}


# The training cell's plan puts every halo row in the local tier (the
# uncached and global tiers are empty): one local-tier pull per exchanged
# layer (1 and 2) in the refresh step, the pipelined step and the closing
# evaluation, and a backward for each of the refresh step's two
TRAIN_GATHERS = {"gather_rows": 6, "gather_rows_bwd": 2}


def steady_step_ms(rt, params, opt_state, steps: int = 3) -> dict:
    """Median host ms of ``steps`` steps of each kind from the trained
    state, each fenced by reading its loss (the run's own step 0 is a
    refresh step that also builds the kernels)."""
    out = {}
    for kind in ("refresh", "cached", "pipelined"):
        step, times = getattr(rt, f"step_{kind}"), []
        state = (params, opt_state, rt.caches0)
        for _ in range(steps):
            t0 = time.perf_counter()
            *state, m = step(*state)
            float(m["loss"])
            times.append(1e3 * (time.perf_counter() - t0))
        out[kind] = statistics.median(times)
    return out


def train_counters() -> dict:
    from repro_torch.kernels import cache_gather as kgather
    from repro_torch.kernels import csr_spmm as kcsr, edge_spmm as kedge
    from repro_torch.kernels import ell_spmm as kell
    return {"ell_spmm": kell.ell_spmm,
            "ell_spmm_chunked": kell.ell_spmm_chunked,
            "csr_spmm_tail": kcsr.csr_spmm_accumulate,
            "csr_spmm_dh": kcsr.csr_spmm,
            "ell_spmm_dvals": kell.ell_spmm_dvals,
            "gather_rows": kgather.gather_rows,
            "gather_rows_bwd": kgather.gather_rows_bwd,
            "edge_spmm": kedge.edge_spmm,
            "edge_spmm_dh": kedge.edge_spmm_dh,
            "edge_dvals": kedge.edge_dvals}


def zero_counts() -> None:
    from repro_torch.kernels import ops
    for fn in train_counters().values():
        fn.launches = 0
    ops.pack_for_call.builds = 0


def read_counts() -> dict:
    from repro_torch.kernels import ops
    out = {k: fn.launches for k, fn in train_counters().items()}
    out["packs_built_for_a_call"] = ops.pack_for_call.builds
    return out


def train_launches(backend: str, layers: int, kinds: list[str],
                   gathers: dict, model: str = "gcn") -> dict:
    """The launches a training run gives: each step and the closing
    evaluation run every layer's forward once (the ELL kernel under
    ``ell`` and ``hybrid``, the tail's CSR kernel under ``hybrid``, the
    edge list's CSR kernel under ``edges``; a SAGE layer twice under
    ``ell`` and ``hybrid``, its ``degree()`` being the same product of a
    ones column, recomputed per call, and once under ``edges``, whose
    ``degree()`` is a segment sum; a GAT layer once, its heads in one
    launch); the backward needs ``d_h`` from layer 1 on (layer 0's input
    is constant, and the ones column has no gradient), but from layer 0
    on for GAT, whose heads' inputs are ``h @ w``, with one
    ``edge_dvals`` for all the heads (their attention's gradient); the
    ELL ``d_vals``
    never (the ELL values are constants of the graph); the gathers as
    each step kind gives them (``gathers``, per kind); every pack comes
    from ``make_adj_builder`` or the exchange maps."""
    passes, steps = len(kinds) + 1, len(kinds)
    ell = backend != "edges"
    fwd = layers * passes * (2 if model == "sage" and ell else 1)
    dh = (layers if model == "gat" else layers - 1) * steps
    return {"ell_spmm": fwd if ell else 0,
            "ell_spmm_chunked": 0,
            "csr_spmm_tail": fwd if backend == "hybrid" else 0,
            "csr_spmm_dh": dh if ell else 0,
            "ell_spmm_dvals": 0,
            **{k: sum(gathers[kind][k] for kind in kinds + ["evaluation"])
               for k in ("gather_rows", "gather_rows_bwd")},
            "edge_spmm": 0 if ell else fwd,
            "edge_spmm_dh": 0 if ell else dh,
            "edge_dvals": dh if model == "gat" else 0,
            "packs_built_for_a_call": 0}


def refresh_grads(cfg, spec, sp, xplan, params0, lr: float, device,
                  rt=None) -> tuple[float, list, float]:
    """One refresh step's loss and gradients (on the CPU) and its seconds,
    on ``device`` from ``params0`` (on ``rt``, or a runtime built
    here)."""
    from repro_torch.dist import make_sim_runtime
    from repro_torch.optim import adam
    if rt is None:
        rt = make_sim_runtime(cfg, sp, xplan, adam(lr), spec=spec,
                              device=device)
    t0 = time.perf_counter()
    loss, grads = rt.loss_and_grads(
        [{k: v.to(device) for k, v in p.items()} for p in params0],
        rt.caches0)
    return (float(loss), [{k: v.cpu() for k, v in g.items()} for g in grads],
            time.perf_counter() - t0)


def card_vs_cpu(name: str, cfg, spec, sp, xplan, seed: int, lr: float,
                card: str, checks: CpuChecks, card_rt=None) -> dict:
    """One refresh step's loss and gradients on the card (``card_rt``, or
    a runtime built here on ``card``) and on the CPU from the same
    parameters (``init_gnn`` of ``seed``), the CPU's through ``checks``:
    it raises past ``LOSS_ATOL`` / ``GRAD_RTOL``.  Returns the card's
    parameters, loss and gradients, the reference of the SPMD phases."""
    from repro_torch.models.gnn import init_gnn
    params0 = init_gnn(cfg, torch.Generator().manual_seed(seed), "cpu")
    loss, grads, _ = refresh_grads(cfg, spec, sp, xplan, params0, lr, card,
                                   card_rt)

    def compare(res, cpu_s):
        loss_err = abs(loss - res[0])
        if loss_err > LOSS_ATOL:
            raise AssertionError(f"{name}: refresh-step loss differs from "
                                 f"the CPU's by {loss_err}")
        return {"refresh_loss_card": loss, "refresh_loss_cpu": res[0],
                "refresh_loss_err": loss_err,
                "refresh_grad_err": grads_err(grads, res[1]),
                "cpu_refresh_step_s": res[2]}
    cpu_params = [{k: v.clone() for k, v in q.items()} for q in params0]
    checks.submit(name, lambda: refresh_grads(cfg, spec, sp, xplan,
                                              cpu_params, lr, "cpu"),
                  compare)
    return {"params0": params0, "loss": loss, "grads": grads}


def sgd_trajectories(args) -> dict:
    """An 8-step SGD run of ``args``' flags at ``TRAIN_SGD_SCALE`` on the
    card and on the CPU; raises past ``TRAJ_ATOL``."""
    from repro_torch.core import StalenessController
    from repro_torch.dist import make_sim_runtime, train_capgnn
    from repro_torch.launch.train import prepare_train
    from repro_torch.optim import sgd
    args01 = argparse.Namespace(**{**vars(args), "scale":
                                   float(TRAIN_SGD_SCALE)})
    ctx01 = prepare_train(args01)
    trajs = {}
    for dev in (args.device, "cpu"):
        rt01 = make_sim_runtime(ctx01["cfg"], ctx01["sp"], ctx01["xplan"],
                                sgd(args.lr), spec=ctx01["spec"], device=dev)
        _, r01 = train_capgnn(
            ctx01["cfg"], rt01, ctx01["xplan"], args.parts, sgd(args.lr),
            epochs=args.epochs,
            controller=StalenessController(refresh_every=args.refresh_every),
            spec=ctx01["spec"])
        trajs[dev] = r01.losses
    traj_err = float(np.abs(np.subtract(trajs[args.device],
                                        trajs["cpu"])).max())
    if traj_err > TRAJ_ATOL:
        raise AssertionError(f"SGD trajectory differs from the CPU's by "
                             f"{traj_err}: {trajs}")
    return {"sgd_scale": float(TRAIN_SGD_SCALE), "sgd_losses": trajs,
            "sgd_traj_err": traj_err}


def schedule_kinds(args, drifts: list | None = None) -> list[str]:
    """The step kinds the training loop gives ``args``' flags: a refresh
    every ``--refresh-every`` steps, pipelined after step 0 unless
    ``--no-pipeline``, cached otherwise; under ``--adaptive-staleness``
    the period follows ``drifts`` (each step's measured drift, None where
    it measured none) as ``StalenessController`` sets it."""
    from repro_torch.core import StalenessController
    ctl = StalenessController(refresh_every=args.refresh_every,
                              adaptive=args.adaptive_staleness)
    kinds = []
    for e in range(args.epochs):
        refresh = ctl.should_refresh()
        kinds.append("cached" if not refresh else
                     "pipelined" if args.pipeline and e > 0 else "refresh")
        ctl.observe(drifts[e] if drifts else None, refreshed=refresh)
    return kinds


def phase_train(name: str, argv: list[str], checks: CpuChecks,
                ctx: dict | None = None, check_scale: str | None = None,
                sgd_check: bool = False, cell_gathers: dict | None =
                TRAIN_GATHERS, cpu_check: bool = True
                ) -> tuple[dict, dict, dict | None]:
    """One training cell through launch.train's entry (``ctx``: the host
    plan of the same flags but the stacking, reused; built when None).

    Checks: the step kinds (:func:`schedule_kinds`; under
    ``--adaptive-staleness`` from the drifts the run's tracer measured),
    the launches of the backend (the counters zeroed just before the run
    and read just after; the gathers worked out from the plan's arrays,
    at full scale also against ``cell_gathers``, the cell's stated
    counts), finite falling losses, the bytes equal to the plan's; with
    ``cpu_check``, one refresh step's loss and gradients on the card
    against the CPU (through ``checks``; at ``check_scale`` when given:
    the same flags at that scale), and with ``sgd_check`` an 8-step SGD
    trajectory at ``TRAIN_SGD_SCALE``.  Returns the launches, the run's
    context and the card's refresh step (parameters, loss, gradients;
    None without ``cpu_check``)."""
    from repro_torch.launch.train import build_parser, prepare_train, train_gnn

    args = build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out, ctx = train_gnn(args, ctx)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    rep, cfg, spec, xplan = ctx["report"], ctx["cfg"], ctx["spec"], ctx["xplan"]
    rt, sp = ctx["runtime"], ctx["sp"]
    epochs, layers = args.epochs, cfg.num_layers
    kinds = rep.step_kinds
    drifts = ([c.drift for c in ctx["tracer"].counters]
              if ctx["tracer"] is not None else None)
    if args.adaptive_staleness and drifts is None:
        raise AssertionError(f"{name}: an adaptive run needs --trace for "
                             "its drifts")
    if kinds != schedule_kinds(args, drifts):
        raise AssertionError(f"{name}: step kinds {kinds}, the schedule "
                             f"gives {schedule_kinds(args, drifts)}")
    per_kind = gather_launches(xplan, layers - 1)
    want = train_launches(args.backend, layers, kinds, per_kind,
                          args.model)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    if cell_gathers is not None and args.scale == 1.0 and \
            {k: want[k] for k in cell_gathers} != cell_gathers:
        raise AssertionError(f"the plan gives the gathers {want}, the cell "
                             f"states {cell_gathers}: tier rows "
                             f"{xplan.uncached.n_rows} uncached, "
                             f"{xplan.local.n_rows} local, "
                             f"{xplan.glob.n_unique} global")
    losses = rep.losses
    if len(losses) != epochs or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    comm, vanilla = plan_bytes(cfg, spec, xplan, kinds)
    if (rep.comm_bytes, rep.comm_bytes_vanilla) != (comm, vanilla):
        raise AssertionError(f"{name}: bytes {rep.comm_bytes}/"
                             f"{rep.comm_bytes_vanilla}, the plan gives "
                             f"{comm}/{vanilla}")
    steady_ms = steady_step_ms(rt, ctx["params"], rep.final_opt_state)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one refresh step, card vs CPU, same parameters; on the card its tier
    # pulls' gradients go through the gather backward
    ref = None
    if cpu_check:
        if check_scale is None:
            check_cfg, check_sp, check_x, check_spec = cfg, sp, xplan, spec
        else:
            cargs = argparse.Namespace(**{**vars(args), "scale":
                                          float(check_scale)})
            cctx = prepare_train(cargs)
            check_cfg, check_sp, check_x, check_spec = (
                cctx["cfg"], cctx["sp"], cctx["xplan"], cctx["spec"])
            rt = None
        bwd0 = read_counts()["gather_rows_bwd"]
        ref = card_vs_cpu(name, check_cfg, check_spec, check_sp, check_x,
                          args.seed, args.lr, args.device, checks, rt)
        refresh_bwd = read_counts()["gather_rows_bwd"] - bwd0
        want_bwd = gather_launches(check_x, layers - 1)["refresh"][
            "gather_rows_bwd"]
        if refresh_bwd != want_bwd:
            raise AssertionError(f"{name}: the refresh check launched the "
                                 f"gather backward {refresh_bwd} times, "
                                 f"want {want_bwd}")
    del ctx["runtime"], rt
    torch.cuda.empty_cache()
    extra = sgd_trajectories(args) if sgd_check else {}

    step_ms = {k: statistics.median(1e3 * t for t, kk in
                                    zip(rep.step_s, kinds) if kk == k)
               for k in sorted(set(kinds))}
    pack = {}
    if sp.ell is not None:
        pack = {"ell_pack": list(sp.ell.cols.shape),
                "ell_pack_bytes": int(sp.ell.cols.nbytes + sp.ell.vals.nbytes),
                "tail_width": sp.ell.tail_width}
    emit(name, argv=argv, model=args.model, parts=args.parts,
         group=ctx["group"], nodes=ctx["task"].graph.num_nodes, **pack,
         n_edges_stacked=list(sp.e_src.shape),
         n_inner_max=sp.n_inner_max, n_halo_max=sp.n_halo_max,
         total_halo=xplan.total_halo,
         tier_rows={"uncached": xplan.uncached.n_rows,
                    "local": xplan.local.n_rows,
                    "global": xplan.glob.n_unique},
         losses=losses, final_loss=losses[-1], test_acc=out["test_acc"],
         comm_bytes=rep.comm_bytes, comm_bytes_vanilla=rep.comm_bytes_vanilla,
         comm_reduction=rep.comm_reduction,
         refresh_steps=rep.refresh_steps, cached_steps=rep.cached_steps,
         step_kinds=kinds, drifts=drifts, compile_s=rep.compile_s,
         stack_waste_frac=out["stack_waste_frac"],
         wall_time_s=rep.wall_time_s,
         wall_time_per_epoch_s=rep.wall_time_s / (epochs - 1),
         step_ms=[1e3 * t for t in rep.step_s], median_step_ms=step_ms,
         steady_step_ms=steady_ms, gather_launches_per_kind=per_kind,
         host_plan_s=ctx["host_plan_s"], launch_wall_s=wall_s,
         launches=launches, checked_at_scale=(
             float(check_scale or args.scale) if cpu_check else None),
         **extra, peak_mem_gb=peak_gb)
    return launches, ctx, ref


def with_backend(argv: list[str], backend: str,
                 scale: str | None = None, model: str | None = None
                 ) -> list[str]:
    out = list(argv)
    out[out.index("--backend") + 1] = backend
    if scale is not None:
        out[out.index("--scale") + 1] = scale
    if model is not None:
        out[out.index("--model") + 1] = model
    return out


def shared_context(ctx: dict, argv: list[str]) -> dict:
    """The host plan of ``ctx`` for flags that differ from its own in the
    backend or the model only: the partition, RAPA, JACA and the exchange
    plan are the same (every model has the same ``feat_dims``, which is
    all the plan reads of it); the layout is stacked anew for another
    backend."""
    import dataclasses as dc
    from repro_torch.dist import TrainSpec, stack_partitions
    from repro_torch.launch.train import build_parser
    t0 = time.perf_counter()
    args = build_parser().parse_args(argv)
    cfg = dc.replace(ctx["cfg"], model=args.model)
    if cfg.feat_dims != ctx["cfg"].feat_dims:
        raise AssertionError(f"{args.model}: feat_dims {cfg.feat_dims}")
    sp = (ctx["sp"] if args.backend == ctx["spec"].backend else
          stack_partitions(ctx["ps"], ctx["task"], backend=args.backend))
    keep = ("task", "ps", "profiles", "group", "xplan")
    return {**{k: ctx[k] for k in keep}, "cfg": cfg, "sp": sp,
            "spec": TrainSpec.from_cli_args(args),
            "host_plan_s": time.perf_counter() - t0}


# The paper's ablation rows (Table 8, ``benchmarks/overall.py``: Vanilla
# is zero cache capacity refreshed every step, no RAPA, no pipeline), the
# adaptive staleness control and its most heterogeneous group (Fig. 21):
# name -> (flags on top of TRAIN_ARGV, the run whose partition it
# shares: None for the CLI's own host pipeline).  The CaPGNN row is the
# ``train`` cell itself.
ABLATION = {
    "vanilla": (["--no-jaca", "--no-rapa", "--no-pipeline",
                 "--refresh-every", "1"], None),
    "jaca": (["--no-rapa", "--no-pipeline"], "vanilla"),
    "rapa": (["--no-jaca", "--no-pipeline", "--refresh-every", "1"],
             "train"),
    "jaca_rapa": (["--no-pipeline"], "train"),
    "adaptive": (["--adaptive-staleness", "--trace", "--trace-dir",
                  str(ROOT / "build" / "chip_smoke" / "adaptive")],
                 "train"),
    "x8": (["--parts", "8", "--group", "x8"], None),
}
ABLATION_CPU_CHECKED = ("vanilla", "x8")   # a refresh step against the CPU
ZERO_CAPACITY = ("vanilla", "rapa")         # every halo row uncached


def ablation_context(base: dict, argv: list[str]) -> dict:
    """The host plan of ``argv``'s flags on ``base``'s task, partition
    (METIS, and RAPA's result when ``base`` ran it) and stacking: JACA's
    capacity and exchange plan built anew for the flags
    (``launch.train.plan_exchange``)."""
    from repro_torch.dist import TrainSpec
    from repro_torch.launch.train import build_parser, plan_exchange
    t0 = time.perf_counter()
    args = build_parser().parse_args(argv)
    planner, xplan = plan_exchange(args, base["ps"], base["profiles"],
                                   base["cfg"])
    keep = ("task", "ps", "profiles", "group", "cfg", "sp")
    return {**{k: base[k] for k in keep}, "planner": planner,
            "xplan": xplan, "spec": TrainSpec.from_cli_args(args),
            "host_plan_s": time.perf_counter() - t0}


def phase_train_ablation(tctx: dict, checks: CpuChecks) -> dict:
    """The configurations of :data:`ABLATION` at the train cell's width,
    each through ``launch.train``'s entry and :func:`phase_train`'s
    checks (its line ``train_<name>``): the step kinds of its schedule,
    its launches counted from zero, falling losses, ``comm_bytes`` and
    ``comm_bytes_vanilla`` equal to :func:`plan_bytes` of the run's own
    kinds and plan; ``vanilla`` and ``x8`` also a refresh step against
    the CPU at ``TRAIN_SGD_SCALE``.  Then the ``train_ablation`` line:
    the reduction exactly 0.0 for the zero-capacity rows, the vanilla
    halo rows (``comm_bytes_vanilla`` over the exchanged widths' bytes)
    equal across the runs that share one partition, and the step ms by
    kind of every row beside the CaPGNN cell's."""
    ctxs, by_path, rows = {"train": tctx}, {}, {}
    shared = {"train": ["capgnn"]}
    for name, (flags, base) in ABLATION.items():
        argv = TRAIN_ARGV + flags
        ctx = None if base is None else ablation_context(ctxs[base], argv)
        checked = name in ABLATION_CPU_CHECKED
        by_path[f"train_{name}"], ctxs[name], _ = phase_train(
            f"train_{name}", argv, checks, ctx,
            check_scale=TRAIN_SGD_SCALE if checked else None,
            cell_gathers=None, cpu_check=checked)
        torch.cuda.empty_cache()
        shared.setdefault(base or name, []).append(name)
    reports = {"capgnn": tctx["report"],
               **{name: ctxs[name]["report"] for name in ABLATION}}
    for name in ZERO_CAPACITY:
        if reports[name].comm_reduction != 0.0:
            raise AssertionError(f"train_{name}: comm_reduction "
                                 f"{reports[name].comm_reduction}, want 0.0")
    # runs on one partition count the same vanilla halo rows: 8 steps of
    # every halo row, over the widths each exchanges (layer 0's features
    # too without JACA: nothing replicates them)
    halo_rows = {}
    for base, names in shared.items():
        got = {}
        for n in names:
            c = ctxs["train" if n == "capgnn" else n]
            dims = c["cfg"].feat_dims[:c["cfg"].num_layers]
            dims = dims[0 if c["spec"].exchange_layer0 else 1:]
            got[n] = reports[n].comm_bytes_vanilla / (4 * sum(dims))
        if len(set(got.values())) != 1:
            raise AssertionError(f"the vanilla halo rows differ on {base}'s "
                                 f"partition: {got}")
        halo_rows[base] = got
    for name, rep in reports.items():
        rows[name] = {
            "comm_bytes": rep.comm_bytes,
            "comm_bytes_vanilla": rep.comm_bytes_vanilla,
            "comm_reduction": rep.comm_reduction,
            "step_kinds": rep.step_kinds, "median_step_ms": {
                k: statistics.median(1e3 * t for t, kk in
                                     zip(rep.step_s, rep.step_kinds)
                                     if kk == k)
                for k in sorted(set(rep.step_kinds))},
            "final_loss": rep.losses[-1]}
    emit("train_ablation", vanilla_halo_rows=halo_rows, rows=rows)
    return by_path


EDGE_D = 256          # the train cell's hidden width: layers 1-2's aggregation
EDGE_DVALS_D = 64     # a GAT head's width at the paper's hidden 256, 4 heads
GAT_HEADS = 4         # GNNConfig().num_heads


def pack_matrix(pack):
    """A CSR pack's entries as a coalesced torch CSR tensor (repeated
    entries summed), for the library yardsticks ``torch.sparse.mm`` and
    ``torch.sparse.sampled_addmm``."""
    rows = torch.repeat_interleave(
        torch.arange(pack.n_rows, device=pack.col.device),
        (pack.rowptr[1:] - pack.rowptr[:-1]).long())
    return torch.sparse_coo_tensor(
        torch.stack([rows, pack.col.long()]), pack.w,
        (pack.n_rows, pack.n_cols)).coalesce().to_sparse_csr()


def dvals_bytes(pack, d: int, n_edges: int) -> float:
    """Bytes ``edge_dvals`` needs on these inputs: each entry's col and
    perm once, the g row of each row with entries and each named h row
    once (f32), each edge's value written once."""
    g_rows = int((pack.rowptr[1:] > pack.rowptr[:-1]).sum())
    h_rows = torch.unique(pack.col).numel()
    return float(pack.nnz * 8 + (g_rows + h_rows) * d * 4 + n_edges * 4)


def edge_entry(name: str, source: str, replaces: str, t: dict, err: float,
               b: float, by: str, prefix: str = "", **extra) -> dict:
    """A kernels-line entry of the edge list's route from its timings
    ``t`` (``<prefix>kernel_ms`` / ``plain_ms`` / ``library_ms``)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err,
            "ms": t[prefix + "kernel_ms"], "plain_ms": t[prefix + "plain_ms"],
            "bound_ms": b, "bound_by": by,
            "library_ms": t[prefix + "library_ms"], **extra}


def phase_coo_spmm(sp, gen, dev="cuda") -> list[dict]:
    """The ``edges`` backend's aggregation at the train cell's stacked edge
    list, over the CSR packs ``make_adj_builder`` builds for it, d = 256
    (layers 1 and 2 differentiate it): the forward (the CSR kernel over
    ``A``, counted as ``edge_spmm``) and ``d_h`` (over ``A^T``,
    ``edge_spmm_dh``) against the plain version, ``ops.coo_spmm`` and its
    autograd backward, each twice bit for bit, timed beside it, beside
    ``torch.sparse.mm`` of the same matrix and its transpose (the library
    calls) and the bound; then ``edge_dvals`` with GAT's 4 heads of 64 in
    one launch on the same packs, against its plain version
    (``ref.edge_dvals_ref``), the autograd of ``coo_spmm`` in each head's
    weights (the reference's loop over the heads; 0 at the padding edges)
    and four one-head launches, twice bit for bit, beside
    ``torch.sparse.sampled_addmm`` at the edges' pattern once a head.
    Returns the three kernels-line entries."""
    from repro_torch.kernels import edge_spmm as kedge, ops, ref
    src, dst, w = (torch.as_tensor(a, device=dev)
                   for a in (sp.e_src, sp.e_dst, sp.e_w))
    n_parts, ni = sp.num_parts, sp.n_inner_max
    n_cols, d = ni + sp.n_halo_max, EDGE_D
    t0 = time.perf_counter()
    packs = ops.edge_packs(src, dst, w, ni, n_cols)
    pack_s = time.perf_counter() - t0
    fwd, bwd = packs.fwd, packs.bwd
    h = torch.randn((n_parts, n_cols, d), generator=gen, device=dev,
                    requires_grad=True)
    g = torch.randn((n_parts, ni, d), generator=gen, device=dev)
    hf, gf = h.detach().view(-1, d), g.view(-1, d)
    plain = ops.coo_spmm(src, dst, w, h, ni)
    want_dh = torch.autograd.grad(plain, h, g, retain_graph=True)[0]
    err, bits = {}, {}
    for key, fn, want in (
            ("forward", lambda: kedge.edge_spmm(fwd, hf),
             plain.detach().reshape(-1, d)),
            ("d_h", lambda: kedge.edge_spmm_dh(bwd, gf),
             want_dh.reshape(-1, d))):
        got, again = fn(), fn()
        err[key] = check_close(f"edge_spmm {key}", got, want,
                               **csr_tol(want))
        bits[key] = torch.equal(got.view(torch.int32),
                                again.view(torch.int32))
        if not bits[key]:
            raise AssertionError(f"edge_spmm {key}: two launches differ")
    del want_dh, got, again
    mat, mat_t = pack_matrix(fwd), pack_matrix(bwd)
    t = time_calls({
        "kernel_ms": lambda: kedge.edge_spmm(fwd, hf),
        "plain_ms": lambda: ops.coo_spmm(src, dst, w, h.detach(), ni),
        "library_ms": lambda: torch.sparse.mm(mat, hf),
        "dh_kernel_ms": lambda: kedge.edge_spmm_dh(bwd, gf),
        "dh_plain_ms": lambda: torch.autograd.grad(plain, h, g,
                                                   retain_graph=True),
        "dh_library_ms": lambda: torch.sparse.mm(mat_t, gf),
    }, reps=3, rounds=2)
    del plain, h
    b_f, by_f = bound_ms(csr_bytes(fwd, d, 4, False), 2.0 * fwd.nnz * d)
    b_b, by_b = bound_ms(csr_bytes(bwd, d, 4, False), 2.0 * bwd.nnz * d)
    shape = dict(shape=[n_parts, ni, n_cols, d], edges=list(src.shape),
                 live_edges=fwd.nnz, max_row=max_row(fwd),
                 max_row_t=max_row(bwd), segments=[fwd.seg.shape[0],
                                                   bwd.seg.shape[0]],
                 packs_build_s=pack_s)
    # the wrapper's host time a call (checks, config, ctypes), which the
    # device time above no longer holds
    host = {"kernel_enqueue_us": enqueue_us(
                lambda: kedge.edge_spmm(fwd, hf)),
            "dh_kernel_enqueue_us": enqueue_us(
                lambda: kedge.edge_spmm_dh(bwd, gf))}
    emit("coo_spmm", **shape, max_abs_err=err, bit_reproducible=bits,
         bound_ms=b_f, bound_by=by_f, dh_bound_ms=b_b, dh_bound_by=by_b,
         **t, **host)
    over = "one launch at d=256 over the train cell's edge packs"
    entries = [edge_entry("edge_spmm", CSR_SOURCE, EDGE_REPLACES, t,
                          err["forward"], b_f, by_f, timed_over=over,
                          plain="ops.coo_spmm (index_select, index_add_)"),
               edge_entry("edge_spmm_dh", CSR_SOURCE, EDGE_REPLACES, t,
                          err["d_h"], b_b, by_b, prefix="dh_",
                          timed_over=over + " (transposed)",
                          plain="the autograd backward of ops.coo_spmm")]

    # GAT's attention gradient: its 4 heads of 64 in one launch
    heads, d = GAT_HEADS, EDGE_DVALS_D
    n_edges = src.numel()
    h = torch.randn((n_parts * n_cols, heads, d), generator=gen, device=dev)
    g = torch.randn((n_parts * ni, heads, d), generator=gen, device=dev)
    got, again = (kedge.edge_dvals(fwd, g, h, n_edges) for _ in range(2))
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("edge_dvals: two launches differ")
    dv_err = check_close("edge_dvals", got, ref.edge_dvals_ref(fwd, g, h,
                                                               n_edges))
    # the reference's loop over the heads: coo_spmm's autograd in each
    # head's weights
    ev = w[..., None].repeat(1, 1, heads).requires_grad_(True)
    h3, g3 = h.view(n_parts, n_cols, heads, d), g.view(n_parts, ni, heads, d)
    by_coo = torch.stack([ops.coo_spmm(src, dst, ev[..., z], h3[..., z, :],
                                       ni) for z in range(heads)], dim=-2)
    old = torch.autograd.grad(by_coo, ev, g3, retain_graph=True)[0]
    coo_err = check_close("edge_dvals (coo_spmm's autograd, per head)",
                          got.view(n_parts, -1, heads), old)
    if got.view(n_parts, -1, heads)[dst == ni].any():
        raise AssertionError("edge_dvals: a padding edge has a value")
    gz = [g[:, z].contiguous() for z in range(heads)]
    hz = [h[:, z].contiguous() for z in range(heads)]
    hz_t = [x.t() for x in hz]
    per_head = torch.stack([kedge.edge_dvals(fwd, gz[z], hz[z], n_edges)
                            for z in range(heads)], -1)
    per_head_err = check_close("edge_dvals (one launch a head)", per_head,
                               got)
    del old, again, per_head
    t = time_calls({
        "kernel_ms": lambda: kedge.edge_dvals(fwd, g, h, n_edges),
        "per_head_launches_ms": lambda: [kedge.edge_dvals(
            fwd, gz[z], hz[z], n_edges) for z in range(heads)],
        "plain_ms": lambda: ref.edge_dvals_ref(fwd, g, h, n_edges),
        "old_route_ms": lambda: torch.autograd.grad(by_coo, ev, g3,
                                                    retain_graph=True),
        "library_ms": lambda: [torch.sparse.sampled_addmm(
            mat, gz[z], hz_t[z], beta=0.0) for z in range(heads)],
    }, reps=5, rounds=2)
    nbytes = dvals_bytes(fwd, heads * d, n_edges * heads)
    b, by = bound_ms(nbytes, 2.0 * fwd.nnz * heads * d)
    one_head_b = bound_ms(dvals_bytes(fwd, d, n_edges), 2.0 * fwd.nnz * d)[0]
    emit("kernel", name="edge_dvals", shape=[n_parts, ni, n_cols, heads, d],
         edges=n_edges, live_edges=fwd.nnz, max_abs_err=dv_err,
         coo_autograd_max_abs_err=coo_err,
         per_head_max_abs_err=per_head_err, bit_reproducible=True,
         bytes=nbytes, bound_ms=b, bound_by=by,
         four_one_head_bounds_ms=heads * one_head_b, **t)
    entries.append(edge_entry(
        "edge_dvals", EDGE_DVALS_SOURCE, EDGE_DVALS_REPLACES, t, dv_err, b,
        by, old_route_ms=t["old_route_ms"],
        per_head_launches_ms=t["per_head_launches_ms"],
        timed_over="one launch for GAT's 4 heads of 64 over the train "
                   "cell's forward edge pack",
        library="torch.sparse.sampled_addmm at the coalesced edge pattern, "
                "once a head"))
    del by_coo, ev, mat, mat_t, packs, fwd, bwd
    return entries


def phase_coo_spmm_15d(layout, rank: int, seed: int = 0,
                       dev="cuda") -> None:
    """The 1.5D chunk's aggregation at its shapes: rank ``rank``'s edge
    chunk over its gathered group buffer ``[g*ni, d]`` into ``[ni, d]``,
    through ``strategy_15d.chunk_adj`` (the runtime's own adjacency: the
    CSR kernel over the chunk's packs, built once), at d = 500 (layer 0,
    whose input needs no gradient) and 256 (forward and backward), each
    against the plain version ``ops.coo_spmm`` (and its autograd
    backward), timed beside it, ``torch.sparse.mm`` of the same matrix
    (and of its transpose for the backward: the library calls) and the
    least time the card could take; the backward also as its kernel
    alone (``backward_kernel_ms``) and the host's time to enqueue either
    (``backward_enqueue_us``, ``backward_kernel_enqueue_us``)."""
    from repro_torch.dist.strategy_15d import chunk_adj
    from repro_torch.kernels import edge_spmm as kedge, ops
    gen = torch.Generator(device=dev).manual_seed(seed)
    adj = chunk_adj(layout, rank, dev)
    src, dst, w = adj.src, adj.dst, adj.weight
    fwd, bwd = adj.packs.fwd, adj.packs.bwd
    ni, n_cols = layout.ni, layout.g * layout.ni
    mat, mat_t = pack_matrix(fwd), pack_matrix(bwd)
    rec = {}
    for d in (500, 256):
        h = torch.randn((n_cols, d), generator=gen, device=dev,
                        requires_grad=d == 256)
        g = torch.randn((ni, d), generator=gen, device=dev)
        y = adj.spmm(h)
        plain = ops.coo_spmm(src, dst, w, h, ni)
        err = check_close(f"edge_spmm 1.5D forward d={d}", y,
                          plain.detach(), **csr_tol(plain.detach()))
        fns = {"forward_ms": lambda: adj.spmm(h.detach()),
               "plain_forward_ms": lambda: ops.coo_spmm(src, dst, w,
                                                        h.detach(), ni),
               "library_forward_ms": lambda: torch.sparse.mm(
                   mat, h.detach())}
        b, by = bound_ms(csr_bytes(fwd, d, 4, False), 2.0 * fwd.nnz * d)
        rec[f"d{d}"] = {"max_abs_err": err, "bound_ms": b, "bound_by": by}
        if d == 256:
            d_h = torch.autograd.grad(y, h, g, retain_graph=True)[0]
            want = torch.autograd.grad(plain, h, g, retain_graph=True)[0]
            rec["d256"]["backward_max_abs_err"] = check_close(
                "edge_spmm 1.5D backward d=256", d_h, want, **csr_tol(want))
            fns["backward_ms"] = lambda: torch.autograd.grad(
                y, h, g, retain_graph=True)
            fns["backward_kernel_ms"] = lambda: kedge.edge_spmm_dh(bwd, g)
            fns["plain_backward_ms"] = lambda: torch.autograd.grad(
                plain, h, g, retain_graph=True)
            fns["library_backward_ms"] = lambda: torch.sparse.mm(mat_t, g)
            rec["d256"]["backward_bound_ms"] = bound_ms(
                csr_bytes(bwd, d, 4, False), 2.0 * bwd.nnz * d)[0]
            # the host's time a backward call takes to enqueue (autograd,
            # the Function's casts and views, the wrapper)
            rec["d256"]["backward_enqueue_us"] = enqueue_us(
                fns["backward_ms"])
            rec["d256"]["backward_kernel_enqueue_us"] = enqueue_us(
                fns["backward_kernel_ms"])
        rec[f"d{d}"].update(time_calls(fns, reps=5, rounds=2))
        del h, g, y, plain
    emit("coo_spmm_15d", case=f"c{layout.c}pr{layout.pr}", rank=rank,
         edges=fwd.nnz, ni=ni, n_cols=n_cols, max_row=max_row(fwd), **rec)


def rank_jobs(rank, world_size, device, jobs):
    """Several rank programs, ``(fn, args)`` each, one after another on
    one process group: the ranks reach the card once for them all."""
    out = []
    for fn, args in jobs:
        out.append(fn(rank, world_size, device, *args))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def spawn_jobs(jobs: list, world_size: int, backend: str,
               devices) -> tuple[list, float]:
    """:func:`rank_jobs` of ``jobs`` in one spawn of ``world_size`` ranks:
    each job's results in rank order, and the spawn's wall seconds."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    ranks = spawn(rank_jobs, world_size, backend=backend, devices=devices,
                  args=(jobs,))
    return ([[r[i] for r in ranks] for i in range(len(jobs))],
            time.perf_counter() - t0)


def spmd_rank(rank, world_size, device, cfg, sp, xplan, spec, params_np,
              epochs, lr, steady, planner=None):
    """One rank of the SPMD phases: the refresh step's loss and gradients
    from ``params_np``; an ``epochs``-step ``train_capgnn`` with Adam
    (re-planned by ``planner``, this rank's copy, when one is given) and
    the test evaluation, its launches counted from zero; ``steady`` steps
    of each kind from the trained state, each timed and its host staging
    seconds kept apart."""
    from repro_torch.core import StalenessController
    from repro_torch.dist import make_spmd_runtime, train_capgnn
    from repro_torch.optim import adam
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    opt = adam(lr)
    rt = make_spmd_runtime(cfg, sp, xplan, opt, spec=spec, device=device)
    build_s = time.perf_counter() - t0
    params = [{k: torch.as_tensor(v, device=device) for k, v in p.items()}
              for p in params_np]
    loss, grads = rt.loss_and_grads(params, rt.caches0)
    zero_counts()
    p8, rep = train_capgnn(
        cfg, rt, xplan, world_size, opt, epochs=epochs,
        controller=StalenessController(refresh_every=spec.refresh_every),
        params0=params, planner=planner, spec=spec)
    test = rt.evaluate(p8, "test")
    torch.cuda.synchronize(device)
    launches = read_counts()
    wire = rt.wire_log[:epochs]
    steady_ms, stage_ms = {}, {}
    for kind in ("refresh", "cached", "pipelined") if steady else ():
        step, state = getattr(rt, f"step_{kind}"), (p8, rep.final_opt_state,
                                                     rt.caches0)
        times, stages = [], []
        for _ in range(steady):
            t0 = time.perf_counter()
            *state, m = step(*state)
            float(m["loss"])
            times.append(1e3 * (time.perf_counter() - t0))
            stages.append(1e3 * rt.wire_log[-1]["host_stage_s"])
        steady_ms[kind] = statistics.median(times)
        stage_ms[kind] = statistics.median(stages)
    return {"loss": float(loss),
            "grads": [{k: v.cpu() for k, v in g.items()} for g in grads],
            "losses": rep.losses, "step_kinds": rep.step_kinds,
            "step_ms": [1e3 * s for s in rep.step_s],
            "host_stage_ms": [1e3 * w["host_stage_s"] for w in wire],
            "comm_bytes": rep.comm_bytes, "refresh_steps": rep.refresh_steps,
            "cached_steps": rep.cached_steps, "test": test,
            "wire": [w["counts"] for w in wire], "launches": launches,
            "steady_step_ms": steady_ms, "steady_host_stage_ms": stage_ms,
            "host_fetch_rows": rep.host_fetch_rows,
            "host_fetch_bytes": rep.host_fetch_bytes,
            "host_writeback_bytes": rep.host_writeback_bytes,
            "replan_events": rep.replan_events, "hit_rate": rep.hit_rate,
            "build_s": build_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9}


def spmd_gather_launches(xplan, transport: str, bf16: bool,
                         n_exchanged: int) -> dict:
    """The row gather's launches on one rank of the SPMD runtime, per step
    kind, from the plan's widths: per exchanged layer, a tier pull with a
    non-empty payload gathers the owner's pack (and, on a bf16 ``p2p``
    wire, its per-peer blocks) and, with rows to receive, the consumer's
    addressing; the global buffer's fill gathers the send pack and the
    buffer; its read gathers once where there are reads.  A refresh step
    differentiates every one; a cached or pipelined step the uncached
    tier's; an evaluation none."""
    p = xplan.num_parts

    def tier(t):
        width = p * t.peer_block if transport == "p2p" else \
            t.send_row.shape[1]
        if not width:
            return 0
        return 1 + int(bf16 and transport == "p2p") + \
            int(t.recv_valid.shape[1] > 0)
    g = xplan.glob
    fill = (1 + int(g.buf_size > 0)) if g.send_row.shape[1] else 0
    read = int(g.read_buf_idx.shape[1] > 0)
    un, loc = tier(xplan.uncached), tier(xplan.local)
    every = un + loc + fill + read
    fwd = {"refresh": every, "cached": un + read, "pipelined": every,
           "evaluation": every}
    bwd = {"refresh": every, "cached": un, "pipelined": un, "evaluation": 0}
    return {k: {"gather_rows": n_exchanged * fwd[k],
                "gather_rows_bwd": n_exchanged * bwd[k]} for k in fwd}


def spmd_jobs(ctx: dict, ref: dict, transports, epochs: int,
              lr: float) -> list:
    """:func:`phase_spmd`'s rank programs, one for each transport."""
    import dataclasses as dc
    params_np = [{k: v.numpy() for k, v in q.items()} for q in ref["params0"]]
    return [(spmd_rank, (ctx["cfg"], ctx["sp"], ctx["xplan"],
                         dc.replace(ctx["spec"], transport=t), params_np,
                         epochs, lr, 3)) for t in transports]


def phase_spmd(name: str, ctx: dict, ref: dict, transports,
               backend: str, devices, epochs: int, lr: float,
               spawned=None) -> dict:
    """The SPMD runtime of the train cell's flags on ``P`` ranks over
    ``backend`` (``devices``: one per rank), under each of ``transports``
    (all in one spawn; ``spawned``: :func:`spmd_jobs`' results from a
    spawn shared with other phases, and its wall seconds).

    Checks, over the ranks: one refresh step's loss within ``LOSS_ATOL``
    and its gradients within ``GRAD_RTOL`` of the card's single-process
    runtime on the same parameters (``ref``); every step's counted valid
    and padded rows and bytes equal to the plan's (``transport_rows``;
    under ``p2p`` ``bytes_per_step``); the report's bytes and step counts
    equal to the plan's; finite falling losses; every rank's losses the
    same; the launches, summed over ranks, those the backend gives.
    Returns the launches by path, ``{name}_{transport}``."""
    cfg, sp, xplan = ctx["cfg"], ctx["sp"], ctx["xplan"]
    p, layers = sp.num_parts, cfg.num_layers
    jobs = spmd_jobs(ctx, ref, transports, epochs, lr)
    res, spawn_wall_s = spawned or spawn_jobs(jobs, p, backend, devices)
    by_path = {}
    for transport, (_, job), ranks in zip(transports, jobs, res):
        spec = job[3]
        grad_err = []
        for r in ranks:
            loss_err = abs(r["loss"] - ref["loss"])
            if loss_err > LOSS_ATOL:
                raise AssertionError(f"{name}: refresh loss differs from the "
                                     f"card's sim runtime by {loss_err}")
            grad_err.append(grads_err(r["grads"], ref["grads"]))
            if r["losses"] != ranks[0]["losses"]:
                raise AssertionError(f"{name}: ranks disagree on the losses")
        kinds = ranks[0]["step_kinds"]
        losses = ranks[0]["losses"]
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: losses {losses}")
        comm, vanilla = plan_bytes(cfg, spec, xplan, kinds)
        if ranks[0]["comm_bytes"] != comm:
            raise AssertionError(f"{name}: comm_bytes "
                                 f"{ranks[0]['comm_bytes']}, the plan gives "
                                 f"{comm}")
        width = 2 if spec.halo_dtype == "bf16" else 4
        counted = []
        for s, kind in enumerate(kinds):
            refresh = kind != "cached"
            valid = xplan.transport_rows(transport, refresh)
            padded = xplan.transport_rows(transport, refresh, padded=True)
            for li in range(1, layers):
                d = cfg.feat_dims[li]
                got = {t: {f: sum(r["wire"][s].get((li, t), {}).get(f, 0)
                                  for r in ranks)
                           for f in ("valid_rows", "padded_rows", "bytes",
                                     "wire_bytes")}
                       for t in ("uncached", "local", "global")}
                for t, c in got.items():
                    if (c["valid_rows"], c["padded_rows"], c["bytes"]) != \
                            (valid[t], padded[t], valid[t] * d * width):
                        raise AssertionError(
                            f"{name}: step {s} ({kind}) layer {li} {t}: "
                            f"counted {c}, the plan gives {valid[t]} / "
                            f"{padded[t]}")
                step_bytes = sum(c["bytes"] for c in got.values())
                if transport == "p2p" and step_bytes != xplan.bytes_per_step(
                        d, refresh, dtype_bytes=width):
                    raise AssertionError(f"{name}: step {s} layer {li}: "
                                         f"{step_bytes} bytes counted")
                counted.append({"step": s, "kind": kind, "layer": li, **got})
        launches = {k: sum(r["launches"][k] for r in ranks)
                    for k in ranks[0]["launches"]}
        per_kind = spmd_gather_launches(xplan, transport,
                                        spec.halo_dtype == "bf16", layers - 1)
        want = {k: p * v for k, v in train_launches(
            spec.backend, layers, kinds, per_kind).items()}
        want["packs_built_for_a_call"] = 0
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")

        def by_kind(key):
            return {k: statistics.median(t for t, kk in
                                         zip(ranks[0][key], kinds) if kk == k)
                    for k in sorted(set(kinds))}
        emit(name, transport=transport, backend=backend, ranks=p,
             devices=(list(devices) if not isinstance(devices, str)
                      else devices),
             wire="gloo-host" if backend == "gloo" else "nccl",
             argv=TRAIN_ARGV, losses=losses, step_kinds=kinds,
             median_step_ms=by_kind("step_ms"),
             median_host_stage_ms=by_kind("host_stage_ms"),
             steady_step_ms=ranks[0]["steady_step_ms"],
             steady_host_stage_ms=ranks[0]["steady_host_stage_ms"],
             steady_step_ms_max_rank={k: max(r["steady_step_ms"][k]
                                             for r in ranks)
                                      for k in ranks[0]["steady_step_ms"]},
             comm_bytes=comm, comm_bytes_vanilla=vanilla,
             refresh_steps=ranks[0]["refresh_steps"],
             cached_steps=ranks[0]["cached_steps"],
             counted_equal_plan=True, counted=counted[:2 * (layers - 1)],
             launches=launches, gather_launches_per_kind_per_rank=per_kind,
             refresh_loss_err=max(abs(r["loss"] - ref["loss"]) for r in ranks),
             refresh_grad_err_max_rel=max(e["max_rel"] for g in grad_err
                                          for e in g),
             test=ranks[0]["test"],
             traj_vs_sim_max_abs=(float(np.abs(np.subtract(
                 losses, ref["run_losses"])).max()) if "run_losses" in ref
                 else None),
             build_s=[r["build_s"] for r in ranks], spawn_wall_s=spawn_wall_s,
             peak_mem_gb=[r["peak_mem_gb"] for r in ranks])
        by_path[f"{name}_{transport}"] = launches
    return by_path


# the tier schedule of the spmd_tiers phase: (step, plan index).  The
# pipelined step's refresh rings run beside the uncached tier's rotations;
# the transition reads plan 0 and pulls plan 1; set_plan(0) before the
# last refresh.
TIER_SCHEDULE = (("refresh", None), ("cached", None), ("pipelined", None),
                 ("cached", None), ("transition", 1), ("cached", None),
                 ("refresh", 0))
TIER_CASES = (("p2p", "f32"), ("allgather", "f32"), ("p2p", "bf16"))
TIER_LR = 0.5
# SPMD rank vs the card's single-process runtime over the tier schedule:
# f32 sums over ranks in another order; a bf16 wire can land one payload
# entry a bf16 ulp (2^-8 of it) apart where its f32 value sits on a
# rounding boundary, and the logits that read it move with it
TIER_TOL = {"f32": 1e-5, "bf16": 5e-5}


def tiers_context() -> dict:
    """The graph of ``tests/spmd_parity_script.py`` (rmat 360 / 2,200, GCN
    12 -> 16 -> 16 -> 5, 4 METIS parts) with the hybrid pack, and two
    rankings of one forced capacity (``c_gpu`` 10 rows a worker, ``c_cpu``
    25) padded to its widths: every tier carries rows under both, and a
    switch between them changes the rows, not the shapes."""
    from repro_torch.core import CacheCapacity, build_cache_plan
    from repro_torch.data.gnn_data import FullBatchTask, split_masks
    from repro_torch.dist import (build_exchange_plan, exchange_capacity,
                                  stack_partitions)
    from repro_torch.graph import (build_partition, metis_partition, rmat,
                                   symmetric_normalize, synth_features)
    from repro_torch.models.gnn import GNNConfig, init_gnn
    g = rmat(360, 2200, seed=3)
    feats, labels = synth_features(g, 12, 5, seed=3)
    gn = symmetric_normalize(g)
    tr, va, te = split_masks(g.num_nodes, seed=3)
    task = FullBatchTask(graph=gn, features=feats, labels=labels,
                         train_mask=tr, val_mask=va, test_mask=te,
                         num_classes=5)
    ps = build_partition(gn, metis_partition(gn, SPMD_RANKS, seed=3), hops=1)
    cap = CacheCapacity(c_gpu=[10] * SPMD_RANKS, c_cpu=25)
    plans = [build_exchange_plan(ps, build_cache_plan(
        ps, cap, refresh_every=2, policy=pol, seed=1),
        pad_to=exchange_capacity(ps, cap))
        for pol in ("overlap_high", "random")]
    for x in plans:
        if not (x.uncached.n_rows and x.local.n_rows and x.glob.n_unique):
            raise AssertionError("spmd_tiers: a plan with an empty tier")
    cfg = GNNConfig(model="gcn", in_dim=12, hidden_dim=16, out_dim=5,
                    num_layers=3)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
    return {"cfg": cfg, "sp": stack_partitions(ps, task, backend="hybrid"),
            "plans": plans, "task": task, "ps": ps,
            "params_np": [{k: v.numpy() for k, v in q.items()}
                          for q in params]}


def tier_schedule(rt, params, opt, plans) -> list[dict]:
    """:data:`TIER_SCHEDULE` on a runtime installed on ``plans[0]``: each
    step's loss, parameters and caches, on the host."""
    state, out = (params, opt.init(params), rt.caches0), []
    for kind, plan in TIER_SCHEDULE:
        if kind == "transition":
            *state, m = rt.step_transition(*state, plans[plan])
        else:
            if plan is not None:
                rt.set_plan(plans[plan])
            *state, m = getattr(rt, f"step_{kind}")(*state)
        out.append({"kind": kind, "loss": float(m["loss"]),
                    "params": [{k: v.cpu() for k, v in q.items()}
                               for q in state[0]],
                    "caches": {k: [c.cpu() for c in v]
                               for k, v in state[2].items()}})
    return out


def spmd_tiers_rank(rank, world_size, device, cfg, sp, plans, specs,
                    params_np):
    """One rank of the ``spmd_tiers`` phase, one process group for every
    spec of ``specs``: :func:`tier_schedule` with ``sgd(TIER_LR)`` and
    every step's wire counts."""
    from repro_torch.dist import make_spmd_runtime
    from repro_torch.optim import sgd
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for spec in specs:
        opt = sgd(TIER_LR)
        rt = make_spmd_runtime(cfg, sp, plans[0], opt, spec=spec,
                               device=device)
        params = [{k: torch.as_tensor(v, device=device)
                   for k, v in q.items()} for q in params_np]
        steps = tier_schedule(rt, params, opt, plans)
        torch.cuda.synchronize(device)
        for st, w in zip(steps, rt.wire_log):
            st["wire"] = w["counts"]
        out.append(steps)
    return out


def tier_jobs(tctx: dict) -> list:
    """:func:`phase_spmd_tiers`' rank program: every case of
    :data:`TIER_CASES`."""
    from repro_torch.dist import TrainSpec
    specs = [TrainSpec(backend="hybrid", transport=transport,
                       halo_dtype=halo, refresh_every=2, pipeline=True)
             for transport, halo in TIER_CASES]
    return [(spmd_tiers_rank, (tctx["cfg"], tctx["sp"], tctx["plans"], specs,
                               tctx["params_np"]))]


def phase_spmd_tiers(name: str, tctx: dict, backend: str, devices,
                     spawned=None) -> None:
    """The SPMD runtime on :func:`tiers_context`'s graph, 4 ranks over
    ``backend``, under each of :data:`TIER_CASES` (both transports, and a
    bf16 ``p2p`` wire): :data:`TIER_SCHEDULE`, whose refresh steps
    differentiate every collective (the rotations, the ring broadcast and
    the all-gather, each through its transpose) and whose pipelined and
    transition steps run the deferred rings beside the uncached tier's
    synchronous exchange.  Every step's loss, parameters and emitted
    caches against the card's single-process runtime doing the same steps
    (:data:`TIER_TOL`), and its counted rows against the plans'.
    ``spawned``: :func:`tier_jobs`' results from a spawn shared with other
    phases, and its wall seconds."""
    from repro_torch.dist import make_sim_runtime
    from repro_torch.optim import sgd
    cfg, sp, plans = tctx["cfg"], tctx["sp"], tctx["plans"]
    # each step's (read, emit) plan: a transition exchanges the uncached
    # tier on the installed plan and pulls the cached tiers of the next
    plan_of, installed = [], 0
    for kind, plan in TIER_SCHEDULE:
        if kind == "transition":
            plan_of.append((installed, plan))
        elif plan is not None:
            plan_of.append((plan, plan))
        else:
            plan_of.append((installed, installed))
        installed = plan if plan is not None else installed
    jobs = tier_jobs(tctx)
    specs = jobs[0][1][3]
    (by_rank,), wall_s = spawned or spawn_jobs(jobs, SPMD_RANKS, backend,
                                               devices)
    cases = []
    for c, ((transport, halo), spec) in enumerate(zip(TIER_CASES, specs)):
        ranks = [r[c] for r in by_rank]
        opt = sgd(TIER_LR)
        sim = make_sim_runtime(cfg, sp, plans[0], opt, spec=spec,
                               device="cuda")
        ref = tier_schedule(sim, [{k: torch.as_tensor(v, device="cuda")
                                   for k, v in q.items()}
                                  for q in tctx["params_np"]], opt, plans)
        err = {"loss": 0.0, "params": 0.0, "local": 0.0, "global": 0.0}
        for i, want in enumerate(ref):
            for r in ranks:
                got = r[i]
                err["loss"] = max(err["loss"], abs(got["loss"] - want["loss"]))
                err["params"] = max(err["params"], max(
                    float((a[k] - b[k]).abs().max())
                    for a, b in zip(got["params"], want["params"])
                    for k in b))
                for a, b in zip(got["caches"]["global"],
                                ranks[0][i]["caches"]["global"]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name}: step {i}: the global "
                                             "buffer differs between ranks")
            for li, w in enumerate(want["caches"]["local"]):
                got = torch.cat([r[i]["caches"]["local"][li] for r in ranks])
                err["local"] = max(err["local"],
                                   float((got - w).abs().max()))
            for a, b in zip(ranks[0][i]["caches"]["global"],
                            want["caches"]["global"]):
                err["global"] = max(err["global"], float((a - b).abs().max()))
            read_i, emit_i = plan_of[i]
            refresh = want["kind"] != "cached"
            rows = {"uncached": plans[read_i].transport_rows(
                transport, refresh)["uncached"]}
            rows.update({t: plans[emit_i].transport_rows(
                transport, refresh)[t] for t in ("local", "global")})
            for li in range(1, cfg.num_layers):
                for t, n in rows.items():
                    c = sum(r[i]["wire"].get((li, t), {}).get("valid_rows", 0)
                            for r in ranks)
                    if c != n:
                        raise AssertionError(
                            f"{name}: {transport}-{halo} step {i} "
                            f"({want['kind']}) layer {li} {t}: counted {c} "
                            f"rows, the plan gives {n}")
        worst = max(err.values())
        if not worst <= TIER_TOL[halo]:
            raise AssertionError(f"{name}: {transport}-{halo} against the "
                                 f"card's sim runtime: {err}")
        cases.append({"transport": transport, "halo_dtype": halo,
                      "max_abs_err": err, "tol": TIER_TOL[halo],
                      "counted_equal_plan": True})
    emit(name, ranks=SPMD_RANKS, backend=backend, spawn_wall_s=wall_s,
         devices=list(devices) if not isinstance(devices, str) else devices,
         wire="gloo-host" if backend == "gloo" else "nccl",
         steps=[k for k, _ in TIER_SCHEDULE],
         tier_rows=[{t: getattr(x, t).n_rows for t in ("uncached", "local")}
                    | {"global": x.glob.n_unique} for x in plans],
         cases=cases)


# the spmd_models phase: (model, backend, transport) on the parity graph,
# each through refresh, cached, pipelined and cached steps of sgd(TIER_LR)
MODEL_CASES = (("sage", "hybrid", "p2p"), ("gin", "ell", "allgather"),
               ("gat", "edges", "p2p"))
MODEL_KINDS = ["refresh", "cached", "pipelined", "cached"]
MODEL_TOL = 1e-5          # SPMD rank vs the card's sim: f32 sums over ranks


def models_context(tctx: dict) -> list[dict]:
    """:func:`tiers_context`'s graph and first plan for each case of
    :data:`MODEL_CASES`: the model's config (the same widths), the layout
    stacked for its backend, its spec and parameters (``init_gnn`` of
    seed 0)."""
    import dataclasses as dc
    from repro_torch.dist import TrainSpec, stack_partitions
    from repro_torch.models.gnn import init_gnn
    cases = []
    for model, backend, transport in MODEL_CASES:
        cfg = dc.replace(tctx["cfg"], model=model)
        params = init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
        cases.append({
            "model": model, "backend": backend, "transport": transport,
            "cfg": cfg, "xplan": tctx["plans"][0],
            "sp": stack_partitions(tctx["ps"], tctx["task"],
                                   backend=backend),
            "spec": TrainSpec(backend=backend, transport=transport,
                              refresh_every=2, pipeline=True),
            "params_np": [{k: v.numpy() for k, v in q.items()}
                          for q in params]})
    return cases


def model_run(rt, cfg, xplan, opt, params, epochs: int) -> dict:
    """One refresh step's loss and gradients from ``params``, then an
    ``epochs``-step ``train_capgnn`` and the test evaluation, their
    launches counted from zero; on the host."""
    from repro_torch.dist import train_capgnn
    loss, grads = rt.loss_and_grads(params, rt.caches0)
    zero_counts()
    p, rep = train_capgnn(cfg, rt, xplan, xplan.num_parts, opt,
                          epochs=epochs, params0=params, spec=rt.spec)
    rt.evaluate(p, "test")
    torch.cuda.synchronize()
    return {"loss": float(loss), "launches": read_counts(),
            "grads": [{k: v.cpu() for k, v in g.items()} for g in grads],
            "losses": rep.losses, "step_kinds": rep.step_kinds,
            "params": [{k: v.cpu() for k, v in q.items()} for q in p],
            "comm_bytes": rep.comm_bytes}


def spmd_models_rank(rank, world_size, device, cases):
    """One rank of the ``spmd_models`` phase: :func:`model_run` of each
    case with ``sgd(TIER_LR)`` on the SPMD runtime, and every step's wire
    counts."""
    from repro_torch.dist import make_spmd_runtime
    from repro_torch.optim import sgd
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for c in cases:
        opt = sgd(TIER_LR)
        rt = make_spmd_runtime(c["cfg"], c["sp"], c["xplan"], opt,
                               spec=c["spec"], device=device)
        params = [{k: torch.as_tensor(v, device=device)
                   for k, v in q.items()} for q in c["params_np"]]
        res = model_run(rt, c["cfg"], c["xplan"], opt, params,
                        len(MODEL_KINDS))
        res["wire"] = [w["counts"] for w in rt.wire_log]
        out.append(res)
    return out


def phase_spmd_models(name: str, cases: list[dict], backend: str,
                      devices, spawned=None) -> dict:
    """The SPMD runtime with SAGE (``hybrid``, ``p2p``), GIN (``ell``,
    ``allgather``) and GAT (``edges``, ``p2p``) on the parity graph, 4
    ranks over ``backend``: each rank's refresh-step loss, gradients (GIN's
    0-d ``eps`` among them), losses and parameters after
    :data:`MODEL_KINDS` against the card's single-process runtime from the
    same parameters (within :data:`MODEL_TOL`; the gradients within
    ``GRAD_RTOL`` of their largest magnitude, as the ``spmd`` phase holds
    them); every step's counted rows equal to the plan's; the
    launches, summed over ranks, those the model and backend give.
    Returns the launches of each case, by path.  ``spawned``: its rank
    program's results from a spawn shared with other phases, and its wall
    seconds."""
    from repro_torch.dist import make_sim_runtime
    from repro_torch.optim import sgd
    (by_rank,), wall_s = spawned or spawn_jobs(
        [(spmd_models_rank, (cases,))], SPMD_RANKS, backend, devices)
    out, recs = {}, []
    for i, c in enumerate(cases):
        ranks = [r[i] for r in by_rank]
        cfg, x, transport = c["cfg"], c["xplan"], c["transport"]
        layers = cfg.num_layers
        opt = sgd(TIER_LR)
        sim = make_sim_runtime(cfg, c["sp"], x, opt, spec=c["spec"],
                               device="cuda")
        ref = model_run(sim, cfg, x, opt,
                        [{k: torch.as_tensor(v, device="cuda")
                          for k, v in q.items()} for q in c["params_np"]],
                        len(MODEL_KINDS))
        if ref["step_kinds"] != MODEL_KINDS:
            raise AssertionError(f"{name}: step kinds {ref['step_kinds']}")
        err = {"loss": 0.0, "grads_of_max": 0.0, "losses": 0.0,
               "params": 0.0}
        for r in ranks:
            err["loss"] = max(err["loss"], abs(r["loss"] - ref["loss"]))
            err["losses"] = max(err["losses"], float(np.abs(np.subtract(
                r["losses"], ref["losses"])).max()))
            for got, want, key in ((r["grads"], ref["grads"],
                                    "grads_of_max"),
                                   (r["params"], ref["params"], "params")):
                for a, b in zip(got, want):
                    for k in b:
                        e = float((a[k] - b[k]).abs().max())
                        if key == "grads_of_max":
                            e /= float(b[k].abs().max()) + 1e-12
                        err[key] = max(err[key], e)
            if r["comm_bytes"] != ref["comm_bytes"]:
                raise AssertionError(f"{name}: {c['model']}: comm_bytes "
                                     f"{r['comm_bytes']} != "
                                     f"{ref['comm_bytes']}")
        if not (max(err["loss"], err["losses"], err["params"]) <= MODEL_TOL
                and err["grads_of_max"] <= GRAD_RTOL):
            raise AssertionError(f"{name}: {c['model']} against the card's "
                                 f"sim runtime: {err}")
        for s, kind in enumerate(MODEL_KINDS):
            rows = x.transport_rows(transport, kind != "cached")
            for li in range(1, layers):
                for t in ("uncached", "local", "global"):
                    n = rows[t]
                    got = sum(r["wire"][s].get((li, t), {}).get(
                        "valid_rows", 0) for r in ranks)
                    if got != n:
                        raise AssertionError(
                            f"{name}: {c['model']} step {s} ({kind}) "
                            f"layer {li} {t}: counted {got} rows, the plan "
                            f"gives {n}")
        launches = {k: sum(r["launches"][k] for r in ranks)
                    for k in ranks[0]["launches"]}
        per_kind = spmd_gather_launches(x, transport, False, layers - 1)
        want = {k: SPMD_RANKS * v for k, v in train_launches(
            c["backend"], layers, MODEL_KINDS, per_kind, c["model"]).items()}
        want["packs_built_for_a_call"] = 0
        if launches != want:
            raise AssertionError(f"{name}: {c['model']}: launches "
                                 f"{launches}, want {want}")
        out[f"{name}_{c['model']}"] = launches
        recs.append({"model": c["model"], "backend": c["backend"],
                     "transport": transport, "max_err": err,
                     "tol": MODEL_TOL, "grad_rtol": GRAD_RTOL,
                     "counted_equal_plan": True,
                     "losses": ranks[0]["losses"],
                     "eps_grad": (float(ranks[0]["grads"][0]["eps"])
                                  if c["model"] == "gin" else None),
                     "launches": launches})
    emit(name, ranks=SPMD_RANKS, backend=backend, spawn_wall_s=wall_s,
         devices=list(devices) if not isinstance(devices, str) else devices,
         wire="gloo-host" if backend == "gloo" else "nccl",
         steps=MODEL_KINDS, cases=recs)
    return out


# ---------------------------------------------------------------------------
# phase 5b: JACA's CPU tier (host features) and online cache adaptation
# ---------------------------------------------------------------------------

# the share of the widest worker's halo rows that the forced plan keeps on
# the host at layer 0 (uncached and global tiers); the CLI's default
# capacity caches every halo row of the train cell on the device, which
# leaves the host tier empty
HOST_FRAC = 0.5
HOST_BF16_TOL = 5e-3      # host bf16 vs device bf16: one layer-0 bf16 cast
ADAPTIVE_TOL = 1e-5       # card vs CPU, 8 Adam steps at TRAIN_SGD_SCALE
TRAIN_KINDS = ["refresh", "cached", "cached", "cached", "pipelined",
               "cached", "cached", "cached"]


def forced_capacity(ps, host_frac: float):
    """A capacity that fills every tier, with ``host_frac`` of the widest
    worker's halo rows host-resident at layer 0 (the rule of the JAX
    package's out-of-core benchmark, ``benchmarks/out_of_core.py``)."""
    from repro_torch.core import CacheCapacity
    parts = len(ps.parts)
    max_halo = max(pt.n_halo for pt in ps.parts)
    local = max(1, int(round((1.0 - host_frac) * max_halo)))
    c_cpu = max(1, int(round(0.5 * host_frac * max_halo * parts)))
    return CacheCapacity(c_gpu=[local] * parts, c_cpu=c_cpu)


def forced_context(tctx: dict) -> dict:
    """The train cell's host plan (partition, RAPA, stacking) under the
    forced capacity: its exchange plan, unpadded and as the adaptive
    planner pads it."""
    from repro_torch.core import build_cache_plan
    from repro_torch.dist import build_exchange_plan
    ps = tctx["ps"]
    cap = forced_capacity(ps, HOST_FRAC)
    xplan = build_exchange_plan(ps, build_cache_plan(
        ps, cap, refresh_every=tctx["spec"].refresh_every))
    if not (xplan.uncached.n_rows and xplan.local.n_rows
            and xplan.glob.n_unique and xplan.host.n_fetch_rows):
        raise AssertionError("the forced plan leaves a tier empty")
    return {**tctx, "cap": cap, "xplan": xplan, "planner": None}


def host_plan_fields(cfg, xplan, kind: str, width: int) -> dict:
    """A host-features step's rows and bytes by the plan: the host tier
    every step, the global buffers on a stale step, a writeback on an
    emitting one."""
    dims = cfg.feat_dims[1:cfg.num_layers]
    stale = kind != "refresh"
    return {"fetch_rows": xplan.host_fetch_rows(stale, len(dims))["total"],
            "fetch_bytes": xplan.host_bytes_per_step(cfg.in_dim, dims, stale,
                                                     width),
            "writeback_bytes": (xplan.host_writeback_bytes(dims)
                                if kind != "cached" else 0)}


def step_records(rt, params, opt_state, kinds, xplan) -> tuple:
    """``kinds`` steps of ``rt`` from ``params``: per step its kind, host
    ms (fenced by reading the loss), loss and launches and, with host
    features, the store's counts against the plan's (raises where they
    differ), the consumed rows' host gather ms, and the device ms of the
    copies to the card that the step issued (``h2d_rows_ms``: the next
    step's ring fetch; ``h2d_buf_ms``: its global buffers) and of the
    compute stream's waits on them (``wait_rows_ms``, ``wait_buf_ms``).
    Returns the final state and records."""
    store, cfg = rt.host_store, rt.cfg
    width = rt.halo_dtype_bytes
    state, recs, logged = (params, opt_state, rt.caches0), [], []
    for kind in kinds:
        c0 = read_counts()
        s0 = store.snapshot() if store else None
        n0 = len(store.copy_log) if store else 0
        t0 = time.perf_counter()
        *state, m = getattr(rt, f"step_{kind}")(*state)
        loss = float(m["loss"])
        rec = {"kind": kind, "ms": 1e3 * (time.perf_counter() - t0),
               "loss": loss,
               "launches": {k: v - c0[k] for k, v in read_counts().items()}}
        if store is not None:
            d = store.delta(s0)
            logged.append((rec, n0, len(store.copy_log)))
            got = {"fetch_rows": d["fetch_rows"],
                   "fetch_bytes": d["fetch_bytes"],
                   "writeback_bytes": d["writeback_bytes"]}
            want = host_plan_fields(cfg, xplan, kind, width)
            if got != want:
                raise AssertionError(f"host step {kind}: counted {got}, the "
                                     f"plan gives {want}")
            rec.update(got, plan=want, gather_ms=1e3 * d["gather_s"])
        recs.append(rec)
    # the device ms of the copies and waits each step issued (its global
    # buffers' copies, the next step's ring copy; its waits on both)
    for rec, n0, n1 in logged:
        rec.update({f"{k}_ms": 1e3 * v
                    for k, v in store.copy_times(n0, n1).items()})
    return state, recs


def step_launches(backend: str, layers: int, kinds, per_kind: dict) -> dict:
    """The launches of ``kinds`` steps with no evaluation (see
    :func:`train_launches`)."""
    want = train_launches(backend, layers, list(kinds), per_kind)
    for k in ("ell_spmm", "csr_spmm_tail"):
        want[k] -= want[k] // (len(kinds) + 1)
    for k in ("gather_rows", "gather_rows_bwd"):
        want[k] -= per_kind["evaluation"][k]
    return want


def phase_train_host(fctx: dict, seed: int, lr: float) -> tuple:
    """The train cell under the forced plan (hybrid, full width,
    :data:`TRAIN_KINDS` with Adam) on a device-features and a
    host-features runtime, f32 and bf16, from the same parameters.

    Checks: f32 host losses and parameters equal to device mode's bit for
    bit; bf16 within ``HOST_BF16_TOL``; every host step's counted rows and
    bytes equal to the plan's; the f32 host run's launches those the
    steps give.  Returns the f32 host run's launches and losses."""
    import dataclasses as dc
    from repro_torch.dist import make_sim_runtime
    from repro_torch.models.gnn import init_gnn
    from repro_torch.optim import adam
    cfg, sp, xplan = fctx["cfg"], fctx["sp"], fctx["xplan"]
    params0 = init_gnn(cfg, torch.Generator().manual_seed(seed), "cuda")
    runs, launches = {}, None
    for halo in ("f32", "bf16"):
        for features in ("device", "host"):
            spec = dc.replace(fctx["spec"], halo_dtype=halo,
                              features=features)
            opt = adam(lr)
            t0 = time.perf_counter()
            rt = make_sim_runtime(cfg, sp, xplan, opt, spec=spec,
                                  device="cuda")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            if rt.host_store is not None:
                rt.host_store.timing = True
            zero_counts()
            state, recs = step_records(rt, params0, opt.init(params0),
                                       TRAIN_KINDS, xplan)
            if (halo, features) == ("f32", "host"):
                launches = read_counts()
            steady = steady_step_ms(rt, state[0], state[1])
            runs[(halo, features)] = {
                "losses": [r["loss"] for r in recs], "steps": recs,
                "params": [{k: v.cpu() for k, v in q.items()}
                           for q in state[0]],
                "build_s": build_s, "steady_step_ms": steady,
                "resident_bytes": (rt.host_store.resident_bytes()
                                   if rt.host_store else None)}
            del rt, state
            torch.cuda.empty_cache()
    dev, host = runs[("f32", "device")], runs[("f32", "host")]
    if dev["losses"] != host["losses"] or not all(
            torch.equal(a[k], b[k]) for a, b in zip(dev["params"],
                                                    host["params"])
            for k in a):
        raise AssertionError(f"train_host: f32 host mode differs from "
                             f"device mode: {host['losses']} vs "
                             f"{dev['losses']}")
    # bf16: host mode stages the layer-0 local tier through the bf16 cast
    # where device mode reads the f32 table.  The losses are held; Adam
    # normalises each update, so a parameter whose gradient is near 0
    # moves by up to lr a step either way: its difference is reported
    b_dev, b_host = runs[("bf16", "device")], runs[("bf16", "host")]
    bf16_err = max(abs(a - b) for a, b in zip(b_dev["losses"],
                                              b_host["losses"]))
    bf16_param_err = max(float((a[k] - b[k]).abs().max())
                         for a, b in zip(b_dev["params"], b_host["params"])
                         for k in a)
    if not bf16_err <= HOST_BF16_TOL:
        raise AssertionError(f"train_host: bf16 host vs device losses "
                             f"{bf16_err}")
    per_kind = gather_launches(xplan, cfg.num_layers - 1)
    want = step_launches("hybrid", cfg.num_layers, TRAIN_KINDS, per_kind)
    if launches != want:
        raise AssertionError(f"train_host: launches {launches}, want {want}")
    if not (np.all(np.isfinite(host["losses"]))
            and host["losses"][-1] < host["losses"][0]):
        raise AssertionError(f"train_host: losses {host['losses']}")

    def by_kind(run, key):
        return {k: statistics.median(r[key] for r in run["steps"][1:]
                                     if r["kind"] == k)
                for k in ("cached", "pipelined")}
    emit("train_host", host_frac=HOST_FRAC,
         capacity={"c_gpu": fctx["cap"].c_gpu, "c_cpu": fctx["cap"].c_cpu},
         tier_rows={"uncached": xplan.uncached.n_rows,
                    "local": xplan.local.n_rows,
                    "global": xplan.glob.n_unique,
                    "host": xplan.host.n_fetch_rows},
         host_width=xplan.host.width, step_kinds=TRAIN_KINDS,
         losses=host["losses"], f32_host_equals_device=True,
         bf16_loss_max_abs_err=bf16_err, bf16_tol=HOST_BF16_TOL,
         bf16_param_max_abs_err=bf16_param_err,
         steps={f"{h}_{f}": r["steps"] for (h, f), r in runs.items()},
         median_step_ms={f"{h}_{f}": by_kind(r, "ms")
                         for (h, f), r in runs.items()},
         steady_step_ms={f"{h}_{f}": r["steady_step_ms"]
                         for (h, f), r in runs.items()},
         host_median_ms={k: by_kind(host, k)
                         for k in ("gather_ms", "h2d_rows_ms", "h2d_buf_ms",
                                   "wait_rows_ms", "wait_buf_ms")},
         build_s={f"{h}_{f}": r["build_s"] for (h, f), r in runs.items()},
         host_resident_bytes=host["resident_bytes"], launches=launches,
         gather_launches_per_kind=per_kind)
    return launches, host["losses"], params0


def phase_train_host_cli(tctx: dict, argv: list[str]) -> dict:
    """``launch.train``'s entry with ``--features host`` at the CLI's
    default capacity on the train cell's host plan: every halo row in the
    local tier, so the host tier is empty and ``l0loc`` (59,213 rows x 500
    features, 118 MB) is staged once per install.  Checks: the losses
    those of the device-features ``train`` run bit for bit, the launches
    its launches, the counted rows the plan's.  Then one reinstall
    (``set_plan`` of the same plan) is timed: the ``l0loc`` restage."""
    from repro_torch.launch.train import build_parser, train_gnn
    args = build_parser().parse_args(argv)
    zero_counts()
    out, ctx = train_gnn(args, cli_context(tctx, args))
    torch.cuda.synchronize()
    launches = read_counts()
    rep, rt, xplan = ctx["report"], ctx["runtime"], ctx["xplan"]
    if rep.losses != tctx["report"].losses:
        raise AssertionError(f"train_host_cli: losses {rep.losses} differ "
                             f"from the device run's "
                             f"{tctx['report'].losses}")
    width = 2 if args.halo_dtype == "bf16" else 4
    plan_rows = sum(host_plan_fields(ctx["cfg"], xplan, k, width)[
        "fetch_rows"] for k in rep.step_kinds)
    if rep.host_fetch_rows != plan_rows:
        raise AssertionError(f"train_host_cli: {rep.host_fetch_rows} rows, "
                             f"the plan gives {plan_rows}")
    store = rt.host_store
    store.timing = True
    before = store.snapshot()
    t0 = time.perf_counter()
    rt.set_plan(xplan)
    torch.cuda.synchronize()
    install_ms = 1e3 * (time.perf_counter() - t0)
    d, copies = store.delta(before), store.copy_times()
    if d["fetch_rows"] != xplan.local.n_rows:
        raise AssertionError(f"train_host_cli: l0loc restage {d}")
    emit("train_host_cli", argv=argv, losses=rep.losses,
         equal_to_device_run=True, step_kinds=rep.step_kinds,
         step_ms=[1e3 * t for t in rep.step_s],
         host_fetch_rows=out["host_fetch_rows"],
         host_fetch_bytes=out["host_fetch_bytes"],
         host_writeback_bytes=out["host_writeback_bytes"],
         host_width=xplan.host.width, l0loc_rows=d["fetch_rows"],
         l0loc_bytes=d["fetch_bytes"], install_ms=install_ms,
         l0loc_gather_ms=1e3 * d["gather_s"],
         l0loc_h2d_ms=1e3 * copies["h2d_rows"], launches=launches)
    del ctx
    torch.cuda.empty_cache()
    return launches


def membership(plan) -> tuple:
    return (tuple(frozenset(w.local_gids.tolist()) for w in plan.workers),
            frozenset(plan.global_gids.tolist()))


def overlap(a, b) -> float:
    """Jaccard overlap of two memberships (local tiers and global tier)."""
    inter = sum(len(x & y) for x, y in zip(a[0], b[0])) + len(a[1] & b[1])
    union = sum(len(x | y) for x, y in zip(a[0], b[0])) + len(a[1] | b[1])
    return inter / max(1, union)


def adaptive_small(args, policy: str, features: str) -> dict:
    """The ``policy`` run at ``TRAIN_SGD_SCALE`` under the forced
    capacity, on the card and on the CPU from the same parameters: each
    device's losses and final membership."""
    from repro_torch.core import AdaptivePlanner, StalenessController
    from repro_torch.dist import TrainSpec, make_sim_runtime, train_capgnn
    from repro_torch.launch.train import prepare_train
    from repro_torch.models.gnn import init_gnn
    from repro_torch.optim import adam
    args01 = argparse.Namespace(**{**vars(args), "scale":
                                   float(TRAIN_SGD_SCALE)})
    ctx = prepare_train(args01)
    cap = forced_capacity(ctx["ps"], HOST_FRAC)
    spec = TrainSpec.from_cli_args(args01)
    params0 = init_gnn(ctx["cfg"], torch.Generator().manual_seed(args.seed),
                       "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        planner = AdaptivePlanner(ctx["ps"], cap,
                                  refresh_every=args.refresh_every,
                                  policy=policy, seed=args.seed)
        x = planner.exchange_plan()
        rt = make_sim_runtime(ctx["cfg"], ctx["sp"], x, adam(args.lr),
                              spec=spec, device=dev)
        _, rep = train_capgnn(
            ctx["cfg"], rt, x, args.parts, adam(args.lr), epochs=args.epochs,
            controller=StalenessController(refresh_every=args.refresh_every,
                                           replan_every=args.replan_every),
            params0=[{k: v.to(dev) for k, v in q.items()} for q in params0],
            planner=planner, spec=spec)
        out[dev] = {"losses": rep.losses, "plan": membership(planner.plan),
                    "replan_events": rep.replan_events,
                    "hit_rate": rep.hit_rate}
    return out


def phase_train_adaptive(fctx: dict) -> dict:
    """``launch.train``'s entry with ``--cache-policy lru`` (host
    features) and ``drift`` (device features), ``--replan-every 1``, on
    the forced capacity padded by the planner: 8 steps whose refresh at
    step 4 is a ``step_transition`` to the planner's re-plan.  Checks: a
    transition ran; the launches those the steps and the closing
    evaluation give; at ``TRAIN_SGD_SCALE``, the card's ``lru`` re-plan
    memberships equal the CPU's and its losses within ``ADAPTIVE_TOL``
    (``drift`` reads the measured drift, so its membership overlap with
    the CPU's is reported, not required).  Per policy: ``replan_events``,
    ``hit_rate``, ``replan_ms`` (the planner's and the exchange maps'
    host ms) and, apart, the gathers' transposed maps (``gather_pack``)
    rebuilt at the new plan."""
    from repro_torch.core import AdaptivePlanner
    from repro_torch.dist import exchange_arrays
    from repro_torch.launch.train import build_parser, train_gnn
    by_path = {}
    for policy, features in (("lru", "host"), ("drift", "device")):
        argv = TRAIN_ARGV + ["--cache-policy", policy, "--replan-every", "1",
                             "--features", features]
        args = build_parser().parse_args(argv)
        planner = AdaptivePlanner(fctx["ps"], fctx["cap"],
                                  refresh_every=args.refresh_every,
                                  policy=policy, seed=args.seed)
        x0 = planner.exchange_plan()
        zero_counts()
        out, ctx = train_gnn(args, cli_context(fctx, args, planner))
        torch.cuda.synchronize()
        launches = read_counts()
        rep, cfg = ctx["report"], ctx["cfg"]
        if "transition" not in rep.step_kinds or rep.replan_events < 1:
            raise AssertionError(f"train_adaptive {policy}: no transition: "
                                 f"{rep.step_kinds}")
        per_kind = gather_launches(x0, cfg.num_layers - 1)
        per_kind["transition"] = per_kind["pipelined"]
        want = train_launches("hybrid", cfg.num_layers, rep.step_kinds,
                              per_kind)
        if launches != want:
            raise AssertionError(f"train_adaptive {policy}: launches "
                                 f"{launches}, want {want}")
        # the transposed maps of the installed plan, rebuilt alone
        x1 = planner.exchange_plan()
        ni = fctx["sp"].n_inner_max
        times = {}
        for grad in (False, True):
            t0 = time.perf_counter()
            exchange_arrays(x1, ni, "cuda", grad=grad,
                            include_host=features == "host")
            torch.cuda.synchronize()
            times[grad] = 1e3 * (time.perf_counter() - t0)
        small = adaptive_small(args, policy, features)
        card, cpu = small["cuda"], small["cpu"]
        loss_err = float(np.abs(np.subtract(card["losses"],
                                            cpu["losses"])).max())
        same_plan = card["plan"] == cpu["plan"]
        if policy == "lru" and not (same_plan and loss_err <= ADAPTIVE_TOL):
            raise AssertionError(f"train_adaptive lru at scale "
                                 f"{TRAIN_SGD_SCALE}: the card's re-plans "
                                 f"equal the CPU's: {same_plan}, losses "
                                 f"{loss_err}")
        emit("train_adaptive", policy=policy, features=features, argv=argv,
             capacity={"c_gpu": fctx["cap"].c_gpu, "c_cpu": fctx["cap"].c_cpu},
             losses=rep.losses, step_kinds=rep.step_kinds,
             step_ms=[1e3 * t for t in rep.step_s],
             replan_events=rep.replan_events, hit_rate=rep.hit_rate,
             replan_ms=rep.replan_ms, maps_ms_without_packs=times[False],
             maps_ms_with_packs=times[True],
             gather_pack_ms=times[True] - times[False],
             comm_bytes=rep.comm_bytes,
             host_fetch_rows=rep.host_fetch_rows,
             host_fetch_bytes=rep.host_fetch_bytes,
             host_writeback_bytes=rep.host_writeback_bytes,
             tier_rows_after={"uncached": x1.uncached.n_rows,
                              "local": x1.local.n_rows,
                              "global": x1.glob.n_unique},
             launches=launches, small_scale=float(TRAIN_SGD_SCALE),
             small_card_cpu_loss_err=loss_err,
             small_same_membership=same_plan,
             small_membership_overlap=overlap(card["plan"], cpu["plan"]),
             small_replan_events=card["replan_events"],
             small_hit_rate={"cuda": card["hit_rate"], "cpu": cpu["hit_rate"]})
        by_path[f"train_adaptive_{policy}"] = launches
        del ctx
        torch.cuda.empty_cache()
    return by_path


def sim_reference(fctx: dict, spec, params0, lr: float, planner=None) -> dict:
    """The card's single-process run of ``spec`` on the forced plan (or
    ``planner``'s), 8 Adam steps through ``train_capgnn``."""
    from repro_torch.core import StalenessController
    from repro_torch.dist import make_sim_runtime, train_capgnn
    from repro_torch.optim import adam
    x = fctx["xplan"] if planner is None else planner.exchange_plan()
    rt = make_sim_runtime(fctx["cfg"], fctx["sp"], x, adam(lr), spec=spec,
                          device="cuda")
    _, rep = train_capgnn(
        fctx["cfg"], rt, x, len(fctx["ps"].parts), adam(lr), epochs=8,
        controller=StalenessController(refresh_every=spec.refresh_every),
        params0=params0, planner=planner, spec=spec)
    out = {"losses": rep.losses, "replan_events": rep.replan_events,
           "hit_rate": rep.hit_rate, "step_kinds": rep.step_kinds}
    del rt
    torch.cuda.empty_cache()
    return out


def host_spec(fctx: dict, transport: str, features: str, policy: str):
    """An ``spmd_host`` run's spec on the forced plan, and a maker of its
    planner (None under the ``static`` policy)."""
    import dataclasses as dc
    from repro_torch.core import AdaptivePlanner
    spec = dc.replace(fctx["spec"], transport=transport, features=features,
                      cache_policy=policy)

    def planner():
        return (None if policy == "static" else AdaptivePlanner(
            fctx["ps"], fctx["cap"], refresh_every=spec.refresh_every,
            policy=policy, seed=spec.seed))
    return spec, planner


def spmd_host_job(fctx: dict, transport: str, params0, lr: float,
                  features: str = "host", policy: str = "static") -> tuple:
    """:func:`phase_spmd_host`'s rank program."""
    spec, planner = host_spec(fctx, transport, features, policy)
    pl = planner()
    x0 = fctx["xplan"] if pl is None else pl.exchange_plan()
    params_np = [{k: v.cpu().numpy() for k, v in q.items()} for q in params0]
    return (spmd_rank, (fctx["cfg"], fctx["sp"], x0, spec, params_np, 8, lr,
                        0, pl))


def phase_spmd_host(name: str, fctx: dict, ref: dict, transport: str,
                    backend: str, devices, params0, lr: float,
                    features: str = "host", policy: str = "static",
                    spawned=None) -> dict:
    """The SPMD runtime on 4 ranks over ``backend`` under ``transport``,
    the forced plan, ``features`` (each rank staging its own host tier
    from its own store) and the cache ``policy``: 8 Adam steps against
    the card's single-process run of the same spec (``ref``), losses
    within ``TRAJ_ATOL``; every step's counted wire rows those of its
    read and emit plans; with host features, the counted host rows,
    bytes and writebacks summed over the ranks equal to the plan's; the
    launches summed over the ranks those the backend gives.
    ``spawned``: :func:`spmd_host_job`'s results from a spawn shared with
    other phases, and its wall seconds."""
    from repro_torch.core import StalenessController
    cfg, sp = fctx["cfg"], fctx["sp"]
    p, layers = sp.num_parts, cfg.num_layers
    job = spmd_host_job(fctx, transport, params0, lr, features, policy)
    (ranks,), wall_s = spawned or spawn_jobs([job], p, backend, devices)
    spec, planner = host_spec(fctx, transport, features, policy)
    x0 = job[1][2]
    kinds, losses = ranks[0]["step_kinds"], ranks[0]["losses"]
    err = max(abs(a - b) for r in ranks
              for a, b in zip(r["losses"], ref["losses"]))
    if not err <= TRAJ_ATOL or kinds != ref["step_kinds"]:
        raise AssertionError(f"{name}: losses {err} from the card's sim "
                             f"run; kinds {kinds} / {ref['step_kinds']}")
    # each step's (read, emit) plan, replaying the loop's re-plans
    plans, x, rp = [], x0, planner()
    ctl = StalenessController(refresh_every=spec.refresh_every)
    for kind in kinds:
        refresh = ctl.should_refresh()
        if rp is not None and ctl.should_replan():
            nxt = rp.exchange_plan(rp.replan())
            plans.append((x, nxt))
            x = nxt
        else:
            plans.append((x, x))
        if rp is not None:
            rp.observe_step(layers=layers - 1)
        ctl.observe(None, refreshed=refresh)
    for s, kind in enumerate(kinds):
        refresh = kind != "cached"
        xr, xe = plans[s]
        want = {"uncached": xr.transport_rows(transport, refresh)["uncached"],
                "local": xe.transport_rows(transport, refresh)["local"],
                "global": xe.transport_rows(transport, refresh)["global"]}
        for li in range(1, layers):
            for t, n in want.items():
                c = sum(r["wire"][s].get((li, t), {}).get("valid_rows", 0)
                        for r in ranks)
                if c != n:
                    raise AssertionError(f"{name}: step {s} ({kind}) layer "
                                         f"{li} {t}: counted {c}, the plan "
                                         f"gives {n}")
    counts = {}
    if features == "host":
        width = 2 if spec.halo_dtype == "bf16" else 4
        plan = [host_plan_fields(cfg, x0, k, width) for k in kinds]
        for f in ("fetch_rows", "fetch_bytes", "writeback_bytes"):
            got = sum(r[f"host_{f}"] for r in ranks)
            counts[f] = {"ranks": [r[f"host_{f}"] for r in ranks],
                         "plan": sum(q[f] for q in plan)}
            if got != counts[f]["plan"]:
                raise AssertionError(f"{name}: host {f} {counts[f]}")
    per_kind = spmd_gather_launches(x0, transport, spec.halo_dtype == "bf16",
                                    layers - 1)
    per_kind["transition"] = per_kind["pipelined"]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    want = {k: p * v for k, v in train_launches(
        spec.backend, layers, kinds, per_kind).items()}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    if policy != "static" and not (
            all(r["replan_events"] == ref["replan_events"] for r in ranks)
            and all(r["hit_rate"] == ref["hit_rate"] for r in ranks)):
        raise AssertionError(f"{name}: the ranks' re-plans differ from the "
                             "card's sim run")

    def by_kind(key):
        return {k: statistics.median(t for t, kk in
                                     zip(ranks[0][key], kinds) if kk == k)
                for k in sorted(set(kinds))}
    emit(name, transport=transport, backend=backend, ranks=p,
         features=features, cache_policy=policy,
         devices=list(devices) if not isinstance(devices, str) else devices,
         wire="gloo-host" if backend == "gloo" else "nccl",
         losses=losses, step_kinds=kinds, max_abs_err_vs_sim=err,
         tol=TRAJ_ATOL, median_step_ms=by_kind("step_ms"),
         median_host_stage_ms=by_kind("host_stage_ms"),
         counted_equal_plan=True, host_counts=counts,
         replan_events=ranks[0]["replan_events"],
         hit_rate=ranks[0]["hit_rate"], launches=launches,
         test=ranks[0]["test"], spawn_wall_s=wall_s)
    return launches


# ---------------------------------------------------------------------------
# faults and defenses, the tracer, checkpoints
# ---------------------------------------------------------------------------

# the slice's fault spec (one step a class) and its defense flags; every
# injected event must be matched by exactly one counted defense
FAULT_SPEC = ("fetch_drop@3;fetch_delay@2:delay_s=0.12;halo_corrupt@4;"
              "grad_nan@5")
GUARD_FLAGS = ["--guard-every", "2", "--fetch-retries", "1", "--checksums"]
FAULT_PAIRS = {"fetch_drop": "fetch_errors", "fetch_delay": "slow_fetches",
               "halo_corrupt": "corruptions_detected",
               "grad_nan": "rollbacks", "mem_pressure": "mem_backoffs"}
# a faulted run's final loss against the clean run's in the same call
# (the JAX package's fault suite, benchmarks/fault_tolerance.py LOSS_TOL)
FAULT_LOSS_TOL = 0.25
SPMD_FAULT_SPEC = "fetch_drop@3;grad_nan@5"
SPMD_FAULT_GUARD = {"guard_every": 2, "fetch_retries": 1}
CKPT_TOL = 1e-6           # resumed against uninterrupted, the same card
OUT_DIR = ROOT / "build" / "chip_smoke"   # traces and checkpoints (ignored)


def cli_context(ctx: dict, args, planner=None) -> dict:
    """``launch.train``'s context for ``args`` on the host plan of
    ``ctx`` (its exchange plan, or ``planner``'s padded plan)."""
    from repro_torch.dist import TrainSpec
    keep = ("task", "ps", "profiles", "group", "cfg", "sp")
    return {**{k: ctx[k] for k in keep}, "planner": planner,
            "xplan": ctx["xplan"] if planner is None
            else planner.exchange_plan(),
            "spec": TrainSpec.from_cli_args(args), "host_plan_s": 0.0}


def kind_ms(rep) -> dict:
    """Median host ms of each step kind after step 0."""
    out = {}
    for kind in sorted(set(rep.step_kinds[1:])):
        out[kind] = statistics.median(
            1e3 * t for t, k in zip(rep.step_s[1:], rep.step_kinds[1:])
            if k == kind)
    return out


def check_defended(name: str, rep) -> dict:
    """Each injected fault class matched by exactly as many counted
    defenses, and more than none."""
    pairs = {}
    for kind, n in rep.faults_injected.items():
        if kind in FAULT_PAIRS and n:
            got = rep.fault_events[FAULT_PAIRS[kind]]
            if got != n:
                raise AssertionError(f"{name}: {kind} injected {n}, "
                                     f"{FAULT_PAIRS[kind]} {got}")
            pairs[kind] = n
    return pairs


def phase_train_faults(fctx: dict) -> dict:
    """The slice's path: ``launch.train gnn --backend hybrid --features
    host --refresh-every 2 --faults FAULT_SPEC --checksums --guard-every 2
    --fetch-retries 1 --trace --ckpt-dir`` on the forced host plan at full
    width, 8 Adam steps (the CLI's ``fetch_timeout_s`` 0.1 s; the spec's
    0.12 s delay exceeds it), after the same flags without the fault,
    guard, trace and checkpoint flags (the clean run).  Then
    ``--cache-policy lru --faults mem_pressure@4``.  Checks: every class injected == its
    defense, exactly, and > 0; finite final losses within
    ``FAULT_LOSS_TOL`` of the clean run's; the trace valid; the
    checkpoint written.  Returns the faulted run's launches."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.core import AdaptivePlanner
    from repro_torch.launch.train import build_parser, train_gnn
    from repro_torch.obs.check import check_file
    out_dir = OUT_DIR / "train_faults"
    base = TRAIN_ARGV + ["--features", "host", "--refresh-every", "2"]
    argv = base + ["--faults", FAULT_SPEC, *GUARD_FLAGS, "--trace",
                   "--trace-dir", str(out_dir), "--ckpt-dir",
                   str(out_dir / "ckpt")]
    cargs = build_parser().parse_args(base)
    _, cctx = train_gnn(cargs, cli_context(fctx, cargs))
    clean = cctx["report"]
    clean_losses = clean.losses
    del cctx
    args = build_parser().parse_args(argv)
    zero_counts()
    out, ctx = train_gnn(args, cli_context(fctx, args))
    torch.cuda.synchronize()
    launches = read_counts()
    rep, tr = ctx["report"], ctx["tracer"]
    pairs = check_defended("train_faults", rep)
    if set(pairs) != {"fetch_drop", "fetch_delay", "halo_corrupt",
                      "grad_nan"}:
        raise AssertionError(f"train_faults: classes defended {pairs}")
    gap = abs(rep.losses[-1] - clean_losses[-1])
    if not (np.isfinite(rep.losses[-1]) and gap <= FAULT_LOSS_TOL):
        raise AssertionError(f"train_faults: final loss {rep.losses[-1]}, "
                             f"clean {clean_losses[-1]}")
    stats = check_file(out["trace_file"], ["refresh", "cached", "rollback"])
    if latest_step(args.ckpt_dir) != args.epochs:
        raise AssertionError("train_faults: no checkpoint at the last step")
    steady = kind_ms(rep)
    del ctx
    torch.cuda.empty_cache()

    # memory pressure: the backoff shrinks the planner's capacity and
    # replans this very step
    largs = build_parser().parse_args(base + ["--cache-policy", "lru",
                                              "--faults", "mem_pressure@4"])
    planner = AdaptivePlanner(fctx["ps"], fctx["cap"], refresh_every=2,
                              policy="lru", seed=largs.seed)
    lout, lctx = train_gnn(largs, cli_context(fctx, largs, planner))
    lrep = lctx["report"]
    lpairs = check_defended("train_faults lru", lrep)
    if lpairs != {"mem_pressure": 1} or not np.isfinite(lrep.losses[-1]):
        raise AssertionError(f"train_faults lru: {lpairs}, losses "
                             f"{lrep.losses}")
    emit("train_faults", argv=argv, fault_spec=FAULT_SPEC,
         faults_injected=rep.faults_injected, fault_events=rep.fault_events,
         injected_equals_defended=pairs, corrupted_tier=rep.fault_tiers,
         rollback_step=[s.step for s in tr.spans if s.kind == "rollback"],
         losses=rep.losses, clean_losses=clean_losses,
         final_loss_gap=gap, loss_tol=FAULT_LOSS_TOL,
         step_kinds=rep.step_kinds, steady_step_ms=steady,
         clean_steady_step_ms=kind_ms(clean),
         host_fetch_rows=rep.host_fetch_rows, phase_stats=rep.phase_stats,
         trace_spans_by_cat=stats["spans_by_cat"], launches=launches,
         lru={"argv": largs.faults, "faults_injected": lrep.faults_injected,
              "fault_events": lrep.fault_events,
              "step_kinds": lrep.step_kinds, "losses": lrep.losses,
              "replan_events": lrep.replan_events,
              "hit_rate": lrep.hit_rate, "steady_step_ms": kind_ms(lrep)})
    del lctx
    torch.cuda.empty_cache()
    return launches


def step_launch_log(rt) -> list:
    """Wrap ``rt``'s step functions so each call logs its kind and the
    kernel launches it made (counted on the host at launch: no sync)."""
    log = []
    for kind in ("refresh", "cached", "pipelined"):
        def logged(*state, _fn=getattr(rt, f"step_{kind}"), _kind=kind):
            c0 = read_counts()
            res = _fn(*state)
            log.append((_kind, {k: v - c0[k]
                                for k, v in read_counts().items()}))
            return res
        setattr(rt, f"step_{kind}", logged)
    return log


def phase_train_traced(fctx: dict, seed: int, lr: float) -> None:
    """The train cell on the forced plan, device and host features, 8 Adam
    steps untraced, traced, traced with the device-wide fence (twice),
    traced, untraced on one runtime each.  Checks:
    the traced totals equal the report's exactly (``comm_bytes``,
    ``host_fetch_rows`` / ``_bytes``, ``host_writeback_bytes``, steps);
    the exported trace passes ``repro_torch.obs.check``; every step's
    launches equal untraced and traced.  Prints ``phase_stats`` and the
    steady step ms of the three: the cost of the fence, which waits on the
    loss's stream, beside a fence on the whole device (the port's before
    it; in host mode that one also waits for the next step's ring copy on
    the side stream)."""
    import dataclasses as dc
    from repro_torch.core import StalenessController
    from repro_torch.dist import make_sim_runtime, train_capgnn
    from repro_torch.models.gnn import init_gnn
    from repro_torch.obs import NULL_TRACER, Tracer
    from repro_torch.obs.check import check_file
    from repro_torch.optim import adam

    class DeviceFenceTracer(Tracer):
        def fence(self, x):
            if self.enabled and self.do_fence and x.is_cuda:
                torch.cuda.synchronize(x.device)
            return x
    cfg, sp, xplan = fctx["cfg"], fctx["sp"], fctx["xplan"]
    params0 = init_gnn(cfg, torch.Generator().manual_seed(seed), "cuda")
    res = {}
    for features in ("device", "host"):
        spec = dc.replace(fctx["spec"], features=features)
        rt = make_sim_runtime(cfg, sp, xplan, adam(lr), spec=spec,
                              device="cuda")
        log = step_launch_log(rt)
        runs = []
        for traced in (False, True, "device_fence", "device_fence", True,
                       False):
            tr = (None if not traced else DeviceFenceTracer()
                  if traced == "device_fence" else Tracer())
            n0 = len(log)
            _, rep = train_capgnn(
                cfg, rt, xplan, len(fctx["ps"].parts), adam(lr), epochs=8,
                controller=StalenessController(
                    refresh_every=spec.refresh_every),
                params0=params0, tracer=tr, spec=spec)
            rt.set_tracer(NULL_TRACER)
            runs.append((traced, rep, tr, log[n0:]))
        untraced = [r for r in runs if not r[0]]
        traced_runs = [r for r in runs if r[0] is True]
        device_fenced = [r for r in runs if r[0] == "device_fence"]
        for _, rep, tr, steps in traced_runs + device_fenced:
            tot = tr.totals()
            want = {"wire_bytes": rep.comm_bytes,
                    "host_fetch_rows": rep.host_fetch_rows,
                    "host_fetch_bytes": rep.host_fetch_bytes,
                    "host_writeback_bytes": rep.host_writeback_bytes,
                    "steps": len(rep.losses)}
            if {k: tot[k] for k in want} != want:
                raise AssertionError(f"train_traced {features}: totals "
                                     f"{tot}, report {want}")
            if steps != untraced[0][3] or rep.losses != untraced[0][1].losses:
                raise AssertionError(f"train_traced {features}: launches or "
                                     "losses differ traced and untraced")
        paths = traced_runs[0][2].export(str(OUT_DIR / "traced"),
                                         prefix=f"train_{features}")
        stats = check_file(paths["trace"], ["refresh", "cached", "pipelined"])

        def steady(group):
            return {k: statistics.median(
                1e3 * t for _, rep, _, _ in group
                for t, kk in zip(rep.step_s[1:], rep.step_kinds[1:])
                if kk == k) for k in ("refresh", "cached", "pipelined")
                if k in group[0][1].step_kinds[1:]}
        res[features] = {
            "phase_stats": traced_runs[0][1].phase_stats,
            "totals": traced_runs[0][2].totals(),
            "steady_step_ms_untraced": steady(untraced),
            "steady_step_ms_traced": steady(traced_runs),
            "steady_step_ms_traced_device_fence": steady(device_fenced),
            "launches_per_step": [{"kind": k, **c} for k, c in
                                  untraced[0][3]],
            "trace_spans_by_cat": stats["spans_by_cat"],
            "step_kinds": untraced[0][1].step_kinds}
        del rt, runs
        torch.cuda.empty_cache()
    emit("train_traced", launches_equal=True, totals_equal_report=True,
         **res)


def phase_device_trace(tctx: dict) -> None:
    """``launch.train --device-trace-dir`` over 3 steps of the train cell:
    the ``torch.profiler`` capture holds the port's kernels by name, each
    ELL forward launched inside a ``layer{li}/spmm`` range and each row
    gather inside a tier-pull range (a kernel is placed by the host launch
    its ``correlation`` id names); every CSR launch inside a range: the
    hybrid tail's inside the layer ranges, ``d_h`` (launched by autograd's
    thread) inside ``transpose(layer{li}/spmm)`` and the gather's backward
    inside ``transpose(tier_pull_...)``."""
    from repro_torch.launch.train import build_parser, train_gnn
    argv = TRAIN_ARGV + ["--device-trace-dir", str(OUT_DIR / "device")]
    argv[argv.index("--epochs") + 1] = "3"
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    out, ctx = train_gnn(args, shared_context(tctx, argv))
    wall_s = time.perf_counter() - t0
    events = json.load(open(out["device_trace_file"]))["traceEvents"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ranges = [e for e in events if e.get("cat") == "user_annotation"]

    def enclosing(ev) -> list:
        return [r["name"] for r in ranges
                if r["tid"] == ev["tid"] and r["pid"] == ev["pid"]
                and r["ts"] <= ev["ts"] <= r["ts"] + r["dur"]]
    kernels = {"ell_spmm": "ell_spmm_kernel", "csr_spmm": "csr_spmm_kernel",
               "gather_rows": "gather_rows_kernel"}
    found = {}
    for short, sym in kernels.items():
        evs = [e for e in events if e.get("cat") == "kernel"
               and sym in e.get("name", "")]
        where = [enclosing(launch[e["args"]["correlation"]])
                 for e in evs if e["args"].get("correlation") in launch]
        found[short] = {
            "kernels": len(evs), "launches_found": len(where),
            "in_layer_spmm": sum(any(re.fullmatch(r"layer\d+/spmm", n)
                                     for n in w) for w in where),
            "in_tier_pull": sum(any(n.startswith("tier_pull") for n in w)
                                for w in where),
            "in_transpose_layer_spmm": sum(
                any(re.fullmatch(r"transpose\(layer\d+/spmm\)", n)
                    for n in w) for w in where),
            "in_transpose_tier_pull": sum(
                any(n.startswith("transpose(tier_pull") for n in w)
                for w in where),
            "in_no_range": sum(not w for w in where),
            "device_ms": sum(e["dur"] for e in evs) / 1e3}
    ell, csr, gat = found["ell_spmm"], found["csr_spmm"], found["gather_rows"]
    # every CSR launch: the hybrid tail's forward inside its layer's range,
    # d_h inside the transpose of it, the gather's backward inside the
    # transpose of its tier pull
    csr_placed = (csr["in_layer_spmm"] + csr["in_transpose_layer_spmm"]
                  + csr["in_transpose_tier_pull"])
    if not (ell["kernels"] and ell["in_layer_spmm"] == ell["kernels"]
            and gat["kernels"] and gat["in_tier_pull"] == gat["kernels"]
            and csr["kernels"] and csr["launches_found"] == csr["kernels"]
            and csr_placed == csr["kernels"]
            and csr["in_transpose_layer_spmm"] > 0):
        raise AssertionError(f"device_trace: the kernels by range {found}")
    emit("device_trace", argv=argv, trace_file=out["device_trace_file"],
         events=len(events), kernels=found, wall_s=wall_s,
         ranges={n: sum(r["name"] == n for r in ranges) for n in
                 sorted({r["name"] for r in ranges})})
    del ctx
    torch.cuda.empty_cache()


def spmd_faults_rank(rank, world_size, device, cfg, sp, xplan, specs,
                     params_np, lr, fault_spec, guard_kw):
    """One rank of ``spmd_faults``: per spec of ``specs`` (id -> TrainSpec)
    an 8-step ``train_capgnn`` with Adam under this rank's own fault plan
    (seed 0) and guard; its losses, kinds, counts, wire counts and
    launches."""
    from repro_torch.core import StalenessController
    from repro_torch.dist import make_spmd_runtime, train_capgnn
    from repro_torch.faults import FaultPlan, GuardConfig
    from repro_torch.optim import adam
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, spec in specs.items():
        opt = adam(lr)
        rt = make_spmd_runtime(cfg, sp, xplan, opt, spec=spec, device=device)
        params = [{k: torch.as_tensor(v, device=device) for k, v in p.items()}
                  for p in params_np]
        zero_counts()
        _, rep = train_capgnn(
            cfg, rt, xplan, world_size, opt, epochs=8,
            controller=StalenessController(refresh_every=spec.refresh_every),
            params0=params, faults=FaultPlan.parse(fault_spec, seed=0),
            guard=GuardConfig(**guard_kw), spec=spec)
        torch.cuda.synchronize(device)
        out[name] = {"losses": rep.losses, "step_kinds": rep.step_kinds,
                     "faults_injected": rep.faults_injected,
                     "fault_events": rep.fault_events,
                     "wire": [w["counts"] for w in rt.wire_log[:8]],
                     "launches": read_counts(),
                     "step_ms": [1e3 * s for s in rep.step_s],
                     "host_fetch_rows": rep.host_fetch_rows}
        del rt
        torch.cuda.empty_cache()
    return out


def spmd_faults_job(fctx: dict, params0, lr: float) -> tuple:
    """:func:`phase_spmd_faults`' rank program: host features on the
    forced plan under both transports."""
    import dataclasses as dc
    specs = {t: dc.replace(fctx["spec"], transport=t, features="host")
             for t in ("p2p", "allgather")}
    params_np = [{k: v.cpu().numpy() for k, v in q.items()} for q in params0]
    return (spmd_faults_rank, (fctx["cfg"], fctx["sp"], fctx["xplan"], specs,
                               params_np, lr, SPMD_FAULT_SPEC,
                               SPMD_FAULT_GUARD))


def phase_spmd_faults(name: str, fctx: dict, params0, lr: float, backend: str,
                      devices, spawned=None) -> dict:
    """The SPMD runtime on 4 ranks over ``backend``, host features on the
    forced plan, both transports in one spawn, ``SPMD_FAULT_SPEC`` under
    ``SPMD_FAULT_GUARD``, against the card's single-process runtime under
    the same faults: every rank's injected and defense counts equal to
    it, losses within ``TRAJ_ATOL``, every step's counted wire rows equal
    to the plan's.  ``spawned``: :func:`spmd_faults_job`'s results from a
    spawn shared with other phases, and its wall seconds."""
    from repro_torch.core import StalenessController
    from repro_torch.dist import make_sim_runtime, train_capgnn
    from repro_torch.faults import FaultPlan, GuardConfig
    from repro_torch.optim import adam
    cfg, sp, xplan = fctx["cfg"], fctx["sp"], fctx["xplan"]
    p, layers = sp.num_parts, cfg.num_layers
    job = spmd_faults_job(fctx, params0, lr)
    specs = job[1][3]
    rt = make_sim_runtime(cfg, sp, xplan, adam(lr), spec=specs["p2p"],
                          device="cuda")
    _, ref = train_capgnn(
        cfg, rt, xplan, p, adam(lr), epochs=8,
        controller=StalenessController(
            refresh_every=specs["p2p"].refresh_every),
        params0=params0, faults=FaultPlan.parse(SPMD_FAULT_SPEC, seed=0),
        guard=GuardConfig(**SPMD_FAULT_GUARD), spec=specs["p2p"])
    del rt
    torch.cuda.empty_cache()
    (ranks,), wall_s = spawned or spawn_jobs([job], p, backend, devices)
    res, by_path = {}, {}
    for t in specs:
        runs = [r[t] for r in ranks]
        for r in runs:
            if (r["faults_injected"], r["fault_events"]) != \
                    (ref.faults_injected, ref.fault_events):
                raise AssertionError(f"{name} {t}: counts {r['fault_events']}"
                                     f", the sim's {ref.fault_events}")
        err = max(float(np.nanmax(np.abs(np.subtract(r["losses"],
                                                     ref.losses))))
                  for r in runs)
        if not err <= TRAJ_ATOL or runs[0]["step_kinds"] != ref.step_kinds:
            raise AssertionError(f"{name} {t}: losses {err} from the sim")
        for s, kind in enumerate(ref.step_kinds):
            want = xplan.transport_rows(t, kind != "cached")
            for li in range(1, layers):
                for tier in ("uncached", "local", "global"):
                    c = sum(r["wire"][s].get((li, tier), {}).get(
                        "valid_rows", 0) for r in runs)
                    if c != want[tier]:
                        raise AssertionError(f"{name} {t}: step {s} layer "
                                             f"{li} {tier}: {c} rows, the "
                                             f"plan's {want[tier]}")
        by_path[f"{name}_{t}"] = {k: sum(r["launches"][k] for r in runs)
                                  for k in runs[0]["launches"]}
        res[t] = {"losses": runs[0]["losses"], "max_abs_err_vs_sim": err,
                  "step_kinds": runs[0]["step_kinds"],
                  "median_step_ms": statistics.median(runs[0]["step_ms"][1:]),
                  "host_fetch_rows": [r["host_fetch_rows"] for r in runs],
                  "launches": by_path[f"{name}_{t}"]}
    emit(name, backend=backend, ranks=p,
         devices=list(devices) if not isinstance(devices, str) else devices,
         wire="gloo-host" if backend == "gloo" else "nccl",
         fault_spec=SPMD_FAULT_SPEC, guard=SPMD_FAULT_GUARD,
         faults_injected=ref.faults_injected, fault_events=ref.fault_events,
         sim_losses=ref.losses, counts_equal_sim=True,
         counted_equal_plan=True, tol=TRAJ_ATOL, spawn_wall_s=wall_s, **res)
    return by_path


def phase_checkpoint(tctx: dict) -> None:
    """``tests/test_system.py``'s kill-and-resume scenario at the train
    cell's width (``--no-pipeline``, so a resumed refresh is the
    uninterrupted run's): 8 epochs straight; 4 with ``--ckpt-dir``; a
    step-6 checkpoint truncated by ``ckpt_truncate`` (frac 0.5) and a
    stray ``.tmp``; ``latest_step`` must be 4 and the resumed run's final
    loss the straight run's within ``CKPT_TOL``.  Then ``launch.serve``
    with the trained ``--ckpt-dir`` and ``--store-dir``, and again with
    ``--load-store``: the tables equal bit for bit."""
    import warnings
    from repro_torch.checkpoint import latest_step
    from repro_torch.faults import FaultPlan
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import build_parser, train_gnn
    d = OUT_DIR / "ckpt"
    shutil.rmtree(d, ignore_errors=True)
    argv = TRAIN_ARGV + ["--no-pipeline"]

    def run(*extra):
        a = build_parser().parse_args(argv + list(extra))
        out, ctx = train_gnn(a, shared_context(tctx, argv))
        del ctx
        torch.cuda.empty_cache()
        return out
    straight = run()
    first = run("--epochs", "4", "--ckpt-dir", str(d))
    shutil.copy(d / "ckpt_00000004.npz", d / "ckpt_00000006.npz")
    shutil.copy(d / "ckpt_00000004.json", d / "ckpt_00000006.json")
    kept = FaultPlan.parse("ckpt_truncate@0:frac=0.5").truncate_checkpoint(
        str(d / "ckpt_00000006.npz"))
    (d / "ckpt_00000006.npz.tmp").write_bytes(b"partial")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        step = latest_step(str(d))
        resumed = run("--ckpt-dir", str(d), "--resume")
    err = abs(resumed["final_loss"] - straight["final_loss"])
    if step != 4 or resumed["resumed_from"] != 4 or not err <= CKPT_TOL:
        raise AssertionError(f"checkpoint: latest {step}, resumed from "
                             f"{resumed['resumed_from']}, final loss "
                             f"{resumed['final_loss']} vs "
                             f"{straight['final_loss']}")
    store = OUT_DIR / "store"
    shutil.rmtree(store, ignore_errors=True)
    served = {}
    for extra in (["--store-dir", str(store)],
                  ["--store-dir", str(store), "--load-store"]):
        sargs = tserve.build_parser().parse_args(
            SLICE_ARGV + ["--ckpt-dir", str(d)] + extra)
        t0 = time.perf_counter()
        out, engine = tserve.serve_gnn(sargs)
        served["load" if "--load-store" in extra else "save"] = (
            out, engine.store.tables, time.perf_counter() - t0)
        del engine
    same = all(np.array_equal(a, b) for a, b in
               zip(served["save"][1], served["load"][1]))
    if not same:
        raise AssertionError("checkpoint: the reloaded store's tables differ")
    emit("checkpoint", argv=argv, straight_final_loss=straight["final_loss"],
         first_final_loss=first["final_loss"], truncated_to_bytes=kept,
         latest_step=step, resumed_from=resumed["resumed_from"],
         resumed_final_loss=resumed["final_loss"], final_loss_err=err,
         tol=CKPT_TOL, store_tables_equal=same,
         serve_precompute_s={k: v[0]["precompute_s"]
                             for k, v in served.items()},
         serve_wall_s={k: v[2] for k, v in served.items()},
         serve_qps={k: v[0]["qps"] for k, v in served.items()})


# the 1.5D strategy's cases: (c, pr) on c * pr ranks; each with GCN and GIN
# (the 8-rank c=2, pr=4 case runs in tests/test_torch_strategy15d.py on
# the CPU; on one card its spawn took ~85-100 s of the script's budget)
SPMM15D_SHAPES = ((2, 2), (1, 4))
SPMM15D_MODELS = ("gcn", "gin")
SPMM15D_EPOCHS = 6
# over NCCL, a card per rank: the shapes of 4 ranks
SPMM15D_NCCL_SHAPES = ((2, 2), (1, 4))
# the ranks' loss against the card's sim at the shared initial parameters
# (step 0): f32 sums in other orders, as the spmd phase's refresh loss
SPMM15D_TOL = LOSS_ATOL
# steps 1-5, of the loss: Adam's first update moves every weight by about
# lr * sign(g), so a gradient entry within rounding of zero (summed in
# another order: index_add_'s atomics in both runtimes) moves by up to
# 2 * lr.  At GIN's step-2 spike (loss ~7.3-7.7) the card's sim run twice
# on the same inputs differs by up to 3.7e-4, 5e-5 of the loss, and the
# runs reconverge after it; GCN stays within 1e-6
SPMM15D_TRAJ_RTOL = 1e-3


def spmm15d_argv(c: int, pr: int, model: str) -> list[str]:
    """The train cell's flags under ``--strategy spmm_15d`` on ``c * pr``
    ranks: ``--backend edges`` (the strategy's one backend), JACA on (so
    the layer-0 block is pre-replicated), 6 epochs."""
    argv = with_backend(TRAIN_ARGV, "edges", model=model)
    argv[argv.index("--parts") + 1] = str(c * pr)
    argv[argv.index("--epochs") + 1] = str(SPMM15D_EPOCHS)
    return argv + ["--strategy", "spmm_15d", "--replication", str(c)]


def spmm15d_contexts(tctx: dict, shapes) -> dict:
    """``(c, pr) -> launch.train.prepare_train``'s 1.5D context of the
    shape's flags (GCN): the CLI's own host pipeline, ``P / c`` block
    rows; a shape with as many block rows as the train cell ``tctx`` has
    partitions takes its task and partition (the same flags partition
    the graph the same way), which spares a host pipeline."""
    import dataclasses as dc
    from repro_torch.dist import TrainSpec
    from repro_torch.dist.strategy_15d import build_spmm15d_layout
    from repro_torch.launch.train import build_parser, prepare_train
    out = {}
    for c, pr in shapes:
        args = build_parser().parse_args(spmm15d_argv(c, pr, "gcn"))
        if pr != len(tctx["ps"].parts):
            out[(c, pr)] = prepare_train(args)
            continue
        spec = TrainSpec.from_cli_args(args)
        out[(c, pr)] = {
            **{k: tctx[k] for k in ("task", "ps", "group")},
            "cfg": dc.replace(tctx["cfg"], model="gcn"), "spec": spec,
            "layout": build_spmm15d_layout(tctx["ps"], tctx["task"], spec)}
    return out


def spmm15d_jobs(ctxs: dict, shapes, models=SPMM15D_MODELS) -> list[dict]:
    """``launch.train.train_15d_rank``'s jobs: each shape with each model,
    the CLI's own flags and context."""
    import dataclasses as dc
    from repro_torch.launch.train import build_parser
    jobs = []
    for c, pr in shapes:
        ctx = ctxs[(c, pr)]
        for model in models:
            args = build_parser().parse_args(spmm15d_argv(c, pr, model))
            jobs.append({"args": args, "layout": ctx["layout"],
                         "cfg": dc.replace(ctx["cfg"], model=model),
                         "spec": ctx["spec"], "group": ctx["group"],
                         "inner_sizes": [pt.n_inner
                                         for pt in ctx["ps"].parts]})
    return jobs


def spmm15d_rank(rank, world_size, device, jobs):
    """One rank of the 1.5D phases: the CLI's rank program
    (``launch.train.train_15d_rank``) over ``jobs``, its launches counted
    from zero (the chunk's aggregation: the edge list's CSR kernel)."""
    from repro_torch.launch.train import train_15d_rank
    zero_counts()
    res = train_15d_rank(rank, world_size, device, jobs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"jobs": res, "launches": read_counts()}


def spmm15d_sim(job: dict, ps, device="cuda") -> list[float]:
    """The oracle: the card's single-process ``capgnn_sim`` at
    ``refresh_every=1`` on the same block rows (the layout's ``edges``
    stacking, a plan with every halo row uncached: a refresh step's
    numerics do not depend on the tiers) of ``ps``, the partition of
    the layout's block rows, ``SPMM15D_EPOCHS`` Adam steps
    from ``init_gnn`` of the run's seed, as the ranks start."""
    from repro_torch.core import CacheCapacity, build_cache_plan
    from repro_torch.dist import (TrainSpec, build_exchange_plan,
                                  make_sim_runtime)
    from repro_torch.models.gnn import init_gnn
    from repro_torch.optim import adam
    args, layout, cfg = job["args"], job["layout"], job["cfg"]
    xplan = build_exchange_plan(ps, build_cache_plan(
        ps, CacheCapacity(c_gpu=[0] * layout.pr, c_cpu=0), refresh_every=1))
    opt = adam(args.lr)
    spec = TrainSpec(backend="edges", exchange_layer0=False)
    rt = make_sim_runtime(cfg, layout.sp, xplan, opt, spec=spec,
                          device=device)
    params = init_gnn(cfg, torch.Generator().manual_seed(args.seed), device)
    state = (params, opt.init(params), rt.caches0)
    losses = []
    for _ in range(SPMM15D_EPOCHS):
        *state, m = rt.step_refresh(*state)
        losses.append(float(m["loss"]))
    return losses


def spmm15d_prepare(tctx: dict, shapes, models=SPMM15D_MODELS) -> dict:
    """The 1.5D phases' host plans (:func:`spmm15d_contexts`) and their
    rank jobs by world size, for :func:`phase_spmm15d` or for a spawn
    that other phases share (``spawn_jobs``)."""
    t0 = time.perf_counter()
    ctxs = spmm15d_contexts(tctx, shapes)
    by_size: dict = {}
    for c, pr in shapes:
        by_size.setdefault(c * pr, []).append((c, pr))
    return {"ctxs": ctxs, "plan_s": time.perf_counter() - t0,
            "jobs": {size: spmm15d_jobs(ctxs, group, models)
                     for size, group in sorted(by_size.items())}}


def phase_spmm15d(name: str, tctx: dict, shapes, backend: str, devices,
                  models=SPMM15D_MODELS, prep: dict | None = None,
                  spawned: dict | None = None) -> dict:
    """The 1.5D strategy (``--strategy spmm_15d``) at the train cell's
    width through the CLI's rank program, ``c * pr`` ranks over
    ``backend`` (``devices``: ``"cuda"`` for a card per rank, or ranks
    sharing card 0), all cases of one world size in one spawn.

    Checks, per case: every rank's 6 losses the same, the first (at the
    shared initial parameters) within ``SPMM15D_TOL`` of the card's
    ``capgnn_sim`` at ``refresh_every=1`` on the same block rows and the
    later ones within ``SPMM15D_TRAJ_RTOL`` of its losses (the sim run
    twice: its own spread is printed); every rank's counted forward bytes, every step,
    equal to ``forward_collective_bytes_per_device``, and their sum over
    the ranks to ``step_bytes_total``; the report's bytes; finite losses;
    every rank's launches: the chunk's CSR kernel once a layer a forward
    (each step and the closing test evaluation) and its ``d_h`` once a
    layer from layer 1 a step (layer 0's gathered block is constant), no
    other kernel of the port.  Prints per case the steady step ms and
    host-staging ms of every rank and its peak device memory.  Returns
    the launches summed over the ranks.  ``prep`` (:func:`spmm15d_prepare`
    of the same shapes and models) and ``spawned`` (world size ->
    ``(ranks' results, spawn wall seconds)`` of its jobs, run in a spawn
    shared with other phases) spare this phase its own."""
    from repro_torch.dist.strategy_15d import (
        forward_collective_bytes_per_device, step_bytes_total)
    from repro_torch.launch.mesh import spawn
    prep = prep or spmm15d_prepare(tctx, shapes, models)
    ctxs, plan_s = prep["ctxs"], prep["plan_s"]
    if backend == "gloo":
        # the chunk aggregation of the first shape's rank 0, timed alone
        phase_coo_spmm_15d(ctxs[shapes[0]]["layout"], 0)
    summed: dict = {}
    for size, jobs in prep["jobs"].items():
        devs = (devices if isinstance(devices, str)
                else [devices[0]] * size)
        if spawned is not None and size in spawned:
            ranks, spawn_wall_s = spawned[size]
        else:
            t0 = time.perf_counter()
            ranks = spawn(spmm15d_rank, size, backend=backend, devices=devs,
                          args=(jobs,))
            spawn_wall_s = time.perf_counter() - t0
        want = {**{k: 0 for k in ranks[0]["launches"]},
                "edge_spmm": sum(j["cfg"].num_layers * (SPMM15D_EPOCHS + 1)
                                 for j in jobs),
                "edge_spmm_dh": sum((j["cfg"].num_layers - 1)
                                    * SPMM15D_EPOCHS for j in jobs)}
        for r in ranks:
            if r["launches"] != want:
                raise AssertionError(f"{name}: rank launches "
                                     f"{r['launches']}, want {want}")
            for k, v in r["launches"].items():
                summed[k] = summed.get(k, 0) + v
        for ji, job in enumerate(jobs):
            per = [r["jobs"][ji] for r in ranks]
            layout, cfg, spec = job["layout"], job["cfg"], job["spec"]
            case = f"c{layout.c}pr{layout.pr}-{cfg.model}"
            losses = per[0]["losses"]
            if any(p["losses"] != losses for p in per) or not \
                    np.all(np.isfinite(losses)):
                raise AssertionError(f"{name} {case}: losses "
                                     f"{[p['losses'] for p in per]}")
            ps = ctxs[(layout.c, layout.pr)]["ps"]
            sim = spmm15d_sim(job, ps)
            rerun = spmm15d_sim(job, ps)
            diff = np.abs(np.subtract(losses, sim))
            err = float(diff.max())
            rel = float((diff[1:] / np.abs(sim[1:])).max())
            if diff[0] > SPMM15D_TOL or rel > SPMM15D_TRAJ_RTOL:
                raise AssertionError(f"{name} {case}: losses {losses}, the "
                                     f"card's sim {sim} (max err {err})")
            model_b = forward_collective_bytes_per_device(layout, cfg, spec)
            total_b = step_bytes_total(layout, cfg, spec)
            for p in per:
                if p["forward_bytes"] != [model_b] * SPMM15D_EPOCHS:
                    raise AssertionError(f"{name} {case}: rank {p['rank']} "
                                         f"counted {p['forward_bytes']}, the "
                                         f"model gives {model_b}")
            if sum(p["forward_bytes"][0] for p in per) != total_b or \
                    per[0]["out"]["comm_bytes"] != SPMM15D_EPOCHS * total_b:
                raise AssertionError(f"{name} {case}: step bytes")

            def steady(key):
                return [statistics.median(1e3 * t for t in p[key][1:])
                        for p in per]
            emit(name, case=case, c=layout.c, g=layout.g, pr=layout.pr,
                 ranks=size, model=cfg.model, backend=backend,
                 devices=devs if isinstance(devs, str) else devs[0],
                 wire="gloo-host" if backend == "gloo" else "nccl",
                 argv=spmm15d_argv(layout.c, layout.pr, cfg.model),
                 ni=layout.ni, edges_per_rank=[int(e) for e in
                                               layout.n_edges_dev],
                 losses=losses, sim_losses=sim, max_abs_err_vs_sim=err,
                 step0_err=float(diff[0]), max_rel_err_after_step0=rel,
                 tol=SPMM15D_TOL, traj_rtol=SPMM15D_TRAJ_RTOL,
                 sim_rerun_max_abs=float(np.abs(np.subtract(sim,
                                                            rerun)).max()),
                 fwd_collective_bytes_per_device=model_b,
                 counted_equal_model=True, step_bytes_total=total_b,
                 comm_reduction_vs_vanilla=per[0]["out"][
                     "comm_reduction_vs_vanilla"],
                 test_acc=per[0]["out"]["test_acc"],
                 compile_s=[p["out"]["compile_s"] for p in per],
                 steady_step_ms=steady("step_s"),
                 steady_host_stage_ms=steady("host_stage_s"),
                 peak_mem_gb=[p["peak_mem_gb"] for p in per],
                 launches=ranks[0]["launches"], spawn_wall_s=spawn_wall_s,
                 host_plan_s=plan_s)
        del ranks, jobs
        torch.cuda.empty_cache()
    return summed


# ---------------------------------------------------------------------------
# the transformer zoo: plain torch on every path (no kernel of the port)
# ---------------------------------------------------------------------------

LM_SEQ = 520              # > blocked attention's 512-row chunks, every
                          # reduced window (hymba 32, mixtral 64), the
                          # mLSTM's 128-row chunks
LM_DECODE_STEPS = 8
LM_TOL_OF_MAX = 1e-4      # f32 card vs CPU, of the largest magnitude
LM_BF16_AGREE, LM_BF16_TOL = 0.75, 0.12   # tests/test_archs_smoke.py's bar
LM_SERVE_ARGV = ["lm", "--device", "cuda", "--arch", "qwen3-1.7b",
                 "--batch", "4", "--steps", "32", "--cache-len", "256",
                 "--seed", "0"]
LM_F32_DECODE_STEPS = 16
LM_F32_TOL_OF_MAX = 1e-3  # f32 decode vs the card's own prefill, 28 layers
LM_TRAIN_ARGV = ["lm", "--arch", "qwen3-1.7b", "--full", "--steps", "8",
                 "--batch", "4", "--seq-len", "128", "--device", "cuda"]
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
LM_PREFILL_S = 4096       # blocked_attention timed at qwen3-1.7b prefill
LM_PROFILE_STEPS = 4      # decode steps under torch.profiler
LM_TRAIN_LOSSES: list = []   # lm_train's, for lm_spmd


def tree_err(got, want) -> tuple[float, float]:
    """``(largest |got - want| over the float leaves, largest |want|
    among them)`` of two trees of tensors (on any devices); integer
    leaves (a ring cache's positions) must be equal."""
    from repro_torch.optim.optimizers import tree_leaves
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    for a, b in pairs:
        if not b.is_floating_point() and not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError("integer leaves differ")
    pairs = [(a, b) for a, b in pairs if b.is_floating_point()]
    return (max(float((a.cpu().double() - b.cpu().double()).abs().max())
                for a, b in pairs),
            max(float(b.abs().max()) for _, b in pairs))


def lm_check(name: str, what: str, got, want, tol_of_max: float) -> float:
    err, scale = tree_err(got, want)
    if not err <= tol_of_max * scale:
        raise AssertionError(f"{name}: {what} differs by {err}, more than "
                             f"{tol_of_max} of {scale}")
    return err / scale


def lm_decode(cfg, params, toks, device, steps: int):
    """``steps`` ``serve_step`` calls from an empty cache over ``toks``'
    first columns: the logits [steps, B, V] (f32) and the caches."""
    from repro_torch.models.transformer import init_decode_cache, serve_step
    caches = init_decode_cache(cfg, toks.shape[0], steps, device)
    outs = []
    for t in range(steps):
        lg, caches = serve_step(cfg, params, caches, toks[:, t:t + 1], t)
        outs.append(lg.float())
    return torch.stack(outs), caches


def phase_lm_reduced(seed: int = 0) -> dict:
    """Every architecture's reduced config on the card against the CPU,
    from the same parameters (``init_model`` of one CPU generator, copied
    to the card): in f32 (TF32 off) the prefill logits and ``aux``, one
    ``train_step_fn`` step's loss and gradients (``loss_and_grads``) at
    ``LM_SEQ`` tokens, and ``LM_DECODE_STEPS`` decode steps with their
    caches, all within ``LM_TOL_OF_MAX`` of the largest magnitude; in
    bf16 every output finite and the card's decode against its own
    prefill at the reference's bar (phi-3-vision: prefill only).  No
    launch of the port's kernels."""
    import dataclasses as dc
    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.models.transformer import forward, init_model, \
        loss_and_grads
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    zero_counts()
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = dc.replace(get_reduced(arch), dtype="float32")
        params = init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
        on_card = tree_map(lambda t: t.to("cuda"), params)
        rng = np.random.default_rng(seed)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  (1, LM_SEQ)))
                 for k in ("tokens", "labels")}
        if cfg.vision_tokens:
            batch["patches"] = torch.from_numpy(rng.normal(
                size=(1, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
        cbatch = {k: v.to("cuda") for k, v in batch.items()}
        errs = {}
        with torch.no_grad():
            lg_card, aux_card = forward(cfg, on_card, cbatch)
            lg_cpu, aux_cpu = forward(cfg, params, batch)
        errs["logits"] = lm_check(arch, "prefill logits", [lg_card],
                                  [lg_cpu], LM_TOL_OF_MAX)
        errs["aux"] = abs(float(aux_card) - float(aux_cpu))
        if errs["aux"] > LM_TOL_OF_MAX * max(1.0, abs(float(aux_cpu))):
            raise AssertionError(f"{arch}: aux {aux_card} vs {aux_cpu}")
        loss_card, _, g_card = loss_and_grads(cfg, on_card, cbatch)
        loss_cpu, _, g_cpu = loss_and_grads(cfg, params, batch)
        errs["loss"] = lm_check(arch, "loss", [loss_card], [loss_cpu],
                                LM_TOL_OF_MAX)
        errs["grads"] = lm_check(arch, "gradients", g_card, g_cpu,
                                 LM_TOL_OF_MAX)
        toks = batch["tokens"][:, :LM_DECODE_STEPS]
        with torch.no_grad():
            dec_card, c_card = lm_decode(cfg, on_card, toks.to("cuda"),
                                         "cuda", LM_DECODE_STEPS)
            dec_cpu, c_cpu = lm_decode(cfg, params, toks, "cpu",
                                       LM_DECODE_STEPS)
        errs["decode"] = lm_check(arch, "decode logits", [dec_card],
                                  [dec_cpu], LM_TOL_OF_MAX)
        errs["caches"] = lm_check(arch, "decode caches", c_card, c_cpu,
                                  LM_TOL_OF_MAX)
        f32_s = time.perf_counter() - t0
        del on_card, g_card, g_cpu, c_card, c_cpu

        # bf16, the config's own dtype, on the card
        cfg16 = get_reduced(arch)
        p16 = init_model(cfg16, torch.Generator().manual_seed(seed), "cuda")
        loss16, _, g16 = loss_and_grads(cfg16, p16, cbatch)
        finite = bool(torch.isfinite(loss16)) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(g16))
        bf16 = {"loss": float(loss16)}
        with torch.no_grad():
            full, _ = forward(cfg16, p16, {"tokens": cbatch["tokens"][
                :, :LM_DECODE_STEPS]})
            dec, _ = lm_decode(cfg16, p16, cbatch["tokens"], "cuda",
                               LM_DECODE_STEPS)
        dec, full = dec[:, 0].cpu(), full[0].float().cpu()
        finite = finite and bool(torch.isfinite(dec).all()) and \
            bool(torch.isfinite(full).all())
        if not finite:
            raise AssertionError(f"{arch}: bf16 outputs not finite")
        if not cfg16.vision_tokens:
            agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
            # assert_allclose(dec, full, rtol=0.12, atol=0.12)
            excess = float(((dec - full).abs()
                            - LM_BF16_TOL * full.abs()).max())
            if agree < LM_BF16_AGREE or excess > LM_BF16_TOL:
                raise AssertionError(f"{arch}: bf16 decode vs prefill: top-1 "
                                     f"agreement {agree}, |dec - full| - "
                                     f"rtol |full| up to {excess}")
            bf16.update(top1_agree=agree,
                        max_abs_err=float((dec - full).abs().max()))
        del p16, g16
        emit("lm_reduced", arch=arch, name=cfg.name, seq=LM_SEQ,
             params=sum(t.numel() for t in tree_leaves(params)),
             f32_err_of_max=errs, tol_of_max=LM_TOL_OF_MAX, bf16=bf16,
             f32_s=f32_s, arch_s=time.perf_counter() - t0)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"lm_reduced launched the port's kernels: "
                             f"{launches}")
    torch.cuda.empty_cache()
    return launches


def time_attention() -> dict:
    """``blocked_attention`` (plain torch, the reference's algorithm) at
    qwen3-1.7b prefill (1 x ``LM_PREFILL_S`` tokens, 16 / 8 heads of 128,
    bf16) and the ring decode attention at ``serve lm``'s step (4 x 1
    query over a 256-slot cache), each beside its bound and one
    ``scaled_dot_product_attention`` call on the same inputs (timed here,
    used nowhere in the port)."""
    import torch.nn.functional as F
    from repro_torch.models.transformer.attention import blocked_attention
    from repro_torch.models.transformer.blocks import _decode_attn_ring
    gen = torch.Generator(device="cuda").manual_seed(0)
    hq, hkv, hd = 16, 8, 128

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    out = {}
    s = LM_PREFILL_S
    q, k, v = rnd(1, s, hq, hd), rnd(1, s, hkv, hd), rnd(1, s, hkv, hd)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kt_e, vt_e = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))
    with torch.inference_mode():
        got = blocked_attention(q, k, v, causal=True)
        lib = F.scaled_dot_product_attention(qt, kt_e, vt_e, is_causal=True)
        err = float((got.float() - lib.transpose(1, 2).float()).abs().max())
        t = time_calls({
            "plain": lambda: blocked_attention(q, k, v, causal=True),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt_e, vt_e, is_causal=True)}, reps=3)
    nbytes = 2 * (2 * s * hq * hd + 2 * s * hkv * hd)
    flops = 2 * 2 * hq * hd * s * (s + 1) / 2      # causal QK^T and PV
    b_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    out["blocked_attention_prefill"] = {
        "shape": [1, s, hq, hkv, hd], "dtype": "bfloat16",
        "plain_ms": t["plain"], "library_ms": t["library"],
        "bound_ms": b_ms, "bound_by": "operations"
        if flops / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        "max_abs_err_vs_library": err}
    b, w = 4, 256
    qd, ck, cv = rnd(b, 1, hq, hd), rnd(b, w, hkv, hd), rnd(b, w, hkv, hd)
    valid = torch.arange(w, device="cuda")[None].expand(b, w) < 32
    qdt = qd.transpose(1, 2)
    ckt, cvt = (x.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
                for x in (ck, cv))
    mask = valid[:, None, None, :]
    with torch.inference_mode():
        got = _decode_attn_ring(qd, ck, cv, valid)
        lib = F.scaled_dot_product_attention(qdt, ckt, cvt, attn_mask=mask)
        err = float((got.float() - lib.transpose(1, 2).float()).abs().max())
        t = time_calls({
            "plain": lambda: _decode_attn_ring(qd, ck, cv, valid),
            "library": lambda: F.scaled_dot_product_attention(
                qdt, ckt, cvt, attn_mask=mask)}, reps=50)
    nbytes = 2 * (2 * b * w * hkv * hd + 2 * b * hq * hd) + b * w
    flops = 2 * 2 * b * hq * hd * w
    out["decode_attention_step"] = {
        "shape": [b, 1, w, hq, hkv, hd], "dtype": "bfloat16",
        "per_layer": True, "plain_ms": t["plain"],
        "library_ms": t["library"],
        "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                        flops / BF16_FLOP_PER_S) * 1e3, "bound_by": "bytes",
        "max_abs_err_vs_library": err}
    return out


def phase_lm_serve(seed: int = 0) -> dict:
    """``serve lm``'s decode loop (``launch.serve.decode_lm``) at
    qwen3-1.7b's published width in bf16 (28 layers, d 2048, GQA 16 / 8,
    qk-norm, tied embeddings, vocab 151,936): batch 4, cache 256, 32
    greedy steps, tokens/s and the steady step beside its bound (the
    weights read once over HBM) and peak memory; then the same weights in
    f32, batch 1: ``LM_F32_DECODE_STEPS`` decode steps against the card's
    own prefill within ``LM_F32_TOL_OF_MAX`` of the largest logit.  No
    launch of the port's kernels."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, decode_lm
    from repro_torch.models.transformer import forward, init_model
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    args = build_parser().parse_args(LM_SERVE_ARGV)
    cfg = get_config(args.arch)
    zero_counts()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator().manual_seed(args.seed),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, detail = decode_lm(cfg, params, args)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not out["logits_finite"]:
        raise AssertionError(f"lm_serve: logits not finite: {out}")
    step_ms = detail["step_ms"]
    attention = time_attention()
    fed = torch.from_numpy(detail["tokens"].T.copy()).to("cuda")
    profile = lm_profile("decode", lambda: lm_decode(
        cfg, params, fed, "cuda", LM_PROFILE_STEPS), LM_PROFILE_STEPS)

    # f32 at the same width: decode against the card's own prefill
    cfg32 = dc.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del params, detail
    torch.cuda.empty_cache()
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, LM_F32_DECODE_STEPS))).to("cuda")
    with torch.inference_mode():
        full, _ = forward(cfg32, p32, {"tokens": toks})
        dec, _ = lm_decode(cfg32, p32, toks, "cuda", LM_F32_DECODE_STEPS)
    err = lm_check("lm_serve", "f32 decode vs prefill", [dec[:, 0]],
                   [full[0]], LM_F32_TOL_OF_MAX)
    del p32, full, dec
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"lm_serve launched the port's kernels: "
                             f"{launches}")
    torch.cuda.empty_cache()
    emit("lm_serve", argv=LM_SERVE_ARGV, config=cfg.name,
         layers=cfg.num_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads], vocab=cfg.vocab_size,
         dtype=cfg.dtype, out=out, steady_step_ms=statistics.median(step_ms),
         step_ms=step_ms, weight_bytes=weight_bytes,
         step_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
         step_bound_by="bytes (the weights read once)",
         peak_mem_gb=peak_gb, init_s=init_s,
         f32_decode_vs_prefill_err_of_max=err,
         f32_tol_of_max=LM_F32_TOL_OF_MAX, f32_steps=LM_F32_DECODE_STEPS,
         attention=attention, profile=profile, launches=launches,
         card=nvidia_smi())
    return launches


def lm_profile(name: str, fn, steps: int) -> dict:
    """``fn`` (``steps`` steps) under ``torch.profiler`` after one
    unprofiled call: wall and device-busy ms a step, the idle share and
    the kernels launched a step (``launch.profile_serve``'s summary)."""
    from repro_torch.launch.profile_serve import _profiled, _summary
    with torch.inference_mode(name == "decode"):
        fn()
        prof, wall = _profiled(fn)
    rec = _summary(name, prof, wall, top=6)
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"steps": steps, "wall_ms_per_step": rec["wall_ms"] / steps,
            "device_busy_ms_per_step": rec["device_busy_ms"] / steps,
            "idle_share": rec["idle_share"],
            "kernels_per_step": n_kernels / steps,
            "device_top": rec["device_top"]}


def phase_lm_train() -> dict:
    """``train lm --arch qwen3-1.7b --full --steps 8 --batch 4 --seq-len
    128 --device cuda`` through the CLI's parser and loop
    (``launch.train.train_lm``): finite losses, the last below the
    first, step ms, tokens/s and peak memory (bf16 parameters, gradients
    and AdamW's two moments, and the activations).  No launch of the
    port's kernels."""
    from repro_torch.launch.train import build_parser, lm_config, train_lm
    args = build_parser().parse_args(LM_TRAIN_ARGV)
    cfg = lm_config(args)
    zero_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, detail = train_lm(cfg, args)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = detail["losses"]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"lm_train: losses {losses}")
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"lm_train launched the port's kernels: "
                             f"{launches}")
    steady_ms = statistics.median(detail["step_ms"][1:])
    from repro_torch.data import synthetic_token_batches
    from repro_torch.models.transformer import train_step_fn
    from repro_torch.optim import adamw
    hb = next(synthetic_token_batches(cfg.vocab_size, args.seq_len,
                                      args.batch, seed=args.seed))
    batch = {k: torch.from_numpy(hb[k]).to("cuda")
             for k in ("tokens", "labels")}
    step = train_step_fn(cfg, adamw(args.lr))
    state = [detail.pop("params"), detail.pop("opt_state")]

    def one_step():
        state[:] = step(state[0], state[1], batch)[:2]
    profile = lm_profile("train", one_step, 1)
    del state, step
    torch.cuda.empty_cache()
    LM_TRAIN_LOSSES[:] = losses
    emit("lm_train", argv=LM_TRAIN_ARGV, config=cfg.name,
         layers=cfg.num_layers, dtype=cfg.dtype, out=out, losses=losses,
         step_ms=detail["step_ms"], steady_step_ms=steady_ms,
         steady_tokens_per_s=args.batch * args.seq_len / steady_ms * 1e3,
         peak_mem_gb=peak_gb, wall_s=wall_s, profile=profile,
         launches=launches, card=nvidia_smi())
    return launches


def phase_profile() -> None:
    """``measure_profile()`` on the card: the paper's five
    microbenchmarks (Table 1 harness, 1024^2 f32) and the memory sizes."""
    import dataclasses as dc
    from repro_torch.core import measure_profile
    t0 = time.perf_counter()
    prof = measure_profile()
    emit("profile", **dc.asdict(prof), size=1024, sparsity=0.996, repeats=5,
         seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 6: the backward kernels and the chunked forward, training shapes
# ---------------------------------------------------------------------------

def pack_csr(pack):
    """A :class:`~repro_torch.kernels.csr_spmm.CsrPack` as a torch CSR
    tensor, for the library yardstick ``torch.sparse.mm``."""
    return torch.sparse_csr_tensor(pack.rowptr.long(), pack.col.long(),
                                   pack.w, size=(pack.n_rows, pack.n_cols),
                                   check_invariants=True)


def slice_packs(sp, long_row=None) -> dict:
    """The CSR packs of one slice's stacked layout on the card, as
    ``make_adj_builder`` builds them: the transposed pack of the whole
    hybrid adjacency (``dh``), of the ELL slots alone (``dh_ell``, the
    ``ell`` backend's) and the tail's (``tail``)."""
    from repro_torch.kernels import ops
    kw = {} if long_row is None else {"long_row": long_row}
    ell, dev = sp.ell, torch.device("cuda")
    n_cols = sp.n_inner_max + sp.n_halo_max
    tail = (ell.tail_src, ell.tail_dst, ell.tail_w)
    return {"dh": ops.transpose_csr(ell.cols, ell.vals, n_cols, *tail,
                                    device=dev, **kw),
            "dh_ell": ops.transpose_csr(ell.cols, ell.vals, n_cols,
                                        device=dev, **kw),
            "tail": ops.tail_csr(*tail, sp.n_inner_max, n_cols, device=dev,
                                 **kw)}


def max_row(pack) -> int:
    """The most entries in one row of a CSR pack."""
    return int((pack.rowptr[1:] - pack.rowptr[:-1]).max())


def csr_bytes(pack, d: int, elem: int, accumulate: bool) -> float:
    """Bytes the CSR product needs on these inputs: each entry's col and w
    once, the row pointers (write mode: every row), each x row an entry
    names once, and each listed out row written once (read once more when
    accumulating)."""
    x_rows = torch.unique(pack.col).numel()
    out_rows = (pack.n_rows if pack.every_row else
                pack.short_rows.numel() + pack.long_rows.numel())
    rowptr = (pack.n_rows + 1) * 4 if not accumulate else 0
    return float(pack.nnz * 8 + rowptr + x_rows * d * elem
                 + out_rows * d * elem * (2 if accumulate else 1))


def phase_dh(packs, sp, gen) -> dict:
    """``d_h = A^T g`` through the CSR kernel over the training slice's
    transposed pack at d = 256 (layers 1 and 2 of a step): against the
    plain version, twice bit for bit, timed beside ``torch.sparse.mm`` of
    the same ``A^T``, the route the tail took before (the autograd backward
    of ``coo_spmm``), the ELL-only pack (the ``ell`` backend's) and the
    bound; returns the kernels-line entry."""
    from repro_torch.kernels import csr_spmm as kcsr, ops, ref
    dev = torch.device("cuda")
    pack, pack_ell = packs["dh"], packs["dh_ell"]
    ell = sp.ell
    n_parts, n_rows, _ = ell.cols.shape
    n_cols = sp.n_inner_max + sp.n_halo_max
    d = 256
    g = torch.randn((n_parts * n_rows, d), generator=gen, device=dev)
    got = kcsr.csr_spmm(pack, g)
    again = kcsr.csr_spmm(pack, g)
    want = ref.csr_spmm_ref(pack, g)
    err = check_close("csr_spmm_dh", got, want, **csr_tol(want))
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("csr_spmm_dh: two launches differ in their bits")
    want = ref.csr_spmm_ref(pack_ell, g)
    err_ell = check_close("csr_spmm_dh (ELL slots)",
                          kcsr.csr_spmm(pack_ell, g), want, **csr_tol(want))
    del want
    csr_t = pack_csr(pack)
    lib_diff = float((torch.sparse.mm(csr_t, g) - got).abs().max())
    del got, again
    # the route the tail's d_h took before: the autograd backward of
    # coo_spmm's gather and index_add_ (the ELL slots' share went to the
    # deleted atomic kernel)
    ts, td, tw = (torch.as_tensor(a, device=dev) for a in
                  (ell.tail_src, ell.tail_dst, ell.tail_w))
    x = torch.randn((n_parts, n_cols, d), generator=gen, device=dev,
                    requires_grad=True)
    tail_out = ops.coo_spmm(ts.long(), td.long(), tw, x, n_rows)
    g3 = g.view(n_parts, n_rows, d)
    t = time_calls({
        "kernel_ms": lambda: kcsr.csr_spmm(pack, g),
        "plain_ms": lambda: ref.csr_spmm_ref(pack, g),
        "library_ms": lambda: torch.sparse.mm(csr_t, g),
        "old_route_ms": lambda: torch.autograd.grad(tail_out, x, g3,
                                                    retain_graph=True),
        "ell_only_ms": lambda: kcsr.csr_spmm(pack_ell, g),
    }, reps=5)
    del tail_out, x, csr_t
    nbytes = csr_bytes(pack, d, 4, accumulate=False)
    b, by = bound_ms(nbytes, 2.0 * pack.nnz * d)
    # the deleted atomic kernel's work (ELL slots only) counted over the
    # live slots: their cols and vals, g and d_h once
    live = int((torch.as_tensor(ell.vals) != 0).sum())
    b_ell, _ = bound_ms(live * 8 + g.numel() * 4 + n_parts * n_cols * d * 4,
                        2.0 * live * d)
    rec = dict(shape=[pack.n_rows, pack.n_cols, d], nnz=pack.nnz,
               ell_nnz=pack_ell.nnz, max_row=max_row(pack),
               long_rows=pack.long_rows.numel(),
               segments=pack.seg.shape[0], long_row=pack.long_row,
               max_abs_err=err, ell_only_max_abs_err=err_ell,
               bit_reproducible=True, library_max_abs_diff=lib_diff,
               bound_ms=b, bound_by=by, bytes=nbytes,
               ell_slots_bound_ms=b_ell, **t)
    emit("kernel", name="csr_spmm_dh", **rec)
    return {"name": "csr_spmm_dh", "route": "cuda", "source": CSR_SOURCE,
            "replaces": BWD_REPLACES, "max_abs_err": err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b, "bound_by": by, "library_ms": t["library_ms"],
            "old_route_ms": t["old_route_ms"], "ell_only_ms": t["ell_only_ms"],
            "ell_slots_bound_ms": b_ell,
            "timed_over": f"one launch at d={d} over the training slice's "
                          "transposed hybrid pack (layers 1 and 2 of a step "
                          "launch it once each)"}


def phase_gather_bwd(xplan, sp, gen) -> tuple[dict, dict]:
    """The row gather at the training slice's local-tier map (its refresh
    step's pull of layers 1 and 2) at d = 256.

    Forward: the gather kernel bit for bit against its plain version,
    timed beside it and ``index_select`` (the -1 ids zeroed by a
    ``torch.where``).  Backward: the CSR kernel over the transposed index
    map against its plain version, twice bit for bit, and against the
    autograd of the old two-stage pull; timed beside that pull's indexing
    backward, the backward of an ``index_select`` route over the flattened
    h (an ``index_add_``) and one ``index_add`` call (the library).  The
    pull, forward and backward, as one composed gather and as the two
    stages (owners' pack, then the consumers' addressing) on an f32 wire.
    Returns the backward's kernels-line entry and the forward's numbers at
    this shape."""
    from repro_torch.dist.capgnn_sim import _rows, exchange_arrays
    from repro_torch.kernels import cache_gather as kgather, ref
    dev = torch.device("cuda")
    n_parts, ni, d = sp.num_parts, sp.n_inner_max, 256
    maps = exchange_arrays(xplan, ni, dev)["loc"]["pull"]
    staged = exchange_arrays(xplan, ni, dev,
                             halo_dtype=torch.float32)["loc"]["pull"]
    gm = maps["pull"]
    idx, pack = gm["idx"], gm["pack"]
    n_out = idx.numel()
    flat_idx = idx.view(-1)
    ok = flat_idx >= 0
    n_ok = int(ok.sum())

    # forward: bit for bit against the plain version
    h = torch.randn((n_parts, ni, d), generator=gen, device=dev,
                    requires_grad=True)
    hf = h.detach().view(-1, d)
    fwd = kgather.gather_rows(hf, flat_idx)
    fwd_want = ref.gather_rows_ref(hf, flat_idx)
    torch.cuda.synchronize()
    if not torch.equal(fwd.view(torch.int32), fwd_want.view(torch.int32)):
        raise AssertionError("gather_rows is not bit-exact at the training "
                             f"slice's local-tier map [{hf.shape[0]}, {d}]"
                             f" x {n_out}")
    fwd_err = float((fwd - fwd_want).abs().max())
    safe_idx = flat_idx.clamp(min=0)
    lib_fwd = torch.where(ok[:, None], hf.index_select(0, safe_idx), 0.0)
    if not torch.equal(lib_fwd, fwd):
        raise AssertionError("index_select differs from the gather")
    del fwd, fwd_want, lib_fwd

    # backward
    g = torch.randn((n_out, d), generator=gen, device=dev)
    got = kgather.gather_rows_bwd(pack, g)
    again = kgather.gather_rows_bwd(pack, g)
    want = ref.csr_spmm_ref(pack, g)
    err = check_close("gather_rows_bwd", got, want, **csr_tol(want))
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("gather_rows_bwd: two launches differ in their "
                             "bits")
    # the old route: the owners' pack h[p, send_row], then the consumers'
    # addressing payload[src_part, src_slot], invalid rows zeroed
    tier = xplan.local
    send_row, part, slot = (torch.as_tensor(np.asarray(a, np.int64),
                                            device=dev)
                            for a in (tier.send_row, tier.recv_src_part,
                                      tier.recv_src_slot))
    valid = torch.as_tensor(np.asarray(tier.recv_valid), device=dev)
    pidx = torch.arange(n_parts, device=dev)[:, None]
    old_rows = torch.where(valid[..., None], h[pidx, send_row][part, slot],
                           0.0)
    g3 = g.view(old_rows.shape)
    old_err = check_close("gather_rows_bwd (the old pull's autograd)",
                          got.view(h.shape),
                          torch.autograd.grad(old_rows, h, g3,
                                              retain_graph=True)[0],
                          **csr_tol(want))
    h_flat = h.view(-1, d)
    is_rows = torch.where(ok[:, None], h_flat.index_select(0, safe_idx), 0.0)
    idx_ok, g_ok = flat_idx[ok].long(), g[ok]
    zeros = torch.zeros((n_parts * ni, d), device=dev)
    lib_diff = float((torch.index_add(zeros, 0, idx_ok, g_ok) - got)
                     .abs().max())

    # the pull as the sim runs it, forward and backward: one composed
    # gather, or the two stages (an f32 wire: no cast, the same rows)
    def pull(m, wire):
        rows = _rows(m, h, wire)
        return rows, torch.autograd.grad(rows, h, g3)[0]
    rows_c, grad_c = pull(maps, None)
    rows_s, grad_s = pull(staged, torch.float32)
    if not torch.equal(rows_c.view(torch.int32), rows_s.view(torch.int32)):
        raise AssertionError("the composed and two-stage pulls differ")
    staged_err = check_close("the two-stage pull's gradient", grad_s, grad_c,
                             **csr_tol(grad_c))
    del rows_c, grad_c, rows_s, grad_s

    t = time_calls({
        "kernel_ms": lambda: kgather.gather_rows_bwd(pack, g),
        "plain_ms": lambda: ref.csr_spmm_ref(pack, g),
        "library_ms": lambda: torch.index_add(zeros, 0, idx_ok, g_ok),
        "old_route_ms": lambda: torch.autograd.grad(old_rows, h, g3,
                                                    retain_graph=True),
        "index_select_route_ms": lambda: torch.autograd.grad(
            is_rows, h_flat, g, retain_graph=True),
        "forward_ms": lambda: kgather.gather_rows(hf, flat_idx),
        "forward_plain_ms": lambda: ref.gather_rows_ref(hf, flat_idx),
        "forward_library_ms": lambda: torch.where(
            ok[:, None], hf.index_select(0, safe_idx), 0.0),
        "pull_composed_ms": lambda: pull(maps, None),
        "pull_two_stage_ms": lambda: pull(staged, torch.float32),
    }, reps=5)
    del old_rows, is_rows, h, got, again, want
    nbytes = csr_bytes(pack, d, 4, accumulate=False)
    b, by = bound_ms(nbytes, pack.nnz * d)
    # each valid id's row read once, every output row written once, the ids
    fwd_bytes = n_ok * d * 4 + n_out * d * 4 + n_out * 4
    fb, fby = bound_ms(fwd_bytes, 0.0)
    forward = {"ms": t["forward_ms"], "plain_ms": t["forward_plain_ms"],
               "library_ms": t["forward_library_ms"], "bound_ms": fb,
               "bound_by": fby, "bytes": fwd_bytes, "max_abs_err": fwd_err,
               "bit_exact": True, "library": "index_select + where",
               "shape": [hf.shape[0], d, n_out], "valid_ids": n_ok}
    rec = dict(shape=[pack.n_rows, pack.n_cols, d], nnz=pack.nnz,
               max_row=max_row(pack), long_rows=pack.long_rows.numel(),
               max_abs_err=err, old_route_max_abs_err=old_err,
               two_stage_max_abs_err=staged_err,
               bit_reproducible=True, library_max_abs_diff=lib_diff,
               bound_ms=b, bound_by=by, bytes=nbytes,
               forward_bound_ms=fb, forward_max_abs_err=fwd_err,
               forward_bit_exact=True, **t)
    emit("kernel", name="gather_rows_bwd", **rec)
    entry = {"name": "gather_rows_bwd", "route": "cuda",
             "source": CSR_SOURCE, "replaces": GATHER_BWD_REPLACES,
             "max_abs_err": err, "ms": t["kernel_ms"],
             "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
             "library_ms": t["library_ms"],
             "old_route_ms": t["old_route_ms"],
             "index_select_route_ms": t["index_select_route_ms"],
             "pull_composed_ms": t["pull_composed_ms"],
             "pull_two_stage_ms": t["pull_two_stage_ms"],
             "timed_over": f"one launch at d={d} over the training slice's "
                           f"local-tier map ({pack.nnz} rows of {n_out} "
                           f"into [{pack.n_rows}, {d}]; a refresh step "
                           "launches it once per layer 1 and 2); library: "
                           "one torch.index_add over the valid rows; "
                           "pull_*: a tier pull's forward and backward"}
    return entry, forward


def tail_case(pack_name: str, tail, sp, d: int, dtype, gen) -> dict:
    """The hybrid tail's forward on one slice's tail at one width: the CSR
    kernel adding into an output (the ELL kernel's, as on the main path)
    against its plain version, timed beside ``torch.sparse.mm`` of the
    tail added to it, the route it replaced (``coo_spmm`` added to it) and
    the bound."""
    from repro_torch.kernels import csr_spmm as kcsr, ops, ref
    dev = torch.device("cuda")
    ell = sp.ell
    n_parts, n_rows, _ = ell.cols.shape
    n_cols = sp.n_inner_max + sp.n_halo_max
    h = torch.randn((n_parts, n_cols, d), generator=gen,
                    device=dev).to(dtype)
    out0 = torch.randn((n_parts * n_rows, d), generator=gen,
                       device=dev).to(dtype)
    hf = h.view(-1, d)
    want = ref.csr_spmm_ref(tail, hf, out0)
    err = check_close(f"csr_spmm_tail ({dtype})",
                      kcsr.csr_spmm_accumulate(tail, hf, out0.clone()),
                      want, **csr_tol(want))
    ts, td, tw = (torch.as_tensor(a, device=dev) for a in
                  (ell.tail_src, ell.tail_dst, ell.tail_w))
    out = out0.clone()
    fns = {"kernel_ms": lambda: kcsr.csr_spmm_accumulate(tail, hf, out),
           "plain_ms": lambda: ref.csr_spmm_ref(tail, hf, out0),
           "old_route_ms": lambda: out0 + ops.coo_spmm(
               ts.long(), td.long(), tw, h, n_rows).reshape(-1, d)}
    extra = {}
    csr = pack_csr(tail)
    if dtype != torch.float32:
        csr = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      csr.values().to(dtype), size=csr.shape)
    try:
        lib = out0 + torch.sparse.mm(csr, hf)
    except RuntimeError as exc:    # the library may not take bf16 CSR
        extra["library"] = f"none: {str(exc).splitlines()[0]}"
    else:
        extra["library_max_abs_diff"] = float(
            (lib.float() - want.float()).abs().max())
        fns["library_ms"] = lambda: out0 + torch.sparse.mm(csr, hf)
        del lib
    t = time_calls(fns, reps=5)
    t.setdefault("library_ms", None)
    nbytes = csr_bytes(tail, d, h.element_size(), accumulate=True)
    b, by = bound_ms(nbytes, 2.0 * tail.nnz * d)
    rec = dict(pack=pack_name, dtype=str(dtype).replace("torch.", ""),
               shape=[tail.n_rows, tail.n_cols, d], nnz=tail.nnz,
               tail_rows=tail.short_rows.numel() + tail.long_rows.numel(),
               max_row=max_row(tail), long_rows=tail.long_rows.numel(),
               long_row=tail.long_row,
               max_abs_err=err, bound_ms=b, bound_by=by, bytes=nbytes,
               **t, **extra)
    emit("kernel", name="csr_spmm_tail", **rec)
    return rec


def tail_cases(pack_name: str, tail, sp, gen) -> dict:
    """:func:`tail_case` at the slices' widths: f32 at d = 500 and 256,
    bf16 at d = 500, keyed as :func:`ell_pack_cases`."""
    out = {}
    for dtype, d in ((torch.float32, 500), (torch.float32, 256),
                     (torch.bfloat16, 500)):
        key = f"{'f32' if dtype == torch.float32 else 'bf16'}_{d}"
        out[key] = tail_case(pack_name, tail, sp, d, dtype, gen)
        torch.cuda.empty_cache()
    return out


SWEEP_LONG_ROWS = (64, 128, 256, 512, 1024)


def sweep_csr(slices: dict, gen) -> None:
    """The CSR kernel's long-row threshold ``L``: for each, the packs
    rebuilt, ``d_h`` on the training pack at d = 256 and the tail at the
    main paths' widths on both slices checked against the plain version and
    timed in turns; one ``sweep`` line per case and one with the total
    weighted by the main paths' launches."""
    from repro_torch.kernels import csr_spmm as kcsr, ops, ref
    dev = torch.device("cuda")
    xs = {}
    for name, sp in slices.items():
        n_parts, n_rows, _ = sp.ell.cols.shape
        n_cols = sp.n_inner_max + sp.n_halo_max
        for d in (500, 256):
            xs[name, d] = (torch.randn((n_parts * n_cols, d), generator=gen,
                                       device=dev),
                           torch.zeros((n_parts * n_rows, d), device=dev))
    g = torch.randn((xs["train", 256][1].shape[0], 256), generator=gen,
                    device=dev)
    fns, rows, errs = {}, {}, {}
    for L in SWEEP_LONG_ROWS:
        for name, sp in slices.items():
            packs = slice_packs(sp, L)
            for d in (500, 256):
                tail, (h, out) = packs["tail"], xs[name, d]
                key = f"{L}/{name}_tail_{d}"
                want = ref.csr_spmm_ref(tail, h, out)
                errs[key] = check_close(
                    f"csr_spmm tail L={L}",
                    kcsr.csr_spmm_accumulate(tail, h, out.clone()), want,
                    **csr_tol(want))
                fns[key] = (lambda t=tail, h=h, o=out:
                            kcsr.csr_spmm_accumulate(t, h, o))
                rows[key] = (tail.long_rows.numel(), tail.seg.shape[0])
            if name == "train":
                dh = packs["dh"]
                key = f"{L}/train_dh_256"
                want = ref.csr_spmm_ref(dh, g)
                errs[key] = check_close(f"csr_spmm d_h L={L}",
                                        kcsr.csr_spmm(dh, g), want,
                                        **csr_tol(want))
                fns[key] = lambda p=dh: kcsr.csr_spmm(p, g)
                rows[key] = (dh.long_rows.numel(), dh.seg.shape[0])
    t = time_calls(fns, reps=5)
    mix = {"serve_tail_500": 1, "serve_tail_256": 2, "train_tail_500": 9,
           "train_tail_256": 18, "train_dh_256": 16}
    for L in SWEEP_LONG_ROWS:
        for case in mix:
            key = f"{L}/{case}"
            emit("sweep", name="csr_spmm", long_row=L, case=case, ms=t[key],
                 max_abs_err=errs[key], long_rows=rows[key][0],
                 segments=rows[key][1])
        emit("sweep", name="csr_spmm", long_row=L,
             main_paths_weighted_ms=sum(c * t[f"{L}/{k}"]
                                        for k, c in mix.items()),
             chosen=L == ops.LONG_ROW)
    del fns, xs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the CSR kernel's design variants (--kernels-only): row order x stripe x
# mode on every route it serves, beside the floor probe
# ---------------------------------------------------------------------------

VARIANT_STRIPE_BYTES = (256, 512, 1024)
VARIANT_ROUNDS = 8   # rounds of each variant: their median and spread
L2_FIT_ROWS = 8192   # the floor probe's x: 8 MB of f32 rows at d = 256
GRAPH_CALLS = 20     # calls in the CUDA graph of a device-only time
# x folded into this many rows (48 MB of 1 KB rows, the 1.5D chunk's x):
# the ring against four register steps as x outgrows the L2
FOLD_ROWS = (L2_FIT_ROWS, 49152)


def flat_order(pack):
    """``pack`` with its short rows longest first over the whole stack
    (a forward pack's own order): the same rows, another walk."""
    import dataclasses as dc
    counts = (pack.rowptr[1:] - pack.rowptr[:-1])[pack.short_rows.long()]
    order = torch.sort(-counts, stable=True).indices
    return dc.replace(pack, short_rows=pack.short_rows[order].contiguous())


def blocked_order(pack, col_block: int):
    """``pack`` with its short rows listed block by block of ``col_block``
    columns (a row's block that of its first column, empty rows last),
    longest first within a block (a transposed pack's own order, from
    :func:`flat_order`): the warps in flight read one partition's x
    rows.  The same rows, another walk."""
    import dataclasses as dc
    pack = flat_order(pack)
    rowptr, short = pack.rowptr.long(), pack.short_rows.long()
    counts = (rowptr[1:] - rowptr[:-1])[short]
    col = torch.cat([pack.col, pack.col.new_zeros(1)]).long()
    n_blocks = -(-pack.n_cols // col_block)
    block = torch.where(counts > 0, col[rowptr[:-1][short]] // col_block,
                        n_blocks)
    order = torch.sort(block, stable=True).indices
    return dc.replace(pack, short_rows=pack.short_rows[order].contiguous())


def index_order(pack):
    """``pack`` with its short rows in row order: neighbouring rows (close
    ids, which a generated graph's communities share) in flight
    together, whatever their lengths."""
    import dataclasses as dc
    return dc.replace(pack, short_rows=torch.sort(pack.short_rows).values)


def l2_fit(pack, x, rows: int = L2_FIT_ROWS):
    """The floor probe: ``pack`` with every column folded into the first
    ``rows`` rows of ``x`` (by default :data:`L2_FIT_ROWS`, so the x rows
    it reads fit in the L2); the same entries, rows and row order."""
    import dataclasses as dc
    k = min(rows, pack.n_cols)
    return (dc.replace(pack, col=(pack.col % k).contiguous(), n_cols=k),
            x[:k].contiguous())


def csr_variant_cases(tctx: dict, esp, layout, gen) -> dict:
    """The CSR kernel's routes at the train cell's shapes: name -> (pack,
    x, out to accumulate into or None, the columns of one partition for
    :func:`blocked_order` or None): the edge list's A and A^T at d = 256,
    the hybrid A^T (``d_h``), the hybrid tail at d = 500 (accumulate),
    the row gather's transposed map (``gather_rows_bwd``), GAT's A with 4
    heads of 64, and the 1.5D chunk's A and A^T at d = 256 (rank 0 of
    ``layout``, through ``strategy_15d.chunk_adj``)."""
    from repro_torch.dist.capgnn_sim import exchange_arrays
    from repro_torch.dist.strategy_15d import chunk_adj
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    src, dst, w = (torch.as_tensor(a, device=dev)
                   for a in (esp.e_src, esp.e_dst, esp.e_w))
    n_parts, ni = esp.num_parts, esp.n_inner_max
    n_cols = ni + esp.n_halo_max
    edge = ops.edge_packs(src, dst, w, ni, n_cols)
    sp = tctx["sp"]
    hyb = slice_packs(sp)
    gpack = exchange_arrays(tctx["xplan"], sp.n_inner_max,
                            dev)["loc"]["pull"]["pull"]["pack"]
    chunk = chunk_adj(layout, 0, dev).packs

    def x(rows, *feat):
        return torch.randn((rows, *feat), generator=gen, device=dev)
    heads = ops._valued(edge.fwd, torch.rand(
        (n_parts, src.shape[1], GAT_HEADS), generator=gen, device=dev),
        GAT_HEADS)
    hyb_cols = sp.n_inner_max + sp.n_halo_max
    return {
        "edge_fwd_256": (edge.fwd, x(edge.fwd.n_cols, 256), None, n_cols),
        "edge_dh_256": (edge.bwd, x(edge.bwd.n_cols, 256), None, ni),
        "hybrid_dh_256": (hyb["dh"], x(hyb["dh"].n_cols, 256), None,
                          sp.n_inner_max),
        "hybrid_tail_500": (hyb["tail"], x(hyb["tail"].n_cols, 500),
                            x(hyb["tail"].n_rows, 500), hyb_cols),
        "gather_bwd_256": (gpack, x(gpack.n_cols, 256), None, None),
        "gat_heads_4x64": (heads, x(heads.n_cols, GAT_HEADS, 64), None,
                           n_cols),
        "chunk15d_fwd_256": (chunk.fwd, x(chunk.fwd.n_cols, 256), None,
                             None),
        "chunk15d_dh_256": (chunk.bwd, x(chunk.bwd.n_cols, 256), None,
                            None)}


def protocol_times(fns: dict) -> dict:
    """``fns`` under each timing protocol: queued behind the spin
    (``spin_ms``, ``time_calls``'s default) and from an idle card
    (``idle_ms``), 3 and 5 calls a run; the device time of a CUDA graph
    of :data:`GRAPH_CALLS` calls (``graph_ms``: no host time at all);
    and the host's time to enqueue a call (``enqueue_us``)."""
    out = {}
    for reps in (3, 5):
        out[f"spin_ms_{reps}"] = time_calls(fns, reps, VARIANT_ROUNDS)
        out[f"idle_ms_{reps}"] = time_calls(fns, reps, VARIANT_ROUNDS,
                                            spin=False)
    out["graph_ms"] = {k: device_us(f, GRAPH_CALLS) / 1e3
                       for k, f in fns.items()}
    out["enqueue_us"] = {k: enqueue_us(f) for k, f in fns.items()}
    return out


def phase_csr_variants(cases: dict) -> dict:
    """Each case through every row order (``flat``: :func:`flat_order`;
    ``blocked``: :func:`blocked_order`, where the case has partitions;
    ``index``: :func:`index_order`), stripe and mode the kernel builds,
    each checked against the plain version, and timed in turns over
    :data:`VARIANT_ROUNDS` rounds (median and the rounds' least and most)
    with the pack's own order and configuration (``default``), the floor
    probe (:func:`l2_fit`, the default configuration), the ring and four
    register steps over x folded into each of :data:`FOLD_ROWS` rows;
    then the default under every protocol (:func:`protocol_times`).  One
    ``csr_variants`` line per case.
    Returns each case's median times."""
    from repro_torch.kernels import csr_spmm as kcsr, ref
    out = {}
    for name, (pack, x, acc, col_block) in cases.items():
        want = ref.csr_spmm_ref(pack, x, acc)
        tol = csr_tol(want)
        heads = pack.w.shape[0] if pack.w.dim() == 2 else 1

        work = None if acc is None else acc.clone()

        def run(p, config=(), x_=x, into=None):
            if acc is None:
                return kcsr.write_mode("csr_spmm", p, x_, config)[0]
            into = work if into is None else into
            kcsr._run("csr_spmm_accumulate", p, x_, into, True, config)
            return into

        def fresh(p, config=()):
            """One result to check: accumulate mode into a new copy."""
            return run(p, config, into=None if acc is None else acc.clone())
        fns, errs = {}, {}
        vec = kcsr.csr_launch_config(x.shape[-1], 4, 0,
                                     kcsr.mean_row(pack))[0]
        modes = list(kcsr.MODES) if vec * 4 == 16 else ["regs2"]
        orders = [("flat", flat_order(pack)), ("index", index_order(pack))]
        if col_block:
            orders.insert(1, ("blocked", blocked_order(pack, col_block)))
        for order, p in orders:
            for sb in VARIANT_STRIPE_BYTES:
                for mode in modes:
                    key = f"{order}_{sb}B_{mode}"
                    fns[key] = (lambda p=p, c=(sb, mode): run(p, c))
                    errs[key] = check_close(f"csr variant {name} {key}",
                                            fresh(p, (sb, mode)), want,
                                            **tol)
        probe, x_fit = l2_fit(pack, x)
        fns["l2_fit_default"] = lambda: run(probe, (), x_fit)
        if "ring" in modes:
            for rows in FOLD_ROWS:
                folded, x_f = l2_fit(pack, x, rows)
                for c in ((1024, "ring"), (512, "regs4")):
                    fns[f"fold{rows}_{c[0]}B_{c[1]}"] = (
                        lambda p=folded, x_=x_f, c=c: run(p, c, x_))
        fns["default"] = lambda: run(pack)
        errs["default"] = check_close(f"csr variant {name} default",
                                      fresh(pack), want, **tol)
        del want
        runs = time_runs(fns, reps=5, rounds=VARIANT_ROUNDS)
        t = {k: statistics.median(v) for k, v in runs.items()}
        spread = {k: [min(v), max(v)] for k, v in runs.items()}
        b, by = bound_ms(csr_bytes(pack, x.shape[-1] * heads, 4,
                                   acc is not None),
                         2.0 * pack.nnz * x.shape[-1] * heads)
        best = min((k for k in t if k != "l2_fit_default"
                    and not k.startswith("fold")), key=t.get)
        _, stripe, mode = kcsr.csr_launch_config(x.shape[-1], 4, 0,
                                                 kcsr.mean_row(pack))
        mode = {v: k for k, v in kcsr.MODES.items()}[mode]
        emit("csr_variants", case=name, nnz=pack.nnz, n_rows=pack.n_rows,
             n_cols=pack.n_cols, heads=heads, d=x.shape[-1],
             col_block=col_block,
             default=f"{min(stripe * vec * 4, 1024)}B_{mode}",
             best=best, bound_ms=b, bound_by=by, ms=t, spread_ms=spread,
             max_abs_err=errs,
             protocols=protocol_times({"default": fns["default"]}))
        out[name] = t
        del fns
        torch.cuda.empty_cache()
    return out


def phase_dvals_variants(esp, gen) -> None:
    """``edge_dvals`` at GAT's shape (4 heads of 64 on the train cell's
    forward edge pack): one launch for the heads in the pack's own and
    the blocked row order, in one pass and head by head, four one-head
    launches, each against the plain version, and the floor probe
    (:func:`l2_fit`), over :data:`VARIANT_ROUNDS` rounds (median and
    spread), and the one-pass launch under every protocol; one
    ``dvals_variants`` line."""
    from repro_torch.kernels import edge_spmm as kedge, ops, ref
    dev = torch.device("cuda")
    src, dst, w = (torch.as_tensor(a, device=dev)
                   for a in (esp.e_src, esp.e_dst, esp.e_w))
    ni, n_cols = esp.n_inner_max, esp.n_inner_max + esp.n_halo_max
    fwd = ops.edge_packs(src, dst, w, ni, n_cols, grad=False).fwd
    blocked = blocked_order(fwd, n_cols)
    n_edges = src.numel()
    g = torch.randn((fwd.n_rows, GAT_HEADS, 64), generator=gen, device=dev)
    h = torch.randn((fwd.n_cols, GAT_HEADS, 64), generator=gen, device=dev)
    gz = [g[:, z].contiguous() for z in range(GAT_HEADS)]
    hz = [h[:, z].contiguous() for z in range(GAT_HEADS)]
    want = ref.edge_dvals_ref(fwd, g, h, n_edges)
    probe, h_fit = l2_fit(fwd, h)
    fns = {"heads_own": lambda: kedge.edge_dvals(fwd, g, h, n_edges),
           "heads_blocked": lambda: kedge.edge_dvals(blocked, g, h,
                                                     n_edges),
           "heads_by_head_own": lambda: kedge._dvals(
               fwd, g, h, n_edges, one_pass=False)[0],
           "l2_fit": lambda: kedge.edge_dvals(probe, g, h_fit, n_edges),
           "per_head": lambda: torch.stack([kedge.edge_dvals(
               fwd, gz[z], hz[z], n_edges) for z in range(GAT_HEADS)], -1)}
    errs = {k: check_close(f"edge_dvals {k}", f(), want)
            for k, f in fns.items() if k != "l2_fit"}
    runs = time_runs(fns, reps=5, rounds=VARIANT_ROUNDS)
    nbytes = dvals_bytes(fwd, GAT_HEADS * 64, n_edges * GAT_HEADS)
    b, by = bound_ms(nbytes, 2.0 * fwd.nnz * GAT_HEADS * 64)
    emit("dvals_variants", heads=GAT_HEADS, d=64, nnz=fwd.nnz,
         edges=n_edges, bound_ms=b, bound_by=by, bytes=nbytes,
         ms={k: statistics.median(v) for k, v in runs.items()},
         spread_ms={k: [min(v), max(v)] for k, v in runs.items()},
         max_abs_err=errs,
         protocols=protocol_times({"heads_own": fns["heads_own"]}))


SPMM_AT_D = 64     # a GAT head's width at the paper's hidden 256, 4 heads


def phase_spmm_at(sp, gen) -> dict:
    """``EllAdj.spmm_at``, the first caller whose ELL values carry a
    gradient, on the training slice's ELL pack (the hybrid pack's regular
    part) at d = :data:`SPMM_AT_D`: its forward and backward once, the
    launches counted from zero (the ELL forward, ``d_vals``, and ``d_h``
    over the transposed pack built for the call: the values are not the
    constants ``dh_pack`` is built from); the product, ``d_vals`` and
    ``d_h`` against their plain versions on the same inputs; the
    ``d_vals`` launch at this width timed beside its plain version.
    Returns the path's launches."""
    from repro_torch.kernels import ell_spmm as kell, ref
    from repro_torch.models.gnn import EllAdj
    dev = torch.device("cuda")
    cols = torch.as_tensor(sp.ell.cols, device=dev)
    vals = torch.as_tensor(sp.ell.vals, device=dev)
    n_parts, n_rows, k = cols.shape
    n_cols, d = sp.n_inner_max + sp.n_halo_max, SPMM_AT_D
    adj = EllAdj(cols, vals, n_cols)
    e = torch.randn(tuple(vals.shape), generator=gen, device=dev)
    h = torch.randn((n_parts, n_cols, d), generator=gen, device=dev)
    g = torch.randn((n_parts, n_rows, d), generator=gen, device=dev)
    te, th = e.clone().requires_grad_(True), h.clone().requires_grad_(True)
    zero_counts()
    out = adj.spmm_at(te, th)
    d_e, d_h = torch.autograd.grad(out, (te, th), g)
    torch.cuda.synchronize()
    launches = read_counts()
    want = {**{k_: 0 for k_ in launches}, "ell_spmm": 1, "csr_spmm_dh": 1,
            "ell_spmm_dvals": 1, "packs_built_for_a_call": 1}
    if launches != want:
        raise AssertionError(f"ell_spmm_at: launches {launches}, want "
                             f"{want}")
    live = vals != 0
    v = torch.where(live, e, 0.0)
    want_dv, want_dh = ref.ell_spmm_bwd_ref(cols, v, h, g, n_cols)
    err = {"forward": check_close("spmm_at forward", out.detach(),
                                  ref.ell_spmm_ref(cols, v, h)),
           "d_vals": check_close("spmm_at d_vals", d_e,
                                 torch.where(live, want_dv, 0.0)),
           "d_h": check_close("spmm_at d_h", d_h, want_dh,
                              **csr_tol(want_dh))}
    del te, th, out, d_e, d_h, want_dv, want_dh
    fns = {"kernel_ms": lambda: kell.ell_spmm_dvals(cols, g, h),
           "plain_ms": lambda: ref.ell_spmm_bwd_ref(cols, v, h, g, n_cols,
                                                    need_h=False)}
    # the library yardstick at this width: torch.sparse.sampled_addmm at
    # the live slots' CSR pattern (as phase_backward's at d = 256)
    pattern = ell_csr(cols, vals, n_cols)
    g2, h_t = g.reshape(-1, d), h.reshape(-1, d).t()
    lib = torch.sparse.sampled_addmm(pattern, g2, h_t, beta=0.0)
    lib_diff = float((lib.values()
                      - kell.ell_spmm_dvals(cols, g, h)[live]).abs().max())
    fns["library_ms"] = lambda: torch.sparse.sampled_addmm(pattern, g2, h_t,
                                                           beta=0.0)
    del lib
    t = time_calls(fns, reps=5)
    rows = referenced_rows(cols, torch.ones_like(live), n_cols)
    nbytes = cols.numel() * 8 + g.numel() * 4 + rows * d * 4
    b, by = bound_ms(nbytes, 2.0 * cols.numel() * d)
    emit("kernel", name="ell_spmm_at", shape=[n_parts, n_rows, k, n_cols, d],
         live_slots=int(live.sum()), launches=launches, max_abs_err=err,
         dvals_ms=t["kernel_ms"], dvals_plain_ms=t["plain_ms"],
         dvals_library_ms=t["library_ms"],
         dvals_library_covers="the live slots only "
                              "(torch.sparse.sampled_addmm)",
         dvals_library_max_abs_diff=lib_diff,
         dvals_bound_ms=b, dvals_bound_by=by)
    return launches


def phase_backward(sp, gen) -> list[dict]:
    """d_vals and the chunked forward at the training slice's shapes (its
    hybrid pack, d = 256, random g and h); returns their kernels-line
    entries.  (The unchunked forward on this pack: :func:`ell_pack_cases`;
    ``d_h``: :func:`phase_dh`.)"""
    from repro_torch.kernels import ell_spmm as kell, ref
    dev = torch.device("cuda")
    cols = torch.as_tensor(sp.ell.cols, device=dev)
    vals = torch.as_tensor(sp.ell.vals, device=dev)
    n_parts, n_rows, k = cols.shape
    n_cols = sp.n_inner_max + sp.n_halo_max
    d = 256
    live = vals != 0
    g = torch.randn((n_parts, n_rows, d), generator=gen, device=dev)
    h = torch.randn((n_parts, n_cols, d), generator=gen, device=dev)
    entries = []

    # d_vals: every slot's <g[i], h[cols[i, k]]>, padding slots included;
    # every column-0 slot of a row holds the same bits
    got = kell.ell_spmm_dvals(cols, g, h)
    again = kell.ell_spmm_dvals(cols, g, h)
    err = check_close("ell_spmm_dvals", got,
                      ref.ell_spmm_bwd_ref(cols, vals, h, g, n_cols,
                                           need_h=False)[0])
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("ell_spmm_dvals: two launches differ in their "
                             "bits")
    zero_col = cols == 0
    has = zero_col.any(-1)
    hi = torch.where(zero_col, got, -torch.inf).amax(-1)
    lo = torch.where(zero_col, got, torch.inf).amin(-1)
    if not torch.equal(hi[has], lo[has]):
        raise AssertionError("ell_spmm_dvals: the column-0 slots of a row "
                             "differ")
    del again
    fns = {"kernel_ms": lambda: kell.ell_spmm_dvals(cols, g, h),
           "plain_ms": lambda: ref.ell_spmm_bwd_ref(cols, vals, h, g, n_cols,
                                                    need_h=False)}
    # the library yardstick: torch.sparse.sampled_addmm at the live slots'
    # CSR pattern (it leaves out the padding slots the einsum covers)
    extra = {}
    pattern = ell_csr(cols, vals, n_cols)
    g2, h_t = g.view(-1, d), h.view(-1, d).t()
    try:
        lib = torch.sparse.sampled_addmm(pattern, g2, h_t, beta=0.0)
    except RuntimeError as exc:
        extra["library"] = f"none: {str(exc).splitlines()[0]}"
    else:
        extra["library_max_abs_diff"] = float(
            (lib.values() - got[live]).abs().max())
        fns["library_ms"] = lambda: torch.sparse.sampled_addmm(
            pattern, g2, h_t, beta=0.0)
        del lib
    t = time_calls(fns, reps=5)
    t.setdefault("library_ms", None)
    rows = referenced_rows(cols, torch.ones_like(live), n_cols)
    nbytes = cols.numel() * 4 + g.numel() * 4 + rows * d * 4 + cols.numel() * 4
    b, by = bound_ms(nbytes, 2.0 * cols.numel() * d)
    vec, stripe, lanes = kell.dvals_launch_config(d, g.data_ptr()
                                                  | h.data_ptr())
    emit("kernel", name="ell_spmm_dvals",
         shape=[n_parts, n_rows, k, n_cols, d], live_slots=int(live.sum()),
         column0_slots=int(zero_col.sum()), max_abs_err=err,
         bit_reproducible=True, vec=vec, stripe_bytes=stripe * vec * 4,
         lanes_per_slot=lanes, bound_ms=b, bound_by=by, bytes=nbytes, **t,
         **extra)
    entries.append({"name": "ell_spmm_dvals", "route": "cuda",
                    "source": BWD_SOURCE, "replaces": BWD_REPLACES,
                    "max_abs_err": err, "ms": t["kernel_ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
                    "library_ms": t["library_ms"],
                    "library_covers": "the live slots only "
                                      "(torch.sparse.sampled_addmm)",
                    "timed_over": f"one launch at d={d}, every slot of "
                                  "the training pack (on no path of the "
                                  "slice: the ELL values are constants)"})
    del pattern, got

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


# ---------------------------------------------------------------------------
# The transformer zoo sharded: DTensor on a ("data", "model") DeviceMesh
# ---------------------------------------------------------------------------

LM_SPMD_MESH = (2, 2)
LM_SPMD_STEPS = 4               # the wire's ~8 s a step sets the phase
LM_SPMD_DECODE_STEPS = 16
LM_SPMD_CACHE = 256
LM_SPMD_F32_TOL_OF_MAX = 1e-4   # sharded f32 logits, gradients vs the card's
LM_SPMD_LOSS_RTOL = 2e-2        # bf16 AdamW losses vs single-device
LM_SPMD_TOP1_MIN = 0.9          # bf16 teacher-forced decode argmax agreement
LM_MOE_LAYERS = 2               # mixtral-8x7b: 32 layers are ~93 GB in bf16
LM_MOE_TOL_OF_MAX = 1e-4        # EP ranks vs the per-block plain version
LM_DRYRUN_CASES = (("qwen3-14b", "train_4k", False),
                   ("mixtral-8x7b", "decode_32k", True))


def lm_spmd_cfg():
    """qwen3-1.7b at its published CONFIG (bf16, 28 layers) with remat on,
    as the dry run's training step forces it, and the step's shape."""
    import dataclasses as dc
    from repro_torch.launch.train import build_parser, lm_config
    args = build_parser().parse_args(LM_TRAIN_ARGV)
    return dc.replace(lm_config(args), remat=True), args


def lm_dryrun_child(out_dir: str, device: str = "cuda") -> None:
    """The dry runs this script compares with, on the CPU in a process of
    their own (a ``fake`` group, fake tensors): qwen3-1.7b's training step
    at ``train lm``'s shape on the 2 x 2 mesh, and the production cases of
    :data:`LM_DRYRUN_CASES`.  Each writes its JSON to ``out_dir``."""
    import logging
    logging.disable(logging.WARNING)
    from repro_torch.launch.dryrun import fake_group, run_one
    from repro_torch.launch.mesh import make_device_mesh
    cfg, args = lm_spmd_cfg()
    fake_group(LM_SPMD_MESH[0] * LM_SPMD_MESH[1])
    mesh = make_device_mesh(LM_SPMD_MESH, ("data", "model"), device)
    res = run_one(cfg.name, (args.seq_len, args.batch, "train"),
                  cfg_override=cfg, mesh=mesh, device=device)
    Path(out_dir, "qwen3-1.7b_2x2.json").write_text(json.dumps(res))
    for arch, shape, multi_pod in LM_DRYRUN_CASES:
        res = run_one(arch, shape, multi_pod=multi_pod, device=device)
        Path(out_dir, f"{arch}_{shape}.json").write_text(json.dumps(res))


def start_lm_dryruns():
    """Start :func:`lm_dryrun_child` beside the card's phases (it needs the
    CPU only); :func:`wait_lm_dryruns` joins it."""
    import multiprocessing as mproc
    out = OUT_DIR / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    proc = mproc.get_context("spawn").Process(target=lm_dryrun_child,
                                             args=(str(out),))
    proc.start()
    return proc, out, time.perf_counter()


def wait_lm_dryruns(started) -> dict:
    proc, out, t0 = started
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"the dry runs' process exited {proc.exitcode}")
    return {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}, \
        time.perf_counter() - t0


def _rank_quiet():
    import logging
    import warnings
    warnings.filterwarnings("ignore")
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)


def _reset_peak() -> None:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def logits_and_grads(cfg, params, batch):
    """``loss_and_grads`` of ``params`` on ``batch`` with the logits and
    ``aux`` of the loss's own forward: ``(logits, aux, metrics,
    grads)``."""
    from repro_torch.models.transformer import loss_and_grads, model
    real, kept = model.forward, []
    model.forward = lambda *a, **k: kept.append(real(*a, **k)) or kept[-1]
    try:
        _, met, grads = loss_and_grads(cfg, params, batch)
    finally:
        model.forward = real
    logits, aux = kept[0]
    return logits.detach(), aux.detach(), met, grads


def shard_grad_err(grads, want) -> tuple[float, float]:
    """Rank 0's shard of every gradient (its chunk starts at 0 on each
    sharded dim) against the single-device gradient: the worst leaf's
    error over that leaf's largest magnitude, and the largest error over
    the largest magnitude of all leaves."""
    from repro_torch.optim.optimizers import tree_leaves
    worst, err, top = 0.0, 0.0, 0.0
    for leaf, ref in zip(tree_leaves(grads), want):
        got = leaf.to_local()
        ref = ref[tuple(slice(0, n) for n in got.shape)].to(got.device)
        e, m = float((got - ref).abs().max()), float(ref.abs().max())
        worst = max(worst, e / m if m else (0.0 if e == 0 else float("inf")))
        err, top = max(err, e), max(top, m)
    return worst, err / top


def lm_spmd_rank(rank, world_size, device, losses_ref):
    """One rank of ``lm_spmd``: qwen3-1.7b (full width and depth) sharded
    on the 2 x 2 mesh.  Rank 0 also runs the single-device references
    (the f32 forward and backward, the greedy bf16 decode) on its card
    while the others wait at the next collective."""
    _rank_quiet()
    from repro_torch.data import synthetic_token_batches
    from repro_torch.dist import staged
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.hlo_cost import OpCounter
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.transformer import (
        init_decode_cache, init_model, serve_step, train_step_fn, use_spmd)
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    import dataclasses as dc
    cfg, args = lm_spmd_cfg()
    zero_counts()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator().manual_seed(args.seed), "cpu")
    out = {"rank": rank, "init_s": time.perf_counter() - t0}
    mesh = make_device_mesh(LM_SPMD_MESH, ("data", "model"), device.type)
    hb = synthetic_token_batches(cfg.vocab_size, args.seq_len, args.batch,
                                 seed=args.seed)
    batches = [{k: torch.from_numpy(b[k]).to(device)
                for k in ("tokens", "labels")}
               for _, b in zip(range(LM_SPMD_STEPS), hb)]
    cfg32 = dc.replace(cfg, dtype="float32")
    ref = None
    if rank == 0:                  # the single-device f32 forward, backward
        p32 = tree_map(lambda t: t.to(device).float(), params)
        logits, _, _, grads = logits_and_grads(cfg32, p32, batches[0])
        ref = {"logits": logits, "grads": tree_leaves(grads)}
        del p32, logits, grads
        _reset_peak()
    # f32 forward and backward, sharded
    ctx = shd.make_spmd_ctx(mesh, cfg, "train", False)
    bspec = shd.batch_specs(mesh, cfg, args.seq_len, args.batch, "train",
                            False)
    dbatches = [shd.place(b, mesh, bspec) for b in batches]
    d32 = tree_map(lambda t: t.float(), shd.shard_params(params, mesh, cfg))
    with use_spmd(ctx):
        logits, _, _, grads = logits_and_grads(cfg32, d32, dbatches[0])
    logits = logits.full_tensor()
    if rank == 0:
        out["f32_err"] = float((logits - ref["logits"]).abs().max())
        out["f32_max"] = float(ref["logits"].abs().max())
        out["grad_err_leaf"], out["grad_err_of_max"] = shard_grad_err(
            grads, ref["grads"])
    del d32, logits, grads, ref
    _reset_peak()
    # bf16 AdamW with ZeRO-1 moments
    opt = adamw(args.lr)
    dparams = shd.shard_params(params, mesh, cfg)
    state = shd.shard_params(opt.init(params), mesh, cfg, zero_data=True)
    step = train_step_fn(cfg, opt)
    torch.cuda.synchronize()
    _reset_peak()
    staged.host_stage_s(reset=True)
    losses, step_ms, counted = [], [], None
    with use_spmd(ctx):
        for i, b in enumerate(dbatches):
            t1 = time.perf_counter()
            if i == 1:                  # the dry run's step, counted
                with OpCounter() as oc:
                    dparams, state, met = step(dparams, state, b)
                counted = oc.cost
                loss = float(met["loss"].full_tensor())
            else:
                dparams, state, met = step(dparams, state, b)
                loss = float(met["loss"].full_tensor())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(loss)
    out.update(losses=losses, step_ms=step_ms,
               steady_step_ms=statistics.median(step_ms[1:]),
               host_stage_s=staged.host_stage_s(),
               train_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               collectives=dict(counted.collective_bytes),
               collective_counts=dict(counted.collective_counts),
               flops=counted.flops)
    del state
    # bf16 decode, teacher-forced on the single-device greedy tokens
    b, w, n = args.batch, LM_SPMD_CACHE, LM_SPMD_DECODE_STEPS
    toks = torch.zeros((b, n + 1), dtype=torch.int64, device=device)
    toks[:, 0] = batches[0]["tokens"][:, 0]
    if rank == 0:
        p16 = tree_map(lambda t: t.to(device), params)
        caches = init_decode_cache(cfg, b, w, device)
        with torch.no_grad():
            for t in range(n):
                lg, caches = serve_step(cfg, p16, caches, toks[:, t:t + 1], t)
                toks[:, t + 1] = lg.float().argmax(-1)
        del p16, caches
        _reset_peak()
    import torch.distributed as dist
    dist.broadcast(toks, 0)
    dparams = shd.shard_params(params, mesh, cfg)
    del params
    dctx = shd.make_spmd_ctx(mesh, cfg, "decode", False)
    caches = shd.place(init_decode_cache(cfg, b, w, device), mesh,
                       shd.decode_state_specs(mesh, cfg, b, w, False))
    tok_spec = shd.P(shd.dp_axes(mesh), None)
    agree, dec_ms = [], []
    _reset_peak()
    with use_spmd(dctx), torch.no_grad():
        for t in range(n):
            t1 = time.perf_counter()
            lg, caches = serve_step(cfg, dparams, caches, shd.place(
                toks[:, t:t + 1].contiguous(), mesh, tok_spec), t)
            top = lg.full_tensor().float().argmax(-1)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t1) * 1e3)
            agree.append((top == toks[:, t + 1]).float().mean().item())
    out.update(top1_agree=float(np.mean(agree)), decode_step_ms=dec_ms,
               decode_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=read_counts())
    if rank == 0 and losses_ref is not None:
        out["loss_rel_err"] = [abs(a - r) / abs(r)
                               for a, r in zip(losses, losses_ref)]
    return out


def lm_spmd_ranks(rank, world_size, device, losses_ref):
    """``lm_spmd``'s and ``lm_spmd_moe``'s rank programs in one spawn (the
    four processes reach the card once)."""
    dense = lm_spmd_rank(rank, world_size, device, losses_ref)
    _reset_peak()
    return {"spmd": dense, "moe": lm_moe_rank(rank, world_size, device, 128)}


def phase_lm_spmd_all(names, losses_ref, dryrun: dict | None, backend: str,
                      devices) -> dict:
    """The two sharded LM phases from one spawn of 4 ranks: ``names``
    (``lm_spmd`` and ``lm_spmd_moe``, or their NCCL twins) checked and
    printed by :func:`phase_lm_spmd` and :func:`phase_lm_spmd_moe`;
    returns the launches summed over both."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    res = spawn(lm_spmd_ranks, 4, backend=backend, devices=devices,
                args=(losses_ref,))
    wall_s = time.perf_counter() - t0
    a = phase_lm_spmd(names[0], [r["spmd"] for r in res], losses_ref,
                      dryrun, backend, wall_s)
    b = phase_lm_spmd_moe(names[1], [r["moe"] for r in res], backend,
                          wall_s)
    return {k: a[k] + b[k] for k in a}


def phase_lm_spmd(name: str, res: list, losses_ref, dryrun: dict | None,
                  backend: str, wall_s: float) -> dict:
    """``lm_spmd``: qwen3-1.7b at its published CONFIG (28 layers, d 2048,
    GQA 16 / 8 of 128, vocab 151,936) on 4 ranks as a ``("data",
    "model")`` 2 x 2 DeviceMesh (``staged``: ranks sharing the card, their
    collectives staged through pinned host buffers into gloo; ``nccl``: a
    card per rank).  One f32 forward and backward against the card's
    single-device one: the logits within ``LM_SPMD_F32_TOL_OF_MAX`` of
    their largest magnitude, and rank 0's shard of every gradient within
    ``LM_SPMD_F32_TOL_OF_MAX`` of that leaf's largest magnitude;
    ``LM_SPMD_STEPS`` bf16 AdamW steps with ZeRO-1 moments at ``train
    lm``'s batch 4 x 128, each loss within
    ``LM_SPMD_LOSS_RTOL`` of single-device ``train_lm``'s
    (``losses_ref``); ``LM_SPMD_DECODE_STEPS`` decode steps at batch 4 and
    cache 256, teacher-forced on the single-device greedy tokens, top-1
    agreement at least ``LM_SPMD_TOP1_MIN``.  Step ms, peak memory and the
    counter's collective bytes per kind, per rank; the bytes of rank 0 (the
    dry run's rank) equal the dry run's for the same step and mesh."""
    r0 = res[0]
    if not r0["f32_err"] <= LM_SPMD_F32_TOL_OF_MAX * r0["f32_max"]:
        raise AssertionError(f"{name}: f32 forward differs by {r0['f32_err']}"
                             f" of {r0['f32_max']}")
    if not r0["grad_err_leaf"] <= LM_SPMD_F32_TOL_OF_MAX:
        raise AssertionError(f"{name}: an f32 gradient differs by "
                             f"{r0['grad_err_leaf']} of its largest value")
    if losses_ref is not None and max(r0["loss_rel_err"]) > \
            LM_SPMD_LOSS_RTOL:
        raise AssertionError(f"{name}: losses {r0['losses']} against "
                             f"{losses_ref}")
    if not np.all(np.isfinite(r0["losses"])):
        raise AssertionError(f"{name}: losses {r0['losses']}")
    if min(r["top1_agree"] for r in res) < LM_SPMD_TOP1_MIN:
        raise AssertionError(f"{name}: decode top-1 agreement "
                             f"{[r['top1_agree'] for r in res]}")
    launches = _summed_launches(name, res)
    equal = None
    if dryrun is not None:
        want = dryrun["qwen3-1.7b_2x2"]
        equal = (want["collectives"] == r0["collectives"]
                 and want["collective_counts"] == r0["collective_counts"])
        if not equal:
            raise AssertionError(f"{name}: counted {r0['collectives']} "
                                 f"{r0['collective_counts']}, the dry run "
                                 f"{want['collectives']} "
                                 f"{want['collective_counts']}")
    emit(name, config="qwen3-1.7b", layers=28, mesh=list(LM_SPMD_MESH),
         backend=backend, f32_err_of_max=r0["f32_err"] / r0["f32_max"],
         f32_grad_err_of_leaf_max=r0["grad_err_leaf"],
         f32_grad_err_of_max=r0["grad_err_of_max"],
         f32_tol_of_max=LM_SPMD_F32_TOL_OF_MAX, losses=r0["losses"],
         losses_single_device=losses_ref,
         loss_rel_err=r0.get("loss_rel_err"),
         loss_rtol=LM_SPMD_LOSS_RTOL,
         top1_agree=[r["top1_agree"] for r in res],
         top1_min=LM_SPMD_TOP1_MIN,
         steady_step_ms=[r["steady_step_ms"] for r in res],
         step_ms_rank0=r0["step_ms"],
         decode_step_ms_median=[statistics.median(r["decode_step_ms"])
                                for r in res],
         host_stage_s=[r["host_stage_s"] for r in res],
         train_peak_gb=[r["train_peak_gb"] for r in res],
         decode_peak_gb=[r["decode_peak_gb"] for r in res],
         collectives=[r["collectives"] for r in res],
         collective_counts=[r["collective_counts"] for r in res],
         flops_per_rank=[r["flops"] for r in res],
         equals_dryrun=equal, init_s=[r["init_s"] for r in res],
         launches=launches, spawn_wall_s=wall_s, card=nvidia_smi())
    return launches


def _summed_launches(name: str, res: list) -> dict:
    """The port's kernel launches summed over the ranks: none on the
    transformer zoo's paths (its attention, MoE and scans are plain
    torch)."""
    total = {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
    if any(total.values()):
        raise AssertionError(f"{name} launched the port's kernels: {total}")
    return total


def _moe_cfg():
    import dataclasses as dc
    from repro_torch.configs import get_config
    return dc.replace(get_config("mixtral-8x7b"),
                      num_layers=LM_MOE_LAYERS, dtype="float32")


def plain_ep_dispatch(mesh_shape):
    """``blocks._moe_dispatch`` replaced by the plain version of the
    expert-parallel MoE: ``_apply_moe`` on each device's token block of
    the ``P(dp, "model", None)`` layout (batch over the data axis, the
    sequence over the model axis), with that block's capacity, and ``aux``
    averaged over the blocks."""
    from repro_torch.models.transformer import blocks

    def dispatch(cfg, p, h):
        d_sz, m_sz = mesh_shape
        outs, auxes = [], []
        for hb in h.chunk(d_sz, 0):
            row = []
            for blk in hb.chunk(m_sz, 1):
                o, a = blocks._apply_moe(cfg, p, blk)
                row.append(o)
                auxes.append(a)
            outs.append(torch.cat(row, 1))
        return torch.cat(outs, 0), torch.stack(auxes).mean()
    return dispatch


def lm_moe_rank(rank, world_size, device, seq: int):
    """One rank of ``lm_spmd_moe``: mixtral-8x7b at its published widths,
    ``LM_MOE_LAYERS`` layers, f32, expert-parallel on the 2 x 2 mesh (8
    experts over the 2-way model axis).  Rank 0 first runs the plain
    version on its card (forward, aux, one backward)."""
    _rank_quiet()
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.hlo_cost import OpCounter
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.transformer import blocks, init_model, use_spmd
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    import dataclasses as dc
    cfg = _moe_cfg()
    zero_counts()
    gen = torch.Generator(device=device).manual_seed(0)
    # drawn in bf16 on the card (the same values on every rank), held f32
    p16 = init_model(dc.replace(cfg, dtype="bfloat16"), gen, device)
    b = 4
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (b, seq), generator=g)
             .to(device) for k in ("tokens", "labels")}
    out = {"rank": rank}
    ref = None
    if rank == 0:
        real = blocks._moe_dispatch
        blocks._moe_dispatch = plain_ep_dispatch(LM_SPMD_MESH)
        try:
            p32 = tree_map(lambda t: t.float(), p16)
            logits, aux, met, grads = logits_and_grads(cfg, p32, batch)
            ref = {"logits": logits.cpu(), "aux": float(aux),
                   "loss": float(met["loss"]),
                   "grads": [t.cpu() for t in tree_leaves(grads)]}
            del p32, grads, logits
        finally:
            blocks._moe_dispatch = real
        _reset_peak()
    mesh = make_device_mesh(LM_SPMD_MESH, ("data", "model"), device.type)
    dp = tree_map(lambda t: t.float(), shd.shard_params(p16, mesh, cfg))
    del p16
    _reset_peak()
    bspec = shd.batch_specs(mesh, cfg, seq, b, "train", False)
    dbatch = shd.place(batch, mesh, bspec)
    ctx = shd.make_spmd_ctx(mesh, cfg, "train", False)
    moe_costs = []
    real_ep = blocks._apply_moe_ep

    def counted_ep(*a, **k):           # the MoE layers' own collectives
        with OpCounter() as oc:
            res = real_ep(*a, **k)
        moe_costs.append(oc.cost)
        return res
    blocks._apply_moe_ep = counted_ep
    torch.cuda.synchronize()
    _reset_peak()
    t0 = time.perf_counter()
    try:
        with use_spmd(ctx), OpCounter() as oc:
            logits, aux, met, grads = logits_and_grads(cfg, dp, dbatch)
        torch.cuda.synchronize()
        fwd_costs = moe_costs[:LM_MOE_LAYERS]
    finally:
        blocks._apply_moe_ep = real_ep
    out["step_ms"] = (time.perf_counter() - t0) * 1e3   # forward + backward
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    full = logits.full_tensor().cpu()
    aux_v, loss_v = float(aux.full_tensor()), float(met["loss"].full_tensor())
    del dp, dbatch, logits
    _reset_peak()
    shapes = {"e": cfg.n_experts, "e_loc": cfg.n_experts // LM_SPMD_MESH[1],
              "d": cfg.d_model, "f": cfg.moe_d_ff, "seq": seq,
              "t": (b // LM_SPMD_MESH[0]) * (seq // LM_SPMD_MESH[1])}
    cap = max(1, int(shapes["t"] * cfg.top_k / shapes["e"] * 1.25))
    out.update(launches=read_counts(), cap=cap,
               fwd_moe=[dict(c.collective_bytes) for c in fwd_costs],
               step_collectives=dict(oc.cost.collective_bytes),
               step_counts=dict(oc.cost.collective_counts), shapes=shapes)
    if rank == 0:
        # rank 0's shard of every gradient against the plain version's:
        # gathering the 13 GB of f32 gradients over the staged wire took
        # ~40 s
        gleaf, gerr = shard_grad_err(grads, ref["grads"])
        out.update(logits_err=float((full - ref["logits"]).abs().max()),
                   logits_max=float(ref["logits"].abs().max()),
                   aux=aux_v, aux_plain=ref["aux"], loss=loss_v,
                   loss_plain=ref["loss"], grad_err_of_max=gerr,
                   grad_err_of_leaf_max=gleaf)
    return out


def phase_lm_spmd_moe(name: str, res: list, backend: str,
                      wall_s: float) -> dict:
    """``lm_spmd_moe``: mixtral-8x7b at its published widths (d 4096, 32 /
    8 heads, 8 experts top-2, F 14,336, vocab 32,000) with
    ``LM_MOE_LAYERS`` layers (32 are ~93 GB in bf16) on the 2 x 2 mesh,
    expert-parallel (``8 % 2 == 0``), f32 at batch 4 x 128: logits, aux,
    loss and one backward's gradients (rank 0's shard of every leaf: a
    quarter of the experts, every replicated leaf) against the plain
    version
    (:func:`plain_ep_dispatch` in one process on the card) within
    ``LM_MOE_TOL_OF_MAX``; each MoE layer's counted all-to-all and FSDP
    all-gather bytes equal the byte model from the shapes (two all-to-alls
    of ``e * cap * d`` and three gathers of ``e_loc * D * F``, f32)."""
    r0 = res[0]
    tol = LM_MOE_TOL_OF_MAX
    for what, err, scale in (("logits", r0["logits_err"], r0["logits_max"]),
                             ("grads", r0["grad_err_of_max"], 1.0),
                             ("aux", abs(r0["aux"] - r0["aux_plain"]), 1.0),
                             ("loss", abs(r0["loss"] - r0["loss_plain"]),
                              r0["loss_plain"])):
        if not err <= tol * scale:
            raise AssertionError(f"{name}: {what} differs by {err} of {scale}")
    launches = _summed_launches(name, res)
    s = r0["shapes"]
    model = {"all-to-all": 2 * s["e"] * r0["cap"] * s["d"] * 4,
             "all-gather": 3 * s["e_loc"] * s["d"] * s["f"] * 4}
    for r in res:
        for layer in r["fwd_moe"]:
            got = {k: layer[k] for k in model}
            if got != model:
                raise AssertionError(f"{name}: rank {r['rank']} MoE layer "
                                     f"counted {got}, the byte model {model}")
    emit(name, config="mixtral-8x7b", layers=LM_MOE_LAYERS,
         reduced=f"depth {LM_MOE_LAYERS} of 32 (bf16 weights ~93 GB)",
         mesh=list(LM_SPMD_MESH), backend=backend, batch=4,
         seq=r0["shapes"]["seq"],
         cap=r0["cap"], logits_err_of_max=r0["logits_err"] / r0["logits_max"],
         grad_err_of_max=r0["grad_err_of_max"],
         grad_err_of_leaf_max=r0["grad_err_of_leaf_max"],
         aux=r0["aux"], aux_plain=r0["aux_plain"], loss=r0["loss"],
         loss_plain=r0["loss_plain"], tol_of_max=tol,
         moe_layer_bytes=res[0]["fwd_moe"], byte_model=model,
         step_collectives=[r["step_collectives"] for r in res],
         step_ms=[r["step_ms"] for r in res],
         peak_gb=[r["peak_gb"] for r in res], launches=launches,
         spawn_wall_s=wall_s, card=nvidia_smi())
    return launches


def phase_lm_dryrun(dryrun: dict, wait_s: float) -> None:
    """``lm_dryrun``: ``run_one`` of :data:`LM_DRYRUN_CASES` (a ``fake``
    group of 256 or 512 ranks, fake tensors on ``cuda``; counts, not
    timings): per-device FLOPs, bytes, collectives and memory, and the
    roofline terms over the card's constants (``launch.mesh.HW``)."""
    from repro_torch.launch.mesh import HW
    for arch, shape, _ in LM_DRYRUN_CASES:
        r = dryrun[f"{arch}_{shape}"]
        terms = {"compute_s": r["hlo_flops_per_device"] / HW.PEAK_BF16_FLOPS,
                 "memory_s": r["hlo_bytes_per_device"] / HW.HBM_BW,
                 "collective_s": r["collective_bytes_per_device"]
                 / HW.LINK_BW}
        emit("lm_dryrun", **{k: r[k] for k in (
            "arch", "shape", "mesh", "devices", "kind", "trace_s",
            "hlo_flops_per_device", "hlo_bytes_per_device",
            "collective_bytes_per_device", "collectives",
            "collective_counts", "memory")},
             roofline_terms=terms, bound_by=max(terms, key=terms.get),
             dryrun_wait_s=wait_s)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", action="store_true",
                   help="time every feature stripe of the ELL forward and "
                        "every long-row threshold of the CSR kernel, and "
                        "print ptxas's report of every kernel")
    p.add_argument("--spmd-nccl", action="store_true",
                   help="run only the SPMD runtime over NCCL (one card per "
                        "rank: needs 4 cards), every tier non-empty and at "
                        "the training cell's flags, against the card's "
                        "single-process runtime, and the transformer zoo's "
                        "two sharded cases (lm_spmd_nccl, lm_spmd_moe_nccl)")
    p.add_argument("--kernels-only", action="store_true",
                   help="run only the edge route's kernel phases at the "
                        "train cell's shapes: the CSR kernel's row orders, "
                        "stripes and modes on every route it serves, "
                        "edge_dvals with GAT's heads, and the kernels "
                        "lines of coo_spmm, csr_spmm_dh, csr_spmm_tail and "
                        "gather_rows_bwd")
    p.add_argument("--spmd-nccl-pair", action="store_true",
                   help="run only the paper's CaPGNN and Vanilla rows "
                        "through the SPMD runtime over NCCL (spmd_nccl and "
                        "spmd_vanilla_nccl, p2p; needs 4 cards)")
    return p.parse_args(argv)


def spmd_host_nccl(tctx: dict, lr: float) -> None:
    """The ``spmd_host`` run over NCCL, one card per rank (``p2p``, host
    features, the forced plan), and one ``lru`` re-planned run under
    ``allgather`` (``spmd_lru_nccl``), each against the card's
    single-process run of the same spec; then ``spmd_faults_nccl``."""
    import dataclasses as dc
    from repro_torch.core import AdaptivePlanner
    from repro_torch.models.gnn import init_gnn
    fctx = forced_context(tctx)
    seed = int(TRAIN_ARGV[TRAIN_ARGV.index("--seed") + 1])
    params0 = init_gnn(fctx["cfg"], torch.Generator().manual_seed(seed),
                       "cuda")
    spec = fctx["spec"]
    ref = sim_reference(fctx, dc.replace(spec, transport="p2p",
                                         features="host"), params0, lr)
    phase_spmd_host("spmd_host_nccl", fctx, ref, "p2p", "nccl", "cuda",
                    params0, lr)
    planner = AdaptivePlanner(fctx["ps"], fctx["cap"],
                              refresh_every=spec.refresh_every, policy="lru",
                              seed=spec.seed)
    ref = sim_reference(fctx, dc.replace(spec, transport="allgather",
                                         cache_policy="lru"), params0, lr,
                        planner)
    phase_spmd_host("spmd_lru_nccl", fctx, ref, "allgather", "nccl", "cuda",
                    params0, lr, features="device", policy="lru")
    phase_spmd_faults("spmd_faults_nccl", fctx, params0, lr, "nccl", "cuda")


def spmd_nccl_row(name: str, argv: list[str], transports) -> dict:
    """:func:`phase_spmd` of ``argv``'s flags over NCCL, a card per rank,
    against the card's single-process refresh step from ``init_gnn`` of
    the seed; returns the flags' host plan."""
    from repro_torch.launch.train import build_parser, prepare_train
    from repro_torch.models.gnn import init_gnn
    args = build_parser().parse_args(argv)
    ctx = prepare_train(args)
    params0 = init_gnn(ctx["cfg"], torch.Generator().manual_seed(args.seed),
                       "cpu")
    loss, grads, _ = refresh_grads(ctx["cfg"], ctx["spec"], ctx["sp"],
                                   ctx["xplan"], params0, args.lr, "cuda")
    ref = {"params0": params0, "loss": loss, "grads": grads}
    phase_spmd(name, ctx, ref, transports, "nccl", "cuda", args.epochs,
               args.lr)
    return ctx


def main_spmd_nccl(device: dict, pair_only: bool = False) -> None:
    """``--spmd-nccl``: the ``spmd_tiers_nccl`` and ``spmd_models_nccl``
    phases; then the ``spmd_nccl`` phase at the training cell's flags
    under both transports and ``spmd_vanilla_nccl`` at the Vanilla row's
    (:data:`ABLATION`, ``p2p``), the host-features and ``lru`` runs over
    NCCL (:func:`spmd_host_nccl`), the 1.5D strategy's 4-rank GCN cases
    (``spmm15d_nccl``), and the transformer zoo's ``lm_spmd_nccl`` and
    ``lm_spmd_moe_nccl``.  ``pair_only`` (``--spmd-nccl-pair``): the
    CaPGNN and Vanilla rows alone, ``p2p``."""
    if not pair_only:
        tiers = tiers_context()
        phase_spmd_tiers("spmd_tiers_nccl", tiers, "nccl", "cuda")
        phase_spmd_models("spmd_models_nccl", models_context(tiers), "nccl",
                          "cuda")
    ctx = spmd_nccl_row("spmd_nccl", TRAIN_ARGV, ("p2p",) if pair_only
                        else ("p2p", "allgather"))
    spmd_nccl_row("spmd_vanilla_nccl", TRAIN_ARGV + ABLATION["vanilla"][0],
                  ("p2p",))
    if pair_only:
        print(json.dumps({"ok": True, "device": device}), flush=True)
        return
    lr = float(TRAIN_ARGV[TRAIN_ARGV.index("--lr") + 1])
    spmd_host_nccl(ctx, lr)
    phase_spmm15d("spmm15d_nccl", ctx, SPMM15D_NCCL_SHAPES, "nccl", "cuda",
                  models=("gcn",))
    # the transformer zoo's two sharded cases, a card per rank
    phase_lm_spmd_all(("lm_spmd_nccl", "lm_spmd_moe_nccl"), None, None,
                      "nccl", "cuda")
    print(json.dumps({"ok": True, "device": device}), flush=True)


def main_kernels(device: dict) -> None:
    """``--kernels-only``: the train cell's host plan (hybrid, and its
    edge list stacked anew) and the 1.5D layout at ``c=2, pr=2``, then
    :func:`phase_csr_variants`, :func:`phase_dvals_variants`,
    ``coo_spmm`` (with ``edge_dvals``),
    the training tail's ``csr_spmm_tail`` lines, ``csr_spmm_dh`` and
    ``gather_rows_bwd``; the kernels line carries no launches (no path
    runs here)."""
    from repro_torch.dist import stack_partitions
    from repro_torch.launch.train import build_parser, prepare_train
    ptxas_report(("csr_spmm", "edge_dvals"))
    tctx = prepare_train(build_parser().parse_args(TRAIN_ARGV))
    esp = stack_partitions(tctx["ps"], tctx["task"], backend="edges")
    gen = torch.Generator(device="cuda").manual_seed(0)
    layout = spmm15d_contexts(tctx, [(2, 2)])[(2, 2)]["layout"]
    phase_csr_variants(csr_variant_cases(tctx, esp, layout, gen))
    phase_dvals_variants(esp, gen)
    entries = phase_coo_spmm(esp, gen)
    packs = slice_packs(tctx["sp"])
    tail_cases("train", packs["tail"], tctx["sp"], gen)
    entries.append(phase_dh(packs, tctx["sp"], gen))
    del packs
    entries.append(phase_gather_bwd(tctx["xplan"], tctx["sp"], gen)[0])
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


def main(argv=None) -> None:
    opts = parse_args(argv)
    device = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if opts.spmd_nccl or opts.spmd_nccl_pair:
        return main_spmd_nccl(device, pair_only=opts.spmd_nccl_pair)
    if opts.kernels_only:
        return main_kernels(device)
    dryruns = start_lm_dryruns()     # CPU only: beside the card's phases
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

    checks = CpuChecks()
    serve_launches = phase_main("main_path", SLICE_ARGV, ctx, checks)
    torch.cuda.empty_cache()
    by_path = {"serve": serve_launches}
    by_path["serve_sage"] = phase_main(
        "serve_sage", with_backend(SLICE_ARGV, "hybrid", model="sage"), ctx,
        checks, check_scale=SERVE_SAGE_CHECK_SCALE)
    torch.cuda.empty_cache()
    by_path["serve_fresh"] = phase_serve_fresh(ctx, checks)
    torch.cuda.empty_cache()
    by_path.update(phase_examples())
    torch.cuda.empty_cache()
    by_path["train"], tctx, tref = phase_train("train", TRAIN_ARGV, checks,
                                               sgd_check=True)
    tref["run_losses"] = tctx["report"].losses
    # SAGE and GIN on the same host plan (every model has the same widths)
    for model in ("sage", "gin"):
        argv = with_backend(TRAIN_ARGV, "hybrid", model=model)
        by_path[f"train_{model}"], _, _ = phase_train(
            f"train_{model}", argv, checks, shared_context(tctx, argv))
        torch.cuda.empty_cache()
    # the default flags (--backend edges) on the same host plan, and GAT,
    # which runs on the edge list only
    edges_argv = with_backend(TRAIN_ARGV, "edges")
    by_path["train_edges"], ectx, _ = phase_train(
        "train_edges", edges_argv, checks, shared_context(tctx, edges_argv))
    edge_entries = phase_coo_spmm(ectx["sp"], gen)
    gat_argv = with_backend(TRAIN_ARGV, "edges", model="gat")
    gat_argv[gat_argv.index("--lr") + 1] = GAT_LR
    by_path["train_gat"], _, _ = phase_train(
        "train_gat", gat_argv, checks, shared_context(ectx, gat_argv))
    del ectx
    torch.cuda.empty_cache()
    by_path["train_ell"], _, _ = phase_train(
        "train_ell", with_backend(TRAIN_ARGV, "ell", TRAIN_ELL_SCALE),
        checks, check_scale=TRAIN_SGD_SCALE)
    torch.cuda.empty_cache()
    by_path.update(phase_train_ablation(tctx, checks))
    epochs = len(tctx["report"].losses)
    lr = float(TRAIN_ARGV[TRAIN_ARGV.index("--lr") + 1])
    # the SPMD runtime: 4 ranks sharing card 0 over gloo, the spmd,
    # spmd_tiers and spmd_models rank programs in one spawn
    shared = ["cuda:0"] * SPMD_RANKS
    transports = ("p2p", "allgather")
    tiers = tiers_context()
    cases = models_context(tiers)
    # the 1.5D strategy's 4-rank shapes share the spawn
    prep15 = spmm15d_prepare(tctx, SPMM15D_SHAPES)
    res, wall_s = spawn_jobs(
        spmd_jobs(tctx, tref, transports, epochs, lr) + tier_jobs(tiers)
        + [(spmd_models_rank, (cases,)),
           (spmm15d_rank, (prep15["jobs"][SPMD_RANKS],))],
        SPMD_RANKS, "gloo", shared)
    n = len(transports)
    by_path.update(phase_spmd("spmd", tctx, tref, transports, "gloo", shared,
                              epochs, lr, spawned=(res[:n], wall_s)))
    phase_spmd_tiers("spmd_tiers", tiers, "gloo", shared,
                     spawned=(res[n:n + 1], wall_s))
    by_path.update(phase_spmd_models("spmd_models", cases, "gloo", shared,
                                     spawned=(res[n + 1:n + 2], wall_s)))
    # the 1.5D strategy: its ranks share card 0 over gloo
    by_path["spmm15d"] = phase_spmm15d(
        "spmm15d", tctx, SPMM15D_SHAPES, "gloo", shared, prep=prep15,
        spawned={SPMD_RANKS: (res[n + 2], wall_s)})
    del res
    torch.cuda.empty_cache()
    # JACA's CPU tier and online adaptation on the train cell's host plan
    fctx = forced_context(tctx)
    seed = int(TRAIN_ARGV[TRAIN_ARGV.index("--seed") + 1])
    by_path["train_host"], host_losses, params0 = phase_train_host(
        fctx, seed, lr)
    by_path["train_host_cli"] = phase_train_host_cli(
        tctx, TRAIN_ARGV + ["--features", "host"])
    by_path.update(phase_train_adaptive(fctx))
    # faults and defenses, the tracer and checkpoints
    torch.cuda.empty_cache()
    by_path["train_faults"] = phase_train_faults(fctx)
    phase_train_traced(fctx, seed, lr)
    # spmd_host and spmd_faults: host features on 4 ranks sharing the
    # card, in one spawn
    host_ref = {"losses": host_losses, "step_kinds": TRAIN_KINDS,
                "replan_events": 0, "hit_rate": None}
    (host_ranks, fault_ranks), wall_s = spawn_jobs(
        [spmd_host_job(fctx, "p2p", params0, lr),
         spmd_faults_job(fctx, params0, lr)], SPMD_RANKS, "gloo", shared)
    by_path["spmd_host"] = phase_spmd_host(
        "spmd_host", fctx, host_ref, "p2p", "gloo", shared, params0, lr,
        spawned=([host_ranks], wall_s))
    by_path.update(phase_spmd_faults("spmd_faults", fctx, params0, lr,
                                     "gloo", shared,
                                     spawned=([fault_ranks], wall_s)))
    del fctx
    torch.cuda.empty_cache()
    phase_device_trace(tctx)
    phase_checkpoint(tctx)
    torch.cuda.empty_cache()
    phase_profile()
    # the card-vs-CPU checks, before the phases whose step is host-bound
    checks.finish()
    # the transformer zoo: plain torch, no kernel of the port on its paths
    by_path["lm_reduced"] = phase_lm_reduced()
    by_path["lm_serve"] = phase_lm_serve()
    by_path["lm_train"] = phase_lm_train()
    torch.cuda.empty_cache()
    # the transformer zoo sharded: 4 ranks sharing the card as a 2 x 2 mesh
    dryrun, dryrun_wait_s = wait_lm_dryruns(dryruns)
    by_path["lm_spmd"] = phase_lm_spmd_all(
        ("lm_spmd", "lm_spmd_moe"), list(LM_TRAIN_LOSSES), dryrun, "staged",
        ["cuda:0"] * SPMD_RANKS)
    phase_lm_dryrun(dryrun, dryrun_wait_s)
    n_cards = torch.cuda.device_count()
    if n_cards >= SPMD_RANKS:
        by_path.update(phase_spmd("spmd_nccl", tctx, tref,
                                  ("p2p", "allgather"), "nccl", "cuda",
                                  epochs, lr))
        phase_spmd_tiers("spmd_tiers_nccl", tiers, "nccl", "cuda")
        by_path.update(phase_spmd_models(
            "spmd_models_nccl", models_context(tiers), "nccl", "cuda"))
        spmd_host_nccl(tctx, lr)
        by_path["spmm15d_nccl"] = phase_spmm15d(
            "spmm15d_nccl", tctx, SPMM15D_NCCL_SHAPES, "nccl", "cuda",
            models=("gcn",))
        phase_lm_spmd_all(("lm_spmd_nccl", "lm_spmd_moe_nccl"),
                          list(LM_TRAIN_LOSSES), dryrun, "nccl", "cuda")
    else:
        for name in ("spmd_nccl", "spmd_vanilla_nccl", "spmd_tiers_nccl",
                     "spmd_models_nccl",
                     "spmd_host_nccl", "spmd_lru_nccl", "spmd_faults_nccl",
                     "spmm15d_nccl", "lm_spmd_nccl", "lm_spmd_moe_nccl"):
            emit(name, ran=False, cards=n_cards, ranks=SPMD_RANKS,
                 why="NCCL needs one card per rank")
    torch.cuda.empty_cache()
    ell_cases["train"] = ell_pack_cases("train", tctx["sp"], gen)
    slices = {"serve": sp, "train": tctx["sp"]}
    packs = {name: slice_packs(s) for name, s in slices.items()}
    tails = {name: tail_cases(name, packs[name]["tail"], s, gen)
             for name, s in slices.items()}
    dh = phase_dh(packs["train"], tctx["sp"], gen)
    del packs
    torch.cuda.empty_cache()
    gather_bwd, gather["per_launch"]["train"] = phase_gather_bwd(
        tctx["xplan"], tctx["sp"], gen)
    torch.cuda.empty_cache()
    if opts.sweep:
        sweep_ell(slices, gen)
        sweep_csr(slices, gen)
        sweep_dvals(tctx["sp"], gen)
    by_path["ell_spmm_at"] = phase_spmm_at(tctx["sp"], gen)
    torch.cuda.empty_cache()
    entries = [weighted_entry("ell_spmm", ELL_SOURCE, ELL_REPLACES,
                              ell_cases), gather, gather_bwd, dh,
               weighted_entry("csr_spmm_tail", CSR_SOURCE, TAIL_REPLACES,
                              tails)] + phase_backward(tctx["sp"], gen) \
        + edge_entries
    # launches: every path's, each counted from zero over its own run
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
