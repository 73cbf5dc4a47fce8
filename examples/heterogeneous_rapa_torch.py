"""Heterogeneous-device demo of the PyTorch port: RAPA against uniform
partitioning (paper Fig. 21), through ``repro_torch`` only.

The steps of ``examples/heterogeneous_rapa.py``: the paper's Table-4
device groups (x2 homogeneous ... x8 strongly heterogeneous), each
device's cost model before and after RAPA, then a short training run on
the most heterogeneous group to show that accuracy holds.  The runtime
takes the ``TrainSpec`` that the JAX example's loose-keyword defaults
give (``TrainSpec()``: the ``edges`` backend, layer 0 exchanged, no
pipeline).

    PYTHONPATH=src python examples/heterogeneous_rapa_torch.py [--device cpu]

It runs on the card unless given ``--device cpu``.
"""
import argparse

import numpy as np

from repro_torch.core import (PAPER_GROUPS, RapaConfig, StalenessController,
                              build_cache_plan, cal_capacity, do_partition,
                              make_group, partition_lambdas)
from repro_torch.data import make_task
from repro_torch.dist import (TrainSpec, build_exchange_plan,
                              make_sim_runtime, stack_partitions,
                              train_capgnn)
from repro_torch.graph import build_partition, metis_partition
from repro_torch.launch.serve import resolve_device, set_fp32_numerics
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam

GROUPS = ("x2", "x4", "x6", "x8")


def main(device: str = "cuda", scale: float = 0.05, epochs: int = 40) -> dict:
    """Run the demo; returns its figures (per group the heterogeneity and
    the uniform and RAPA max-costs; the x8 run's losses, test accuracy,
    communication saved and spec)."""
    device = resolve_device(device)       # raises for cuda without CUDA
    set_fp32_numerics()
    task = make_task("flickr", scale=scale, feat_dim=64, seed=0)
    cfg_r = RapaConfig(feat_dim=64)
    # Eq. 15 objective: the MAX per-device cost is the step-time bound.
    print(f"{'group':5s} {'het':>5s} {'uniform max-cost':>17s} "
          f"{'rapa max-cost':>14s}")
    table = {}
    for grp in GROUPS:
        profiles = make_group(PAPER_GROUPS[grp])
        p = len(profiles)
        ps = build_partition(task.graph,
                             metis_partition(task.graph, p, seed=0), hops=1)
        lam0 = partition_lambdas(ps, profiles, cfg_r)
        lam1 = do_partition(ps, profiles, cfg_r).lambda_final
        het = max(pr.mm for pr in profiles) / min(pr.mm for pr in profiles)
        table[grp] = {"het": het, "uniform_max_cost": float(lam0.max()),
                      "rapa_max_cost": float(np.max(lam1))}
        print(f"{grp:5s} {het:5.1f} {lam0.max():17.3e} {np.max(lam1):14.3e}")

    # train on the x8 group with the RAPA-balanced partitions
    profiles = make_group(PAPER_GROUPS["x8"])
    ps = build_partition(task.graph,
                         metis_partition(task.graph, 8, seed=0), hops=1)
    ps = do_partition(ps, profiles, cfg_r).partition_set
    gcfg = GNNConfig(model="sage", in_dim=64, hidden_dim=128,
                     out_dim=task.num_classes, num_layers=3)
    cap = cal_capacity(ps, gcfg.feat_dims, profiles)
    plan = build_cache_plan(ps, cap, refresh_every=4)
    xplan = build_exchange_plan(ps, plan)
    sp = stack_partitions(ps, task)
    opt = adam(0.01)
    spec = TrainSpec()
    rt = make_sim_runtime(gcfg, sp, xplan, opt, spec=spec, device=device)
    params, rep = train_capgnn(gcfg, rt, xplan, 8, opt, epochs=epochs,
                               controller=StalenessController(refresh_every=4),
                               spec=spec)
    _, acc = rt.evaluate(params, "test")
    print(f"\nx8 GraphSAGE: loss {rep.losses[-1]:.4f}, test acc {acc:.3f}, "
          f"comm saved {rep.comm_reduction:.1%}")
    return {"groups": table, "losses": rep.losses,
            "final_loss": rep.losses[-1], "test_acc": acc,
            "comm_bytes": rep.comm_bytes,
            "comm_bytes_vanilla": rep.comm_bytes_vanilla,
            "comm_reduction": rep.comm_reduction,
            "step_kinds": rep.step_kinds, "spec": rep.spec}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--epochs", type=int, default=40)
    main(**vars(ap.parse_args()))
