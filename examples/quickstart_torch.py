"""Quickstart of the PyTorch port: CaPGNN full-batch GNN training on a
partitioned graph, through ``repro_torch`` only.

The steps of ``examples/quickstart.py``: a scaled Flickr-like graph,
METIS-style partitions and their halo statistics, RAPA balancing against
the x4 device group, the JACA two-level cache plan, the exchange plan and
the stacked layout, then a 3-layer GCN trained with the staleness
schedule and the pipelined refresh, printing the test accuracy and the
exact communication bytes saved against a vanilla runtime.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

It runs on the card unless given ``--device cpu``.
"""
import argparse
import json

from repro_torch.core import (PAPER_GROUPS, RapaConfig, StalenessController,
                              build_cache_plan, cal_capacity, do_partition,
                              halo_stats, make_group)
from repro_torch.data import make_task
from repro_torch.dist import (TrainSpec, build_exchange_plan,
                              make_sim_runtime, stack_partitions,
                              train_capgnn)
from repro_torch.graph import build_partition, metis_partition
from repro_torch.launch.serve import resolve_device, set_fp32_numerics
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam


def main(device: str = "cuda", epochs: int = 60, scale: float = 0.05) -> dict:
    """Run the quickstart; returns its figures (halo stats, bytes, step
    counts, final loss, test accuracy)."""
    device = resolve_device(device)       # raises for cuda without CUDA
    set_fp32_numerics()
    # 1. Data + graph partitioning ---------------------------------------
    task = make_task("flickr", scale=scale, feat_dim=64, seed=0)
    parts = 4
    assign = metis_partition(task.graph, parts, seed=0)
    ps = build_partition(task.graph, assign, hops=1)
    stats = halo_stats(ps).as_dict()
    print("halo stats:", json.dumps(stats, indent=1))

    # 2. RAPA: balance partitions against a heterogeneous device group ---
    profiles = make_group(PAPER_GROUPS["x4"])   # 2x RTX3090 + 2x A40
    rapa = do_partition(ps, profiles, RapaConfig(feat_dim=64))
    ps = rapa.partition_set
    first, last = (h["std"] / max(h["lambda"].mean(), 1e-9)
                   for h in (rapa.history[0], rapa.history[-1]))
    print(f"RAPA: removed {rapa.removed_per_part} halo replicas/part, "
          f"cost rel-std {first:.3f} -> {last:.3f}")

    # 3. JACA: adaptive capacity + two-level cache plan ------------------
    cfg = GNNConfig(model="gcn", in_dim=64, hidden_dim=128,
                    out_dim=task.num_classes, num_layers=3)
    cap = cal_capacity(ps, cfg.feat_dims, profiles)
    plan = build_cache_plan(ps, cap, refresh_every=4)
    xplan = build_exchange_plan(ps, plan)

    # 4. Train with the staleness-scheduled steps and the pipeline -------
    sp = stack_partitions(ps, task)
    opt = adam(0.01)
    spec = TrainSpec(pipeline=True, refresh_every=4)
    runtime = make_sim_runtime(cfg, sp, xplan, opt, spec=spec, device=device)
    ctl = StalenessController(refresh_every=4)
    params, report = train_capgnn(cfg, runtime, xplan, parts, opt,
                                  epochs=epochs, controller=ctl, spec=spec)
    _, test_acc = runtime.evaluate(params, "test")

    print(f"final loss {report.losses[-1]:.4f}  test acc {test_acc:.3f}")
    print(f"comm {report.comm_bytes / 2**20:.1f} MiB "
          f"(vanilla {report.comm_bytes_vanilla / 2**20:.1f} MiB, "
          f"saved {report.comm_reduction:.1%}) over "
          f"{report.refresh_steps} refresh + {report.cached_steps} cached "
          "steps")
    return {"halo_stats": stats, "comm_bytes": report.comm_bytes,
            "comm_bytes_vanilla": report.comm_bytes_vanilla,
            "comm_reduction": report.comm_reduction,
            "refresh_steps": report.refresh_steps,
            "cached_steps": report.cached_steps,
            "final_loss": report.losses[-1], "test_acc": test_acc}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--epochs", type=int, default=60)
    main(**vars(ap.parse_args()))
