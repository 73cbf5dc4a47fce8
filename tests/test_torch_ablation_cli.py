"""``launch.train gnn`` of both packages under the paper's ablation and
device-group flags, on the CPU.

The argvs are Table 8's rows (Vanilla: no JACA, no RAPA, no pipeline, a
refresh every step; no RAPA; no JACA), the adaptive staleness control,
the x8 group of Fig. 21 (8 partitions), even random partitions and the
uniform group, at ``test_cli_reports_match``'s small sizes (Flickr at
scale 0.02, width 16, 5 epochs, ``--backend hybrid``).  Every count of
the two JSON reports is equal; Vanilla's ``comm_reduction_vs_vanilla``
is exactly 0.0 in both.  The initial parameters differ (``jax.random``
cannot be replayed in torch), so the losses agree only in kind.
"""
import argparse
import json

import numpy as np
import pytest

from repro.launch import train as jlaunch
from repro_torch.launch import train as tlaunch
from torch_threads import torch_threads_per_worker  # noqa: F401

BASE = ["--scale", "0.02", "--feat-dim", "16", "--hidden", "16",
        "--epochs", "5", "--backend", "hybrid", "--refresh-every", "2"]
VANILLA = ["--no-jaca", "--no-rapa", "--no-pipeline", "--refresh-every", "1"]
ARGVS = {
    "vanilla": VANILLA,
    "no-rapa": ["--no-rapa"],
    "no-jaca": ["--no-jaca"],
    "adaptive": ["--adaptive-staleness"],
    "x8": ["--parts", "8", "--group", "x8"],
    "even-random": ["--even", "--partitioner", "random"],
    "uniform": ["--group", "uniform"],
}
COUNTS = ("dataset", "model", "parts", "strategy", "replication", "group",
          "uneven", "inner_sizes", "stack_waste_frac", "epochs",
          "resumed_from", "halo_dtype", "features", "prefetch_depth",
          "host_fetch_rows", "host_fetch_bytes", "host_writeback_bytes",
          "cache_policy", "replan_events", "planner_hit_rate",
          "comm_bytes", "comm_reduction_vs_vanilla", "refresh_steps",
          "cached_steps")


@pytest.mark.parametrize("case", list(ARGVS))
def test_cli_reports_match_under_the_flags(case, capsys):
    argv = BASE + ARGVS[case]
    ns = tlaunch.build_parser().parse_args(["gnn", "--device", "cpu", *argv])
    jargs = argparse.Namespace(**{**vars(ns), "cmd": "gnn"})
    del jargs.device
    want = jlaunch.run_gnn(jargs)
    capsys.readouterr()
    got = tlaunch.main(["gnn", "--device", "cpu", *argv])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
    assert set(got) == set(want)
    for k in COUNTS:
        assert got[k] == want[k], k
    if case == "vanilla":
        assert got["comm_reduction_vs_vanilla"] == 0.0
        assert got["refresh_steps"] == 5 and got["cached_steps"] == 0
    if case == "x8":
        assert got["group"] == "x8" and len(got["inner_sizes"]) == 8
    if case == "uniform":
        assert got["group"] == "uniform"
    assert np.isfinite(got["final_loss"]) and 0.0 <= got["test_acc"] <= 1.0
