"""The port's 1.5D replicated-row strategy (``repro_torch.dist.
strategy_15d``, ``--strategy spmm_15d``) against the JAX package, on the
CPU.

The JAX 1.5D *layout* is numpy and builds here, so the port's is held to
it byte for byte, and so are the three byte models and every capability
refusal.  The JAX 1.5D *runtime* cannot run against the installed JAX
(its ``shard_map`` call passes ``check_rep``), so the numerics are held
against the oracle of the JAX package's own parity script
(``tests/spmm15d_parity_script.py``): JAX ``capgnn_sim`` at
``refresh_every=1`` on the same block-row partition.

The graph of that script: rmat 360 / 2,200, 12 -> 16 -> 16 -> 5, METIS
block rows; parameters from the JAX package's ``init_gnn`` carried across
as numpy.  One spawn of 4 gloo ranks runs ``(c=2, pr=2)`` GCN and GIN,
each with ``exchange_layer0`` on and off, ``(c=1, pr=4)`` GCN and a bf16
wire; one spawn of 8 ranks runs ``(c=2, pr=4)`` GCN (permute, gather and
all-reduce in one step) and a bf16 wire.  Held, per case and on every
rank (every replica of every block row):

- ``forward_fresh``'s logits within 1e-5 of the oracle's (valid rows);
- one ``sgd(1.0)`` step: the loss and every parameter (the delta is the
  gradient) within 1e-5 of the oracle's refresh step;
- a 6-step ``adam`` loss trajectory within 1e-5;
- every forward's counted bytes (the ``Wire`` counts, backward aside)
  equal to ``forward_collective_bytes_per_device``, and the report's
  bytes to ``step_bytes_total`` / ``vanilla_bytes_total`` per step;
- bf16 wire: 2-byte rows counted, losses within 5e-3 of the f32 run.

The CLI: a tiny ``--strategy spmm_15d --parts 4 --replication 2`` run
prints the JAX package's keys, its byte figure equal to the JAX model on
the JAX layout of the same flags; ``P % c**2`` and a capability refusal
exit with the JAX package's messages; ``--ckpt-dir`` / ``--resume``.
"""
import argparse
import json

import numpy as np
import pytest

import jax

import repro.core as jcore
import repro.dist as jdist
from repro.data.gnn_data import FullBatchTask as JTask, split_masks as jsplit
from repro.dist.spec import TrainSpec as JSpec
from repro.dist import strategy_15d as j15
from repro.graph import (build_partition as jbuild, metis_partition as jmetis,
                         rmat as jrmat, symmetric_normalize as jnorm,
                         synth_features as jfeats)
from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
from repro.optim import adam as jadam, sgd as jsgd
from repro_torch.data.gnn_data import FullBatchTask, split_masks
from repro_torch.dist import (StrategyCapabilityError, TrainSpec,
                              get_strategy)
from repro_torch.dist import strategy_15d as t15
from repro_torch.graph import (build_partition, metis_partition, rmat,
                               symmetric_normalize, synth_features)
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import spawn
from repro_torch.models.gnn import GNNConfig

import torch_15d_ranks
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5
BF16_LOSS_TOL = 5e-3
EPOCHS = torch_15d_ranks.EPOCHS
LAYOUTS = [(1, 4), (2, 2), (2, 4)]           # (c, pr)
CASES = {   # id: (c, pr, model, exchange_layer0, halo dtype)
    "c2pr2-gcn": (2, 2, "gcn", True, "f32"),
    "c2pr2-gcn-prereplicated": (2, 2, "gcn", False, "f32"),
    "c2pr2-gin": (2, 2, "gin", True, "f32"),
    "c2pr2-gin-prereplicated": (2, 2, "gin", False, "f32"),
    "c1pr4-gcn": (1, 4, "gcn", True, "f32"),
    "c2pr4-gcn": (2, 4, "gcn", True, "f32"),
}
BF16_CASES = {   # id: (case, the f32 case it tracks)
    "c2pr2-gcn-bf16": ((2, 2, "gcn", True, "bf16"), "c2pr2-gcn"),
    "c2pr4-gcn-bf16": ((2, 4, "gcn", True, "bf16"), "c2pr4-gcn"),
}
JAX_KEYS = ("dataset", "model", "parts", "strategy", "replication",
            "block_rows", "group_size", "group", "uneven", "inner_sizes",
            "epochs", "resumed_from", "final_loss", "halo_dtype",
            "test_acc", "comm_bytes", "comm_reduction_vs_vanilla",
            "fwd_collective_bytes_per_device", "refresh_steps",
            "cached_steps", "compile_s", "wall_time_s")
_CACHE: dict = {}


def _graph(mods, parts):
    """The parity script's task and ``parts``-way partition in one
    package's modules."""
    rmat_, feats_, norm_, task_, split_, metis_, build_ = mods
    g = rmat_(360, 2200, seed=3)
    feats, labels = feats_(g, 12, 5, seed=3)
    gn = norm_(g)
    tr, va, te = split_(g.num_nodes, seed=3)
    task = task_(graph=gn, features=feats, labels=labels, train_mask=tr,
                 val_mask=va, test_mask=te, num_classes=5)
    return task, build_(gn, metis_(gn, parts, seed=3), hops=1)


def _problem(pr):
    key = ("problem", pr)
    if key not in _CACHE:
        jt, jps = _graph((jrmat, jfeats, jnorm, JTask, jsplit, jmetis,
                          jbuild), pr)
        tt, tps = _graph((rmat, synth_features, symmetric_normalize,
                          FullBatchTask, split_masks, metis_partition,
                          build_partition), pr)
        _CACHE[key] = (jt, jps, tt, tps)
    return _CACHE[key]


def _layouts(c, pr):
    """The JAX and the port's layouts of ``(c, pr)``."""
    key = ("layout", c, pr)
    if key not in _CACHE:
        jt, jps, tt, tps = _problem(pr)
        _CACHE[key] = (
            j15.build_spmm15d_layout(jps, jt, JSpec(strategy="spmm_15d",
                                                    replication=c)),
            t15.build_spmm15d_layout(tps, tt, TrainSpec(strategy="spmm_15d",
                                                        replication=c)))
    return _CACHE[key]


def _cfg_kw(model):
    return dict(model=model, in_dim=12, hidden_dim=16, out_dim=5,
                num_layers=3)


def _params_np(model):
    jp = jinit(jax.random.PRNGKey(7), JConfig(**_cfg_kw(model)))
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in jp]


def _spec_kw(c, xl0, halo_dtype):
    return dict(strategy="spmm_15d", replication=c, exchange_layer0=xl0,
                halo_dtype=halo_dtype)


def _rank_args(case):
    c, pr, model, xl0, halo_dtype = case
    return (_layouts(c, pr)[1], _cfg_kw(model),
            _spec_kw(c, xl0, halo_dtype), _params_np(model))


def _ranks(case_id):
    """Every rank's results of one case, from the spawn of its world
    size that runs every case of that size."""
    if "ranks" not in _CACHE:
        cases = dict(CASES)
        cases.update({cid: case for cid, (case, _) in BF16_CASES.items()})
        by_size: dict = {}
        for cid, case in cases.items():
            by_size.setdefault(case[0] * case[1], {})[cid] = _rank_args(case)
        out = {}
        for size, group in sorted(by_size.items()):
            per_rank = spawn(torch_15d_ranks.run_15d_cases, size,
                             backend="gloo", devices="cpu", args=(group,))
            out.update({cid: [r[cid] for r in per_rank] for cid in group})
        _CACHE["ranks"] = out
    return _CACHE["ranks"][case_id]


def _oracle(pr, model):
    """JAX ``capgnn_sim`` at ``refresh_every=1`` on the ``pr`` block rows:
    fresh logits, one ``sgd(1.0)`` refresh step and a 6-step ``adam``
    trajectory from the same parameters."""
    key = ("oracle", pr, model)
    if key in _CACHE:
        return _CACHE[key]
    jt, jps, _, _ = _problem(pr)
    cfg = JConfig(**_cfg_kw(model))
    cap = jcore.cal_capacity(jps, cfg.feat_dims,
                             [jcore.PROFILES["rtx3090"]] * pr)
    xplan = jdist.build_exchange_plan(jps, jcore.build_cache_plan(
        jps, cap, refresh_every=1))
    sp = jdist.stack_partitions(jps, jt)
    spec = JSpec(donate=False)
    params = jax.tree.map(jax.numpy.asarray, _params_np(model))
    sim = jdist.make_sim_runtime(cfg, sp, xplan, jsgd(1.0), spec=spec)
    logits = np.asarray(sim.forward_fresh(params))
    p1, _, _, m1 = sim.step_refresh(params, jsgd(1.0).init(params),
                                    jdist.init_caches(cfg, xplan, pr))
    opt = jadam(1e-2)
    sim = jdist.make_sim_runtime(cfg, sp, xplan, opt, spec=spec)
    _, rep = jdist.train_capgnn(cfg, sim, xplan, pr, opt, epochs=EPOCHS,
                                spec=spec, params0=params)
    _CACHE[key] = {"logits": logits, "valid": np.asarray(sp.inner_valid),
                   "loss": float(m1["loss"]),
                   "params": [{k: np.asarray(v) for k, v in layer.items()}
                              for layer in p1],
                   "losses": rep.losses}
    return _CACHE[key]


def _jax_spec(c, xl0, halo_dtype):
    return JSpec(strategy="spmm_15d", replication=c, exchange_layer0=xl0,
                 halo_dtype=halo_dtype)


# --------------------------------------------------------------- layout


@pytest.mark.parametrize("c,pr", LAYOUTS, ids=[f"c{c}pr{p}" for c, p in
                                                LAYOUTS])
def test_layout_is_the_jax_layout(c, pr):
    """``chunk_src`` / ``chunk_dst`` / ``chunk_w`` / ``n_edges_dev`` and
    ``(c, g, pr, ni)`` byte-identical to JAX ``build_spmm15d_layout``; the
    replica chunks partition the block rows' edges."""
    jl, tl = _layouts(c, pr)
    assert (tl.c, tl.g, tl.pr, tl.ni) == (jl.c, jl.g, jl.pr, jl.ni)
    assert tl.n_devices == jl.n_devices == c * pr
    for f in ("chunk_src", "chunk_dst", "chunk_w", "n_edges_dev"):
        a, b = getattr(tl, f), getattr(jl, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    np.testing.assert_array_equal(tl.block_of_dev, jl.block_of_dev)
    tps = _problem(pr)[3]
    assert tl.edges_total == sum(
        int((pt.local_graph.edges()[1] < pt.n_inner).sum())
        for pt in tps.parts)


@pytest.mark.parametrize("halo_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("xl0", [True, False], ids=["exchange_layer0",
                                                   "prereplicated"])
def test_byte_models_are_the_jax_models(halo_dtype, xl0):
    """``forward_collective_bytes_per_device``, ``step_bytes_total`` and
    ``vanilla_bytes_total`` equal the JAX package's on every layout."""
    for c, pr in LAYOUTS:
        jl, tl = _layouts(c, pr)
        for model in ("gcn", "gin"):
            jcfg, tcfg = JConfig(**_cfg_kw(model)), GNNConfig(**_cfg_kw(model))
            jspec = _jax_spec(c, xl0, halo_dtype)
            tspec = TrainSpec(**_spec_kw(c, xl0, halo_dtype))
            for name in ("forward_collective_bytes_per_device",
                         "step_bytes_total", "vanilla_bytes_total"):
                assert getattr(t15, name)(tl, tcfg, tspec) == \
                    getattr(j15, name)(jl, jcfg, jspec), (c, pr, name)
            assert get_strategy("spmm_15d").step_bytes(tl, tcfg, tspec) == \
                j15.SPMM_15D.step_bytes(jl, jcfg, jspec)


def test_layout_refuses_what_jax_refuses():
    """``pr % c`` (``P % c**2``) fails with the JAX package's message."""
    jt, jps, tt, tps = _problem(3)
    with pytest.raises(jdist.StrategyCapabilityError) as je:
        j15.build_spmm15d_layout(jps, jt, JSpec(strategy="spmm_15d",
                                                replication=2))
    with pytest.raises(StrategyCapabilityError) as te:
        t15.build_spmm15d_layout(tps, tt, TrainSpec(strategy="spmm_15d",
                                                    replication=2))
    assert str(te.value) == str(je.value)
    assert "P % c**2" in str(te.value)


# --------------------------------------------------------- capabilities

REFUSALS = {
    "features-host": dict(features="host"),
    "pipeline": dict(pipeline=True),
    "cache-policy": dict(cache_policy="lru"),
    "refresh-every": dict(refresh_every=2),
    "backend-hybrid": dict(backend="hybrid"),
    "backend-ell": dict(backend="ell"),
    "faults": dict(faults="grad_nan@3"),
    "guard-every": dict(guard_every=2),
    "checksums": dict(checksums=True),
    "fetch-retries": dict(fetch_retries=1),
    "pallas-pack": dict(pallas_pack=True),
}


@pytest.mark.parametrize("refusal", list(REFUSALS))
def test_validate_spec_refuses_as_jax(refusal):
    """Each ``validate_spec`` refusal of ``spmm_15d`` raises when the spec
    is built, with the JAX package's message word for word."""
    kw = dict(strategy="spmm_15d", replication=2, **REFUSALS[refusal])
    with pytest.raises(jdist.StrategyCapabilityError) as je:
        JSpec(**kw)
    with pytest.raises(StrategyCapabilityError) as te:
        TrainSpec(**kw)
    assert str(te.value) == str(je.value)
    assert str(te.value).startswith("spmm_15d does not support")


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_model_refused_as_jax(model):
    """A model the 1.5D step functions do not implement fails with the
    JAX package's message, before any group is needed."""
    jl, tl = _layouts(2, 2)
    spec_kw = dict(strategy="spmm_15d", replication=2)
    with pytest.raises(jdist.StrategyCapabilityError) as je:
        j15.make_spmm15d_runtime(JConfig(**_cfg_kw(model)), jl, jadam(1e-2),
                                 JSpec(**spec_kw))
    with pytest.raises(StrategyCapabilityError) as te:
        t15.make_spmm15d_runtime(GNNConfig(**_cfg_kw(model)), tl, None,
                                 TrainSpec(**spec_kw), device="cpu")
    assert str(te.value) == str(je.value)


def test_registry_and_sim_refusal_as_jax():
    """``get_strategy("spmm_15d")`` is the singleton ``Spmm15DStrategy``,
    a ``DistStrategy`` with the JAX package's ``caps``; its sim runtime is
    refused with the JAX package's message."""
    from repro_torch.dist import DistStrategy
    s = get_strategy("spmm_15d")
    assert isinstance(s, t15.Spmm15DStrategy) and s is t15.SPMM_15D
    assert isinstance(s, DistStrategy)
    assert isinstance(get_strategy("halo_1d"), DistStrategy)
    for name in ("halo_1d", "spmm_15d"):
        assert vars(get_strategy(name).caps) == \
            vars(jdist.get_strategy(name).caps), name
    spec_kw = dict(strategy="spmm_15d", replication=2)
    with pytest.raises(jdist.StrategyCapabilityError) as je:
        jdist.get_strategy("spmm_15d").make_sim_runtime(
            None, None, None, JSpec(**spec_kw))
    with pytest.raises(StrategyCapabilityError) as te:
        s.make_sim_runtime(None, None, None, TrainSpec(**spec_kw))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="halo_1d, spmm_15d"):
        get_strategy("2d")


# ------------------------------------------------------------- numerics


def _each_replica(case_id):
    """``(rank result, block row)`` of every rank of the case."""
    c = CASES[case_id][0]
    return [(r, r["rank"] // c) for r in _ranks(case_id)]


@pytest.mark.parametrize("case_id", list(CASES))
def test_logits_match_oracle(case_id):
    c, pr, model, _, _ = CASES[case_id]
    ref = _oracle(pr, model)
    ranks = _ranks(case_id)
    assert len(ranks) == c * pr
    for r, i in _each_replica(case_id):
        v = ref["valid"][i]
        got = r["logits"]
        assert got.shape == ref["logits"][i].shape
        np.testing.assert_allclose(got[v], ref["logits"][i][v], rtol=0,
                                   atol=TOL, err_msg=f"rank {r['rank']}")


@pytest.mark.parametrize("case_id", list(CASES))
def test_sgd_step_gradients_match_oracle(case_id):
    """One ``sgd(1.0)`` step: the parameter delta is the gradient, so a
    c-fold (or c**2-fold) replication error in the cotangents shows."""
    _, pr, model, _, _ = CASES[case_id]
    ref = _oracle(pr, model)
    for r, _ in _each_replica(case_id):
        assert abs(r["sgd"]["loss"] - ref["loss"]) <= TOL
        for li, (got, want) in enumerate(zip(r["sgd"]["params"],
                                             ref["params"])):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(
                    got[k], want[k], rtol=0, atol=TOL,
                    err_msg=f"rank {r['rank']} layer {li} {k}")


@pytest.mark.parametrize("case_id", list(CASES))
def test_adam_trajectory_matches_oracle(case_id):
    """A 6-step ``adam`` run: the losses within 1e-5 of the oracle's, the
    same on every rank; the report's step counts; the parameters and the
    test evaluation replicated."""
    _, pr, model, _, _ = CASES[case_id]
    ref = _oracle(pr, model)
    ranks = _ranks(case_id)
    for r in ranks:
        tr = r["train"]
        np.testing.assert_allclose(tr["losses"], ref["losses"], rtol=0,
                                   atol=TOL)
        assert tr["losses"] == ranks[0]["train"]["losses"]
        assert (tr["refresh_steps"], tr["cached_steps"]) == (EPOCHS, 0)
        assert tr["test"] == ranks[0]["train"]["test"]
        for a, b in zip(tr["params"], ranks[0]["train"]["params"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("case_id", list(CASES))
def test_counted_bytes_equal_model(case_id):
    """Every rank's counted forward bytes, every step, equal
    ``forward_collective_bytes_per_device`` (the JAX package's model on
    the JAX layout); the report's bytes are ``step_bytes_total`` and
    ``vanilla_bytes_total`` a step."""
    c, pr, model, xl0, halo_dtype = CASES[case_id]
    jl, _ = _layouts(c, pr)
    jcfg, jspec = JConfig(**_cfg_kw(model)), _jax_spec(c, xl0, halo_dtype)
    want = j15.forward_collective_bytes_per_device(jl, jcfg, jspec)
    assert want > 0 or c == 1 and not xl0
    for r in _ranks(case_id):
        tr = r["train"]
        assert tr["model_bytes"] == want
        assert tr["forward_bytes"] == [want] * EPOCHS
        assert t15.counted_forward_bytes(r["sgd"]["counts"]) == want
        assert tr["comm_bytes"] == EPOCHS * j15.step_bytes_total(jl, jcfg,
                                                                 jspec)
        assert tr["comm_bytes_vanilla"] == EPOCHS * j15.vanilla_bytes_total(
            jl, jcfg, jspec)


@pytest.mark.parametrize("cid", list(BF16_CASES))
def test_bf16_wire_counts_two_bytes_and_tracks_f32(cid):
    """A bf16 wire: every permuted and gathered row counted at 2 bytes an
    entry (the all-reduce stays f32), the losses within 5e-3 of the f32
    run's."""
    (c, pr, model, xl0, halo_dtype), f32_cid = BF16_CASES[cid]
    jl, _ = _layouts(c, pr)
    want = j15.forward_collective_bytes_per_device(
        jl, JConfig(**_cfg_kw(model)), _jax_spec(c, xl0, halo_dtype))
    f32 = j15.forward_collective_bytes_per_device(
        jl, JConfig(**_cfg_kw(model)), _jax_spec(c, xl0, "f32"))
    assert want < f32
    f32_losses = _ranks(f32_cid)[0]["train"]["losses"]
    for r in _ranks(cid):
        assert r["train"]["forward_bytes"] == [want] * EPOCHS
        for key, cnt in r["sgd"]["counts"].items():
            if key[1] in ("permute", "all_gather"):
                d = 16 if key[0] else 12
                assert cnt["bytes"] == cnt["valid_rows"] * d * 2, key
        np.testing.assert_allclose(r["train"]["losses"], f32_losses,
                                   rtol=0, atol=BF16_LOSS_TOL)


# ------------------------------------------------------------------ CLI

_CLI = ["gnn", "--device", "cpu", "--scale", "0.005", "--feat-dim", "8",
        "--hidden", "8", "--strategy", "spmm_15d", "--parts", "4",
        "--replication", "2"]


def _jax_cli_bytes(argv) -> tuple:
    """The JAX package's ``run_gnn`` pipeline for the same flags, up to
    the layout: ``(fwd_collective_bytes_per_device, block_rows,
    group_size, inner_sizes)``."""
    from repro.core import (PAPER_GROUPS, capability_weights, do_partition,
                            make_group, RapaConfig)
    from repro.data import make_task
    args = ttrain.build_parser().parse_args(argv)
    spec = JSpec.from_cli_args(args)
    c, n_parts = spec.replication, args.parts // spec.replication
    task = make_task(args.dataset, scale=args.scale, feat_dim=args.feat_dim,
                     seed=args.seed)
    profiles = make_group(PAPER_GROUPS[f"x{n_parts}"])
    assign = jmetis(task.graph, n_parts, seed=args.seed,
                    weights=capability_weights(profiles))
    ps = jbuild(task.graph, assign, hops=1, parts=n_parts)
    ps = do_partition(ps, profiles,
                      RapaConfig(feat_dim=args.feat_dim)).partition_set
    cfg = JConfig(model=args.model, in_dim=task.features.shape[1],
                  hidden_dim=args.hidden, out_dim=task.num_classes,
                  num_layers=args.layers)
    layout = j15.build_spmm15d_layout(ps, task, spec)
    return (j15.forward_collective_bytes_per_device(layout, cfg, spec),
            layout.pr, layout.g, [pt.n_inner for pt in ps.parts])


def test_cli_spmm15d_prints_jax_keys(capsys):
    """``--strategy spmm_15d --parts 4 --replication 2`` on 4 gloo ranks:
    the JSON has the JAX package's keys, its byte figure, block rows,
    group size and inner sizes those of the JAX pipeline for the same
    flags, a finite falling loss and every step a refresh."""
    argv = _CLI + ["--epochs", "3"]
    out = ttrain.main(argv)
    assert json.loads(capsys.readouterr().out) == out
    assert set(JAX_KEYS) <= set(out)
    fwd, pr, g, inner = _jax_cli_bytes(argv)
    assert (out["fwd_collective_bytes_per_device"], out["block_rows"],
            out["group_size"], out["inner_sizes"]) == (fwd, pr, g, inner)
    assert out["comm_bytes"] == 3 * 4 * fwd
    assert (out["refresh_steps"], out["cached_steps"]) == (3, 0)
    assert np.isfinite(out["final_loss"]) and out["group"] == "x2"


@pytest.mark.parametrize("flags,match", [
    (["--parts", "6"], r"P % c\*\*2 == 0"),
    (["--features", "host"], "spmm_15d does not support features='host'"),
    (["--model", "sage"], "spmm_15d implements models"),
], ids=["parts", "features-host", "model-sage"])
def test_cli_spmm15d_exits_with_the_jax_message(flags, match):
    with pytest.raises(SystemExit, match=match):
        ttrain.main(_CLI + ["--epochs", "1"] + flags)


def test_cli_spmm15d_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    """Rank 0 saves ``--ckpt-dir``'s checkpoint; ``--resume`` loads it on
    every rank and trains the remaining epochs: 2 + 1 steps end where 3
    straight steps end."""
    monkeypatch.chdir(tmp_path)
    straight = ttrain.main(_CLI + ["--epochs", "3"])
    ttrain.main(_CLI + ["--epochs", "2", "--ckpt-dir", "ck"])
    resumed = ttrain.main(_CLI + ["--epochs", "3", "--ckpt-dir", "ck",
                                  "--resume"])
    capsys.readouterr()
    from repro_torch.checkpoint import latest_step
    assert resumed["resumed_from"] == 2 and latest_step("ck") == 3
    assert abs(resumed["final_loss"] - straight["final_loss"]) <= 1e-6


def test_cli_runs_the_ranks_on_the_requested_device(monkeypatch):
    """``--device cuda`` without CUDA raises before any rank starts; the
    backend is gloo on the CPU, NCCL with a card per rank, else gloo
    ranks sharing the cards."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, SystemExit)):
        ttrain.main([a if a != "cpu" else "cuda" for a in _CLI] +
                    ["--epochs", "1"])
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ttrain.spmm15d_backend(cpu, 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert ttrain.spmm15d_backend(cuda, 4) == "nccl"
    assert ttrain.spmm15d_backend(cuda, 8) == "gloo"


def test_from_cli_args_normalises_halo_knobs():
    """The CLI's halo-only defaults (pipelined refresh, ``--refresh-every
    4``) normalise away under ``spmm_15d``, as in the JAX package."""
    args = ttrain.build_parser().parse_args(_CLI)
    t = TrainSpec.from_cli_args(args).to_dict()
    j = JSpec.from_cli_args(argparse.Namespace(**vars(args))).to_dict()
    assert t == j
    assert (t["pipeline"], t["refresh_every"], t["exchange_layer0"]) == \
        (False, 1, False)
