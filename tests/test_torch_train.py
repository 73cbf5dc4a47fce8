"""The port's training slice against the JAX package's, on the CPU.

Parameters come from the JAX package's ``init_gnn`` and are carried across
with ``params_from_reference``.  Held:

- one ``sgd(1.0)`` and one ``adam`` update within 1e-6;
- ``StalenessController`` schedules, RAPA's ``do_partition`` outputs and
  ``TrainSpec.to_dict()`` exactly equal;
- refresh-every-step partitioned logits equal the full-graph logits
  within 1e-5 (the anchor of ``tests/test_system.py``);
- ``train_capgnn``'s 8-epoch loss trajectories within 1e-5 for the
  edges, ell and hybrid backends, for the bf16 halo wire, with ``adam``
  and with ``sgd`` (the ell/hybrid kernels run in interpret mode on the
  JAX side, their plain versions on the port's), under a forced-capacity
  plan whose uncached and global tiers are not empty; ``comm_bytes``,
  ``comm_bytes_vanilla``, ``refresh_steps`` and ``cached_steps`` exactly
  equal;
- the CLI's JSON report equal in every count.
"""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro.dist as jdist
import repro.graph as jgraph
from repro.dist.spec import TrainSpec as JSpec
from repro.launch import train as jlaunch
from repro.models.gnn import (GNNConfig as JConfig, gnn_forward as jforward,
                              init_gnn as jinit, make_local_adj)
from repro.optim import adam as jadam, adamw as jadamw, sgd as jsgd
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.graph as tgraph
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.dist import (TrainSpec, build_exchange_plan, make_sim_runtime,
                              stack_partitions, train_capgnn)
from repro_torch.launch import train as tlaunch
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam, adamw, sgd
from torch_threads import torch_threads_per_worker  # noqa: F401

P = 4
EPOCHS = 8
LOSS_TOL = 1e-5      # f32 losses, port (plain torch) vs JAX (XLA / interpret)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
_CACHE: dict = {}


def _np_params(jparams):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams]


@pytest.fixture(scope="module")
def pipe():
    """flickr at scale 0.02, 32 features, the profile-weighted METIS
    partition of ``launch.train`` and RAPA, in both packages."""
    profiles_j = jcore.make_group(jcore.PAPER_GROUPS["x4"])
    profiles_t = tcore.make_group(tcore.PAPER_GROUPS["x4"])
    out = {}
    for name, core, data, graph, prof in (
            ("jax", jcore, jdata, jgraph, profiles_j),
            ("torch", tcore, tdata, tgraph, profiles_t)):
        task = data.make_task("flickr", scale=0.02, feat_dim=32, seed=0)
        g = task.graph
        assign = graph.metis_partition(g, P, seed=0,
                                       weights=core.capability_weights(prof))
        ps = graph.build_partition(g, assign, hops=1, parts=P)
        res = core.do_partition(ps, prof, core.RapaConfig(feat_dim=32))
        out[name] = dict(task=task, ps0=ps, ps=res.partition_set, rapa=res)
    kw = dict(model="gcn", in_dim=32, hidden_dim=32,
              out_dim=out["jax"]["task"].num_classes, num_layers=3)
    out["jcfg"], out["tcfg"] = JConfig(**kw), GNNConfig(**kw)
    out["jparams"] = jinit(jax.random.PRNGKey(0), out["jcfg"])
    return out


def _plans(pipe, refresh_every=4):
    """Forced-capacity plans (every tier non-empty) in both packages."""
    key = ("plans", refresh_every)
    if key not in _CACHE:
        jps, tps = pipe["jax"]["ps"], pipe["torch"]["ps"]
        jplan = jcore.build_cache_plan(
            jps, jcore.CacheCapacity(c_gpu=[10] * P, c_cpu=25),
            refresh_every=refresh_every)
        tplan = tcore.build_cache_plan(
            tps, tcore.CacheCapacity(c_gpu=[10] * P, c_cpu=25),
            refresh_every=refresh_every)
        _CACHE[key] = (jdist.build_exchange_plan(jps, jplan),
                       build_exchange_plan(tps, tplan))
    return _CACHE[key]


def _stacked(pipe, backend):
    key = ("sp", backend)
    if key not in _CACHE:
        _CACHE[key] = (
            jdist.stack_partitions(pipe["jax"]["ps"], pipe["jax"]["task"],
                                   backend=backend),
            stack_partitions(pipe["torch"]["ps"], pipe["torch"]["task"],
                             backend=backend))
    return _CACHE[key]


# ---------------------------------------------------------------------------
# optimizers, schedule, RAPA, spec
# ---------------------------------------------------------------------------

def _tree(rng):
    return [{"w": rng.normal(size=(6, 5)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)},
            {"w": rng.normal(size=(5, 3)).astype(np.float32),
             "b": rng.normal(size=(3,)).astype(np.float32)}]


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizer_steps_match(name):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng)
    make_j, make_t = {"sgd": (lambda: jsgd(1.0), lambda: sgd(1.0)),
                      "adam": (lambda: jadam(1e-2), lambda: adam(1e-2)),
                      "adamw": (lambda: jadamw(1e-2), lambda: adamw(1e-2))
                      }[name]
    jo, to = make_j(), make_t()
    jp = jax.tree.map(jax.numpy.asarray, params)
    js = jo.init(jp)
    tp = params_from_reference(params, device="cpu")
    ts = to.init(tp)
    for step in range(3):
        jg = jax.tree.map(jax.numpy.asarray, grads)
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(params_from_reference(grads, device="cpu"), ts,
                           tp)
        for a, b in zip(_np_params(jp), tp):
            for k in a:
                np.testing.assert_allclose(b[k].numpy(), a[k], **OPT_TOL)
        grads = _tree(rng)
    # the reference's state carries across and continues identically
    ts2 = opt_state_from_reference(js, device="cpu")
    tp2, _ = to.update(params_from_reference(grads, device="cpu"), ts2,
                       params_from_reference(_np_params(jp), device="cpu"))
    jp2, _ = jo.update(jax.tree.map(jax.numpy.asarray, grads), js, jp)
    for a, b in zip(_np_params(jp2), tp2):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k], **OPT_TOL)


def test_clip_by_global_norm_matches():
    from repro.optim import clip_by_global_norm as jclip
    from repro_torch.optim import clip_by_global_norm as tclip
    grads = _tree(np.random.default_rng(2))
    jg, jn = jclip(jax.tree.map(jax.numpy.asarray, grads), 1.5)
    tg, tn = tclip(params_from_reference(grads, device="cpu"), 1.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(_np_params(jg), tg):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k], **OPT_TOL)


@pytest.mark.parametrize("kw", [dict(refresh_every=4),
                                dict(refresh_every=3, replan_every=2),
                                dict(refresh_every=4, adaptive=True,
                                     eps_h=0.5)])
def test_staleness_schedules_equal(kw):
    from repro.core import StalenessController as JCtl
    from repro_torch.core import StalenessController as TCtl
    jc, tc = JCtl(**kw), TCtl(**kw)
    drifts = np.random.default_rng(3).uniform(0.0, 1.0, 40)
    for d in drifts:
        assert (jc.should_refresh(), jc.should_replan(), jc.period) == \
            (tc.should_refresh(), tc.should_replan(), tc.period)
        jc.observe(float(d))
        tc.observe(float(d))
    assert jc.step == tc.step
    assert tcore.theorem1_bound(2.0, 0.3, 0.1, 50) == \
        jcore.theorem1_bound(2.0, 0.3, 0.1, 50)


def test_rapa_outputs_equal(pipe):
    jr, tr = pipe["jax"]["rapa"], pipe["torch"]["rapa"]
    for a, b in zip(jr.partition_set.parts, tr.partition_set.parts):
        np.testing.assert_array_equal(a.inner_nodes, b.inner_nodes)
        np.testing.assert_array_equal(a.halo_nodes, b.halo_nodes)
        np.testing.assert_array_equal(a.local_graph.indptr,
                                      b.local_graph.indptr)
        np.testing.assert_array_equal(a.local_graph.indices,
                                      b.local_graph.indices)
    assert tr.removed_per_part == jr.removed_per_part
    np.testing.assert_array_equal(tr.lambda_final, jr.lambda_final)
    assert len(tr.history) == len(jr.history)
    for a, b in zip(jr.history, tr.history):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    np.testing.assert_array_equal(
        tcore.capability_weights(tcore.make_group(tcore.PAPER_GROUPS["x4"])),
        jcore.capability_weights(jcore.make_group(jcore.PAPER_GROUPS["x4"])))


def _cli_namespace(argv):
    return tlaunch.build_parser().parse_args(["gnn", "--device", "cpu",
                                              *argv])


@pytest.mark.parametrize("argv", [[], ["--no-jaca", "--no-pipeline"],
                                  ["--backend", "hybrid", "--halo-dtype",
                                   "bf16", "--refresh-every", "2"]])
def test_train_spec_dicts_equal(argv):
    args = _cli_namespace(argv)
    assert TrainSpec.from_cli_args(args).to_dict() == \
        JSpec.from_cli_args(args).to_dict()


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

def test_refresh_every_step_equals_full_graph(pipe):
    """Partitioned forward with every tier fresh == the full-graph GCN,
    on the partition before RAPA (whose pruned halos drop edges)."""
    tps, task = pipe["torch"]["ps0"], pipe["torch"]["task"]
    plan = tcore.build_cache_plan(
        tps, tcore.CacheCapacity(c_gpu=[10] * P, c_cpu=25), refresh_every=1)
    tx = build_exchange_plan(tps, plan)
    tsp = stack_partitions(tps, task, backend="hybrid")
    spec = TrainSpec(backend="hybrid", refresh_every=1)
    rt = make_sim_runtime(pipe["tcfg"], tsp, tx, adam(1e-2), spec=spec,
                          device="cpu")
    params = params_from_reference(_np_params(pipe["jparams"]), device="cpu")
    logits_p = rt.forward_fresh(params).numpy()
    adj = make_local_adj(task.graph, task.graph.num_nodes, backend="edges")
    logits_f = np.asarray(jforward(pipe["jcfg"], pipe["jparams"], adj,
                                   jax.numpy.asarray(task.features), None))
    for i, part in enumerate(tps.parts):
        np.testing.assert_allclose(logits_p[i, : part.n_inner],
                                   logits_f[part.inner_nodes],
                                   rtol=1e-5, atol=1e-5)


RUNS = {   # id: (backend, halo dtype, optimizer)
    "edges-adam": ("edges", "f32", "adam"),
    "ell-adam": ("ell", "f32", "adam"),
    "hybrid-adam": ("hybrid", "f32", "adam"),
    "hybrid-bf16-adam": ("hybrid", "bf16", "adam"),
    "hybrid-sgd": ("hybrid", "f32", "sgd"),
}


def _train(pipe, run_id):
    """One 8-epoch ``train_capgnn`` run in each package from the same
    parameters, pipelined refreshes every 4 epochs (refresh, 3 cached,
    pipelined, 3 cached)."""
    if ("train", run_id) in _CACHE:
        return _CACHE[("train", run_id)]
    backend, halo_dtype, opt_name = RUNS[run_id]
    jx, tx = _plans(pipe)
    jsp, tsp = _stacked(pipe, backend)
    jopt, topt = ((jadam(1e-2), adam(1e-2)) if opt_name == "adam"
                  else (jsgd(0.5), sgd(0.5)))
    kw = dict(strategy="halo_1d", backend=backend, halo_dtype=halo_dtype,
              pipeline=True, refresh_every=4, exchange_layer0=False,
              donate=False)
    jspec, tspec = JSpec(**kw), TrainSpec(**kw)
    jrt = jdist.make_sim_runtime(pipe["jcfg"], jsp, jx, jopt, spec=jspec)
    jp, jrep = jdist.train_capgnn(pipe["jcfg"], jrt, jx, P, jopt,
                                  epochs=EPOCHS, spec=jspec,
                                  params0=pipe["jparams"])
    trt = make_sim_runtime(pipe["tcfg"], tsp, tx, topt, spec=tspec,
                           device="cpu")
    tp, trep = train_capgnn(
        pipe["tcfg"], trt, tx, P, topt, epochs=EPOCHS, spec=tspec,
        params0=params_from_reference(_np_params(pipe["jparams"]),
                                      device="cpu"))
    _CACHE[("train", run_id)] = (jp, jrep, jrt, tp, trep, trt)
    return _CACHE[("train", run_id)]


@pytest.mark.parametrize("run_id", list(RUNS))
def test_train_trajectories_match(pipe, run_id):
    jp, jrep, jrt, tp, trep, trt = _train(pipe, run_id)
    assert trep.step_kinds == ["refresh"] + ["cached"] * 3 + \
        ["pipelined"] + ["cached"] * 3
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=0,
                               atol=LOSS_TOL)
    assert trep.losses[-1] < trep.losses[0]
    for a, b in zip(_np_params(jp), tp):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k], rtol=1e-4,
                                       atol=1e-5)
    jl, ja = jrt.evaluate(jp, "test")
    tl, ta = trt.evaluate(tp, "test")
    assert abs(tl - jl) < LOSS_TOL and abs(ta - ja) < 1e-6


@pytest.mark.parametrize("run_id", ["hybrid-adam", "hybrid-bf16-adam"])
def test_train_counts_exactly_equal(pipe, run_id):
    _, jrep, _, _, trep, trt = _train(pipe, run_id)
    jx, tx = _plans(pipe)
    assert tx.uncached.n_rows > 0 and tx.glob.n_unique > 0 \
        and tx.local.n_rows > 0, "the forced plan fills every tier"
    for f in ("comm_bytes", "comm_bytes_vanilla", "comm_reduction",
              "refresh_steps", "cached_steps", "host_fetch_rows",
              "replan_events"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.spec == jrep.spec
    # layer 0 is not exchanged (exchange_layer0=False): the hidden widths
    assert trt.comm_dims == [32, 32]


def test_step_transition_and_set_plan(pipe):
    """The plan-switch plumbing matches the reference's: a transition
    step reads the installed plan and emits the next plan's rows, and a
    cached step on the new plan reads them."""
    *_, jrt, _, _, trt = _train(pipe, "hybrid-sgd")
    jx, tx = _plans(pipe)
    jx1, tx1 = _plans(pipe, refresh_every=1)
    jopt, topt = jsgd(0.5), sgd(0.5)
    jparams = pipe["jparams"]
    tparams = params_from_reference(_np_params(jparams), device="cpu")
    jc = jdist.init_caches(pipe["jcfg"], jx, P)
    tc = trt.caches0
    jparams, js, jc, _ = jrt.step_refresh(jparams, jopt.init(jparams), jc)
    tparams, ts, tc, _ = trt.step_refresh(tparams, topt.init(tparams), tc)
    jparams, js, jc, jm = jrt.step_transition(jparams, js, jc, jx1)
    tparams, ts, tc, tm = trt.step_transition(tparams, ts, tc, tx1)
    assert trt.xplan is tx1
    assert abs(float(tm["loss"]) - float(jm["loss"])) < LOSS_TOL
    for a, b in zip(jc["local"] + jc["global"], tc["local"] + tc["global"]):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    _, _, _, jm = jrt.step_cached(jparams, js, jc)
    _, _, _, tm = trt.step_cached(tparams, ts, tc)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < LOSS_TOL
    jrt.set_plan(jx)
    trt.set_plan(tx)
    assert trt.xplan is tx


def test_halo_1d_strategy_is_the_runtime(pipe):
    """Building and training through ``Halo1DStrategy`` equals calling
    the runtime directly; its modeled refresh bytes equal the JAX
    package's."""
    from repro.dist.strategy import get_strategy as jget
    from repro_torch.dist import get_strategy
    tps, task = pipe["torch"]["ps"], pipe["torch"]["task"]
    plan = tcore.build_cache_plan(
        tps, tcore.CacheCapacity(c_gpu=[10] * P, c_cpu=25), refresh_every=2)
    spec = TrainSpec(backend="hybrid", refresh_every=2, pipeline=True)
    strat = get_strategy("halo_1d")
    layout = strat.build_layout(tps, task, spec, plan=plan)
    params0 = params_from_reference(_np_params(pipe["jparams"]), device="cpu")
    rt = strat.make_sim_runtime(pipe["tcfg"], layout, sgd(0.5), spec,
                                device="cpu")
    _, via = strat.train(pipe["tcfg"], rt, layout, sgd(0.5), spec, epochs=3,
                         params0=params0)
    rt2 = make_sim_runtime(pipe["tcfg"], layout.sp, layout.xplan, sgd(0.5),
                           spec=spec, device="cpu")
    _, direct = train_capgnn(pipe["tcfg"], rt2, layout.xplan, P, sgd(0.5),
                             epochs=3, params0=params0, spec=spec)
    assert via.losses == direct.losses
    assert via.comm_bytes == direct.comm_bytes
    jplan = jcore.build_cache_plan(
        pipe["jax"]["ps"], jcore.CacheCapacity(c_gpu=[10] * P, c_cpu=25),
        refresh_every=2)
    jspec = JSpec(backend="hybrid", refresh_every=2, pipeline=True)
    jlayout = jget("halo_1d").build_layout(pipe["jax"]["ps"],
                                           pipe["jax"]["task"], jspec,
                                           plan=jplan)
    assert strat.step_bytes(layout, pipe["tcfg"], spec) == \
        jget("halo_1d").step_bytes(jlayout, pipe["jcfg"], jspec)


def test_cli_reports_match(capsys):
    """``launch.train gnn`` of both packages on the same flags: every
    count equal, losses within the tolerance."""
    argv = ["--scale", "0.02", "--feat-dim", "16", "--hidden", "16",
            "--epochs", "5", "--backend", "hybrid", "--refresh-every", "2"]
    jargs = argparse.Namespace(**{**vars(_cli_namespace(argv)),
                                  "cmd": "gnn"})
    del jargs.device
    want = jlaunch.run_gnn(jargs)
    capsys.readouterr()
    got = tlaunch.main(["gnn", "--device", "cpu", *argv])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(got))
    assert set(got) == set(want)
    for k in ("dataset", "model", "parts", "strategy", "replication", "group",
              "uneven", "inner_sizes", "stack_waste_frac", "epochs",
              "resumed_from", "halo_dtype", "features", "prefetch_depth",
              "host_fetch_rows", "host_fetch_bytes", "host_writeback_bytes",
              "cache_policy", "replan_events", "planner_hit_rate",
              "comm_bytes", "comm_reduction_vs_vanilla", "refresh_steps",
              "cached_steps"):
        assert got[k] == want[k], k
    # different initial parameters (torch.Generator vs jax.random): the
    # losses agree only in kind
    assert np.isfinite(got["final_loss"]) and 0.0 <= got["test_acc"] <= 1.0
