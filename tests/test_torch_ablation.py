"""The port's training runtime under the ablation plans, against the JAX
package's ``capgnn_sim`` on the CPU, with the JAX parameters handed
across (``params_from_reference``).

Flickr at scale 0.02, 32 features, GCN 32 -> 32 -> 32 -> 7, the
profile-weighted METIS partition of the x4 group and RAPA, ``hybrid``
backend, 8 epochs of ``adam``:

- ``vanilla``: the zero-capacity plan (``CacheCapacity(c_gpu=[0] * P,
  c_cpu=0)``: the local and global tiers empty, every halo row in the
  uncached tier), a refresh every step, no pipeline, layer 0 exchanged
  (the CLI's ``--no-jaca --no-pipeline --refresh-every 1``);
- ``adaptive``: JACA's plan under ``StalenessController(adaptive=True)``
  with the pipeline: the period follows each refresh's measured drift.

Held: losses within 1e-5, parameters within 1e-4 / 1e-5, the step kinds
and the measured drifts (both runs traced) equal, and ``comm_bytes``,
``comm_bytes_vanilla``, ``refresh_steps`` and ``cached_steps`` exactly
equal; Vanilla's reduction is exactly 0.0.
"""
import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.data as jdata
import repro.dist as jdist
import repro.graph as jgraph
from repro.dist.spec import TrainSpec as JSpec
from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
from repro.obs import Tracer as JTracer
from repro.optim import adam as jadam
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.graph as tgraph
from repro_torch.convert import params_from_reference
from repro_torch.dist import (TrainSpec, build_exchange_plan, make_sim_runtime,
                              stack_partitions, train_capgnn)
from repro_torch.models.gnn import GNNConfig
from repro_torch.obs import Tracer
from repro_torch.optim import adam
from torch_threads import torch_threads_per_worker  # noqa: F401

P = 4
EPOCHS = 8
LOSS_TOL = 1e-5
# plan -> (zero capacity, refresh_every, pipeline, layer 0 exchanged,
# adaptive staleness)
PLANS = {"vanilla": (True, 1, False, True, False),
         "adaptive": (False, 4, True, False, True)}
_CACHE: dict = {}


def _np_params(jparams):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams]


def _pipe():
    """Both packages' task, RAPA-balanced partition and the x4 profiles;
    the JAX parameters."""
    if "pipe" not in _CACHE:
        out = {}
        for name, core, data, graph in (("jax", jcore, jdata, jgraph),
                                        ("torch", tcore, tdata, tgraph)):
            prof = core.make_group(core.PAPER_GROUPS["x4"])
            task = data.make_task("flickr", scale=0.02, feat_dim=32, seed=0)
            assign = graph.metis_partition(
                task.graph, P, seed=0, weights=core.capability_weights(prof))
            ps = graph.build_partition(task.graph, assign, hops=1, parts=P)
            ps = core.do_partition(ps, prof,
                                   core.RapaConfig(feat_dim=32)).partition_set
            out[name] = dict(task=task, ps=ps, profiles=prof)
        kw = dict(model="gcn", in_dim=32, hidden_dim=32,
                  out_dim=out["jax"]["task"].num_classes, num_layers=3)
        out["jcfg"], out["tcfg"] = JConfig(**kw), GNNConfig(**kw)
        out["jparams"] = jinit(jax.random.PRNGKey(0), out["jcfg"])
        _CACHE["pipe"] = out
    return _CACHE["pipe"]


def _xplan(core, build, side, zero, refresh_every, dims):
    ps = side["ps"]
    cap = (core.CacheCapacity(c_gpu=[0] * P, c_cpu=0) if zero else
           core.cal_capacity(ps, dims, side["profiles"]))
    return build(ps, core.build_cache_plan(ps, cap,
                                           refresh_every=refresh_every))


def _run(plan):
    """One 8-epoch ``train_capgnn`` of the plan in each package from the
    JAX parameters, both traced (the kinds and drifts of every step)."""
    if plan in _CACHE:
        return _CACHE[plan]
    pipe = _pipe()
    zero, every, pipeline, layer0, adaptive = PLANS[plan]
    dims = pipe["tcfg"].feat_dims
    jx = _xplan(jcore, jdist.build_exchange_plan, pipe["jax"], zero, every,
                dims)
    tx = _xplan(tcore, build_exchange_plan, pipe["torch"], zero, every, dims)
    kw = dict(strategy="halo_1d", backend="hybrid", halo_dtype="f32",
              pipeline=pipeline, refresh_every=every,
              exchange_layer0=layer0, donate=False)
    jspec, tspec = JSpec(**kw), TrainSpec(**kw)
    jsp = jdist.stack_partitions(pipe["jax"]["ps"], pipe["jax"]["task"],
                                 backend="hybrid")
    tsp = stack_partitions(pipe["torch"]["ps"], pipe["torch"]["task"],
                           backend="hybrid")
    jrt = jdist.make_sim_runtime(pipe["jcfg"], jsp, jx, jadam(1e-2),
                                 spec=jspec)
    jtr = JTracer()
    jp, jrep = jdist.train_capgnn(
        pipe["jcfg"], jrt, jx, P, jadam(1e-2), epochs=EPOCHS, spec=jspec,
        params0=pipe["jparams"], tracer=jtr,
        controller=jcore.StalenessController(refresh_every=every,
                                             adaptive=adaptive))
    trt = make_sim_runtime(pipe["tcfg"], tsp, tx, adam(1e-2), spec=tspec,
                           device="cpu")
    ttr = Tracer()
    tp, trep = train_capgnn(
        pipe["tcfg"], trt, tx, P, adam(1e-2), epochs=EPOCHS, spec=tspec,
        params0=params_from_reference(_np_params(pipe["jparams"]),
                                      device="cpu"), tracer=ttr,
        controller=tcore.StalenessController(refresh_every=every,
                                             adaptive=adaptive))
    _CACHE[plan] = dict(jx=jx, tx=tx, jp=jp, jrep=jrep, jtr=jtr, tp=tp,
                        trep=trep, ttr=ttr)
    return _CACHE[plan]


def test_zero_capacity_plan_leaves_only_the_uncached_tier():
    r = _run("vanilla")
    for x in (r["jx"], r["tx"]):
        assert x.local.n_rows == 0 and x.glob.n_unique == 0
        assert x.uncached.n_rows == x.total_halo > 0
    assert r["tx"].total_halo == r["jx"].total_halo


@pytest.mark.parametrize("plan", list(PLANS))
def test_losses_and_parameters_match(plan):
    r = _run(plan)
    np.testing.assert_allclose(r["trep"].losses, r["jrep"].losses, rtol=0,
                               atol=LOSS_TOL)
    assert r["trep"].losses[-1] < r["trep"].losses[0]
    for a, b in zip(_np_params(r["jp"]), r["tp"]):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("plan", list(PLANS))
def test_step_kinds_drifts_and_bytes_equal(plan):
    r = _run(plan)
    jkinds = [c.kind for c in r["jtr"].counters]
    assert r["trep"].step_kinds == jkinds
    assert [c.kind for c in r["ttr"].counters] == jkinds
    for jc, tc in zip(r["jtr"].counters, r["ttr"].counters):
        assert (jc.drift is None) == (tc.drift is None)
        if jc.drift is not None:
            assert abs(tc.drift - jc.drift) < LOSS_TOL
    for f in ("comm_bytes", "comm_bytes_vanilla", "comm_reduction",
              "refresh_steps", "cached_steps"):
        assert getattr(r["trep"], f) == getattr(r["jrep"], f), f
    assert r["trep"].spec == r["jrep"].spec
    if plan == "vanilla":
        assert jkinds == ["refresh"] * EPOCHS
        assert r["trep"].comm_reduction == 0.0
    else:
        # the period moved off the fixed schedule's
        assert jkinds != ["refresh", "cached", "cached", "cached",
                          "pipelined", "cached", "cached", "cached"]
