"""The port's online cache adaptation against the JAX package's, on the
CPU (``tests/test_adaptive.py`` of the JAX package).

Held:

- the cache simulators (``plan_hit_rate``, ``simulate_policy_hit_rate``
  under every policy, ``comm_bytes_per_step``) and
  ``plan_from_membership`` equal the JAX package's on the same
  ``PartitionSet``, exactly;
- ``AdaptivePlanner``: every policy's re-plans (memberships, tiers and
  global ids), hit counts and ``shrink_capacity`` equal the JAX
  package's given the same observations; live FIFO/LRU eviction equals
  the trace simulator;
- ``train_capgnn`` with a planner (``lru`` and ``drift`` through
  pipelined transitions, ``lru`` through ``set_plan`` and a refresh,
  ``lru`` with host features): losses within 1e-5 of the JAX package's,
  ``replan_events``, ``hit_rate``, every byte count and the final
  memberships exactly equal;
- a swap between two plans padded to one capacity keeps every per-step
  tensor's shape and dtype (the port's "no retrace": the gathers'
  transposed maps follow the plans' valid ids and are the only tensors
  whose size may change); the plan-counted rows equal the valid rows of
  the maps each step consumed; a membership-preserving re-plan
  (``overlap``) is the static run bit for bit;
- ``graph.reorder`` equals the JAX package's.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dist as jdist
import repro.graph as jgraph
from repro.data.gnn_data import FullBatchTask as JTask, split_masks as jsplit
from repro.dist.spec import TrainSpec as JSpec
from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
from repro.optim import adam as jadam
import repro_torch.core as tcore
import repro_torch.graph as tgraph
from repro_torch.core import AdaptivePlanner, CacheCapacity, StalenessController
from repro_torch.data.gnn_data import FullBatchTask, split_masks
from repro_torch.dist import (TrainSpec, build_exchange_plan, exchange_arrays,
                              exchange_capacity, make_sim_runtime,
                              stack_partitions, train_capgnn)
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam
from torch_threads import torch_threads_per_worker  # noqa: F401

CPU = "cpu"
TOL = 1e-5
EPOCHS = 8
_CACHE: dict = {}


def _ps(graph, n, m, parts, seed):
    g = graph.rmat(n, m, seed=seed)
    assign = graph.random_partition(g, parts, seed=seed)
    for p in range(parts):       # every part non-empty
        assign[p % n] = p
    return graph.build_partition(g, assign, hops=1)


def _both_ps(n=80, m=400, parts=3, seed=4):
    return _ps(jgraph, n, m, parts, seed), _ps(tgraph, n, m, parts, seed)


def _plan_arrays(plan) -> list:
    out = [plan.global_gids, np.array(plan.refresh_every)]
    for w in plan.workers:
        out += [w.local_pos, w.global_pos, w.uncached_pos, w.local_gids,
                w.global_gids, w.uncached_gids]
    return out


def _assert_plans_equal(got, want):
    for a, b in zip(_plan_arrays(got), _plan_arrays(want), strict=True):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- simulators

@pytest.mark.parametrize("policy", ["overlap_high", "overlap_low", "random",
                                    "fifo", "lru"])
def test_simulate_policy_hit_rate_matches_jax(policy):
    jps, tps = _both_ps()
    for frac in (0.2, 0.6):
        k = max(1, int(frac * tps.halo_union().size))
        assert tcore.simulate_policy_hit_rate(tps, k, policy, layers=2,
                                              epochs=2, seed=3) == \
            jcore.simulate_policy_hit_rate(jps, k, policy, layers=2,
                                           epochs=2, seed=3)


@pytest.mark.parametrize("c_gpu,c_cpu,tau", [(0, 0, 1), (5, 12, 4),
                                             (40, 40, 2)])
def test_plan_hit_rate_and_comm_bytes_match_jax(c_gpu, c_cpu, tau):
    jps, tps = _both_ps()
    jplan = jcore.build_cache_plan(jps, jcore.CacheCapacity(
        c_gpu=[c_gpu] * 3, c_cpu=c_cpu), refresh_every=tau)
    tplan = tcore.build_cache_plan(tps, CacheCapacity(
        c_gpu=[c_gpu] * 3, c_cpu=c_cpu), refresh_every=tau)
    assert tcore.plan_hit_rate(tplan) == jcore.plan_hit_rate(jplan)
    for width in (4, 2):
        assert tcore.comm_bytes_per_step(tplan, 16, width) == \
            jcore.comm_bytes_per_step(jplan, 16, width)


def _random_membership(ps, cap, rng):
    """Arbitrary capacity-respecting tier membership."""
    local_sets = []
    for i, pt in enumerate(ps.parts):
        hi = min(cap.c_gpu[i], pt.n_halo)
        k = int(rng.integers(0, hi + 1))
        sel = rng.choice(pt.halo_nodes, size=k, replace=False) if k else []
        local_sets.append(set(int(v) for v in sel))
    union = ps.halo_union()
    kc = int(rng.integers(0, min(cap.c_cpu, union.size) + 1))
    glob = (set(int(v) for v in rng.choice(union, size=kc, replace=False))
            if kc else set())
    return local_sets, glob


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_from_membership_matches_jax(seed):
    jps, tps = _both_ps(70, 300, 4, seed)
    cap = dict(c_gpu=[9] * 4, c_cpu=14)
    loc, glob = _random_membership(tps, CacheCapacity(**cap),
                                   np.random.default_rng(seed))
    got = tcore.plan_from_membership(tps, loc, glob, CacheCapacity(**cap), 2)
    want = jcore.plan_from_membership(jps, loc, glob,
                                      jcore.CacheCapacity(**cap), 2)
    _assert_plans_equal(got, want)
    over = [set(range(100))] + loc[1:]
    with pytest.raises(ValueError, match="exceeds"):
        tcore.plan_from_membership(tps, over, glob, CacheCapacity(**cap), 2)


# ------------------------------------------------------------------ planner

@pytest.mark.parametrize("policy", tcore.ADAPTIVE_POLICIES)
def test_planner_replans_match_jax(policy):
    """The same observations (accesses and drift rows from one numpy
    seed) give the same re-plans, hit counts and counters."""
    jps, tps = _both_ps(90, 450, 3, seed=5)
    cap = dict(c_gpu=[6, 3, 9], c_cpu=11)
    jp = jcore.AdaptivePlanner(jps, jcore.CacheCapacity(**cap),
                               refresh_every=2, policy=policy, seed=2)
    tp = AdaptivePlanner(tps, CacheCapacity(**cap), refresh_every=2,
                         policy=policy, seed=2)
    rng = np.random.default_rng(0)
    for r in range(4):
        sub = [pt.halo_nodes[rng.random(pt.n_halo) < 0.7]
               for pt in tps.parts]
        for accessed in (None, sub):
            assert tp.observe_step(accessed, layers=2) == \
                jp.observe_step(accessed, layers=2)
        n_loc = max(w.local_gids.size for w in tp.plan.workers)
        loc_rows = rng.random((3, n_loc))
        gl_rows = rng.random(tp.plan.global_gids.size + 3)
        tp.observe_drift(loc_rows, gl_rows)
        jp.observe_drift(loc_rows, gl_rows)
        _assert_plans_equal(tp.replan(), jp.replan())
        assert tp.counters() == jp.counters()


@pytest.mark.parametrize("policy", ["static", "lru", "drift"])
def test_shrink_capacity_matches_jax(policy):
    jps, tps = _both_ps(90, 450, 3, seed=6)
    cap = dict(c_gpu=[8, 8, 8], c_cpu=16)
    jp = jcore.AdaptivePlanner(jps, jcore.CacheCapacity(**cap),
                               policy=policy)
    tp = AdaptivePlanner(tps, CacheCapacity(**cap), policy=policy)
    for pl in (jp, tp):
        pl.observe_step(layers=2)
        pl.shrink_capacity(0.5)
        pl.observe_step(layers=2)
    assert tp.capacity == CacheCapacity(c_gpu=[4, 4, 4], c_cpu=8)
    _assert_plans_equal(tp.replan(), jp.replan())
    with pytest.raises(ValueError, match="shrink factor"):
        tp.shrink_capacity(1.5)


@pytest.mark.parametrize("policy", ["fifo", "lru"])
@pytest.mark.parametrize("cap_frac", [0.3, 0.6, 0.9])
def test_live_eviction_matches_trace_simulator(policy, cap_frac):
    """The planner as a single shared cache (local tiers disabled)
    reproduces the trace simulator's hit sequence exactly on the epoch
    stream, the port's and the JAX package's."""
    jps, tps = _both_ps()
    k = max(1, int(cap_frac * tps.halo_union().size))
    pl = AdaptivePlanner(tps, CacheCapacity(c_gpu=[0] * 3, c_cpu=k),
                         policy=policy)
    for _ in range(4):
        pl.observe_step(layers=3)
    want = jcore.simulate_policy_hit_rate(jps, k, policy, layers=3,
                                          epochs=4)
    assert pl.hit_rate() == want
    assert tcore.simulate_policy_hit_rate(tps, k, policy, layers=3,
                                          epochs=4) == want


def test_planner_replan_respects_capacities_and_partitions_halo():
    _, tps = _both_ps(80, 400, 3, seed=5)
    cap = CacheCapacity(c_gpu=[6, 3, 9], c_cpu=11)
    for policy in ("lru", "fifo", "drift", "overlap"):
        pl = AdaptivePlanner(tps, cap, policy=policy)
        for _ in range(3):
            pl.observe_step(layers=2)
        plan = pl.replan()
        for i, (w, part) in enumerate(zip(plan.workers, tps.parts)):
            assert w.local_pos.size <= cap.c_gpu[i]
            pos = np.concatenate([w.local_pos, w.global_pos,
                                  w.uncached_pos])
            assert np.array_equal(np.sort(pos), np.arange(part.n_halo))
        assert plan.global_gids.size <= cap.c_cpu
        xa, xb = pl.exchange_plan(plan), pl.exchange_plan(pl._initial)
        assert xa.uncached.recv_valid.shape == xb.uncached.recv_valid.shape
        assert xa.glob.src_part.shape == xb.glob.src_part.shape
        assert xa.host.feat_pos.shape == xb.host.feat_pos.shape


# -------------------------------------------- train_capgnn with a planner

def _task(mods, seed=6, parts=3):
    rmat_, feats_, norm_, task_, split_, metis_, build_ = mods
    g = rmat_(200, 1000, seed=seed)
    feats, labels = feats_(g, 8, 4, seed=seed)
    gn = norm_(g)
    tr, va, te = split_(g.num_nodes, seed=seed)
    task = task_(graph=gn, features=feats, labels=labels, train_mask=tr,
                 val_mask=va, test_mask=te, num_classes=4)
    return task, build_(gn, metis_(gn, parts, seed=seed), hops=1)


def _setup(seed=7):
    key = ("setup", seed)
    if key not in _CACHE:
        jtask, jps = _task((jgraph.rmat, jgraph.synth_features,
                            jgraph.symmetric_normalize, JTask, jsplit,
                            jgraph.metis_partition, jgraph.build_partition),
                           seed)
        ttask, tps = _task((tgraph.rmat, tgraph.synth_features,
                            tgraph.symmetric_normalize, FullBatchTask,
                            split_masks, tgraph.metis_partition,
                            tgraph.build_partition), seed)
        max_halo = max(pt.n_halo for pt in tps.parts)
        cap = dict(c_gpu=[max(1, max_halo // 3)] * 3,
                   c_cpu=max(1, tps.halo_union().size // 4))
        kw = dict(model="gcn", in_dim=8, hidden_dim=8, out_dim=4,
                  num_layers=3)
        jparams = jinit(jax.random.PRNGKey(0), JConfig(**kw))
        _CACHE[key] = dict(
            jtask=jtask, jps=jps, ttask=ttask, tps=tps, cap=cap,
            jcfg=JConfig(**kw), tcfg=GNNConfig(**kw),
            params_np=[{k: np.asarray(v) for k, v in layer.items()}
                       for layer in jparams])
    return _CACHE[key]


TRAIN_CASES = {   # id: (policy, pipeline, features)
    "lru": ("lru", True, "device"),
    "drift": ("drift", True, "device"),
    "lru-set_plan": ("lru", False, "device"),
    "lru-host": ("lru", True, "host"),
}


def _train(case_id):
    key = ("train", case_id)
    if key in _CACHE:
        return _CACHE[key]
    b = _setup()
    policy, pipeline, features = TRAIN_CASES[case_id]
    kw = dict(pipeline=pipeline, refresh_every=2, features=features)
    tp = AdaptivePlanner(b["tps"], CacheCapacity(**b["cap"]),
                         refresh_every=2, policy=policy)
    tx = tp.exchange_plan()
    spec = TrainSpec(**kw)
    rt = make_sim_runtime(b["tcfg"], stack_partitions(b["tps"], b["ttask"]),
                          tx, adam(1e-2), spec=spec, device=CPU)
    params = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
              for layer in b["params_np"]]
    _, rep = train_capgnn(b["tcfg"], rt, tx, 3, adam(1e-2), epochs=EPOCHS,
                          controller=StalenessController(refresh_every=2),
                          params0=params, planner=tp, spec=spec)
    jp = jcore.AdaptivePlanner(b["jps"], jcore.CacheCapacity(**b["cap"]),
                               refresh_every=2, policy=policy)
    jx = jp.exchange_plan()
    jspec = JSpec(donate=False, **kw)
    jrt = jdist.make_sim_runtime(b["jcfg"], jdist.stack_partitions(
        b["jps"], b["jtask"]), jx, jadam(1e-2), spec=jspec)
    _, jrep = jdist.train_capgnn(
        b["jcfg"], jrt, jx, 3, jadam(1e-2), epochs=EPOCHS,
        controller=jcore.StalenessController(refresh_every=2),
        params0=jax.tree.map(jax.numpy.asarray, b["params_np"]),
        planner=jp, spec=jspec)
    _CACHE[key] = (rep, tp, jrep, jp)
    return _CACHE[key]


@pytest.mark.parametrize("case_id", list(TRAIN_CASES))
def test_train_adaptive_matches_jax(case_id):
    rep, tp, jrep, jp = _train(case_id)
    assert rep.replan_events >= 1
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=0, atol=TOL)
    for f in ("replan_events", "hit_rate", "comm_bytes",
              "comm_bytes_vanilla", "refresh_steps", "cached_steps",
              "host_fetch_rows", "host_fetch_bytes",
              "host_writeback_bytes"):
        assert getattr(rep, f) == getattr(jrep, f), f
    _assert_plans_equal(tp.plan, jp.plan)
    kind = "transition" if TRAIN_CASES[case_id][1] else "refresh"
    assert [k for k in rep.step_kinds if k == kind] and \
        len(rep.replan_ms) == rep.replan_events
    assert all(r["plan_ms"] > 0 and r["maps_ms"] > 0 for r in rep.replan_ms)


def test_adaptive_replans_change_the_tiers():
    """The ``lru`` run's re-plans install other memberships than the
    initial overlap plan (the swaps are not vacuous)."""
    _, tp, _, _ = _train("lru")
    before = [set(w.local_gids.tolist()) for w in tp._initial.workers]
    after = [set(w.local_gids.tolist()) for w in tp.plan.workers]
    assert before != after


# --------------------------------------------- slot-stable swaps, no retrace

def _tensors(tree, path=()):
    """Every tensor of a maps tree with its path, the gathers' transposed
    maps (``pack``) left out."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k != "pack":
                yield from _tensors(v, path + (k,))


@pytest.mark.parametrize("halo_dtype", [None, torch.bfloat16])
def test_swap_keeps_every_tensor_shape(halo_dtype):
    """Two rankings padded to one capacity: every index tensor of the
    exchange maps, the host tier's program included, has the same shape
    and dtype; only the transposed maps' entries follow the valid ids."""
    b = _setup()
    cap = CacheCapacity(**b["cap"])
    pad = exchange_capacity(b["tps"], cap)
    plans = [build_exchange_plan(b["tps"], tcore.build_cache_plan(
        b["tps"], cap, refresh_every=2, policy=pol, seed=3), pad_to=pad)
        for pol in ("overlap_high", "random")]
    maps = [dict(_tensors(exchange_arrays(x, 40, CPU, halo_dtype=halo_dtype,
                                          include_host=True)))
            for x in plans]
    assert maps[0].keys() == maps[1].keys()
    for k in maps[0]:
        assert maps[0][k].shape == maps[1][k].shape, k
        assert maps[0][k].dtype == maps[1][k].dtype, k
    assert any(not torch.equal(maps[0][k], maps[1][k]) for k in maps[0])


def test_host_swap_keeps_staged_shapes():
    """In host mode a swap between padded plans stages the same shapes:
    the host tier's fetch, ``l0loc``, the local caches."""
    b = _setup()
    cap = CacheCapacity(**b["cap"])
    tp = AdaptivePlanner(b["tps"], cap, refresh_every=2, policy="lru")
    x0 = tp.exchange_plan()
    rt = make_sim_runtime(b["tcfg"], stack_partitions(b["tps"], b["ttask"]),
                          x0, adam(1e-2), spec=TrainSpec(features="host"),
                          device=CPU)
    shapes = []
    for _ in range(2):
        st = rt._state
        shapes.append((st["l0loc"].shape, st["l0_ring"][0].array.shape,
                       st["xarr"]["host"]["feat_pos"].shape))
        tp.observe_step(layers=2)
        rt.set_plan(tp.exchange_plan(tp.replan()))
    assert shapes[0] == shapes[1]


def test_lru_replan_rows_exact():
    """Membership-churning LRU re-plans: plan-counted rows equal the valid
    rows of the maps each step consumed, across transitions."""
    b = _setup()
    cap = CacheCapacity(**b["cap"])
    planner = AdaptivePlanner(b["tps"], cap, refresh_every=2, policy="lru")
    xp = planner.exchange_plan()
    opt = adam(1e-2)
    rt = make_sim_runtime(b["tcfg"], stack_partitions(b["tps"], b["ttask"]),
                          xp, opt, spec=TrainSpec(), device=CPU)
    params = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
              for layer in b["params_np"]]
    state = (params, opt.init(params), rt.caches0)
    ctl = StalenessController(refresh_every=2)

    def rows(m, key):
        return int(m[key].sum())
    plan_rows = measured = 0
    for _ in range(8):
        refresh = ctl.should_refresh()
        x_read = rt.xplan
        if ctl.should_replan():
            x_next = planner.exchange_plan(planner.replan())
            xr = rt._state["xarr"]
            *state, m = rt.step_transition(*state, x_next)
            xe = rt._state["xarr"]
            plan_rows += (x_read.uncached.n_rows + x_next.local.n_rows
                          + x_next.glob.n_unique)
            measured += (rows(xr["un"], "recv_valid")
                         + rows(xe["loc"], "recv_valid")
                         + int((xe["gl"]["fill"]["pull"]["idx"] >= 0).sum()))
        else:
            fn = rt.step_refresh if refresh else rt.step_cached
            *state, m = fn(*state)
            xa = rt._state["xarr"]
            plan_rows += x_read.uncached.n_rows
            measured += rows(xa["un"], "recv_valid")
            if refresh:
                plan_rows += x_read.local.n_rows + x_read.glob.n_unique
                measured += (rows(xa["loc"], "recv_valid")
                             + int((xa["gl"]["fill"]["pull"]["idx"]
                                    >= 0).sum()))
        planner.observe_step(layers=2)
        ctl.observe(None, refreshed=refresh)
        assert np.isfinite(float(m["loss"]))
    assert plan_rows == measured


def test_overlap_replans_are_the_static_run():
    """A re-plan that keeps the membership (``overlap`` on a static graph)
    changes nothing: the losses and bytes of the static run, bit for
    bit."""
    b = _setup(seed=6)
    cap = tcore.cal_capacity(b["tps"], b["tcfg"].feat_dims,
                             [tcore.PROFILES["rtx3090"]] * 3,
                             m_cpu_gib=0.001)
    plan = tcore.build_cache_plan(b["tps"], cap, refresh_every=2)
    sp = stack_partitions(b["tps"], b["ttask"])
    params = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
              for layer in b["params_np"]]
    reps = []
    for adaptive in (False, True):
        planner = (AdaptivePlanner(b["tps"], cap, refresh_every=2,
                                   policy="overlap") if adaptive else None)
        xp = (planner.exchange_plan(plan) if adaptive
              else build_exchange_plan(b["tps"], plan))
        spec = TrainSpec(pipeline=True, refresh_every=2)
        rt = make_sim_runtime(b["tcfg"], sp, xp, adam(1e-2), spec=spec,
                              device=CPU)
        reps.append(train_capgnn(b["tcfg"], rt, xp, 3, adam(1e-2),
                                 epochs=EPOCHS, params0=params,
                                 planner=planner, spec=spec)[1])
    assert reps[1].replan_events > 0
    assert reps[1].losses == reps[0].losses
    assert reps[1].comm_bytes == reps[0].comm_bytes


# ------------------------------------------------------------------ reorder

@pytest.mark.parametrize("seed", [0, 1])
def test_reorder_matches_jax(seed):
    jps, tps = _both_ps(60, 260, 2, seed)
    np.testing.assert_array_equal(tgraph.bfs_order(tps.graph),
                                  jgraph.bfs_order(jps.graph))
    for jpt, tpt in zip(jps.parts, tps.parts):
        pri = np.random.default_rng(seed).random(tpt.n_halo)
        tg, tperm = tgraph.reorder_partition_arrays(tpt.local_graph,
                                                    tpt.n_inner, pri)
        jg, jperm = jgraph.reorder_partition_arrays(jpt.local_graph,
                                                    jpt.n_inner, pri)
        np.testing.assert_array_equal(tperm, jperm)
        for a, b in ((tg.indptr, jg.indptr), (tg.indices, jg.indices)):
            np.testing.assert_array_equal(a, b)
