"""The port's host feature store and ``features="host"`` runtime against
the JAX package's, on the CPU (``tests/test_host_store.py`` of the JAX
package, and its ``host_parity_script.py`` graph).

The graph: rmat 360 / 2,200, GCN 12 -> 16 -> 16 -> 5, 4 METIS parts, a
forced-capacity plan (``c_gpu`` 8 rows a worker, ``c_cpu`` 30,
``refresh_every`` 3) that puts rows in every tier, so the host tier and
the global buffers are not empty.  Parameters come from the JAX package's
``init_gnn`` and are carried across as numpy.  Held:

- the store: staging masks invalid rows and accounts on consumption, the
  sync path, bf16 staging (bit-equal to the JAX package's cast, half the
  bytes), the global buffer's round trip, ``suggest_prefetch_depth``,
  ``measure_profile``'s fields; each against the JAX package's store;
- the runtime's ring: ``prefetch_depth - 1`` fetches in flight, flushed
  unaccounted by a plan install;
- port host mode against JAX ``capgnn_sim`` host mode through refresh,
  cached and pipelined ``sgd(1.0)`` steps under ``edges``, ``hybrid`` and
  a bf16 wire: logits, losses and parameters within 1e-5 (bf16 5e-3, the
  bound the JAX package holds host bf16 to), every host fetch and
  writeback count exactly equal, and equal to the plan's;
- port host mode equal to port device mode bit for bit in f32 (bf16:
  within 5e-3, device mode reading the layer-0 local tier from the f32
  table), also through re-plans (``set_plan``, ``step_transition``) on
  ragged partitions, with the fetched rows equal to the plan's count.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dist as jdist
from repro.core.device_profile import measure_profile as jmeasure
from repro.data.gnn_data import FullBatchTask as JTask, split_masks as jsplit
from repro.dist.host_store import (HostFeatureStore as JStore,
                                   suggest_prefetch_depth as jsuggest)
from repro.dist.spec import TrainSpec as JSpec
from repro.graph import (build_partition as jbuild, metis_partition as jmetis,
                         rmat as jrmat, symmetric_normalize as jnorm,
                         synth_features as jfeats)
from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
from repro.optim import sgd as jsgd
import repro_torch.core as tcore
from repro_torch.core.device_profile import measure_profile
from repro_torch.data.gnn_data import FullBatchTask, split_masks
from repro_torch.dist import (TrainSpec, build_exchange_plan, make_sim_runtime,
                              stack_partitions, train_capgnn)
from repro_torch.dist.host_store import (HostFeatureStore,
                                         suggest_prefetch_depth)
from repro_torch.graph import (build_partition, metis_partition, rmat,
                               symmetric_normalize, synth_features)
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import sgd
from torch_threads import torch_threads_per_worker  # noqa: F401

CPU = "cpu"
P = 4
TOL = 1e-5
BF16_TOL = 5e-3
SCHEDULE = ("refresh", "cached", "cached", "pipelined", "cached", "cached")
CASES = {"edges": ("edges", "f32"), "hybrid": ("hybrid", "f32"),
         "bf16": ("edges", "bf16")}
_CACHE: dict = {}


def _graph(mods):
    rmat_, feats_, norm_, task_, split_, metis_, build_ = mods
    g = rmat_(360, 2200, seed=3)
    feats, labels = feats_(g, 12, 5, seed=3)
    gn = norm_(g)
    tr, va, te = split_(g.num_nodes, seed=3)
    task = task_(graph=gn, features=feats, labels=labels, train_mask=tr,
                 val_mask=va, test_mask=te, num_classes=5)
    return task, build_(gn, metis_(gn, P, seed=3), hops=1)


def _base():
    if "base" not in _CACHE:
        jtask, jps = _graph((jrmat, jfeats, jnorm, JTask, jsplit, jmetis,
                             jbuild))
        ttask, tps = _graph((rmat, synth_features, symmetric_normalize,
                             FullBatchTask, split_masks, metis_partition,
                             build_partition))
        cap = dict(c_gpu=[8] * P, c_cpu=30)
        jx = jdist.build_exchange_plan(jps, jcore.build_cache_plan(
            jps, jcore.CacheCapacity(**cap), refresh_every=3))
        tx = build_exchange_plan(tps, tcore.build_cache_plan(
            tps, tcore.CacheCapacity(**cap), refresh_every=3))
        assert tx.host.n_fetch_rows and tx.local.n_rows and tx.glob.n_unique
        kw = dict(model="gcn", in_dim=12, hidden_dim=16, out_dim=5,
                  num_layers=3)
        jparams = jinit(jax.random.PRNGKey(7), JConfig(**kw))
        _CACHE["base"] = dict(
            jtask=jtask, jps=jps, ttask=ttask, tps=tps, jx=jx, tx=tx,
            jcfg=JConfig(**kw), tcfg=GNNConfig(**kw),
            params_np=[{k: np.asarray(v) for k, v in layer.items()}
                       for layer in jparams])
    return _CACHE["base"]


def _tparams(params_np):
    return [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
            for layer in params_np]


def _schedule(rt, state):
    """:data:`SCHEDULE` from ``state``: each step's loss and parameters."""
    out = []
    for kind in SCHEDULE:
        *state, m = getattr(rt, f"step_{kind}")(*state)
        out.append((float(m["loss"]), state[0]))
    return out


def _port(case_id, features):
    key = ("port", case_id, features)
    if key not in _CACHE:
        b = _base()
        backend, halo = CASES[case_id]
        spec = TrainSpec(backend=backend, halo_dtype=halo, features=features)
        rt = make_sim_runtime(b["tcfg"], stack_partitions(
            b["tps"], b["ttask"], backend=backend), b["tx"], sgd(1.0),
            spec=spec, device=CPU)
        params = _tparams(b["params_np"])
        snap = rt.host_store.snapshot() if rt.host_store else None
        logits = rt.forward_fresh(params).numpy()
        steps = _schedule(rt, (params, (), rt.caches0))
        _CACHE[key] = dict(
            logits=logits, losses=[s[0] for s in steps],
            params=[[{k: v.numpy() for k, v in layer.items()} for layer in p]
                    for _, p in steps],
            store=rt.host_store.delta(snap) if rt.host_store else None)
    return _CACHE[key]


def _jax(case_id):
    key = ("jax", case_id)
    if key not in _CACHE:
        b = _base()
        backend, halo = CASES[case_id]
        spec = JSpec(backend=backend, halo_dtype=halo, donate=False,
                     features="host", prefetch_depth=2)
        rt = jdist.make_sim_runtime(b["jcfg"], jdist.stack_partitions(
            b["jps"], b["jtask"], backend=backend), b["jx"], jsgd(1.0),
            spec=spec)
        params = jax.tree.map(jax.numpy.asarray, b["params_np"])
        snap = rt.host_store.snapshot()
        logits = np.asarray(rt.forward_fresh(params))
        state = (params, jsgd(1.0).init(params),
                 jdist.init_caches(b["jcfg"], b["jx"], P, features="host"))
        losses, params_by_step = [], []
        for kind in SCHEDULE:
            *state, m = getattr(rt, f"step_{kind}")(*state)
            losses.append(float(m["loss"]))
            params_by_step.append([{k: np.asarray(v) for k, v in l.items()}
                                   for l in state[0]])
        _CACHE[key] = dict(logits=logits, losses=losses,
                           params=params_by_step,
                           store=rt.host_store.delta(snap))
    return _CACHE[key]


def _tol(case_id):
    return BF16_TOL if CASES[case_id][1] == "bf16" else TOL


def _close_params(got, want, tol, what):
    for li, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol,
                                       err_msg=f"{what} layer {li} {k}")


# ------------------------------------------------------- store unit tests

def test_stage_rows_masks_and_accounts_on_consumption():
    feat = np.arange(3 * 5 * 4, dtype=np.float32).reshape(3, 5, 4)
    pos = np.array([[0, 2, 0], [4, 1, 0], [3, 3, 0]])
    valid = np.array([[True, True, False], [True, False, False],
                      [True, True, True]])
    idx = (np.arange(3)[:, None], pos)
    store, jstore = HostFeatureStore(feat, device=CPU), JStore(feat)
    staged, jstaged = store.stage_rows(idx, valid), jstore.stage_rows(idx,
                                                                      valid)
    assert (staged.rows, staged.nbytes) == (jstaged.rows, jstaged.nbytes)
    assert staged.rows == int(valid.sum())
    np.testing.assert_array_equal(store.ready(staged).numpy(),
                                  np.asarray(jstaged.array))
    # nothing accounted until the consuming step takes it
    assert store.stats["fetch_rows"] == 0
    store.account_fetch(staged)
    jstore.account_fetch(jstaged)
    for k in ("fetches", "fetch_rows", "fetch_bytes"):
        assert store.stats[k] == jstore.stats[k], k


def test_fetch_rows_sync_path():
    feat = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32)
    store = HostFeatureStore(feat, device=CPU)
    idx = np.array([3, 17, 3, 0, -1])
    np.testing.assert_array_equal(store.fetch_rows(idx),
                                  JStore(feat).fetch_rows(idx))
    assert store.stats["fetch_rows"] == 5      # accounted immediately
    assert store.delta(store.snapshot()) == {k: 0 for k in store.stats}


def test_bf16_staging_halves_bytes():
    feat = np.random.default_rng(1).normal(size=(10, 8)).astype(np.float32)
    idx = np.arange(10)
    a = HostFeatureStore(feat, device=CPU).stage_rows(idx)
    b = HostFeatureStore(feat, halo_dtype="bf16", device=CPU).stage_rows(idx)
    jb = JStore(feat, halo_dtype="bf16").stage_rows(idx)
    assert b.nbytes * 2 == a.nbytes == jb.nbytes * 2
    assert b.array.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.array.float().numpy(),
                                  np.asarray(jb.array, np.float32))


def test_global_buffer_roundtrip():
    store = HostFeatureStore(np.zeros((4, 4), np.float32), device=CPU)
    with pytest.raises(KeyError, match="never written back"):
        store.stage_buf(0)
    store.init_buf(0, (6, 3), n_valid=5)
    assert store.has_buf(0) and not store.has_buf(1)
    assert store.buf_layers() == [0]
    z = store.stage_buf(0)
    assert z.rows == 5 and z.nbytes == 5 * 3 * 4
    np.testing.assert_array_equal(z.array.numpy(), np.zeros((6, 3)))
    buf = np.random.default_rng(2).normal(size=(6, 3)).astype(np.float32)
    store.write_buf(0, torch.from_numpy(buf), n_valid=5)
    store.write_buf(0, torch.from_numpy(buf), n_valid=5, account=False)
    assert store.stats["writebacks"] == 1
    assert store.stats["writeback_bytes"] == 5 * 3 * 4
    np.testing.assert_array_equal(store.stage_buf(0).array.numpy(), buf)
    np.testing.assert_array_equal(store.buf_table(0), buf)
    store.set_buf(0, buf * 2)
    np.testing.assert_array_equal(store.buf_table(0), buf * 2)
    assert store.resident_bytes() == 4 * 4 * 4 + 6 * 3 * 4
    js = JStore(np.zeros((4, 4), np.float32))
    js.init_buf(0, (6, 3), n_valid=5)
    js.write_buf(0, buf, n_valid=5)
    assert js.resident_bytes() == store.resident_bytes()
    for k in ("writebacks", "writeback_rows", "writeback_bytes"):
        assert js.stats[k] == store.stats[k], k


@pytest.mark.parametrize("args", [(0, 1.0, 10.0), (1 << 20, 0.0, 10.0),
                                  (1 << 30, 1e-3, 1.0), (1 << 20, 1.0, 100.0),
                                  (1 << 28, 0.02, 3.0)])
def test_suggest_prefetch_depth(args):
    assert suggest_prefetch_depth(*args) == jsuggest(*args)


def test_measure_profile_fields_on_cpu():
    prof = measure_profile(size=64, repeats=1, device=CPU)
    jprof = jmeasure(size=64, repeats=1)
    assert prof.name == jprof.name == "measured"
    for f in ("mm", "spmm", "h2d", "d2h", "idt"):
        assert getattr(prof, f) > 0.0, f
    assert prof.mem_gib == jprof.mem_gib == 16.0     # no device memory
    assert prof.host_mem_gib == pytest.approx(jprof.host_mem_gib)


def test_unported_store_hooks_raise():
    """The tracer and fault hooks (refused until they were ported) attach:
    a stage op records nothing on the CPU (no copy), consults the plan
    once, and a dropped one changes no count."""
    from repro_torch.faults import NULL_FAULTS, FaultPlan, FetchError
    from repro_torch.obs import NULL_TRACER, Tracer
    store = HostFeatureStore(np.zeros((2, 2), np.float32), device=CPU)
    assert store.tracer is NULL_TRACER and store.faults is NULL_FAULTS
    tr, fp = Tracer(), FaultPlan.parse("fetch_drop@0")
    store.set_tracer(tr)
    store.set_faults(fp)
    assert store.tracer is tr and store.faults is fp
    store.stage_rows(np.array([1]))
    fp.begin_step(0)
    with pytest.raises(FetchError):
        store.stage_rows(np.array([0]))
    assert fp.injected["fetch_drop"] == 1 and store.stats["fetches"] == 0
    assert tr.spans == []


# --------------------------------------------- the runtime's staging ring

def test_ring_depth_and_unaccounted_flush():
    """The ring keeps ``prefetch_depth - 1`` fetches in flight; a plan
    install flushes them unaccounted and restages ``l0loc`` (accounted)."""
    b = _base()
    spec = TrainSpec(features="host", prefetch_depth=3)
    rt = make_sim_runtime(b["tcfg"], stack_partitions(b["tps"], b["ttask"]),
                          b["tx"], sgd(1.0), spec=spec, device=CPU)
    store, ring = rt.host_store, rt._state["l0_ring"]
    assert len(ring) == 2
    snap = store.snapshot()
    params = _tparams(b["params_np"])
    rt.step_refresh(params, (), rt.caches0)
    assert len(ring) == 2
    assert store.delta(snap)["fetch_rows"] == b["tx"].host.n_fetch_rows
    snap = store.snapshot()
    rt.set_plan(b["tx"])
    assert len(ring) == 2
    assert store.delta(snap)["fetch_rows"] == b["tx"].local.n_rows


# ------------------------------------- host mode against the JAX package

@pytest.mark.parametrize("case_id", list(CASES))
def test_host_forward_matches_jax(case_id):
    np.testing.assert_allclose(_port(case_id, "host")["logits"],
                               _jax(case_id)["logits"], rtol=0,
                               atol=_tol(case_id))


@pytest.mark.parametrize("case_id", list(CASES))
def test_host_steps_match_jax(case_id):
    got, want = _port(case_id, "host"), _jax(case_id)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=_tol(case_id))
    for s, (gp, wp) in enumerate(zip(got["params"], want["params"])):
        _close_params(gp, wp, _tol(case_id), f"step {s} {SCHEDULE[s]}")


@pytest.mark.parametrize("case_id", list(CASES))
def test_host_counts_equal_jax_and_the_plan(case_id):
    """Every fetch and writeback count of the store equals the JAX
    store's, and the plan's: ``l0loc`` once, the host tier every step, the
    global buffers on every stale step, a writeback on every emitting
    one (the fresh forward stages the host tier once more)."""
    got, want = _port(case_id, "host")["store"], _jax(case_id)["store"]
    for k in ("fetches", "fetch_rows", "fetch_bytes", "writebacks",
              "writeback_rows", "writeback_bytes"):
        assert got[k] == want[k], k
    x, cfg = _base()["tx"], _base()["tcfg"]
    dims = cfg.feat_dims[1:cfg.num_layers]
    width = 2 if CASES[case_id][1] == "bf16" else 4
    stale = [k != "refresh" for k in SCHEDULE]
    emit = [k != "cached" for k in SCHEDULE]
    rows = x.host.n_fetch_rows + sum(
        x.host_fetch_rows(s, len(dims))["total"] for s in stale)
    assert got["fetch_rows"] == rows
    # the fresh forward has no local-tier restage: l0loc was staged at
    # the runtime's build, before the snapshot
    assert got["fetch_bytes"] == (
        x.host.n_fetch_rows * cfg.in_dim * width
        + sum(x.host_bytes_per_step(cfg.in_dim, dims, s, width)
              for s in stale))
    assert got["writeback_bytes"] == sum(emit) * x.host_writeback_bytes(dims)


@pytest.mark.parametrize("case_id", list(CASES))
def test_host_equals_device(case_id):
    """f32: host mode is device mode bit for bit (the same rows reach the
    same sums); bf16: within 5e-3 (device mode reads the layer-0 local tier
    from the f32 table, host mode through the bf16 cast)."""
    host, dev = _port(case_id, "host"), _port(case_id, "device")
    if CASES[case_id][1] == "f32":
        np.testing.assert_array_equal(host["logits"], dev["logits"])
        assert host["losses"] == dev["losses"]
        for gp, wp in zip(host["params"], dev["params"]):
            for g, w in zip(gp, wp):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
    else:
        np.testing.assert_allclose(host["losses"], dev["losses"], rtol=0,
                                   atol=BF16_TOL)
        np.testing.assert_allclose(host["logits"], dev["logits"], rtol=0,
                                   atol=BF16_TOL)


@pytest.mark.parametrize("pipeline", [True, False])
def test_train_capgnn_host_report_matches_jax(pipeline):
    """An 8-epoch ``train_capgnn`` in host mode: losses within 1e-5 of the
    JAX package's, and every count of the report equal."""
    b = _base()
    kw = dict(features="host", pipeline=pipeline, refresh_every=3)
    sp = stack_partitions(b["tps"], b["ttask"])
    spec = TrainSpec(**kw)
    rt = make_sim_runtime(b["tcfg"], sp, b["tx"], sgd(0.5), spec=spec,
                          device=CPU)
    _, rep = train_capgnn(b["tcfg"], rt, b["tx"], P, sgd(0.5), epochs=8,
                          params0=_tparams(b["params_np"]), spec=spec)
    jspec = JSpec(donate=False, **kw)
    jrt = jdist.make_sim_runtime(b["jcfg"], jdist.stack_partitions(
        b["jps"], b["jtask"]), b["jx"], jsgd(0.5), spec=jspec)
    _, jrep = jdist.train_capgnn(
        b["jcfg"], jrt, b["jx"], P, jsgd(0.5), epochs=8, spec=jspec,
        params0=jax.tree.map(jax.numpy.asarray, b["params_np"]))
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=0, atol=TOL)
    for f in ("comm_bytes", "comm_bytes_vanilla", "refresh_steps",
              "cached_steps", "host_fetch_rows", "host_fetch_bytes",
              "host_writeback_bytes"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.host_fetch_rows > 0 and rep.host_writeback_bytes > 0


# ------------------------- double buffer under re-plans (property test)

def test_double_buffer_never_serves_stale_rows_under_replans():
    """Ragged uneven partitions and live re-planning: the host runtime is
    stepped through refreshes, cached steps, ``set_plan`` swaps and
    pipelined ``step_transition``\\ s in lockstep with the device runtime.
    Parameters equal bit for bit at every step, so the ring never serves a
    stale or wrong row (flushed prefetches are discarded); the consumed
    rows equal the plan-counted fetches exactly, each install's
    ``l0loc`` restage included."""
    from repro_torch.data.gnn_data import FullBatchTask as Task
    g = rmat(240, 1500, seed=11)
    feats, labels = synth_features(g, 10, 4, seed=11)
    gn = symmetric_normalize(g)
    tr, va, te = split_masks(g.num_nodes, seed=11)
    task = Task(graph=gn, features=feats, labels=labels, train_mask=tr,
                val_mask=va, test_mask=te, num_classes=4)
    rng = np.random.default_rng(11)
    assign = rng.choice(3, size=g.num_nodes, p=[0.6, 0.25, 0.15])
    for p in range(3):
        assign[p] = p
    ps = build_partition(gn, assign, hops=1, parts=3)
    sizes = [pt.n_halo for pt in ps.parts]
    assert max(sizes) > min(sizes)          # genuinely ragged
    cfg = GNNConfig(model="gcn", in_dim=10, hidden_dim=12, out_dim=4,
                    num_layers=3)
    cap = tcore.CacheCapacity(c_gpu=[max(1, max(sizes) // 4)] * 3,
                              c_cpu=max(1, ps.halo_union().size // 4))
    planner = tcore.AdaptivePlanner(ps, cap, refresh_every=2, policy="lru",
                                    seed=11)
    xp = planner.exchange_plan()
    sp = stack_partitions(ps, task)
    opt = sgd(1.0)
    dev = make_sim_runtime(cfg, sp, xp, opt, spec=TrainSpec(), device=CPU)
    host = make_sim_runtime(cfg, sp, xp, opt, device=CPU, spec=TrainSpec(
        features="host", prefetch_depth=3))
    store = host.host_store
    snap = store.snapshot()
    from repro_torch.models.gnn import init_gnn
    params = init_gnn(cfg, torch.Generator().manual_seed(1), CPU)
    sd, sh = (params, (), dev.caches0), (params, (), host.caches0)
    expected, memberships = 0, set()
    schedule = ["refresh", "cached", "transition", "cached", "pipelined",
                "set_plan", "refresh", "cached", "transition", "cached"]
    for step, kind in enumerate(schedule):
        per = host.xplan.host_fetch_rows(True, cfg.num_layers - 1)
        if kind == "transition":
            nxt = planner.exchange_plan(planner.replan())
            sd = dev.step_transition(*sd, nxt)[:3]
            sh = host.step_transition(*sh, nxt)[:3]
            expected += per["total"] + int(nxt.local.n_rows)
        elif kind == "set_plan":
            nxt = planner.exchange_plan(planner.replan())
            dev.set_plan(nxt)
            host.set_plan(nxt)          # flushes the ring unaccounted
            expected += int(nxt.local.n_rows)
            continue
        else:
            sd = getattr(dev, f"step_{kind}")(*sd)[:3]
            sh = getattr(host, f"step_{kind}")(*sh)[:3]
            expected += per["l0"] if kind == "refresh" else per["total"]
        planner.observe_step(layers=2)
        memberships.add(tuple(int(v) for w in planner.plan.workers
                              for v in w.local_gids))
        for a, b in zip(sd[0], sh[0]):
            for k in a:
                assert torch.equal(a[k], b[k]), (step, kind, k)
        for a, b in zip(sd[2]["local"], sh[2]["local"]):
            assert torch.equal(a, b), (step, kind)
    assert len(memberships) >= 2        # the re-plans changed the tiers
    assert store.delta(snap)["fetch_rows"] == expected
