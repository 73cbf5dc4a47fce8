"""The port's fault injection, defenses and checkpoints
(``repro_torch.faults``, ``repro_torch.checkpoint``) against the JAX
package's, on the CPU (``tests/test_faults.py`` and the checkpoint tests
of ``tests/test_system.py`` of the JAX package).

The single-process runs are :mod:`torch_faults_common`'s (the JAX suite's
graph, 2 parts, GCN 12 -> 16 -> 4, 8 Adam steps from the JAX package's
parameters).  Held:

- ``FaultPlan``: the spec grammar and its errors, word for word; the
  injectors fire only inside the step window; ``grad_nan`` poisons the
  JAX package's leaf 0 and ``halo_corrupt`` draws the JAX package's tier
  (the same ``(seed, step)`` draw over the same tier list), into clones;
- a clean run with no plan, the disabled plan, or a fault-free guard is
  bit for bit today's run (and within 1e-5 of the JAX package's);
- per fault class: ``faults_injected`` and ``fault_events`` equal to the
  JAX package's, ``injected == defended``, losses within 1e-5 of the JAX
  package's faulted run (the NaN step NaN in both);
- a rollback resumes the clean trajectory;
- the guard's stale reuse and its budget: an uninjected fetch error past
  the retries with no stale rows still raises; the host store drops a
  fetch before it gathers or takes a ring slot;
- the SPMD runtime on 4 gloo ranks (one spawn, every configuration;
  ``host`` features under both transports and ``device`` features under
  ``p2p``), ``fetch_drop@3;grad_nan@5`` under the guard, traced: every
  rank's counts equal JAX ``capgnn_sim``'s, losses within 1e-5, the
  counted wire rows the plan's, the traced totals the report's;
- checkpoints: kill-and-resume through ``launch.train`` skips a truncated
  file and ends at the uninterrupted run's loss; truncation and a bit
  flip are detected; an old meta without a CRC loads; a checkpoint of
  either package loads in the other, leaves equal; a serving store saved
  by the port reloads bit for bit and loads in the JAX package.

The card test of a dropped fetch (it leaks no pinned ring slot) is in
``tests/test_torch_cuda.py``, which imports no JAX.
"""
import json
import os
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dist as jdist
import repro.graph as jgraph
from repro.checkpoint import (load_checkpoint as jload,
                              save_checkpoint as jsave)
from repro.data.gnn_data import FullBatchTask as JTask, split_masks as jsplit
from repro.dist.spec import TrainSpec as JSpec
from repro.faults import FaultPlan as JFaultPlan, GuardConfig as JGuard
from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
from repro.optim import adam as jadam
from repro.serve import load_store as jload_store
import repro_torch.core as tcore
import repro_torch.graph as tgraph
from repro_torch.checkpoint import (CheckpointCorruptError, latest_step,
                                    load_checkpoint, save_checkpoint,
                                    verify_checkpoint)
from repro_torch.data.gnn_data import FullBatchTask, split_masks
from repro_torch.dist import HostFeatureStore
from repro_torch.faults import (FAULT_KINDS, NULL_FAULTS, DefenseEvents,
                                FaultPlan, FetchError, FetchGuard,
                                GuardConfig)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import spawn
from repro_torch.models.gnn import GNNConfig
from repro_torch.obs.tracer import NULL_TRACER

import torch_faults_common as common
import torch_spmd_ranks
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5
FAULT_CASES = [   # (spec, defense, guard kwargs, cache policy): the JAX suite's
    ("fetch_drop@3,5", "fetch_errors", dict(fetch_retries=2), None),
    ("fetch_delay@2:delay_s=0.12", "slow_fetches",
     dict(fetch_timeout_s=0.05), None),
    ("halo_corrupt@3", "corruptions_detected", dict(checksums=True), None),
    ("grad_nan@3", "rollbacks", dict(guard_every=2), None),
    ("mem_pressure@4", "mem_backoffs", dict(), "lru"),
]


def _losses_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ------------------------------------------------------------ plan parsing

def test_parse_roundtrip_and_errors():
    spec = "fetch_drop@3,7;grad_nan@5;halo_corrupt@4:rows=8"
    fp, jfp = FaultPlan.parse(spec, seed=3), JFaultPlan.parse(spec, seed=3)
    assert fp.enabled and fp.seed == 3
    assert fp.spec_string() == jfp.spec_string() == \
        "fetch_drop@3,7;grad_nan@5;halo_corrupt@4"
    assert fp._by_kind["halo_corrupt"].rows == 8
    assert {k: s.steps for k, s in fp._by_kind.items()} == \
        {k: s.steps for k, s in jfp._by_kind.items()}
    assert not FaultPlan.parse("").enabled
    assert not FaultPlan.parse(None).enabled
    for bad in ("cosmic_ray@3", "grad_nan", "grad_nan@3:zap=1",
                "grad_nan@3;grad_nan@5", "fetch_delay@-1", "grad_nan@3:rows"):
        with pytest.raises(ValueError) as got:
            FaultPlan.parse(bad)
        with pytest.raises(ValueError) as want:
            JFaultPlan.parse(bad)
        assert str(got.value) == str(want.value)
    assert FAULT_KINDS == ("fetch_drop", "fetch_delay", "halo_corrupt",
                           "grad_nan", "mem_pressure", "ckpt_truncate")


def test_injectors_noop_outside_step_window():
    """Setup and evaluation are never faulted: the injectors fire only
    between ``begin_step`` and ``end_run``, on marked steps."""
    fp = FaultPlan.parse("fetch_drop@2;grad_nan@2;mem_pressure@2")
    params = [{"b": torch.zeros(2), "w": torch.ones(2, 2)}]
    fp.on_fetch()                       # no begin_step -> no-op
    assert fp.corrupt_params(params) is params
    assert not fp.mem_pressure()
    fp.begin_step(1)                    # unmarked step -> no-op
    fp.on_fetch()
    assert fp.corrupt_params(params) is params
    fp.begin_step(2)
    with pytest.raises(FetchError):
        fp.on_fetch()
    assert fp.mem_pressure()
    fp.end_run()
    fp.on_fetch()                       # window closed again
    assert fp.injected["fetch_drop"] == 1
    assert fp.injected["mem_pressure"] == 1
    assert NULL_FAULTS.total_injected() == 0


def test_corrupt_params_poisons_the_jax_leaf_in_a_clone():
    """Leaf 0 of the JAX package's flatten (layers in order, keys sorted)
    gets NaN at element ``(0, ..., 0)``; the input is not written."""
    jparams = jinit(jax.random.PRNGKey(1), JConfig(**common.CFG_KW))
    params = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
              for layer in jparams]
    before = [{k: v.clone() for k, v in layer.items()} for layer in params]
    fp, jfp = FaultPlan.parse("grad_nan@0"), JFaultPlan.parse("grad_nan@0")
    fp.begin_step(0)
    jfp.begin_step(0)
    got, want = fp.corrupt_params(params), jfp.corrupt_params(jparams)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert np.isnan(got[0]["b"].numpy()).sum() == 1
    for a, b in zip(params, before):
        for k in a:
            assert torch.equal(a[k], b[k])


class _Bufs:
    """A host store's global buffers (``buf_layers`` / ``buf_table`` /
    ``set_buf``) over numpy tables."""

    def __init__(self, tables):
        self.tables = dict(enumerate(tables))

    def buf_layers(self):
        return sorted(self.tables)

    def buf_table(self, li):
        return self.tables[li]

    def set_buf(self, li, rows):
        self.tables[li] = np.asarray(rows, np.float32)


@pytest.mark.parametrize("host", [False, True])
def test_corrupt_caches_draws_the_jax_tier(host):
    """Over many ``(seed, step)`` draws the port picks the JAX package's
    tier and writes the same rows, into a clone."""
    rng = np.random.default_rng(0)
    local = [rng.normal(size=(2, 5, 3)).astype(np.float32),
             np.zeros((2, 0, 3), np.float32),
             rng.normal(size=(2, 4, 3)).astype(np.float32)]
    glob = [] if host else [rng.normal(size=(6, 3)).astype(np.float32)] * 3
    bufs = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(2)]
    for seed in range(4):
        for step in range(6):
            spec = f"halo_corrupt@{step}:rows=3"
            fp, jfp = FaultPlan.parse(spec, seed), JFaultPlan.parse(spec, seed)
            fp.begin_step(step)
            jfp.begin_step(step)
            caches = {"local": [torch.from_numpy(c) for c in local],
                      "global": [torch.from_numpy(c) for c in glob]}
            store, jstore = (_Bufs(bufs), _Bufs(bufs)) if host else (None,
                                                                      None)
            got, name = fp.corrupt_caches(caches, store)
            want, jname = jfp.corrupt_caches(
                {"local": [jax.numpy.asarray(c) for c in local],
                 "global": [jax.numpy.asarray(c) for c in glob]}, jstore)
            assert name == jname
            for k in ("local", "global"):
                for g, w in zip(got[k], want[k]):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            if host:
                for li in store.buf_layers():
                    np.testing.assert_array_equal(store.buf_table(li),
                                                  jstore.buf_table(li))
            np.testing.assert_array_equal(caches["local"][0].numpy(),
                                          local[0])


# -------------------------------------------------- disabled == untouched

def test_clean_run_bit_identical_with_disabled_plan():
    """No plan, the disabled plan and a defense-armed fault-free run give
    the same losses bit for bit (the guards change control flow only on
    failure), within 1e-5 of the JAX package's clean run."""
    plain = common.torch_run()[0]
    nullfp = common.torch_run(spec="")[0]
    guarded = common.torch_run(guard_kw=dict(guard_every=2, fetch_retries=2,
                                             checksums=True,
                                             fetch_timeout_s=10.0))[0]
    assert plain.losses == nullfp.losses == guarded.losses
    assert plain.fault_events is None and plain.faults_injected is None
    assert nullfp.fault_events is None and nullfp.faults_injected is None
    assert all(v == 0 for v in guarded.fault_events.values())
    _losses_close(plain.losses, common.jax_run()[0].losses)


# ------------------------------------------------------ injected==defended

@pytest.mark.parametrize("spec,defense,guard_kw,policy", FAULT_CASES)
def test_fault_class_matches_jax(spec, defense, guard_kw, policy):
    kind = spec.split("@")[0]
    rep, _, rt = common.torch_run(spec=spec, guard_kw=guard_kw,
                                  policy=policy)
    jrep, _, jrt = common.jax_run(spec=spec, guard_kw=guard_kw,
                                  policy=policy)
    assert len(rep.losses) == common.EPOCHS and np.isfinite(rep.losses[-1])
    assert rep.faults_injected[kind] > 0
    assert rep.faults_injected[kind] == rep.fault_events[defense]
    assert rep.faults_injected == jrep.faults_injected
    assert rep.fault_events == jrep.fault_events
    assert rep.step_kinds is not None and rep.refresh_steps == \
        jrep.refresh_steps
    _losses_close(rep.losses, jrep.losses)
    if kind == "halo_corrupt":
        # the tier the JAX plan draws at that step over the JAX runtime's
        # tiers (its local caches and host buffers)
        jfp = JFaultPlan.parse(spec, seed=0)
        step = jfp._by_kind[kind].steps[0]
        jfp.begin_step(step)
        cfg, _, jx, _ = common.setup("jax")
        bufs = _Bufs([jrt.host_store.buf_table(li)
                      for li in jrt.host_store.buf_layers()])
        _, jname = jfp.corrupt_caches(
            jdist.init_caches(cfg, jx, common.PARTS, features="host"), bufs)
        assert rep.fault_tiers == [(step, jname)]


def test_rollback_resumes_clean_trajectory():
    """After the NaN step's rollback and forced refresh, training replays
    the clean loss trajectory (the snapshot restore is exact and the plain
    refresh rewrites every poisoned tier)."""
    clean = common.torch_run()[0]
    rep = common.torch_run(spec="grad_nan@3",
                           guard_kw=dict(guard_every=2))[0]
    assert not np.isfinite(rep.losses[3])
    # the snapshot was taken after step 1; the rollback replays from there
    np.testing.assert_allclose(rep.losses[4:],
                               clean.losses[2:common.EPOCHS - 2],
                               rtol=1e-6, atol=1e-7)
    assert rep.fault_events["rollbacks"] == 1
    assert rep.fault_events["forced_refreshes"] == 1
    assert rep.step_kinds[4] == "refresh"


def test_injection_deterministic_across_runs():
    spec = "fetch_drop@3;halo_corrupt@4"
    kw = dict(fetch_retries=1, checksums=True)
    a = common.torch_run(spec=spec, guard_kw=kw)[0]
    common._CACHE.pop(("torch", "host", spec, tuple(sorted(kw.items())),
                       None, False))
    b = common.torch_run(spec=spec, guard_kw=kw)[0]
    assert a.losses == b.losses
    assert a.faults_injected == b.faults_injected
    assert a.fault_events == b.fault_events
    assert a.fault_tiers == b.fault_tiers


def test_mem_pressure_needs_a_planner():
    with pytest.raises(ValueError, match="AdaptivePlanner"):
        common.torch_run(spec="mem_pressure@1", guard_kw={})


# --------------------------------------------------------- guard unit tests

class _Store:
    """The store surface the fetch guard reads."""
    tracer = NULL_TRACER

    @staticmethod
    def account_fetch(sf):
        pass

    @staticmethod
    def ready(sf):
        return sf.array


def test_fetch_guard_stale_reuse_and_exhaustion():
    ev = DefenseEvents()
    g = FetchGuard(GuardConfig(fetch_retries=2, fetch_backoff_s=0.0), ev)

    def always_fails():
        raise FetchError("down")

    # an error past the budget with no previously consumed rows raises
    with pytest.raises(FetchError, match="no previously consumed rows"):
        g.fetch_sync(always_fails, _Store, "l0")
    assert ev.fetch_errors == 3 and ev.fetch_retries == 2
    g.last_good["l0"] = torch.ones(3)
    out = g.fetch_sync(always_fails, _Store, "l0")
    assert torch.equal(out, torch.ones(3))
    assert ev.fetch_stale_reuse == 1 and ev.fetch_errors == 6


def test_prefetch_degradation_window():
    ev = DefenseEvents()
    g = FetchGuard(GuardConfig(degrade_steps=2), ev)
    assert g.prefetch_ok()
    g._degraded = 2
    assert not g.prefetch_ok() and not g.prefetch_ok()
    assert g.prefetch_ok()
    assert ev.prefetch_degraded_steps == 2


def test_store_consults_the_plan_before_it_gathers():
    """A dropped stage op raises before any gather or count; a delayed one
    shows its stall in ``gather_s``; the rows are those of an unfaulted
    stage."""
    table = np.arange(24, dtype=np.float32).reshape(6, 4)
    store = HostFeatureStore(table, device="cpu")
    store.init_buf(0, (3, 4), 2)
    fp = FaultPlan.parse("fetch_drop@1;fetch_delay@2:delay_s=0.05")
    store.set_faults(fp)
    before = store.snapshot()
    fp.begin_step(1)
    for stage in (lambda: store.stage_rows(np.array([1, 4])),
                  lambda: store.stage_buf(0)):
        with pytest.raises(FetchError):
            stage()
    assert store.snapshot() == before and fp.injected["fetch_drop"] == 2
    fp.begin_step(2)
    sf = store.stage_rows(np.array([1, 4]))
    assert sf.gather_s >= 0.05
    np.testing.assert_array_equal(sf.array.numpy(), table[[1, 4]])
    fp.end_run()


# ------------------------------------------------------------------- SPMD

SPMD_P = 4
SPMD_SPEC = "fetch_drop@3;grad_nan@5"
SPMD_GUARD = dict(guard_every=2, fetch_retries=1)
SPMD_CASES = {   # id: (transport, features)
    "p2p-host": ("p2p", "host"),
    "allgather-host": ("allgather", "host"),
    "p2p-device": ("p2p", "device"),
}
_SPMD_CAP = dict(c_gpu=[10] * SPMD_P, c_cpu=25)


def _spmd_graph(core, graph, dist, task_cls, split, cfg_cls):
    """The SPMD tests' graph (``tests/spmd_parity_script.py``'s): rmat 360
    / 2,200, GCN 12 -> 16 -> 16 -> 5, 4 METIS parts, a forced capacity
    that fills every tier."""
    g = graph.rmat(360, 2200, seed=3)
    feats, labels = graph.synth_features(g, 12, 5, seed=3)
    gn = graph.symmetric_normalize(g)
    tr, va, te = split(g.num_nodes, seed=3)
    task = task_cls(graph=gn, features=feats, labels=labels, train_mask=tr,
                    val_mask=va, test_mask=te, num_classes=5)
    ps = graph.build_partition(gn, graph.metis_partition(gn, SPMD_P, seed=3),
                               hops=1)
    xplan = dist.build_exchange_plan(ps, core.build_cache_plan(
        ps, core.CacheCapacity(**_SPMD_CAP), refresh_every=2))
    cfg = cfg_cls(model="gcn", in_dim=12, hidden_dim=16, out_dim=5,
                  num_layers=3)
    return cfg, dist.stack_partitions(ps, task), xplan


@pytest.fixture(scope="module")
def spmd():
    """Every SPMD configuration in one spawn of 4 gloo ranks, and JAX
    ``capgnn_sim``'s run of each feature mode under the same faults."""
    import repro_torch.dist as tdist
    cfg, sp, xplan = _spmd_graph(tcore, tgraph, tdist, FullBatchTask,
                                 split_masks, GNNConfig)
    jcfg, jsp, jx = _spmd_graph(jcore, jgraph, jdist, JTask, jsplit, JConfig)
    assert xplan.uncached.n_rows and xplan.local.n_rows and \
        xplan.glob.n_unique and xplan.host.n_fetch_rows
    jparams = jinit(jax.random.PRNGKey(7), jcfg)
    params_np = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in jparams]
    cases = {cid: (dict(transport=t, features=f, pipeline=True,
                        refresh_every=2), SPMD_SPEC, SPMD_GUARD)
             for cid, (t, f) in SPMD_CASES.items()}
    ranks = spawn(torch_spmd_ranks.run_faults, SPMD_P, backend="gloo",
                  devices="cpu", args=(cfg, sp, xplan, cases, params_np,
                                       common.EPOCHS))
    jax_ref = {}
    for features in ("host", "device"):
        from repro.obs import Tracer as JTracer
        jspec = JSpec(features=features, pipeline=True, refresh_every=2,
                      donate=False)
        jrt = jdist.make_sim_runtime(jcfg, jsp, jx, jadam(1e-2), spec=jspec)
        tr = JTracer()
        _, rep = jdist.train_capgnn(
            jcfg, jrt, jx, SPMD_P, jadam(1e-2), epochs=common.EPOCHS,
            params0=jparams, spec=jspec, tracer=tr,
            faults=JFaultPlan.parse(SPMD_SPEC, seed=0),
            guard=JGuard(**SPMD_GUARD))
        jax_ref[features] = (rep, tr)
    return {"ranks": ranks, "jax": jax_ref, "xplan": xplan}


@pytest.mark.parametrize("case_id", list(SPMD_CASES))
def test_spmd_faults_match_jax(spmd, case_id):
    """Each rank's own plan and guard count what JAX ``capgnn_sim``'s
    count (every rank runs the same stage ops as the single store), the
    defenses hold and the losses follow the JAX package's run."""
    features = SPMD_CASES[case_id][1]
    jrep = spmd["jax"][features][0]
    for r in spmd["ranks"]:
        got = r[case_id]
        assert got["faults_injected"] == jrep.faults_injected
        assert got["fault_events"] == jrep.fault_events
        # the rollback after step 5 forces a plain refresh at step 6
        assert got["step_kinds"] == ["refresh", "cached", "pipelined",
                                     "cached", "pipelined", "cached",
                                     "refresh", "cached"]
        _losses_close(got["losses"], jrep.losses)
    inj = jrep.faults_injected
    assert inj["grad_nan"] == jrep.fault_events["rollbacks"] == 1
    if features == "host":
        assert inj["fetch_drop"] == jrep.fault_events["fetch_errors"] > 0


@pytest.mark.parametrize("case_id", list(SPMD_CASES))
def test_spmd_faults_counted_rows_equal_plan(spmd, case_id):
    """The wire counts summed over the ranks are the plan's every step,
    with the guard's agreement all-reduce uncounted."""
    transport = SPMD_CASES[case_id][0]
    xplan, ranks = spmd["xplan"], spmd["ranks"]
    kinds = ranks[0][case_id]["step_kinds"]
    for s, kind in enumerate(kinds):
        want = xplan.transport_rows(transport, kind != "cached")
        for li in (1, 2):
            for t in ("uncached", "local", "global"):
                n = want[t]
                got = sum(r[case_id]["wire"][s].get((li, t), {}).get(
                    "valid_rows", 0) for r in ranks)
                assert got == n, (s, kind, li, t)


@pytest.mark.parametrize("case_id", list(SPMD_CASES))
def test_spmd_traced_totals_equal_report(spmd, case_id):
    """Each rank's traced totals equal its report; summed over the ranks
    the host counts and, step by step, the fault fields equal the JAX
    package's traced stream."""
    features = SPMD_CASES[case_id][1]
    jtr = spmd["jax"][features][1]
    for r in spmd["ranks"]:
        got = r[case_id]
        tot = got["totals"]
        assert tot["steps"] == common.EPOCHS
        assert tot["wire_bytes"] == got["comm_bytes"]
        assert tot["host_fetch_rows"] == got["host_fetch_rows"]
        assert tot["host_fetch_bytes"] == got["host_fetch_bytes"]
        assert tot["host_writeback_bytes"] == got["host_writeback_bytes"]
        for k, v in got["fault_events"].items():
            assert tot[k] == v
        assert tot["faults_injected"] == sum(got["faults_injected"].values())
        for c, jc in zip(got["counters"], jtr.counters):
            for f in ("step", "kind", "faults_injected", "fetch_errors",
                      "rollbacks", "forced_refreshes", "wire_bytes"):
                assert c[f] == getattr(jc, f), (f, c["step"])
    for s, jc in enumerate(jtr.counters):
        for f in ("host_fetch_rows", "host_fetch_bytes",
                  "host_writeback_bytes"):
            assert sum(r[case_id]["counters"][s][f]
                       for r in spmd["ranks"]) == getattr(jc, f), (f, s)


# ------------------------------------------------------------- checkpoints

_CLI = ["gnn", "--device", "cpu", "--dataset", "flickr", "--scale", "0.008",
        "--feat-dim", "16", "--model", "gcn", "--hidden", "16", "--layers",
        "2", "--parts", "2", "--epochs", "8", "--no-rapa", "--no-pipeline",
        "--refresh-every", "4", "--cpu-cache-gib", "1.0"]


def _cli(*extra):
    out, _ = ttrain.train_gnn(ttrain.build_parser().parse_args(
        _CLI + list(extra)))
    return out


def test_kill_and_resume_parity(tmp_path):
    """``tests/test_system.py``'s kill-and-resume scenario through the
    port's CLI: a truncated step-6 checkpoint and a stray ``.tmp`` are
    skipped, the run resumes at step 4 and ends at the uninterrupted
    run's loss; resuming past the budget is a no-op."""
    straight = _cli()
    d = str(tmp_path / "ck")
    first = _cli("--epochs", "4", "--ckpt-dir", d)
    assert first["resumed_from"] == 0 and latest_step(d) == 4
    shutil.copy(f"{d}/ckpt_00000004.npz", f"{d}/ckpt_00000006.npz")
    shutil.copy(f"{d}/ckpt_00000004.json", f"{d}/ckpt_00000006.json")
    FaultPlan.parse("ckpt_truncate@0:frac=0.5").truncate_checkpoint(
        f"{d}/ckpt_00000006.npz")
    open(f"{d}/ckpt_00000006.npz.tmp", "wb").write(b"partial")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert latest_step(d) == 4
        resumed = _cli("--ckpt-dir", d, "--resume")
    assert resumed["resumed_from"] == 4 and latest_step(d) == 8
    np.testing.assert_allclose(resumed["final_loss"], straight["final_loss"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(resumed["test_acc"], straight["test_acc"],
                               rtol=1e-6, atol=1e-7)
    again = _cli("--ckpt-dir", d, "--resume")
    assert again["resumed_from"] == 8 and again["final_loss"] is None


def test_checkpoint_truncation_and_bitflip_detected(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(20, dtype=torch.float32).reshape(4, 5)}
    save_checkpoint(d, 2, tree)
    save_checkpoint(d, 4, tree)
    meta = verify_checkpoint(d, 4)
    assert meta["payload_crc32"] is not None and meta["payload_bytes"] > 0
    FaultPlan.parse("ckpt_truncate@0:frac=0.3").truncate_checkpoint(
        os.path.join(d, "ckpt_00000004.npz"))
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        verify_checkpoint(d, 4)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(d, 4, tree)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert latest_step(d) == 2
    assert any("corrupt" in str(x.message) for x in w)
    assert torch.equal(load_checkpoint(d, 2, tree)["w"], tree["w"])
    path = os.path.join(d, "ckpt_00000002.npz")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF                      # same length, different bytes
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        verify_checkpoint(d, 2)


def test_checkpoint_pre_checksum_meta_still_loads(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones(6)}
    save_checkpoint(d, 3, tree)
    mp = os.path.join(d, "ckpt_00000003.json")
    meta = json.load(open(mp))
    del meta["payload_crc32"], meta["payload_bytes"]
    json.dump(meta, open(mp, "w"))
    assert latest_step(d) == 3
    assert torch.equal(load_checkpoint(d, 3, tree)["w"], tree["w"])


def _training_state():
    """The JAX package's parameters and an Adam state after one update,
    with a bf16 leaf, as both packages hold them."""
    jp = jinit(jax.random.PRNGKey(2), JConfig(**common.CFG_KW))
    jp[1]["x"] = jax.numpy.arange(3, dtype=jax.numpy.bfloat16)
    jopt = jadam(0.1)
    _, jo = jopt.update(jax.tree.map(jax.numpy.ones_like, jp),
                        jopt.init(jp), jp)
    from repro_torch.optim.optimizers import _AdamState

    def port(tree):
        return [{k: torch.from_numpy(np.array(v, np.float32)).to(
            torch.bfloat16 if v.dtype == jax.numpy.bfloat16 else
            torch.float32) for k, v in layer.items()} for layer in tree]
    to = _AdamState(mu=port(jo.mu), nu=port(jo.nu),
                    count=torch.tensor(int(jo.count), dtype=torch.int32))
    return ({"params": jp, "opt_state": jo},
            {"params": port(jp), "opt_state": to})


def _leaves_equal(port_tree, jax_tree):
    from repro_torch.checkpoint.checkpoint import _flatten
    got, want = _flatten(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dtype == torch.bfloat16:
            g, w = g.float(), w.astype(np.float32)
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint written by either package loads in the other: the
    same leaves, bf16 included, and the Adam state's structure."""
    jtree, ttree = _training_state()
    d = str(tmp_path)
    if writer == "port":
        save_checkpoint(d, 5, ttree)
        got = jload(d, 5, jtree)
        _leaves_equal(ttree, got)
    else:
        jsave(d, 5, jtree)
        got = load_checkpoint(d, 5, ttree)
        assert type(got["opt_state"]).__name__ == "_AdamState"
        _leaves_equal(got, jtree)


def test_serve_store_roundtrip_and_trace(tmp_path):
    """``launch.serve gnn --store-dir`` saves the store, ``--load-store``
    reloads it bit for bit (its config and backend from the store), the
    JAX package loads it too, and ``--trace`` writes a valid trace with
    one counter record a micro-batch."""
    from repro.obs import validate_chrome_trace as jvalidate
    base = ["gnn", "--device", "cpu", "--scale", "0.005", "--hidden", "8",
            "--queries", "64", "--backend", "hybrid"]
    st, tr = str(tmp_path / "st"), str(tmp_path / "tr")
    out, eng = tserve.serve_gnn(tserve.build_parser().parse_args(
        base + ["--store-dir", st, "--trace", "--trace-dir", tr]))
    out2, eng2 = tserve.serve_gnn(tserve.build_parser().parse_args(
        base[:3] + ["--scale", "0.005", "--queries", "64", "--store-dir",
                    st, "--load-store"]))
    for a, b in zip(eng.store.tables, eng2.store.tables):
        np.testing.assert_array_equal(a, b)
    assert eng2.store.cfg == eng.store.cfg and out2["backend"] == "hybrid"
    jstore = jload_store(st)
    for a, b in zip(eng.store.tables, jstore.tables):
        np.testing.assert_array_equal(a, b)
    payload = json.load(open(out["trace_file"]))
    stats = jvalidate(payload)
    assert stats["spans_by_cat"]["serve_batch"] == out["batches"]
    lines = open(out["metrics_file"]).read().splitlines()
    assert len(lines) == out["batches"]
    assert sum(json.loads(x)["queries"] for x in lines) == out["queries"]
