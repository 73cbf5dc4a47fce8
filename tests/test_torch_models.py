"""The SAGE, GIN and GAT layers (the rest of ``repro.models.gnn``) against
the JAX package's, on the CPU.

The graph of ``tests/spmd_parity_script.py``: rmat 360 / 2,200, 12
features, 5 classes, 4 METIS parts, models 12 -> 16 -> 16 -> 5, a forced
capacity (``c_gpu`` 10 rows a worker, ``c_cpu`` 25) that fills every
tier, ``refresh_every=2``.  Parameters come from the JAX package's
``init_gnn`` and cross as numpy (``convert.params_from_reference``);
the Pallas kernels run in interpret mode on the JAX side, their plain
versions on the port's.  Parameters and gradients are compared by layer
and key, never by leaf position.  Held, within 1e-5 unless stated:

- the ``Adjacency`` protocol (the counterpart of
  ``tests/test_backends.py:34-86``): ``spmm``, ``degree`` and
  ``spmm_at`` (values and gradients) of every backend of
  ``make_local_adj`` against the JAX package's on one partition, and the
  refusals;
- ``gnn_forward`` on the single-worker graph: logits, loss and every
  parameter gradient for ``gcn``, ``sage`` / ``gin`` under every backend
  and ``gat`` on ``edges``;
- the sim runtime: ``sage`` and ``gin`` under ``edges``, ``ell`` and
  ``hybrid``, fresh logits and a refresh and a cached ``sgd`` step
  against JAX ``capgnn_sim``, every count equal; the
  host-features run equal to the device run bit for bit, and the bf16
  wire against JAX's;
- GAT where the reference is finite: the stacked ``forward_fresh``
  logits, each partition's layer over its edge list trimmed of padding,
  the full-graph gradients against the port's stacked ones; and finite
  stacked gradients where the reference's are not;
- ``capgnn_spmd``: ``tests/test_torch_models_spmd.py``;
- the precompute tables of ``sage`` and ``gin`` on ``hybrid`` and the
  engine's fresh recompute (SAGE's ``degree`` over its ``EdgeListAdj``);
- both CLIs: ``launch.train gnn --model {sage,gat,gin}`` and
  ``launch.serve gnn --model sage --backend hybrid`` at scale 0.02 with
  the JAX package's parameters: the JAX CLI's keys and counts, and (SAGE,
  GIN) its final loss.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dist as jdist
import repro.serve as jserve
from repro.data.gnn_data import FullBatchTask as JTask, split_masks as jsplit
from repro.dist.spec import TrainSpec as JSpec
from repro.graph import (build_partition as jbuild, metis_partition as jmetis,
                         rmat as jrmat, symmetric_normalize as jnorm,
                         synth_features as jfeats)
from repro.launch import serve as jlaunch_serve, train as jlaunch_train
from repro.models import gnn as jgnn
from repro.optim import sgd as jsgd
import repro_torch.core as tcore
import repro_torch.dist.capgnn_sim as tsim
from repro_torch.convert import params_from_reference
from repro_torch.data.gnn_data import FullBatchTask, split_masks
from repro_torch.dist import (TrainSpec, build_exchange_plan,
                              make_sim_runtime, stack_partitions,
                              train_capgnn)
from repro_torch.graph import (build_partition, metis_partition, rmat,
                               symmetric_normalize, synth_features)
from repro_torch.launch import serve as tlaunch_serve, train as tlaunch_train
from repro_torch.models import gnn as tgnn
from repro_torch.optim import sgd
from repro_torch.serve import GNNServeEngine, precompute_embeddings
from torch_threads import torch_threads_per_worker  # noqa: F401

P = 4
TOL = 1e-5
CAP = dict(c_gpu=[10] * P, c_cpu=25)
DIMS = dict(in_dim=12, hidden_dim=16, out_dim=5, num_layers=3)
SCHEDULE = ["refresh", "cached"]          # the sim runtime's steps
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
        jx = jdist.build_exchange_plan(jps, jcore.build_cache_plan(
            jps, jcore.CacheCapacity(**CAP), refresh_every=2))
        tx = build_exchange_plan(tps, tcore.build_cache_plan(
            tps, tcore.CacheCapacity(**CAP), refresh_every=2))
        _CACHE["base"] = dict(jtask=jtask, jps=jps, ttask=ttask, tps=tps,
                              jx=jx, tx=tx)
    return _CACHE["base"]


def _cfgs(model):
    return (jgnn.GNNConfig(model=model, **DIMS),
            tgnn.GNNConfig(model=model, **DIMS))


def _params_np(model, seed=7):
    key = ("params", model, seed)
    if key not in _CACHE:
        jp = jgnn.init_gnn(jax.random.PRNGKey(seed), _cfgs(model)[0])
        _CACHE[key] = [{k: np.asarray(v) for k, v in layer.items()}
                       for layer in jp]
    return _CACHE[key]


def _jparams(params_np):
    return jax.tree.map(jnp.asarray, params_np)


def _tparams(params_np, grad=False):
    out = params_from_reference(params_np, device="cpu")
    for layer in out:
        for v in layer.values():
            v.requires_grad_(grad)
    return out


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _close_tree(got, want, tol=TOL, what=""):
    """Per layer and key (dict order differs between the packages)."""
    assert len(got) == len(want)
    for li, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (li, sorted(g), sorted(w))
        for k in w:
            _close(g[k], w[k], tol, f"{what} layer {li} {k}")


# ---------------------------------------------------------------------------
# the Adjacency protocol
# ---------------------------------------------------------------------------

def _local(backend, part=0):
    b = _base()
    jpart, tpart = b["jps"].parts[part], b["tps"].parts[part]
    return (jgnn.make_local_adj(jpart.local_graph, jpart.n_inner, backend),
            tgnn.make_local_adj(tpart.local_graph, tpart.n_inner, backend,
                                device="cpu"), jpart)


@pytest.mark.parametrize("backend", tgnn.BACKENDS)
def test_local_adj_matches_reference(backend):
    """``spmm`` and ``degree`` of each backend on partition 0, against the
    JAX package's ``make_local_adj`` of the same partition."""
    jadj, tadj, part = _local(backend)
    assert type(tadj).__name__ == type(jadj).__name__
    assert (tadj.n_rows, tadj.n_cols) == (part.n_inner, part.n_local)
    h = np.random.default_rng(0).normal(
        size=(part.n_local, 16)).astype(np.float32)
    _close(tadj.spmm(torch.from_numpy(h)), jadj.spmm(jnp.asarray(h)),
           what="spmm")
    _close(tadj.degree(), jadj.degree(), what="degree")


def test_make_local_adj_unknown_backend():
    part = _base()["tps"].parts[0]
    with pytest.raises(ValueError, match="nope"):
        tgnn.make_local_adj(part.local_graph, part.n_inner, "nope",
                            device="cpu")


@pytest.mark.parametrize("backend", ["edges", "ell"])
def test_spmm_at_matches_reference(backend):
    """``spmm_at`` with random per-edge values in the backend's layout (the
    ELL padding slots too, which it masks): the product and its gradients
    in the values and in ``h``."""
    jadj, tadj, part = _local(backend)
    rng = np.random.default_rng(1)
    shape = tuple(jadj.weight.shape if backend == "edges"
                  else jadj.vals.shape)
    e = rng.normal(size=shape).astype(np.float32)
    h = rng.normal(size=(part.n_local, 8)).astype(np.float32)
    g = rng.normal(size=(part.n_inner, 8)).astype(np.float32)

    def jfn(e_, h_):
        return jnp.sum(jadj.spmm_at(e_, h_) * g)
    jout = jadj.spmm_at(jnp.asarray(e), jnp.asarray(h))
    jde, jdh = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(e), jnp.asarray(h))
    te = torch.from_numpy(e).requires_grad_(True)
    th = torch.from_numpy(h).requires_grad_(True)
    tout = tadj.spmm_at(te, th)
    (tout * torch.from_numpy(g)).sum().backward()
    _close(tout, jout, what="spmm_at")
    _close(te.grad, jde, what="d_vals")
    _close(th.grad, jdh, what="d_h")


@pytest.mark.parametrize("backend", ["dense", "hybrid"])
def test_spmm_at_refused(backend):
    _, tadj, part = _local(backend)
    with pytest.raises(NotImplementedError) as ei:
        tadj.spmm_at(torch.ones(3), torch.ones(part.n_local, 4))
    assert type(tadj).__name__ in str(ei.value)
    assert "edges" in str(ei.value)


# ---------------------------------------------------------------------------
# gnn_forward on the single-worker graph
# ---------------------------------------------------------------------------

FORWARD_CASES = [("gcn", "edges"), ("gat", "edges")] + [
    (m, b) for m in ("sage", "gin") for b in tgnn.BACKENDS]


@pytest.mark.parametrize("model,backend", FORWARD_CASES)
def test_gnn_forward_and_grads_match(model, backend):
    """The whole graph on one worker (no halo): logits, the masked cross
    entropy and every parameter's gradient (``jax.grad``)."""
    b = _base()
    jtask, ttask = b["jtask"], b["ttask"]
    n = jtask.graph.num_nodes
    jcfg, tcfg = _cfgs(model)
    jadj = jgnn.make_local_adj(jtask.graph, n, backend)
    tadj = tgnn.make_local_adj(ttask.graph, n, backend, device="cpu")
    params_np = _params_np(model)
    feats = np.asarray(jtask.features, np.float32)
    labels, mask = jtask.labels, jtask.train_mask.astype(np.float32)

    def jloss(p):
        logits = jgnn.gnn_forward(jcfg, p, jadj, jnp.asarray(feats), None)
        return jgnn.cross_entropy_loss(logits, jnp.asarray(labels),
                                       jnp.asarray(mask)), logits
    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _jparams(params_np))
    tp = _tparams(params_np, grad=True)
    tlogits = tgnn.gnn_forward(tcfg, tp, tadj, torch.from_numpy(feats), None)
    tl = tgnn.cross_entropy_loss(tlogits, torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    tl.backward()
    _close(tlogits, jlogits, what="logits")
    assert abs(float(tl.detach()) - float(jl)) < TOL
    _close_tree([{k: v.grad for k, v in layer.items()} for layer in tp], jg,
                what="grads")


def test_gat_refuses_ell_and_hybrid_adjacency():
    b = _base()
    ttask = b["ttask"]
    n = ttask.graph.num_nodes
    tcfg = _cfgs("gat")[1]
    params = _tparams(_params_np("gat"))
    for backend, cls in (("ell", "EllAdj"), ("hybrid", "HybridAdj")):
        adj = tgnn.make_local_adj(ttask.graph, n, backend, device="cpu")
        with pytest.raises(NotImplementedError, match=cls):
            tgnn.gnn_forward(tcfg, params, adj,
                             torch.from_numpy(ttask.features), None)


@pytest.mark.parametrize("model", ["gin", "gat"])
def test_convert_carries_model_state(model):
    """``params_from_reference`` and ``opt_state_from_reference`` carry
    GIN's 0-d ``eps`` (and its Adam moments) and GAT's ``a_src``,
    ``a_dst`` and ``proj`` unchanged; the next Adam update from them
    equals the JAX package's."""
    from repro.optim import adam as jadam
    from repro_torch.convert import opt_state_from_reference
    from repro_torch.optim import adam
    params_np = _params_np(model)
    rng = np.random.default_rng(3)
    grads_np = [{k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in layer.items()} for layer in params_np]
    jopt, topt = jadam(1e-2), adam(1e-2)
    jp1, js1 = jopt.update(_jparams(grads_np), jopt.init(_jparams(params_np)),
                           _jparams(params_np))
    tp1 = params_from_reference(jax.tree.map(np.asarray, jp1), device="cpu")
    ts1 = opt_state_from_reference(js1, device="cpu")
    for got, want in ((tp1, jp1), (ts1.mu, js1.mu), (ts1.nu, js1.nu)):
        for layer, wlayer in zip(got, want):
            assert set(layer) == set(wlayer)
            for k in wlayer:
                assert tuple(layer[k].shape) == wlayer[k].shape, k
                np.testing.assert_array_equal(layer[k].numpy(),
                                              np.asarray(wlayer[k]))
    assert int(ts1.count) == int(js1.count) == 1
    jp2, _ = jopt.update(_jparams(grads_np), js1, jp1)
    tp2, _ = topt.update(params_from_reference(grads_np, device="cpu"), ts1,
                         tp1)
    _close_tree(tp2, jp2, what="second Adam step")


# ---------------------------------------------------------------------------
# the sim runtime
# ---------------------------------------------------------------------------

def _stacked(backend):
    key = ("sp", backend)
    if key not in _CACHE:
        b = _base()
        _CACHE[key] = (
            jdist.stack_partitions(b["jps"], b["jtask"], backend=backend),
            stack_partitions(b["tps"], b["ttask"], backend=backend))
    return _CACHE[key]


def _spec_kw(backend, halo_dtype="f32", **kw):
    return dict(backend=backend, halo_dtype=halo_dtype, pipeline=True,
                refresh_every=2, **kw)


def _port_run(model, backend, **kw):
    """The port's sim: fresh logits and the :data:`SCHEDULE` steps of
    ``sgd(0.5)`` from the JAX parameters."""
    key = ("port", model, backend, tuple(sorted(kw.items())))
    if key not in _CACHE:
        b = _base()
        tcfg = _cfgs(model)[1]
        spec = TrainSpec(**_spec_kw(backend, **kw))
        rt = make_sim_runtime(tcfg, _stacked(backend)[1], b["tx"], sgd(0.5),
                              spec=spec, device="cpu")
        params = _tparams(_params_np(model))
        logits = rt.forward_fresh(params).numpy()
        p, rep = train_capgnn(tcfg, rt, b["tx"], P, sgd(0.5),
                              epochs=len(SCHEDULE), params0=params,
                              spec=spec)
        _CACHE[key] = (logits, p, rep)
    return _CACHE[key]


def _jax_run(model, backend, halo_dtype="f32"):
    key = ("jax", model, backend, halo_dtype)
    if key not in _CACHE:
        b = _base()
        jcfg = _cfgs(model)[0]
        jspec = JSpec(**_spec_kw(backend, halo_dtype), donate=False)
        jrt = jdist.make_sim_runtime(jcfg, _stacked(backend)[0], b["jx"],
                                     jsgd(0.5), spec=jspec)
        params = _jparams(_params_np(model))
        logits = np.asarray(jrt.forward_fresh(params))
        p, rep = (None, None) if model == "gat" else jdist.train_capgnn(
            jcfg, jrt, b["jx"], P, jsgd(0.5), epochs=len(SCHEDULE),
            spec=jspec, params0=params)
        _CACHE[key] = (logits, p, rep)
    return _CACHE[key]


COUNTS = ("comm_bytes", "comm_bytes_vanilla", "comm_reduction",
          "refresh_steps", "cached_steps", "host_fetch_rows",
          "replan_events")


@pytest.mark.parametrize("backend", ["edges", "ell", "hybrid"])
@pytest.mark.parametrize("model", ["sage", "gin"])
def test_sim_runtime_matches_reference(model, backend):
    """Fresh logits; a refresh and a cached ``sgd`` step: every loss, the
    parameters after them, and every count exactly."""
    b = _base()
    assert b["tx"].uncached.n_rows and b["tx"].local.n_rows and \
        b["tx"].glob.n_unique, "the forced plan fills every tier"
    tlogits, tp, trep = _port_run(model, backend)
    jlogits, jp, jrep = _jax_run(model, backend)
    _close(tlogits, jlogits, what="forward_fresh")
    assert trep.step_kinds == SCHEDULE
    _close(trep.losses, jrep.losses, what="losses")
    _close_tree(tp, jp, what="params")
    for f in COUNTS:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.losses[-1] < trep.losses[0]


def test_sage_host_features_equal_device_bit_for_bit():
    """``features="host"`` (the halo table in the host store, staged per
    step): the device run's logits, losses and parameters bit for bit."""
    dev = _port_run("sage", "hybrid")
    host = _port_run("sage", "hybrid", features="host")
    np.testing.assert_array_equal(host[0], dev[0])
    assert host[2].losses == dev[2].losses
    for a, c in zip(host[1], dev[1]):
        for k in a:
            assert torch.equal(a[k], c[k]), k
    assert host[2].host_fetch_rows > 0 == dev[2].host_fetch_rows


def test_sage_bf16_wire_matches_reference():
    """The bf16 halo wire: the losses of JAX's bf16 run within 1e-5, and
    its counts."""
    _, _, trep = _port_run("sage", "hybrid", halo_dtype="bf16")
    _, _, jrep = _jax_run("sage", "hybrid", "bf16")
    _close(trep.losses, jrep.losses, what="bf16 losses")
    for f in COUNTS:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.comm_bytes == _port_run("sage", "hybrid")[2].comm_bytes // 2


def test_gat_stacked_forward_fresh_matches_reference():
    """The stacked runtime's GAT logits (the reference's forward is
    finite; its padding edges go wrong only in the backward)."""
    tlogits = _port_run("gat", "edges")[0]
    jlogits = _jax_run("gat", "edges")[0]
    assert np.isfinite(jlogits).all()
    _close(tlogits, jlogits, what="GAT forward_fresh")


def _gat_layer_inputs():
    """Layer 0 of GAT on each partition of the stacked edge list: its
    ``[n_local, 12]`` input and output cotangent, random."""
    jsp = _stacked("edges")[0]
    ni, nh = jsp.n_inner_max, jsp.n_halo_max
    rng = np.random.default_rng(5)
    h = rng.normal(size=(P, ni + nh, 12)).astype(np.float32)
    g = rng.normal(size=(P, ni, 16)).astype(np.float32)
    return jsp, h, g


def _jgat_layer_grads(jadj, h, g, p0):
    jcfg = _cfgs("gat")[0]
    ni, nl = jadj.n_rows, jadj.n_cols

    @jax.jit
    def f(p, src, dst, w):
        adj = jgnn.EdgeListAdj(src, dst, w, ni, nl)

        def loss(p_):
            out = jgnn._layer_apply(jcfg, p_, adj, jnp.asarray(h), ni, False)
            return jnp.sum(out * g), out
        return jax.value_and_grad(loss, has_aux=True)(p)
    (_, out), grads = f(p0, jadj.src, jadj.dst, jadj.weight)
    return np.asarray(out), grads


def _tgat_layer_grads(tadj, h, g, p0_np):
    tcfg = _cfgs("gat")[1]
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in p0_np.items()}
    out = tgnn._layer_apply(tcfg, p, tadj, torch.from_numpy(h), tadj.n_rows,
                            False)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), {k: v.grad for k, v in p.items()}


def test_gat_trimmed_partition_layers_match_reference():
    """Each partition's GAT layer over its stacked edge list trimmed to
    ``dst < n_inner_max``, where the reference is finite: output and
    gradients within 1e-5; the port's layer over the padded list gives
    the same.  The reference's own padded list gives non-finite
    gradients where the partition has fewer inner rows than the stack's
    width."""
    jsp, h, g = _gat_layer_inputs()
    ni, nl = jsp.n_inner_max, jsp.n_inner_max + jsp.n_halo_max
    p0_np = _params_np("gat")[0]
    nonfinite = []
    for i in range(P):
        src, dst, w = jsp.e_src[i], jsp.e_dst[i], jsp.e_w[i]
        keep = dst < ni
        jadj = jgnn.EdgeListAdj(jnp.asarray(src[keep]), jnp.asarray(dst[keep]),
                                jnp.asarray(w[keep]), ni, nl)
        jout, jg = _jgat_layer_grads(jadj, h[i], g[i], _jparams(p0_np))
        for trim in (keep, np.ones_like(keep)):
            tadj = tgnn.EdgeListAdj(
                torch.from_numpy(src[trim].astype(np.int64)),
                torch.from_numpy(dst[trim].astype(np.int64)),
                torch.from_numpy(w[trim]), ni, nl)
            tout, tg = _tgat_layer_grads(tadj, h[i], g[i], p0_np)
            _close(tout, jout, what=f"partition {i} output")
            _close_tree([tg], [jg], what=f"partition {i}")
        jpad = jgnn.EdgeListAdj(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(w), ni, nl)
        _, jgpad = _jgat_layer_grads(jpad, h[i], g[i], _jparams(p0_np))
        nonfinite.append(not all(np.isfinite(np.asarray(v)).all()
                                 for v in jgpad.values()))
    n_inner = np.asarray(jsp.n_inner)
    assert (n_inner < ni).any() and (jsp.e_dst == ni).any()
    assert nonfinite == list(n_inner < ni), (nonfinite, n_inner, ni)


def test_gat_stacked_grads_finite_and_per_partition_sum():
    """The port's stacked GAT layer (all partitions in one ``[P, ...]``
    call, padding edges included): output as each partition's, and
    parameter gradients finite and equal to the sum over partitions of
    the trimmed lists' gradients."""
    jsp, h, g = _gat_layer_inputs()
    tsp = _stacked("edges")[1]
    ni, nl = tsp.n_inner_max, tsp.n_inner_max + tsp.n_halo_max
    p0_np = _params_np("gat")[0]
    tadj = tgnn.EdgeListAdj(torch.from_numpy(tsp.e_src.astype(np.int64)),
                            torch.from_numpy(tsp.e_dst.astype(np.int64)),
                            torch.from_numpy(tsp.e_w), ni, nl)
    out, grads = _tgat_layer_grads(tadj, h, g, p0_np)
    want = {k: 0.0 for k in p0_np}
    for i in range(P):
        keep = tsp.e_dst[i] < ni
        one = tgnn.EdgeListAdj(
            torch.from_numpy(tsp.e_src[i][keep].astype(np.int64)),
            torch.from_numpy(tsp.e_dst[i][keep].astype(np.int64)),
            torch.from_numpy(tsp.e_w[i][keep]), ni, nl)
        o, gi = _tgat_layer_grads(one, h[i], g[i], p0_np)
        _close(out[i], o, what=f"partition {i}")
        want = {k: want[k] + gi[k] for k in want}
    for k, v in grads.items():
        assert torch.isfinite(v).all(), k
        _close(v, want[k], what=k)


def test_gat_stacked_grads_equal_full_graph():
    """Every tier fresh (``loss_and_grads`` with no stale read): the
    partitioned GAT equals the full graph, so the port's stacked
    gradients equal the JAX package's full-graph ``jax.grad`` (on the
    partition before any re-balancing, as ``tests/test_system.py``)."""
    b = _base()
    jtask = b["jtask"]
    jcfg, tcfg = _cfgs("gat")
    params_np = _params_np("gat")
    rt = make_sim_runtime(tcfg, _stacked("edges")[1], b["tx"], sgd(0.5),
                          spec=TrainSpec(**_spec_kw("edges")), device="cpu")
    loss, grads = rt.loss_and_grads(_tparams(params_np), rt.caches0)
    adj = jgnn.make_local_adj(jtask.graph, jtask.graph.num_nodes, "edges")

    def jloss(p):
        logits = jgnn.gnn_forward(jcfg, p, adj, jnp.asarray(jtask.features),
                                  None)
        return jgnn.cross_entropy_loss(logits, jnp.asarray(jtask.labels),
                                       jnp.asarray(jtask.train_mask,
                                                   jnp.float32))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(_jparams(params_np))
    assert abs(float(loss) - float(jl)) < TOL
    _close_tree(grads, jg, what="GAT grads")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["sage", "gin"])
def test_precompute_tables_match_reference(model):
    b = _base()
    jcfg, tcfg = _cfgs(model)
    params_np = _params_np(model)
    jsp, tsp = _stacked("hybrid")
    jstore = jserve.precompute_embeddings(jcfg, b["jps"], jsp, b["jx"],
                                          _jparams(params_np),
                                          backend="hybrid", interpret=True)
    tstore = precompute_embeddings(tcfg, b["tps"], tsp, b["tx"],
                                   _tparams(params_np), backend="hybrid",
                                   device="cpu")
    for layer, (got, want) in enumerate(zip(tstore.tables, jstore.tables)):
        _close(got, want, what=f"table {layer}")
    _CACHE[("stores", model)] = (jstore, tstore)


def test_sage_fresh_recompute_matches_reference():
    """After ``update_features``, stale queries recompute over the
    engine's ``EdgeListAdj`` (SAGE's ``degree`` of the subgraph)."""
    if ("stores", "sage") not in _CACHE:
        test_precompute_tables_match_reference("sage")
    jstore, tstore = _CACHE[("stores", "sage")]
    b = _base()
    g, feats = b["jtask"].graph, b["jtask"].features
    params_np = _params_np("sage")
    hot = jserve.rank_hot_nodes(g, 40, ps=b["jps"], policy="degree")
    je = jserve.GNNServeEngine(jstore, _jparams(params_np), g, hot,
                               features=feats)
    te = GNNServeEngine(tstore, _tparams(params_np), b["ttask"].graph, hot,
                        features=feats, device="cpu")
    upd = np.array([5, 77, 200])
    for e in (je, te):
        e.update_features(upd, feats[upd] + 1.5)
    q = np.arange(0, g.num_nodes, 3)
    _close(te.query(q), je.query(q), what="queries")
    assert te.stats["fresh_recomputes"] == je.stats["fresh_recomputes"] > 0


# ---------------------------------------------------------------------------
# the CLIs, with the JAX package's parameters
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--scale", "0.02", "--feat-dim", "16", "--hidden", "16",
              "--layers", "2", "--epochs", "2", "--refresh-every", "2"]


def _reference_init(monkeypatch, module, seed):
    """Make the port's CLI start from the JAX package's ``init_gnn`` of
    ``seed`` (``jax.random`` cannot be replayed)."""
    def init(cfg, generator, device="cuda"):
        jcfg = jgnn.GNNConfig(**{f: getattr(cfg, f) for f in (
            "model", "in_dim", "hidden_dim", "out_dim", "num_layers",
            "num_heads", "residual")})
        jp = jgnn.init_gnn(jax.random.PRNGKey(seed), jcfg)
        return params_from_reference(
            [{k: np.asarray(v) for k, v in layer.items()} for layer in jp],
            device=device)
    monkeypatch.setattr(module, "init_gnn", init)


@pytest.mark.parametrize("model", ["sage", "gat", "gin"])
def test_train_cli_matches_reference(model, monkeypatch, capsys):
    """``launch.train gnn --model`` of both packages on the same flags and
    parameters: the same keys and counts; SAGE's and GIN's final loss
    within 1e-5.  The JAX package's GAT turns non-finite after its first
    step (its padding edges' gradient); the port's stays finite."""
    argv = TRAIN_ARGV + ["--model", model]
    jargs = argparse.Namespace(**{**vars(tlaunch_train.build_parser()
                                         .parse_args(["gnn", *argv])),
                                  "cmd": "gnn"})
    del jargs.device
    want = jlaunch_train.run_gnn(jargs)
    capsys.readouterr()
    _reference_init(monkeypatch, tsim, seed=0)
    got = tlaunch_train.main(["gnn", "--device", "cpu", *argv])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
    assert set(got) == set(want)
    for k in ("model", "parts", "inner_sizes", "epochs", "comm_bytes",
              "comm_reduction_vs_vanilla", "refresh_steps",
              "cached_steps", "host_fetch_rows"):
        assert got[k] == want[k], k
    assert np.isfinite(got["final_loss"])
    if model == "gat":
        assert not np.isfinite(want["final_loss"])
    else:
        assert abs(got["final_loss"] - want["final_loss"]) < TOL
        assert abs(got["test_acc"] - want["test_acc"]) < 1e-6


def test_serve_cli_sage_hybrid_matches_reference(monkeypatch, capsys):
    argv = ["--scale", "0.02", "--feat-dim", "16", "--hidden", "16",
            "--model", "sage", "--backend", "hybrid", "--queries", "256"]
    jargs = argparse.Namespace(**{**vars(tlaunch_serve.build_parser()
                                         .parse_args(["gnn", *argv])),
                                  "cmd": "gnn"})
    del jargs.device
    want = jlaunch_serve.run_gnn(jargs)
    capsys.readouterr()
    _reference_init(monkeypatch, tgnn, seed=0)
    got = tlaunch_serve.main(["gnn", "--device", "cpu", *argv])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
    assert set(got) == set(want)
    for k in ("model", "backend", "parts", "nodes", "layers",
              "hot_capacity", "stale_nodes", "queries", "batches",
              "mean_batch", "hot_hit_rate", "host_hit_rate", "fresh_rate"):
        assert got[k] == want[k], k
