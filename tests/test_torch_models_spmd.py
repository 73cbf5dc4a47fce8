"""The port's SPMD runtime (``repro_torch.dist.capgnn_spmd``) with the
SAGE, GIN and GAT layers, on 4 gloo ranks on the CPU, against the port's
single-process runtime (which ``tests/test_torch_models.py`` holds
against the JAX package).

One spawn of 4 ranks (``torch_spmd_ranks.run_models``) runs, on the
graph and forced plan of ``tests/test_torch_models.py``, ``sage``
(``hybrid``, ``p2p``), ``gin`` (``ell``, ``allgather``), ``gat``
(``edges``, ``p2p``) and ``sage`` again on a 2 x 2 ``("pod", "data")``
mesh (``launch.mesh.make_mesh``).  Held: a refresh step's loss and every
gradient (GIN's 0-d ``eps`` included) within 1e-5 of the sim's, a
4-step ``train_capgnn`` run's losses and parameters within 1e-5 and its
counts equal, every step's counted rows summed over ranks equal to the
plan's; the mesh run equal to the flat run bit for bit, and its
``"data"`` axis alone each pod's pair of ranks.
"""
import numpy as np
import pytest

from repro_torch.dist import TrainSpec, make_sim_runtime, train_capgnn
from repro_torch.launch.mesh import spawn
from repro_torch.optim import sgd

import torch_spmd_ranks
from test_torch_models import (P, TOL, _base, _cfgs, _close, _close_tree,
                               _params_np, _spec_kw, _stacked, _tparams)
from torch_threads import torch_threads_per_worker  # noqa: F401

_CACHE: dict = {}


SPMD_CASES = {   # name: (model, backend, transport, mesh shape)
    "sage-hybrid-p2p": ("sage", "hybrid", "p2p", None),
    "gin-ell-allgather": ("gin", "ell", "allgather", None),
    "gat-edges-p2p": ("gat", "edges", "p2p", None),
    "sage-hybrid-p2p-2x2": ("sage", "hybrid", "p2p", (2, 2)),
}


def _spmd():
    if "spmd" not in _CACHE:
        b = _base()
        cases = []
        for name, (model, backend, transport, mesh) in SPMD_CASES.items():
            cases.append((name, _cfgs(model)[1], _stacked(backend)[1],
                          b["tx"], _spec_kw(backend, transport=transport),
                          _params_np(model), mesh))
        ranks = spawn(torch_spmd_ranks.run_models, P, backend="gloo",
                      devices="cpu", args=(cases,))
        _CACHE["spmd"] = ranks
    return _CACHE["spmd"]


def _sim_ref(model, backend, transport):
    """The port's sim at the SPMD case's spec: a refresh step's loss and
    gradients, and the same ``train_capgnn`` run."""
    b = _base()
    tcfg = _cfgs(model)[1]
    spec = TrainSpec(**_spec_kw(backend, transport=transport))
    rt = make_sim_runtime(tcfg, _stacked(backend)[1], b["tx"], sgd(0.5),
                          spec=spec, device="cpu")
    params = _tparams(_params_np(model))
    loss, grads = rt.loss_and_grads(params, rt.caches0)
    p, rep = train_capgnn(tcfg, rt, b["tx"], P, sgd(0.5),
                          epochs=torch_spmd_ranks.MODEL_EPOCHS,
                          params0=params, spec=spec)
    return loss, grads, p, rep


@pytest.mark.parametrize("name", [n for n, c in SPMD_CASES.items()
                                  if c[3] is None])
def test_spmd_models_match_sim(name):
    model, backend, transport, _ = SPMD_CASES[name]
    ranks = [r[name] for r in _spmd()]
    loss, grads, p, rep = _sim_ref(model, backend, transport)
    want = torch_spmd_ranks.train_fields(rep)
    assert want["step_kinds"] == ["refresh", "cached", "pipelined", "cached"]
    for r in ranks:
        assert abs(r["loss"] - float(loss)) < TOL
        _close_tree(r["grads"], grads, what="grads")
        _close(r["train"]["losses"], want["losses"], what="losses")
        _close_tree(r["params"], p, what="params")
        for f in ("comm_bytes", "comm_bytes_vanilla", "refresh_steps",
                  "cached_steps", "step_kinds"):
            assert r["train"][f] == want[f], f
    if model == "gin":
        assert r["grads"][0]["eps"].shape == ()
        assert r["grads"][0]["eps"] != 0.0
    # every step's rows, summed over ranks, those of the plan
    x, cfg = _base()["tx"], _cfgs(model)[1]
    for s, kind in enumerate(want["step_kinds"]):
        refresh = kind != "cached"
        valid = x.transport_rows(transport, refresh)
        padded = x.transport_rows(transport, refresh, padded=True)
        for li in range(1, cfg.num_layers):
            for t in ("uncached", "local", "global"):
                got = [sum(r["wire"][s].get((li, t), {}).get(f, 0)
                           for r in ranks)
                       for f in ("valid_rows", "padded_rows", "bytes")]
                assert got == [valid[t], padded[t],
                               valid[t] * cfg.feat_dims[li] * 4], \
                    (s, kind, li, t)


def test_spmd_multi_pod_mesh_equals_flat():
    """The ``("pod", "data")`` axis tuple on a 2 x 2 mesh: the flat run's
    losses, gradients, parameters and counts exactly; the ``"data"``
    axis alone is each pod's pair of ranks."""
    ranks = _spmd()
    for r in ranks:
        flat, pods = r["sage-hybrid-p2p"], r["sage-hybrid-p2p-2x2"]
        assert pods["train"] == flat["train"]
        assert pods["loss"] == flat["loss"]
        assert pods["wire"] == flat["wire"]
        for a, c in zip(pods["params"] + pods["grads"],
                        flat["params"] + flat["grads"]):
            for k in a:
                np.testing.assert_array_equal(a[k], c[k])
    assert [r["sage-hybrid-p2p-2x2"]["data_axis_sum"] for r in ranks] == \
        [1.0, 1.0, 5.0, 5.0]
