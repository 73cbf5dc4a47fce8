"""The small runs the port's fault and tracer tests hold against the JAX
package's (``tests/test_faults.py``'s graph): rmat 260 / 1,500, 12
features, 4 classes, 2 METIS parts, GCN 12 -> 16 -> 4, JACA at the
rtx3090 profile, ``refresh_every=2``, 8 Adam steps from the JAX package's
``init_gnn`` at seed 0 (carried across with ``params_from_reference``).

Each run is made once a test process and cached.  A run returns its
report, its tracer (None untraced) and its runtime.
"""
import jax
import numpy as np

import repro.core as jcore
import repro.dist as jdist
import repro.graph as jgraph
from repro.data.gnn_data import FullBatchTask as JTask, split_masks as jsplit
from repro.dist.spec import TrainSpec as JSpec
from repro.faults import FaultPlan as JFaultPlan, GuardConfig as JGuard
from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
from repro.obs import Tracer as JTracer
from repro.optim import adam as jadam
import repro_torch.core as tcore
import repro_torch.dist as tdist
import repro_torch.graph as tgraph
from repro_torch.convert import params_from_reference
from repro_torch.data.gnn_data import FullBatchTask, split_masks
from repro_torch.dist import TrainSpec, make_sim_runtime, train_capgnn
from repro_torch.faults import FaultPlan, GuardConfig
from repro_torch.models.gnn import GNNConfig
from repro_torch.obs import Tracer
from repro_torch.optim import adam

PARTS = 2
EPOCHS = 8
REFRESH_EVERY = 2
LR = 0.01
CFG_KW = dict(model="gcn", in_dim=12, hidden_dim=16, out_dim=4,
              num_layers=2)
_CACHE: dict = {}


def setup(pkg: str, policy=None):
    """``(cfg, stacked layout, exchange plan, planner)`` of one package
    (``"jax"`` or ``"torch"``); a fresh planner under ``policy``."""
    core, graph, dist, task_cls, split, cfg_cls = (
        (jcore, jgraph, jdist, JTask, jsplit, JConfig) if pkg == "jax" else
        (tcore, tgraph, tdist, FullBatchTask, split_masks, GNNConfig))
    g = graph.rmat(260, 1500, seed=5)
    feats, labels = graph.synth_features(g, 12, 4, seed=5)
    gn = graph.symmetric_normalize(g)
    tr, va, te = split(g.num_nodes, seed=5)
    task = task_cls(graph=gn, features=feats, labels=labels, train_mask=tr,
                    val_mask=va, test_mask=te, num_classes=4)
    ps = graph.build_partition(gn, graph.metis_partition(gn, PARTS, seed=5),
                               hops=1)
    cfg = cfg_cls(**CFG_KW)
    cap = core.cal_capacity(ps, cfg.feat_dims,
                            [core.PROFILES["rtx3090"]] * PARTS,
                            m_cpu_gib=1.0)
    planner = None
    if policy:
        planner = core.AdaptivePlanner(ps, cap, refresh_every=REFRESH_EVERY,
                                       policy=policy, seed=5)
        xplan = planner.exchange_plan()
    else:
        xplan = dist.build_exchange_plan(ps, core.build_cache_plan(
            ps, cap, refresh_every=REFRESH_EVERY))
    return cfg, dist.stack_partitions(ps, task), xplan, planner


def params_np():
    if "params" not in _CACHE:
        _CACHE["params"] = [{k: np.asarray(v) for k, v in layer.items()}
                            for layer in jinit(jax.random.PRNGKey(0),
                                               JConfig(**CFG_KW))]
    return _CACHE["params"]


def jax_run(features="host", spec=None, guard_kw=None, policy=None,
            traced=False):
    """The JAX package's ``train_capgnn`` of the configuration."""
    key = ("jax", features, spec, tuple(sorted((guard_kw or {}).items())),
           policy, traced)
    if key not in _CACHE:
        cfg, sp, xplan, planner = setup("jax", policy)
        opt = jadam(LR)
        jspec = JSpec(features=features, refresh_every=REFRESH_EVERY,
                      donate=False)
        rt = jdist.make_sim_runtime(cfg, sp, xplan, opt, spec=jspec)
        tr = JTracer() if traced else None
        _, rep = jdist.train_capgnn(
            cfg, rt, xplan, PARTS, opt, epochs=EPOCHS,
            controller=jcore.StalenessController(
                refresh_every=REFRESH_EVERY),
            planner=planner, tracer=tr, spec=jspec,
            faults=(JFaultPlan.parse(spec, seed=0) if spec is not None
                    else None),
            guard=JGuard(**guard_kw) if guard_kw is not None else None)
        _CACHE[key] = (rep, tr, rt)
    return _CACHE[key]


def torch_run(features="host", spec=None, guard_kw=None, policy=None,
              traced=False):
    """The port's ``train_capgnn`` of the configuration, on the CPU
    (``spec=""`` passes the disabled plan, ``None`` no plan)."""
    key = ("torch", features, spec, tuple(sorted((guard_kw or {}).items())),
           policy, traced)
    if key not in _CACHE:
        cfg, sp, xplan, planner = setup("torch", policy)
        opt = adam(LR)
        tspec = TrainSpec(features=features, refresh_every=REFRESH_EVERY)
        rt = make_sim_runtime(cfg, sp, xplan, opt, spec=tspec, device="cpu")
        tr = Tracer() if traced else None
        _, rep = train_capgnn(
            cfg, rt, xplan, PARTS, opt, epochs=EPOCHS,
            controller=tcore.StalenessController(
                refresh_every=REFRESH_EVERY),
            params0=params_from_reference(params_np(), device="cpu"),
            planner=planner, tracer=tr, spec=tspec,
            faults=FaultPlan.parse(spec, seed=0) if spec is not None else None,
            guard=GuardConfig(**guard_kw) if guard_kw is not None else None)
        _CACHE[key] = (rep, tr, rt)
    return _CACHE[key]
