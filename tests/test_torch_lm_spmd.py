"""The port's sharded transformer zoo against the JAX package, on gloo
ranks on the CPU (reduced configs in f32, B = 4).

The port's parameters and batch are DTensors on a ``("data", "model")``
DeviceMesh laid out by ``launch.sharding``; its forward logits, ``aux``,
loss and gradients are gathered and held within 1e-5 of the largest
magnitude against:

- the JAX package's single-device model, where the sharded model computes
  the same function: dense qwen3 (baseline and block-SP) and
  Mamba-hybrid hymba (block-SP) on a 2 x 2 mesh, and a ``seq_shard``
  forward at B = 1;
- the JAX package's own SPMD run on the same forced mesh
  (``tests/lm_spmd_reference_script.py``), where capacity and ``aux`` are
  taken per device block or dp group: expert-parallel mixtral (with its
  window) and deepseek (MLA with a shared expert) on 2 x 2, and the
  per-dp-group dispatch of mixtral on 2 x 3 (4 experts over a 3-way model
  axis, S = 30).

One spawn of 4 ranks runs every 2 x 2 case, one of 6 ranks the 2 x 3 one,
while the JAX subprocess runs beside them.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.transformer import forward as jforward
from repro.models.transformer import loss_fn as jloss_fn
from repro_torch.launch.mesh import spawn
from torch_lm_common import f32_configs
from torch_lm_spmd_ranks import lm_cases_rank
from torch_threads import torch_threads_per_worker  # noqa: F401

_SCRIPT = os.path.join(os.path.dirname(__file__),
                       "lm_spmd_reference_script.py")
TOL = 1e-5        # of the largest magnitude

# name: (arch, mesh, S, mode, seq_shard, reference)
CASES = {
    "qwen3-baseline": ("qwen3-1.7b", (2, 2), 32, "baseline", False, "single"),
    "qwen3-block_sp": ("qwen3-1.7b", (2, 2), 32, "block_sp", False, "single"),
    "hymba-block_sp": ("hymba-1.5b", (2, 2), 32, "block_sp", False, "single"),
    "mixtral-ep": ("mixtral-8x7b", (2, 2), 32, "baseline", False, "spmd"),
    "deepseek-ep": ("deepseek-v3-671b", (2, 2), 32, "baseline", False,
                    "spmd"),
    "mixtral-groups": ("mixtral-8x7b", (2, 3), 30, "baseline", False, "spmd"),
}
SEQ_SHARD = ("qwen3-1.7b", (2, 2), 32)      # forward at B = 1


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _jparams(jcfg):
    from repro.models.transformer import init_model
    return init_model(jax.random.PRNGKey(0), jcfg)


def _flat(tree, prefix):
    from repro.launch.sharding import _path_names
    return {prefix + "/" + "/".join(_path_names(p)): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _single_device(jcfg, jp, arrs, grads=True):
    batch = {k: jnp.asarray(v) for k, v in arrs.items()}
    logits, aux = jax.jit(lambda p, b: jforward(jcfg, p, b))(jp, batch)
    out = {"logits": np.asarray(logits), "aux": np.asarray(aux)}
    if grads:
        (total, met), g = jax.jit(jax.value_and_grad(
            lambda p, b: jloss_fn(jcfg, p, b), has_aux=True))(jp, batch)
        out.update({"total": np.asarray(total),
                    "loss": np.asarray(met["loss"])})
        out.update(_flat(g, "grads"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm_spmd") / "ref.npz")
    spmd = [f"{a}:{m[0]}x{m[1]}:{s}" for a, m, s, _, _, ref in CASES.values()
            if ref == "spmd"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, _SCRIPT, out, *spmd], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    want, cases = {}, {2 * 2: [], 2 * 3: []}
    for name, (arch, mesh, s, mode, seq_shard, ref) in CASES.items():
        jcfg, _ = f32_configs(arch)
        jp = _jparams(jcfg)
        arrs = _batch(jcfg, 4, s)
        if ref == "single":
            want[name] = _single_device(jcfg, jp, arrs)
        cases[mesh[0] * mesh[1]].append(dict(
            name=name, arch=arch, mesh=mesh, kind="fwd", mode=mode,
            seq_shard=seq_shard, batch=arrs,
            params=jax.tree.map(np.asarray, jp)))
    arch, mesh, s = SEQ_SHARD
    jcfg, _ = f32_configs(arch)
    jp = _jparams(jcfg)
    arrs = _batch(jcfg, 1, s)
    want["qwen3-seq_shard"] = _single_device(jcfg, jp, arrs, grads=False)
    cases[4].append(dict(name="qwen3-seq_shard", arch=arch, mesh=mesh,
                         kind="prefill", seq_shard=True, batch=arrs,
                         params=jax.tree.map(np.asarray, jp)))
    got = {}
    for world, group in cases.items():
        got.update(spawn(lm_cases_rank, world, backend="gloo",
                         devices="cpu", args=(group,))[0])
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    ref = np.load(out)
    for key in ref.files:
        case, what = key.split("|")
        name = next(n for n, c in CASES.items()
                    if f"{c[0]}:{c[1][0]}x{c[1][1]}:{c[2]}" == case)
        want.setdefault(name, {})[what] = ref[key]
    return got, want


def _close(got, want, keys, what):
    scale = max(float(np.abs(want[k]).max()) for k in keys)
    for k in keys:
        err = float(np.abs(np.asarray(got[k], np.float64)
                           - np.asarray(want[k], np.float64)).max())
        assert err <= TOL * max(scale, 1.0), (what, k, err, scale)


@pytest.mark.parametrize("name", list(CASES) + ["qwen3-seq_shard"])
def test_sharded_forward_matches(runs, name):
    got, want = runs
    _close(got[name], want[name], ["logits"], name)
    _close(got[name], want[name], ["aux"], name)
    assert got[name]["logits"].shape == want[name]["logits"].shape


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_loss_and_grads_match(runs, name):
    got, want = runs
    g, w = got[name], want[name]
    _close(g, w, ["loss"], name)
    _close(g, w, ["total"], name)
    gk = sorted(k for k in w if k.startswith("grads/"))
    assert sorted(k for k in g if k.startswith("grads/")) == gk
    _close(g, w, gk, name)


def test_moe_cases_differ_from_single_device(runs):
    """The expert-parallel and per-group dispatches are held against the
    JAX package's SPMD run because they compute another function than
    the single-device model: per-block capacity and ``aux``."""
    got, _ = runs
    arch, mesh, s = CASES["mixtral-ep"][:3]
    jcfg, _ = f32_configs(arch)
    single = _single_device(jcfg, _jparams(jcfg), _batch(jcfg, 4, s),
                            grads=False)
    assert abs(float(got["mixtral-ep"]["aux"]) - float(single["aux"])) > 1e-4
