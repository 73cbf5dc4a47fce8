"""The port's sharded decode and training step against the JAX package,
on 4 gloo ranks on the CPU as a 2 x 2 ``("data", "model")`` mesh
(reduced configs in f32).

- 8 ``serve_step``s at B = 4 into 16-slot caches laid out by
  ``decode_state_specs``: qwen3 against the JAX package's single-device
  decode, mixtral (expert-parallel: its 4 experts over the 2-way model
  axis, capacity per device block) against the JAX package's own SPMD
  decode on the same forced mesh; every step's logits and the final
  caches within 1e-5 of the largest magnitude;
- one AdamW ``train_step_fn`` step of qwen3 with ZeRO-1 moments (the
  optimizer state laid out by ``param_specs(zero_data=True)``): the
  parameters afterwards equal the JAX step's.  Adam's first update is
  ``lr * g / (|g| + eps)``, which turns a gradient's rounding ``d`` into
  up to ``lr * d / eps`` (at the default eps 1e-8, f32 rounding of a
  ~1e-8 gradient moves a parameter by ~1e-4, in either package alone);
  the step runs at eps 1e-4, which bounds that by ``lr * 1e4 * d``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.transformer import (init_decode_cache, init_model,
                                      serve_step, train_step_fn)
from repro.optim import adamw
from repro_torch.launch.mesh import spawn
from torch_lm_common import f32_configs
from torch_lm_spmd_ranks import lm_cases_rank
from torch_threads import torch_threads_per_worker  # noqa: F401

_SCRIPT = os.path.join(os.path.dirname(__file__),
                       "lm_spmd_reference_script.py")
TOL = 1e-5
B, W, STEPS, LR, EPS = 4, 16, 8, 1e-3, 1e-4


def _flat(tree, prefix):
    from repro.launch.sharding import _path_names
    return {prefix + "/" + "/".join(_path_names(p)): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm_spmd_decode") / "ref.npz")
    proc = subprocess.Popen(
        [sys.executable, _SCRIPT, out, "decode:mixtral-8x7b:2x2"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    want, cases = {}, []
    for arch in ("qwen3-1.7b", "mixtral-8x7b"):
        jcfg, _ = f32_configs(arch)
        jp = init_model(jax.random.PRNGKey(0), jcfg)
        toks = _tokens(jcfg, B, STEPS)["tokens"]
        cases.append(dict(name=f"decode-{arch}", arch=arch, mesh=(2, 2),
                          kind="decode", batch_size=B, cache_len=W,
                          tokens=toks, params=jax.tree.map(np.asarray, jp)))
        if arch == "qwen3-1.7b":
            caches = init_decode_cache(jcfg, B, W)
            step = jax.jit(lambda p, c, t, i: serve_step(jcfg, p, c, t, i))
            w = {}
            for i in range(STEPS):
                logits, caches = step(jp, caches,
                                      jnp.asarray(toks[:, i:i + 1]),
                                      jnp.int32(i))
                w[f"logits{i}"] = np.asarray(logits)
            w.update(_flat(caches, "caches"))
            want[f"decode-{arch}"] = w
    jcfg, _ = f32_configs("qwen3-1.7b")
    jp = init_model(jax.random.PRNGKey(0), jcfg)
    arrs = _tokens(jcfg, B, 32)
    opt = adamw(LR, eps=EPS)
    p2, _, met = jax.jit(train_step_fn(jcfg, opt))(
        jp, opt.init(jp), {k: jnp.asarray(v) for k, v in arrs.items()})
    want["train-qwen3"] = dict(_flat(p2, "params"),
                               loss=np.asarray(met["loss"]))
    cases.append(dict(name="train-qwen3", arch="qwen3-1.7b", mesh=(2, 2),
                      kind="train", lr=LR, eps=EPS, batch=arrs,
                      params=jax.tree.map(np.asarray, jp)))
    got = spawn(lm_cases_rank, 4, backend="gloo", devices="cpu",
                args=(cases,))[0]
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    ref = np.load(out)
    want["decode-mixtral-8x7b"] = {k.split("|")[1]: ref[k] for k in ref.files}
    return got, want


def _close(got, want, keys, what):
    scale = max(float(np.abs(want[k]).max()) for k in keys)
    for k in keys:
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= TOL * max(scale, 1.0), (what, k, err, scale)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b"])
def test_sharded_decode_matches(runs, arch):
    got, want = runs
    name = f"decode-{arch}"
    _close(got[name], want[name], [f"logits{i}" for i in range(STEPS)], name)
    keys = sorted(k for k in want[name] if k.startswith("caches/"))
    assert sorted(k for k in got[name] if k.startswith("caches/")) == keys
    for k in keys:
        _close(got[name], want[name], [k], name)


def test_zero1_adamw_step_matches(runs):
    got, want = runs
    g, w = got["train-qwen3"], want["train-qwen3"]
    _close(g, w, ["loss"], "loss")
    keys = sorted(k for k in w if k.startswith("params/"))
    assert sorted(k for k in g if k.startswith("params/")) == keys
    for k in keys:
        _close(g, w, [k], "params")
