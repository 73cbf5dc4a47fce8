"""Shared helpers of the transformer-zoo parity tests (``test_torch_lm*.py``).

Both packages run ``dataclasses.replace(get_reduced(a), dtype="float32")``;
the parameters are the JAX package's ``init_model`` of one key, handed to
the port as numpy through ``convert.lm_params_from_reference``.  Trees
are compared leaf by leaf under their paths (dict keys, list and tuple
positions), never by flattening order alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jreduced
from repro.models.transformer import init_model as jinit
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_reference

TOL = 1e-5            # f32: logits, aux, losses, decode logits and caches
GRAD_TOL = 1e-5       # f32: of the largest gradient magnitude


def f32_configs(arch: str, **overrides):
    """The reduced config of ``arch`` in f32, in both packages."""
    return (dataclasses.replace(jreduced(arch), dtype="float32", **overrides),
            dataclasses.replace(get_reduced(arch), dtype="float32",
                                **overrides))


def reference_params(jcfg, seed: int = 0):
    """``(JAX params, the port's copy on the CPU)``."""
    jp = jinit(jax.random.PRNGKey(seed), jcfg)
    return jp, lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def batches(cfg, b: int, s: int, seed: int = 0):
    """The same batch for both packages: ``(jax_batch, torch_batch)``."""
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.vision_tokens:
        arrs["patches"] = rng.normal(
            size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def paths(tree, prefix: str = "") -> dict:
    """``{path: numpy array}`` over nested dicts, lists and tuples (named
    tuples: by field name) of JAX arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(paths(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        out = {}
        for name, v in zip(names, tree):
            out.update(paths(v, f"{prefix}/{name}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().float().numpy()
                if tree.dtype == torch.bfloat16 else tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def assert_trees_close(got, want, *, rel: float | None = None,
                       atol: float = TOL, what: str = "") -> None:
    """Same paths and shapes; every leaf within ``atol``, or within
    ``rel`` of the largest magnitude over the whole tree."""
    g, w = paths(got), paths(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    scale = max(float(np.abs(v).max()) for v in w.values() if v.size)
    tol = rel * scale if rel is not None else atol
    for k in w:
        assert g[k].shape == w[k].shape, (what, k, g[k].shape, w[k].shape)
        err = max_err(g[k], w[k])
        assert err <= tol, (what, k, err, tol)
