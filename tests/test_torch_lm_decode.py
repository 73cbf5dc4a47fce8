"""The port's transformer decode path (``init_decode_cache`` /
``serve_step``) against the JAX package's, on the CPU.

Reduced configs in f32 from the JAX package's parameters
(``torch_lm_common``), within 1e-5:

- every architecture: 8 ``serve_step`` calls from an empty cache, each
  step's logits and the final caches (KV ring buffers and their ``pos``,
  MLA's compressed cache, the mLSTM / sLSTM states, the Mamba state and
  conv window);
- the sliding-window ring buffer past its width (a window of 4, 8 steps:
  the slots wrap twice, never-written slots stay masked) for mixtral and
  hymba;
- the port's own decode against its own prefill: in f32 within 1e-4 of
  the largest logit (the dense, SSM and hybrid architectures: an MoE
  drops tokens past each expert's capacity, and a capacity counted over 8
  prefill tokens is not one counted over a single decode token); in bf16
  (the configs' dtype) at the reference's bar (``tests/test_archs_smoke.py``:
  top-1 agreement >= 0.75, within 0.12), every architecture but
  phi-3-vision, whose prefix the reference holds in prefill only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.transformer import (init_decode_cache as jcache,
                                      serve_step as jserve)
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import (forward, init_decode_cache,
                                            init_model, serve_step)
from torch_lm_common import (TOL, assert_trees_close, f32_configs, max_err,
                             reference_params)
from torch_threads import torch_threads_per_worker  # noqa: F401

ARCH_IDS = jconfigs.ARCH_IDS
STEPS = 8


def _decode_both(arch, max_len, **overrides):
    jcfg, cfg = f32_configs(arch, **overrides)
    jp, tp = reference_params(jcfg, seed=1)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, STEPS)).astype(np.int32)
    jc = jcache(jcfg, 2, max_len)
    tc = init_decode_cache(cfg, 2, max_len, "cpu")
    assert_trees_close(tc, jc, what="empty cache")
    step = jax.jit(lambda p, c, t, pos: jserve(jcfg, p, c, t, pos))
    for t in range(STEPS):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = serve_step(cfg, tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                            t)
        assert max_err(tl, jl) <= TOL, (arch, t, max_err(tl, jl))
    assert_trees_close(tc, jc, what=f"{arch} caches")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_steps_and_caches_match_reference(arch):
    _decode_both(arch, max_len=12)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "hymba_1_5b"])
def test_ring_cache_wraps_like_reference(arch):
    _decode_both(arch, max_len=12, attn_window=4)


def _decode_vs_prefill(cfg, seed: int):
    params = init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, STEPS)))
    full, _ = forward(cfg, params, {"tokens": toks})
    caches = init_decode_cache(cfg, 1, STEPS, "cpu")
    outs = []
    for t in range(STEPS):
        lg, caches = serve_step(cfg, params, caches, toks[:, t:t + 1], t)
        outs.append(lg[0].float())
    return torch.stack(outs).numpy(), full[0].float().numpy()


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if not get_reduced(a).n_experts])
def test_f32_decode_matches_prefill(arch):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    dec, ful = _decode_vs_prefill(cfg, seed=3)
    assert max_err(dec, ful) <= 1e-4 * np.abs(ful).max()


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if not get_reduced(a).vision_tokens])
def test_bf16_decode_matches_prefill(arch):
    cfg = get_reduced(arch)
    assert cfg.dtype == "bfloat16"
    dec, ful = _decode_vs_prefill(cfg, seed=3)
    assert np.isfinite(dec).all() and np.isfinite(ful).all()
    agree = (dec.argmax(-1) == ful.argmax(-1)).mean()
    assert agree >= 0.75, (arch, agree)
    np.testing.assert_allclose(dec, ful, rtol=0.12, atol=0.12)
