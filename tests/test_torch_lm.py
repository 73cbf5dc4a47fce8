"""The port's transformer zoo (``repro_torch.models.transformer``,
``repro_torch.configs``, ``nn.layers``, ``data.token_stream``) against the
JAX package's, on the CPU.

Every architecture of ``ARCH_IDS`` runs its reduced config in f32 in both
packages from the JAX package's parameters (``torch_lm_common``).  Held,
within 1e-5 unless stated:

- ``forward``: logits and ``aux``; ``loss_fn``: the total and its metrics;
  one ``train_step_fn`` step with ``sgd(1.0)``: the parameter change (the
  gradient) of every leaf, within 1e-5 of the largest;
- every chunked loop past one chunk: ``blocked_attention`` at S = 520
  (> 512), ``banded_attention`` at S = 520 past mixtral's window 64 (two
  band chunks; hymba's window 32 at S = 40 in the per-arch test), the
  mLSTM at S = 136 (> 128); and each primitive alone at small chunks,
  values and gradients;
- the xLSTM's gradient where the reference's is finite: the JAX package's
  mLSTM turns its gradient NaN once a 128-row chunk's masked decay
  overflows ``exp`` (from S = 128 on); the port masks before the ``exp``
  and stays finite;
- the full published configs: a ``torch.device("meta")`` build gives the
  tree, shapes and dtypes of ``jax.eval_shape(init_model)`` and the same
  exact ``param_count``; the registry, the configs, the layers, the token
  stream and the parameter conversion (bf16 through ``uint16``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.nn as jnn
from repro.models.transformer import (forward as jforward, loss_fn as jloss,
                                      param_count as jparam_count,
                                      train_step_fn as jstep_fn)
from repro.models.transformer import attention as jatt, ssm as jssm
from repro.models.transformer import init_model as jinit
from repro.optim import adamw as jadamw, sgd as jsgd
import repro_torch.configs as tconfigs
import repro_torch.data as tdata
import repro_torch.nn as tnn
from repro_torch.convert import (lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.models.transformer import (forward, init_model, loss_fn,
                                            param_count, train_step_fn)
from repro_torch.models.transformer import attention as tatt, ssm as tssm
from repro_torch.optim import sgd
from torch_lm_common import (GRAD_TOL, TOL, assert_trees_close, batches,
                             f32_configs, max_err, paths, reference_params)
from torch_threads import torch_threads_per_worker  # noqa: F401

ARCH_IDS = jconfigs.ARCH_IDS


def _step_delta(jcfg, cfg, jp, tp, jb, tb):
    """One ``train_step_fn`` step with ``sgd(1.0)`` in both packages:
    ``(JAX params - new params, the port's, JAX metrics, the port's)``."""
    jp2, _, jm = jax.jit(jstep_fn(jcfg, jsgd(1.0)))(jp, (), jb)
    tp2, _, tm = train_step_fn(cfg, sgd(1.0))(tp, (), tb)
    jd = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), jp, jp2)
    before = paths(tp)
    td = {k: before[k] - v for k, v in paths(tp2).items()}
    return paths(jd), td, jm, tm


def _check_model(arch: str, s: int, b: int = 2, **overrides):
    jcfg, cfg = f32_configs(arch, **overrides)
    jp, tp = reference_params(jcfg)
    jb, tb = batches(cfg, b, s)
    jl, ja = jax.jit(lambda p, x: jforward(jcfg, p, x))(jp, jb)
    tl, ta = forward(cfg, tp, tb)
    assert tl.shape == (b, s + cfg.vision_tokens, cfg.padded_vocab)
    assert max_err(tl, jl) <= TOL and abs(float(ta) - float(ja)) <= TOL
    jt, jm = jax.jit(lambda p, x: jloss(jcfg, p, x))(jp, jb)
    tt, tm = loss_fn(cfg, tp, tb)
    for got, want in ((tt, jt), (tm["loss"], jm["loss"]),
                      (tm["aux"], jm["aux"])):
        assert abs(float(got) - float(want)) <= TOL
    jd, td, jsm, tsm = _step_delta(jcfg, cfg, jp, tp, jb, tb)
    assert abs(float(tsm["loss"]) - float(jsm["loss"])) <= TOL
    return jd, td


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_loss_and_step_match_reference(arch):
    jd, td = _check_model(arch, s=40)
    assert_trees_close(td, jd, rel=GRAD_TOL, what=arch)


@pytest.mark.parametrize("arch,s", [("qwen3_1_7b", 520),
                                    ("mixtral_8x7b", 520)])
def test_chunked_attention_matches_reference(arch, s):
    """Two query chunks of 512 (blocked), two band chunks (mixtral's
    window 64 < S)."""
    jd, td = _check_model(arch, s=s, b=1)
    assert_trees_close(td, jd, rel=GRAD_TOL, what=arch)


def test_mlstm_past_one_chunk_matches_reference_where_finite():
    jd, td = _check_model("xlstm_350m", s=136, b=1)
    bad = sorted(k for k, v in jd.items() if not np.isfinite(v).all())
    assert bad, "the reference's mLSTM gradient is finite at S = 136"
    assert all(np.isfinite(v).all() for v in td.values())
    scale = max(np.abs(v).max() for k, v in jd.items() if k not in bad)
    for k, v in jd.items():
        if k not in bad:
            assert max_err(td[k], v) <= GRAD_TOL * scale, k


# ---------------------------------------------------------------------------
# the primitives alone, at small chunks
# ---------------------------------------------------------------------------

def _qkv(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _vjp_both(jfn, tfn, arrays, seed=1):
    """Values and the gradient of ``sum(out * w)`` for a random ``w``,
    in both packages."""
    jout = jfn(*[jnp.asarray(a) for a in arrays])
    w = np.random.default_rng(seed).normal(size=jout.shape).astype(np.float32)
    jg = jax.grad(lambda *xs: (jfn(*xs) * w).sum(), argnums=tuple(
        range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tout = tfn(*ts)
    tg = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), ts)
    return jout, tout, jg, tg


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_attention_small_chunks(causal):
    q, k, v = _qkv(2, 37, 4, 2, 8)
    kw = dict(causal=causal, q_chunk=16, k_chunk=8)
    jout, tout, jg, tg = _vjp_both(
        lambda *x: jatt.blocked_attention(*x, **kw),
        lambda *x: tatt.blocked_attention(*x, **kw), [q, k, v])
    assert max_err(tout.detach(), jout) <= TOL
    for a, b in zip(tg, jg):
        assert max_err(a, b) <= TOL


def test_banded_attention_and_decode_attention():
    q, k, v = _qkv(1, 45, 4, 2, 8, seed=2)
    jout, tout, jg, tg = _vjp_both(
        lambda *x: jatt.banded_attention(*x, 12, chunk=8),
        lambda *x: tatt.banded_attention(*x, 12, chunk=8), [q, k, v])
    assert max_err(tout.detach(), jout) <= TOL
    for a, b in zip(tg, jg):
        assert max_err(a, b) <= TOL
    qd = q[:, :1]
    for window in (None, 5):
        want = jatt.decode_attention(jnp.asarray(qd), jnp.asarray(k),
                                     jnp.asarray(v), jnp.int32(20),
                                     window=window)
        got = tatt.decode_attention(torch.from_numpy(qd), torch.from_numpy(k),
                                    torch.from_numpy(v), 20, window=window)
        assert max_err(got, want) <= TOL


def test_rope_rotates_interleaved_pairs():
    x = np.random.default_rng(3).normal(size=(2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(100, 107)
    want = jatt.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tatt.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    assert max_err(got, want) <= TOL
    at = tatt.rope_at(torch.from_numpy(x[:, :1]), 9, 1e4)
    assert max_err(at, jatt.rope_at(jnp.asarray(x[:, :1]), jnp.int32(9), 1e4)
                   ) <= TOL


def test_mlstm_chunked_and_step_small_chunks():
    rng = np.random.default_rng(4)
    b, s, h, d = 2, 21, 2, 4
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32)
              for _ in range(3)] + [rng.normal(size=(b, s, h)).astype(
                  np.float32) for _ in range(2)]
    jout, tout, jg, tg = _vjp_both(
        lambda *x: jssm.mlstm_chunked(*x, chunk=8)[0],
        lambda *x: tssm.mlstm_chunked(*x, chunk=8)[0], arrays)
    assert max_err(tout.detach(), jout) <= TOL
    for a, c in zip(tg, jg):
        assert max_err(a, c) <= TOL
    jy, jst = jssm.mlstm_chunked(*[jnp.asarray(a) for a in arrays], chunk=8)
    one = [a[:, :1] for a in arrays]
    jy1, jst1 = jssm.mlstm_step(jst, *[jnp.asarray(a) for a in one])
    ty, tst = tssm.mlstm_chunked(*[torch.from_numpy(a) for a in arrays],
                                 chunk=8)
    ty1, tst1 = tssm.mlstm_step(tst, *[torch.from_numpy(a) for a in one])
    assert type(tst1) is tssm.MlstmState
    assert max_err(ty1, jy1) <= TOL
    assert_trees_close(tst1, jst1)


def test_selective_scan_and_slstm_scan():
    rng = np.random.default_rng(5)
    b, s, di, n = 2, 9, 6, 3
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    delta = np.abs(rng.normal(size=(b, s, di))).astype(np.float32) * 0.1
    a_log = rng.normal(size=(di, n)).astype(np.float32)
    bc = [rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2)]
    d_skip = rng.normal(size=(di,)).astype(np.float32)
    arrays = [x, delta, a_log, *bc, d_skip]
    jout, tout, jg, tg = _vjp_both(lambda *z: jssm.selective_scan(*z)[0],
                                   lambda *z: tssm.selective_scan(*z)[0],
                                   arrays)
    assert max_err(tout.detach(), jout) <= TOL
    for a, c in zip(tg, jg):
        assert max_err(a, c) <= TOL
    _, jh = jssm.selective_scan(*[jnp.asarray(a) for a in arrays])
    _, th = tssm.selective_scan(*[torch.from_numpy(a) for a in arrays])
    step = [x[:, 0], delta[:, 0], a_log, bc[0][:, 0], bc[1][:, 0], d_skip]
    jy, jh2 = jssm.selective_scan_step(jh, *[jnp.asarray(a) for a in step])
    ty, th2 = tssm.selective_scan_step(th, *[torch.from_numpy(a)
                                             for a in step])
    assert max_err(ty, jy) <= TOL and max_err(th2, jh2) <= TOL

    hds, dh = 2, 3
    gx = rng.normal(size=(b, s, 4 * hds * dh)).astype(np.float32)
    r = (rng.normal(size=(hds, 4, dh, dh)) * 0.3).astype(np.float32)
    jout, tout, jg, tg = _vjp_both(lambda g, rr: jssm.slstm_scan(g, rr, hds)[0],
                                   lambda g, rr: tssm.slstm_scan(g, rr, hds)[0],
                                   [gx, r])
    assert max_err(tout.detach(), jout) <= TOL
    for a, c in zip(tg, jg):
        assert max_err(a, c) <= TOL
    _, jst = jssm.slstm_scan(jnp.asarray(gx), jnp.asarray(r), hds)
    _, tst = tssm.slstm_scan(torch.from_numpy(gx), torch.from_numpy(r), hds)
    jy, jst2 = jssm.slstm_step(jst, jnp.asarray(gx[:, 0]), jnp.asarray(r), hds)
    ty, tst2 = tssm.slstm_step(tst, torch.from_numpy(gx[:, 0]),
                               torch.from_numpy(r), hds)
    assert max_err(ty, jy) <= TOL
    assert_trees_close(tst2, jst2)


# ---------------------------------------------------------------------------
# the published configs, on the meta device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_tree_of_full_config_matches_eval_shape(arch):
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tconfigs.get_reduced(arch)) == \
        dataclasses.asdict(jconfigs.get_reduced(arch))
    want = jax.eval_shape(lambda k: jinit(k, jcfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    got = init_model(cfg, None, device="meta")
    w = {k: v for k, v in _shape_paths(want).items()}
    g = _shape_paths(got)
    assert g == w
    assert param_count(cfg) == jparam_count(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def _shape_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _shape_paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _shape_paths(t, f"{prefix}/{i}").items()}
    dtype = str(tree.dtype).replace("torch.", "")
    return {prefix: (tuple(tree.shape), dtype)}


def test_registry_matches_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.INPUT_SHAPES == jconfigs.INPUT_SHAPES
    assert tconfigs.list_configs() == jconfigs.list_configs()
    for alias in ("qwen3-1.7b", "phi-3-vision-4.2b", "codeqwen1.5-7b",
                  "some-new.model"):
        assert tconfigs.canonical(alias) == jconfigs.canonical(alias)
    for arch in ARCH_IDS:
        got = tconfigs.long_context_variant(tconfigs.get_config(arch))
        want = jconfigs.long_context_variant(jconfigs.get_config(arch))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert tconfigs.get_config(arch).block_runs() == \
            jconfigs.get_config(arch).block_runs()


def test_layers_match_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    p = {"scale": rng.normal(size=(8,)).astype(np.float32),
         "bias": rng.normal(size=(8,)).astype(np.float32),
         "w": rng.normal(size=(8, 4)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert max_err(tnn.layer_norm(tp, tx), jnn.layer_norm(jp, jx)) <= TOL
    assert max_err(tnn.rms_norm(tp, tx), jnn.rms_norm(jp, jx)) <= TOL
    assert max_err(tnn.dense(tp, tx), jnn.dense(jp, jx)) <= TOL
    xb = tx.to(torch.bfloat16)
    assert tnn.rms_norm(tp, xb).dtype == torch.bfloat16
    assert tnn.dropout(None, tx, 0.5, deterministic=True) is tx
    g = torch.Generator().manual_seed(0)
    y = tnn.dropout(g, torch.ones(4000), 0.25, deterministic=False)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    w = tnn.he((64, 32), torch.Generator().manual_seed(1))
    assert abs(float(w.std()) - (2 / 64) ** 0.5) < 0.02
    n = tnn.normal_init((64, 32), torch.Generator().manual_seed(1), 0.05,
                        dtype=torch.bfloat16)
    assert n.dtype == torch.bfloat16 and abs(float(n.float().std()) - 0.05) \
        < 0.005
    assert tnn.normal_init((5, 3), None, device="meta").is_meta


def test_token_stream_matches_reference():
    for vocab, seq, batch, seed in ((512, 16, 3, 0), (2048, 8, 2, 7)):
        jit = iter(jdata.TokenStream(vocab, seq, batch, seed))
        tit = iter(tdata.TokenStream(vocab, seq, batch, seed))
        for _ in range(3):
            a, b = next(jit), next(tit)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])


def test_lm_params_and_adam_state_cross_with_bf16():
    jcfg = jconfigs.get_reduced("hymba_1_5b")           # bf16 and f32 leaves
    jp = jinit(jax.random.PRNGKey(3), jcfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    want, got = paths(jp), paths(tp)
    assert sorted(want) == sorted(got)
    for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        name = "/" + "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                              for e in k)
        t = dict(_flat_tensors(tp))[name]
        assert str(t.dtype).replace("torch.", "") == str(v.dtype), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(v, np.float32))
    opt = jadamw(1e-3)
    st = opt.init(jp)
    tst = opt_state_from_reference(st, "cpu")
    assert int(tst.count) == 0 and tst.count.dtype == torch.int32
    assert sorted(paths(tst.mu)) == sorted(want)


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat_tensors(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_tensors(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
