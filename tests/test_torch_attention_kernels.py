"""The transformer zoo's attention ops (``repro_torch.kernels.flash_attn``)
on the CPU, where they run their plain versions (``kernels/ref.py``),
against the JAX package.

Inputs are seeded numpy in f32, handed to both packages; held within 1e-5:

- ``repro_torch::flash_attention`` and its backward (the CUDA kernels'
  algorithm: P recomputed from the row log-sum-exp, ``dS = P * (dP -
  Delta)``, the GQA group sum) against ``jax.vjp`` of JAX
  ``blocked_attention`` / ``banded_attention``: causal and not, S not a
  multiple of the tile (37, 45), GQA 4 / 2 and 4 / 1, MLA's widths
  (Dqk != Dv), windows shorter than S;
- ``lse`` against a numpy log-sum-exp of the visible scores;
- ``repro_torch::decode_attention`` against JAX ``_decode_attn_ring``:
  GQA, a ring mask, a batch row with no valid slot (the mean of V);
- the ops' fake implementations under ``FakeTensorMode`` on ``cuda`` and
  ``cpu`` fakes (shapes, dtypes; the backward through autograd on ``cpu``
  fakes);
- ``OpCounter`` over each entry point on ``cuda`` and ``cpu`` fakes: one
  operation each, the same FLOPs (the formula: visible pairs x 2 x (Dqk +
  Dv) a head, the backward 2.5x that) and bytes on both devices; and over
  a reduced config's traced ``loss_and_grads``, the attention's FLOPs the
  formula's.  (A CPU-only torch cannot index, cast or record autograd on
  ``cuda`` fakes, so the whole step on ``cuda`` fakes against ``cpu`` fakes
  is a card test, ``tests/test_torch_cuda.py``.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models.transformer import attention as jatt
from repro.models.transformer import blocks as jblocks
from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attn
from repro_torch.kernels.ref import inv_sqrt
from repro_torch.launch.hlo_cost import OpCounter
from repro_torch.models.transformer import attention as tatt
from repro_torch.models.transformer import init_model, loss_and_grads
from repro_torch.optim.optimizers import tree_map
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5

# (name, B, S, Hq, Hkv, Dqk, Dv, causal, window, chunk kwargs)
CASES = [
    ("causal_gqa", 2, 37, 4, 2, 8, 8, True, 0, dict(q_chunk=16, k_chunk=8)),
    ("noncausal_gqa", 2, 37, 4, 2, 8, 8, False, 0,
     dict(q_chunk=16, k_chunk=8)),
    ("causal_mha_one_tile", 1, 45, 2, 2, 8, 8, True, 0, {}),
    ("causal_gqa_4_1", 1, 45, 4, 1, 8, 8, True, 0,
     dict(q_chunk=8, k_chunk=16)),
    ("mla_widths", 2, 37, 4, 4, 12, 8, True, 0, dict(q_chunk=8, k_chunk=8)),
    ("mla_widths_noncausal", 1, 45, 2, 2, 12, 8, False, 0,
     dict(q_chunk=16, k_chunk=16)),
    ("band_12", 1, 45, 4, 2, 8, 8, True, 12, dict(chunk=8)),
    ("band_5", 2, 37, 4, 2, 8, 8, True, 5, dict(chunk=8)),
    ("band_past_s", 1, 37, 4, 2, 8, 8, True, 40, dict(chunk=16)),
]


def _arrays(b, s, hq, hkv, dqk, dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, hq, dqk), (b, s, hkv, dqk), (b, s, hkv, dv))]


def _fns(causal, window, kw):
    if window:
        return (lambda *x: jatt.banded_attention(*x, window, **kw),
                lambda *x: tatt.banded_attention(*x, window, **kw))
    return (lambda *x: jatt.blocked_attention(*x, causal=causal, **kw),
            lambda *x: tatt.blocked_attention(*x, causal=causal, **kw))


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_attention_values_and_grads_match_jax_vjp(case):
    _, b, s, hq, hkv, dqk, dv, causal, window, kw = case
    arrays = _arrays(b, s, hq, hkv, dqk, dv)
    jfn, tfn = _fns(causal, window, kw)
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    cot = np.random.default_rng(1).normal(size=jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tout = tfn(*ts)
    assert tout.shape == (b, s, hq, dv) and tout.dtype == torch.float32
    tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(cot))
    assert _max_err(tout.detach(), jout) <= TOL
    for name, got, want in zip("qkv", tgrads, jgrads):
        assert got.shape == want.shape, name
        assert _max_err(got, want) <= TOL, name


def _numpy_lse(q, k, causal, window):
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    kk = np.repeat(k.astype(np.float64), rep, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk)
    sc *= np.float64(inv_sqrt(d))
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    vis = np.ones((s, s), bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= i - j < window
    sc = np.where(vis, sc, -np.inf)
    mx = sc.max(-1, keepdims=True)
    return (mx + np.log(np.exp(sc - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lse_matches_numpy_logsumexp(case):
    _, b, s, hq, hkv, dqk, dv, causal, window, kw = case
    q, k, v = _arrays(b, s, hq, hkv, dqk, dv, seed=3)
    chunk = kw.get("chunk", kw.get("q_chunk", 512))
    o, lse = torch.ops.repro_torch.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal, window, chunk,
        kw.get("k_chunk", chunk))
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    assert _max_err(lse, _numpy_lse(q, k, causal, window)) <= TOL


def _ring_case(seed=4):
    """q [3, 1, 4, 8] over a ring cache of 10 slots with 2 KV heads:
    row 0 a ring that has wrapped (slot positions 10-19, window 6), row 1
    half filled, row 2 no valid slot."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    ck, cv = (rng.normal(size=(3, 10, 2, 8)).astype(np.float32)
              for _ in range(2))
    pos = 19
    cpos = np.stack([np.arange(10, 20), np.r_[np.arange(5), -np.ones(5)],
                     -np.ones(10)]).astype(np.int32)
    valid = (cpos >= 0) & (cpos <= pos) & (cpos > pos - 6)
    valid[1] = cpos[1] >= 0
    return q, ck, cv, valid


def test_decode_attention_matches_jax_ring():
    q, ck, cv, valid = _ring_case()
    assert valid[0].sum() == 6 and valid[1].sum() == 5 and not valid[2].any()
    want = jblocks._decode_attn_ring(*map(jnp.asarray, (q, ck, cv, valid)))
    got = torch.ops.repro_torch.decode_attention(
        *map(torch.from_numpy, (q, ck, cv, valid)))
    assert got.shape == q.shape and got.dtype == torch.float32
    assert _max_err(got, want) <= TOL
    # the row with no valid slot: the mean of its V rows, each head's group
    mean = np.repeat(cv[2].mean(0), 2, axis=0)
    assert _max_err(got[2, 0], mean) <= TOL


def test_decode_attention_length_and_window_match_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 30, 1, 8)).astype(np.float32)
            for _ in range(2))
    for length, window in ((20, None), (20, 5), (0, None), (29, 30)):
        want = jatt.decode_attention(*map(jnp.asarray, (q, k, v)),
                                     jnp.int32(length), window=window)
        got = tatt.decode_attention(*map(torch.from_numpy, (q, k, v)), length,
                                    window=window)
        assert _max_err(got, want) <= TOL, (length, window)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations(device, dtype):
    """Shapes, dtypes and devices of the three ops on fakes; on ``cpu``
    fakes also the backward through autograd (a CPU-only torch cannot
    record autograd on ``cuda`` fakes: its engine needs the CUDA
    runtime)."""
    b, s, hq, hkv, dqk, dv = 2, 40, 4, 2, 48, 32
    with FakeTensorMode():
        q = torch.empty((b, s, hq, dqk), dtype=dtype, device=device)
        k = torch.empty((b, s, hkv, dqk), dtype=dtype, device=device)
        v = torch.empty((b, s, hkv, dv), dtype=dtype, device=device)
        o, lse = torch.ops.repro_torch.flash_attention(q, k, v, True, 16, 8, 8)
        assert o.shape == (b, s, hq, dv) and o.dtype == dtype
        assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
        assert o.device.type == device and lse.device.type == device
        dq, dk, dvv = torch.ops.repro_torch.flash_attention_bwd(
            torch.empty_like(o), q, k, v, o, lse, True, 16, 8, 8)
        for g, t in ((dq, q), (dk, k), (dvv, v)):
            assert g.shape == t.shape and g.dtype == dtype
            assert g.device.type == device
        cache = torch.empty((b, 16, hkv, 64), dtype=dtype, device=device)
        qd = torch.empty((b, 1, hq, 64), dtype=dtype, device=device)
        valid = torch.empty((b, 16), dtype=torch.bool, device=device)
        od = torch.ops.repro_torch.decode_attention(qd, cache, cache, valid)
        assert od.shape == qd.shape and od.dtype == dtype
        assert od.device.type == device
        if device == "cpu":
            ts = [t.requires_grad_() for t in (q, k, v)]
            out = tatt.blocked_attention(*ts)
            grads = torch.autograd.grad(out.float().sum(), ts)
            assert [g.shape for g in grads] == [t.shape for t in ts]


def test_visible_pairs_counts_the_mask():
    for s in (1, 7, 37, 64):
        for causal, window in ((False, 0), (True, 0), (True, 1), (True, 5),
                               (True, 64)):
            i, j = np.arange(s)[:, None], np.arange(s)[None, :]
            vis = np.ones((s, s), bool)
            if causal:
                vis &= j <= i
            if window:
                vis &= i - j < window
            assert flash_attn.visible_pairs(s, causal, window) == vis.sum()


def _op_costs(device: str, dtype) -> dict:
    """``OpCounter``'s cost of each attention entry point on fakes of
    ``device``: blocked (causal and not, MLA's widths), banded, the
    backward op, ring decode."""
    b, s, hq, hkv = 2, 96, 4, 2
    out = {}
    with FakeTensorMode():
        def rnd(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)
        q, k, v = rnd(b, s, hq, 48), rnd(b, s, hkv, 48), rnd(b, s, hkv, 32)
        do, o = rnd(b, s, hq, 32), rnd(b, s, hq, 32)
        lse = rnd(b, hq, s, dt=torch.float32)
        qd, kd, vd = (rnd(b, n, h, 64) for n, h in ((1, hq), (16, hkv),
                                                      (16, hkv)))
        valid = rnd(b, 16, dt=torch.bool)
        calls = {
            "causal": lambda: tatt.blocked_attention(q, k, v),
            "noncausal": lambda: tatt.blocked_attention(q, k, v,
                                                        causal=False),
            "banded": lambda: tatt.banded_attention(q, k, v, 40),
            "bwd": lambda: torch.ops.repro_torch.flash_attention_bwd(
                do, q, k, v, o, lse, True, 40, 512, 512),
            "decode": lambda: torch.ops.repro_torch.decode_attention(
                qd, kd, vd, valid),
        }
        for name, fn in calls.items():
            with OpCounter() as counter:
                fn()
            out[name] = counter.cost
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_counts_equal_on_cuda_and_cpu_fakes(dtype):
    """Each attention entry point is one counted operation: the formula's
    FLOPs and its operands' and results' bytes, equal on ``cuda`` and
    ``cpu`` fakes."""
    cuda, cpu = _op_costs("cuda", dtype), _op_costs("cpu", dtype)
    e = torch.tensor([], dtype=dtype).element_size()
    b, s, hq, hkv = 2, 96, 4, 2
    fwd = b * hq * 2 * (48 + 32)
    want = {"causal": fwd * flash_attn.visible_pairs(s, True, 0),
            "noncausal": fwd * s * s,
            "banded": fwd * flash_attn.visible_pairs(s, True, 40),
            "bwd": fwd * flash_attn.visible_pairs(s, True, 40) * 5 // 2,
            "decode": b * hq * 16 * 2 * (64 + 64)}
    qkv = e * b * s * (hq * 48 + hkv * 48 + hkv * 32)
    o, lse = e * b * s * hq * 32, 4 * b * hq * s
    want_bytes = {"causal": qkv + o + lse, "noncausal": qkv + o + lse,
                  "banded": qkv + o + lse,
                  "bwd": 2 * qkv + 2 * o + lse,
                  "decode": e * (2 * b * hq * 64 + 2 * b * 16 * hkv * 64)
                  + b * 16}
    for name in want:
        assert cuda[name].flops == cpu[name].flops == want[name], name
        assert cuda[name].bytes_accessed == cpu[name].bytes_accessed \
            == want_bytes[name], name


SEQ, BATCH = 96, 2
TRACED_ARCHS = ["qwen3-1.7b", "deepseek-v3-671b", "mixtral-8x7b"]


def _fake_step_flops(cfg, with_formulas: bool = True) -> float:
    """``OpCounter``'s FLOPs of one ``loss_and_grads`` of ``cfg`` on
    ``cpu`` fakes (parameters of the meta build's shapes), with or without
    the attention ops' formulas in the registry."""
    from torch.utils.flop_counter import flop_registry
    ops = (torch.ops.repro_torch.flash_attention,
           torch.ops.repro_torch.flash_attention_bwd)
    saved = {} if with_formulas else {op: flop_registry.pop(op) for op in ops}
    try:
        shapes = init_model(cfg, None, device="meta")
        with FakeTensorMode():
            params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                              shapes)
            data = {k: torch.zeros((BATCH, SEQ), dtype=torch.int64)
                    for k in ("tokens", "labels")}
            with OpCounter() as counter:
                loss_and_grads(cfg, params, data)
        return counter.cost.flops
    finally:
        flop_registry.update(saved)


@pytest.mark.parametrize("arch", TRACED_ARCHS)
def test_traced_train_step_counts_attention_by_formula(arch):
    """A reduced config's ``loss_and_grads`` traced on fakes: the
    attention's FLOPs (the step's with the ops' formulas less the step's
    without them) are the forward's formula over every layer plus 2.5x it
    for the backward."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    dqk = (cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla
           else cfg.resolved_head_dim)
    dv = cfg.v_head_dim if cfg.use_mla else dqk
    window = cfg.attn_window if cfg.attn_window and cfg.attn_window < SEQ \
        else 0
    fwd = cfg.num_layers * BATCH * cfg.n_heads * flash_attn.visible_pairs(
        SEQ, True, window) * 2 * (dqk + dv)
    got = _fake_step_flops(cfg) - _fake_step_flops(cfg, with_formulas=False)
    assert got == fwd + fwd * 5 // 2
