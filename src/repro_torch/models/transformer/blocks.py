"""Decoder blocks for the architecture zoo: init + apply (train & decode),
the JAX package's ``models/transformer/blocks.py`` in torch.

Block kinds (config.block_kinds):
- ``attn_dense``  — [qk-norm|bias|SWA] GQA or MLA attention + dense FFN
- ``attn_moe``    — attention + top-k MoE FFN (capacity-based dispatch,
                    optional shared experts)
- ``mlstm``       — xLSTM matrix-memory block (chunked linear attention)
- ``slstm``       — xLSTM scalar-memory block (sequential recurrence)
- ``hybrid``      — Hymba-style parallel attention + Mamba heads, then FFN

Params are plain dicts of tensors; each ``init_*`` takes
``(generator, cfg, device)`` and returns one layer's params, and the model
stacks them per run.  Result dtypes follow the reference's: f32 leaves
(norm scales, the router, ``wif``, the sLSTM's ``wg`` and ``r``, Mamba's
``dt_b``, ``a_log`` and ``d_skip``) meet activations that are cast to f32
first, as the reference writes them.

Single-device only.  The reference's sharding hints (``constrain``,
``constrain_to``), its block sequence parallelism (the ``_bsp_active()``
branches) and its ``shard_map`` MoE dispatch and expert parallelism
(``_moe_dispatch`` past its no-context branch, ``_apply_moe_ep``) do
nothing without an ``SpmdCtx``; they are left out here, and the MoE
always dispatches over the whole batch (``_apply_moe``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...nn import layer_norm, normal_init, rms_norm, zeros_init
from .attention import (_inv_sqrt, banded_attention, blocked_attention,
                        rope)
from .config import ModelConfig
from .ssm import (MlstmState, SlstmState, mlstm_chunked, selective_scan,
                  selective_scan_step, slstm_scan, slstm_step)

__all__ = ["init_block", "apply_block", "init_block_cache", "norm_apply",
           "torch_dtype"]

_FULL = 10 ** 9          # "no window": the reference's sentinel


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` ("bfloat16", "float32", ...)."""
    return getattr(torch, cfg.dtype)


def norm_apply(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(p, x)
    return rms_norm(p, x)


def _norm_params(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def _pos_vec(pos: int, device) -> torch.Tensor:
    return torch.full((1,), pos, dtype=torch.int64, device=device)


def _put(cache: torch.Tensor, slot: int, rows: torch.Tensor) -> torch.Tensor:
    """``cache`` with ``rows`` ([B, 1, ...]) written at ``slot`` of axis 1
    (``dynamic_update_slice_in_dim``: the start is clamped into range);
    a new tensor, the cache passed in stays as it was."""
    out = cache.clone()
    out[:, min(max(slot, 0), cache.shape[1] - 1)] = rows[:, 0].to(cache.dtype)
    return out


# ---------------------------------------------------------------------------
# Attention sub-block
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ModelConfig, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = torch_dtype(cfg)

    def w(shape):
        return normal_init(shape, gen, device=device, dtype=dt)

    if cfg.use_mla:
        ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {
            "wdq": w((d, ql)),
            "q_norm": _norm_params(ql, device),
            "wuq": w((ql, nq * (nope + rdim))),
            "wdkv": w((d, kvl + rdim)),
            "kv_norm": _norm_params(kvl, device),
            "wukv": w((kvl, nq * (nope + vdim))),
            "wo": w((nq * vdim, d)),
        }
    p = {"wq": w((d, nq * hd)), "wk": w((d, nkv * hd)),
         "wv": w((d, nkv * hd)), "wo": w((nq * hd, d))}
    if cfg.qkv_bias:
        p["bq"] = zeros_init((nq * hd,), device, dt)
        p["bk"] = zeros_init((nkv * hd,), device, dt)
        p["bv"] = zeros_init((nkv * hd,), device, dt)
    if cfg.qk_norm:
        p["q_norm"] = _norm_params(hd, device)
        p["k_norm"] = _norm_params(hd, device)
    return p


def _apply_attn(cfg: ModelConfig, p: dict, x, positions, cache, pos):
    """x [B,S,D].  Train when cache is None, else one-token decode at the
    int position ``pos``."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        return _apply_mla(cfg, p, x, positions, cache, pos)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if cache is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cfg.attn_window and cfg.attn_window < s:
            o = banded_attention(q, k, v, cfg.attn_window)
        else:
            o = blocked_attention(q, k, v, causal=True)
        new_cache = None
    else:
        at = _pos_vec(pos, x.device)
        q = rope(q, at, cfg.rope_theta)
        k = rope(k, at, cfg.rope_theta)
        slot = pos % cache["k"].shape[1]          # the ring buffer's slot
        ck = _put(cache["k"], slot, k)
        cv = _put(cache["v"], slot, v)
        cpos = cache["pos"].clone()
        cpos[:, slot] = pos
        low = pos - (cfg.attn_window or _FULL)
        # cpos == -1 marks a never-written slot; it must stay masked or the
        # zero keys dilute the softmax (decode != prefill).
        valid = (cpos >= 0) & (cpos <= pos) & (cpos > low)
        o = _decode_attn_ring(q, ck, cv, valid)
        new_cache = {"k": ck, "v": cv, "pos": cpos}
    o = o.reshape(b, s, nq * hd)
    return (o @ p["wo"]).to(x.dtype), new_cache


def _decode_attn_ring(q, ck, cv, valid):
    """Decode attention over a (possibly ring-buffer) cache with an explicit
    per-slot validity mask.  q [B,1,Hq,hd], ck/cv [B,W,Hkv,hd]."""
    b, _, hq, hd = q.shape
    nkv = ck.shape[2]
    if nkv != hq:
        ck = torch.repeat_interleave(ck, hq // nkv, dim=2)
        cv = torch.repeat_interleave(cv, hq // nkv, dim=2)
    sc = torch.einsum("bohd,bshd->bhos", q.float(), ck.float()) * _inv_sqrt(hd)
    sc = torch.where(valid[:, None, None, :], sc, -1e30)
    w = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhos,bshd->bohd", w, cv.float())
    return o.to(q.dtype)


def _apply_mla(cfg: ModelConfig, p: dict, x, positions, cache, pos):
    """DeepSeek MLA.  Train: expanded form.  Decode: absorbed/compressed."""
    b, s, d = x.shape
    nq = cfg.n_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    cq = rms_norm(p["q_norm"], x @ p["wdq"])
    qall = (cq @ p["wuq"]).reshape(b, s, nq, nope + rdim)
    q_nope, q_rope = qall[..., :nope], qall[..., nope:]
    dkv = x @ p["wdkv"]                       # [B,S,kvl+rdim]
    ckv = rms_norm(p["kv_norm"], dkv[..., :kvl])
    k_rope = dkv[..., kvl:].reshape(b, s, 1, rdim)
    if cache is None:
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        k_rope_r = rope(k_rope, positions, cfg.rope_theta)
        kv = (ckv @ p["wukv"]).reshape(b, s, nq, nope + vdim)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_rope_r.expand(b, s, nq, rdim)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        o = blocked_attention(q, k, v, causal=True)
        o = o.reshape(b, s, nq * vdim)
        return (o @ p["wo"]).to(x.dtype), None
    # --- absorbed decode: cache (ckv, k_rope), score in compressed space ---
    at = _pos_vec(pos, x.device)
    q_rope = rope(q_rope, at, cfg.rope_theta)
    k_rope_r = rope(k_rope, at, cfg.rope_theta)
    c_cache = _put(cache["ckv"], pos, ckv)
    r_cache = _put(cache["kr"], pos, k_rope_r[:, :, 0])
    wukv = p["wukv"].reshape(kvl, nq, nope + vdim)
    w_uk = wukv[..., :nope]                   # [kvl, nq, nope]
    w_uv = wukv[..., nope:]                   # [kvl, nq, vdim]
    q_abs = torch.einsum("bohn,lhn->bohl", q_nope.float(),
                         w_uk.float())        # [B,1,nq,kvl]
    sc = torch.einsum("bohl,bsl->bhos", q_abs, c_cache.float())
    sc = sc + torch.einsum("bohr,bsr->bhos", q_rope.float(),
                           r_cache.float())
    sc = sc * _inv_sqrt(nope + rdim)
    spos = torch.arange(c_cache.shape[1], device=x.device)[None, None, None, :]
    mask = spos <= pos
    if cfg.attn_window:  # +swa long-context variant
        mask &= spos > (pos - cfg.attn_window)
    sc = torch.where(mask, sc, -1e30)
    w = torch.softmax(sc, dim=-1)
    ctx_c = torch.einsum("bhos,bsl->bohl", w, c_cache.float())
    o = torch.einsum("bohl,lhv->bohv", ctx_c, w_uv.float())
    o = o.reshape(b, s, nq * vdim).to(x.dtype)
    return o @ p["wo"], {"ckv": c_cache, "kr": r_cache}


# ---------------------------------------------------------------------------
# FFN sub-blocks
# ---------------------------------------------------------------------------

def _init_ffn(gen, cfg: ModelConfig, d_ff: int, device) -> dict:
    d, dt = cfg.d_model, torch_dtype(cfg)
    if cfg.ffn_act == "swiglu":
        return {"wg": normal_init((d, d_ff), gen, device=device, dtype=dt),
                "wu": normal_init((d, d_ff), gen, device=device, dtype=dt),
                "wd": normal_init((d_ff, d), gen, device=device, dtype=dt)}
    return {"wi": normal_init((d, d_ff), gen, device=device, dtype=dt),
            "bi": zeros_init((d_ff,), device, dt),
            "wd": normal_init((d_ff, d), gen, device=device, dtype=dt)}


def _apply_ffn(cfg: ModelConfig, p: dict, x):
    if cfg.ffn_act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    # jax.nn.gelu's default is the tanh form
    return F.gelu(x @ p["wi"] + p["bi"], approximate="tanh") @ p["wd"]


def _init_moe(gen, cfg: ModelConfig, device) -> dict:
    d, dt = cfg.d_model, torch_dtype(cfg)
    e = cfg.n_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    p = {"router": normal_init((d, e), gen, 0.02, device, torch.float32),
         "wg": normal_init((e, d, fe), gen, device=device, dtype=dt),
         "wu": normal_init((e, d, fe), gen, device=device, dtype=dt),
         "wd": normal_init((e, fe, d), gen, device=device, dtype=dt)}
    if cfg.n_shared_experts:
        p["shared"] = _init_ffn(gen, cfg, fe * cfg.n_shared_experts, device)
    return p


def _apply_moe(cfg: ModelConfig, p: dict, x, capacity_factor: float = 1.25):
    """Top-k MoE with sort-based capacity dispatch over the whole batch.

    Tokens are routed to ``[E, cap]`` expert buffers through a stable sort
    on expert id (no [T, E, cap] one-hot); each expert keeps its first
    ``cap = int(T * k / E * capacity_factor)`` assignments in token order,
    the rest land on a sentinel row and are dropped (the residual path
    keeps them).  Returns (out, the Switch-style load-balance aux loss).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.float() @ p["router"]
    gates = torch.softmax(logits, dim=-1)                 # [T,E]
    topv, topi = torch.topk(gates, k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    cap = max(1, int(t * k / e * capacity_factor))

    eid = topi.reshape(-1)                                # [T*k]
    gate = topv.reshape(-1)
    tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.sort(eid, stable=True).indices
    eid_s, tok_s, gate_s = eid[order], tok[order], gate[order]
    # bincount(eid, length=E), without the host sync of torch.bincount
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, eid, torch.ones_like(eid))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - starts[eid_s]
    keep = rank < cap
    slot = torch.where(keep, eid_s * cap + rank, e * cap)  # sentinel row

    rows = torch.where(keep[:, None], xf[tok_s], 0.0)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype,
                      device=dev).index_add(0, slot, rows)
    buf3 = buf[: e * cap].reshape(e, cap, d)
    hg = F.silu(torch.einsum("ecd,edf->ecf", buf3, p["wg"]))
    hu = torch.einsum("ecd,edf->ecf", buf3, p["wu"])
    ho = torch.einsum("ecf,efd->ecd", hg * hu, p["wd"])   # [E,cap,D]
    out_rows = torch.cat([ho.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=ho.dtype, device=dev)])
    vals = torch.where(keep, gate_s, 0.0)[:, None].to(x.dtype) * out_rows[slot]
    out = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add(
        0, tok_s, vals)
    if cfg.n_shared_experts:
        out = out + _apply_ffn(cfg, p["shared"], xf)
    me = gates.mean(0)
    frac = counts.float() / max(1, t * k)
    aux = (me * frac).sum() * e
    return out.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# mLSTM / sLSTM / hybrid sub-blocks
# ---------------------------------------------------------------------------

def _init_mlstm(gen, cfg: ModelConfig, device) -> dict:
    d, dt = cfg.d_model, torch_dtype(cfg)
    di = d * cfg.ssm_expand

    def w(shape, dtype=dt):
        return normal_init(shape, gen, device=device, dtype=dtype)

    return {"wq": w((d, di)), "wk": w((d, di)), "wv": w((d, di)),
            "wz": w((d, di)), "wif": w((d, 2 * cfg.n_heads), torch.float32),
            "wd": w((di, d))}


def _apply_mlstm(cfg: ModelConfig, p: dict, x, cache):
    b, s, d = x.shape
    h = cfg.n_heads
    di = d * cfg.ssm_expand
    dh = di // h
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, h, dh)
    v = (x @ p["wv"]).reshape(b, s, h, dh)
    gif = x.float() @ p["wif"]
    ig, fg = gif[..., :h], gif[..., h:]
    chunk = 1 if (cache is not None and s == 1) else 128
    y, st = mlstm_chunked(q, k, v, ig, fg, state=cache, chunk=chunk)
    y = y.reshape(b, s, di) * F.silu(x @ p["wz"])
    out = (y @ p["wd"]).to(x.dtype)
    return out, (st if cache is not None else None)


def _init_slstm(gen, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {"wg": normal_init((d, 4 * d), gen, device=device,
                              dtype=torch.float32),
            "r": normal_init((h, 4, dh, dh), gen, 0.05, device,
                             torch.float32)}


def _apply_slstm(cfg: ModelConfig, p: dict, x, cache):
    b, s, d = x.shape
    gx = x.float() @ p["wg"]
    if cache is not None and s == 1:
        y, st = slstm_step(cache, gx[:, 0], p["r"], cfg.n_heads)
        return y[:, None].to(x.dtype), st
    y, st = slstm_scan(gx, p["r"], cfg.n_heads, state=cache)
    return y.to(x.dtype), (st if cache is not None else None)


def _init_mamba(gen, cfg: ModelConfig, device) -> dict:
    d, dt = cfg.d_model, torch_dtype(cfg)
    di = d * cfg.ssm_expand
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)

    def w(shape):
        return normal_init(shape, gen, device=device, dtype=dt)

    a_init = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                    device=device)[None].tile(di, 1))
    return {"win": w((d, 2 * di)),
            "conv": w((cfg.ssm_conv, di)),
            "conv_b": zeros_init((di,), device, dt),
            "wbc": w((di, 2 * n)),
            "wdt1": w((di, dt_rank)),
            "wdt2": w((dt_rank, di)),
            "dt_b": torch.full((di,), -4.6, dtype=torch.float32,
                               device=device),      # softplus ~ 0.01
            "a_log": a_init,
            "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
            "wout": w((di, d))}


def _causal_conv(x, kernel, bias, conv_state=None):
    """Depthwise causal conv1d.  x [B,S,DI], kernel [CW,DI]."""
    cw = kernel.shape[0]
    if conv_state is not None:
        ctx = torch.cat([conv_state, x], dim=1)          # [B,CW-1+S,DI]
    else:
        ctx = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(ctx[:, i:i + x.shape[1]] * kernel[i] for i in range(cw))
    new_state = ctx[:, -(cw - 1):] if cw > 1 else ctx[:, :0]
    return out + bias, new_state


def _apply_mamba(cfg: ModelConfig, p: dict, x, cache):
    b, s, d = x.shape
    di = d * cfg.ssm_expand
    n = cfg.ssm_state
    xz = x @ p["win"]
    xi, z = xz[..., :di], xz[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(xi, p["conv"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    bc = xc @ p["wbc"]
    b_in, c_in = bc[..., :n], bc[..., n:]
    delta = F.softplus((xc @ p["wdt1"]) @ p["wdt2"] + p["dt_b"]).float()
    if cache is not None and s == 1:
        y, h = selective_scan_step(cache["h"], xc[:, 0], delta[:, 0],
                                   p["a_log"], b_in[:, 0], c_in[:, 0],
                                   p["d_skip"])
        y = y[:, None]
    else:
        h0 = cache["h"] if cache is not None else None
        y, h = selective_scan(xc, delta, p["a_log"], b_in, c_in,
                              p["d_skip"], h0=h0)
    y = y * F.silu(z)
    out = (y @ p["wout"]).to(x.dtype)
    new_cache = ({"h": h, "conv": new_conv} if cache is not None else None)
    return out, new_cache


# ---------------------------------------------------------------------------
# Block assembly
# ---------------------------------------------------------------------------

def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
               device="cpu") -> dict:
    """One layer's params of ``kind``, drawn from ``generator``."""
    d = cfg.d_model
    if kind == "attn_dense":
        return {"norm1": _norm_params(d, device),
                "attn": _init_attn(generator, cfg, device),
                "norm2": _norm_params(d, device),
                "ffn": _init_ffn(generator, cfg, cfg.d_ff, device)}
    if kind == "attn_moe":
        return {"norm1": _norm_params(d, device),
                "attn": _init_attn(generator, cfg, device),
                "norm2": _norm_params(d, device),
                "moe": _init_moe(generator, cfg, device)}
    if kind == "mlstm":
        return {"norm1": _norm_params(d, device),
                "mlstm": _init_mlstm(generator, cfg, device)}
    if kind == "slstm":
        return {"norm1": _norm_params(d, device),
                "slstm": _init_slstm(generator, cfg, device)}
    if kind == "hybrid":
        return {"norm1": _norm_params(d, device),
                "attn": _init_attn(generator, cfg, device),
                "mamba": _init_mamba(generator, cfg, device),
                "norm2": _norm_params(d, device),
                "ffn": _init_ffn(generator, cfg, cfg.d_ff, device)}
    raise ValueError(kind)


def apply_block(cfg: ModelConfig, kind: str, p: dict, x, positions,
                cache=None, pos=None):
    """Returns (x_out, new_cache, aux_loss).  ``positions`` [S] for the
    full-sequence pass (``cache`` None); for decode, ``cache`` and the int
    position ``pos``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn_dense", "attn_moe"):
        a, c_attn = _apply_attn(cfg, p["attn"], norm_apply(cfg, p["norm1"], x),
                                positions, cache, pos)
        x = x + a
        h = norm_apply(cfg, p["norm2"], x)
        if kind == "attn_dense":
            x = x + _apply_ffn(cfg, p["ffn"], h)
        else:
            mo, aux = _apply_moe(cfg, p["moe"], h)
            x = x + mo
        return x, c_attn, aux
    if kind == "mlstm":
        y, st = _apply_mlstm(cfg, p["mlstm"], norm_apply(cfg, p["norm1"], x),
                             cache)
        return x + y, st, aux
    if kind == "slstm":
        y, st = _apply_slstm(cfg, p["slstm"], norm_apply(cfg, p["norm1"], x),
                             cache)
        return x + y, st, aux
    if kind == "hybrid":
        h = norm_apply(cfg, p["norm1"], x)
        c_attn = cache["attn"] if cache is not None else None
        c_ssm = cache["ssm"] if cache is not None else None
        a, c_attn2 = _apply_attn(cfg, p["attn"], h, positions, c_attn, pos)
        m, c_ssm2 = _apply_mamba(cfg, p["mamba"], h, c_ssm)
        x = x + 0.5 * (a + m)
        x = x + _apply_ffn(cfg, p["ffn"], norm_apply(cfg, p["norm2"], x))
        new_cache = ({"attn": c_attn2, "ssm": c_ssm2}
                     if cache is not None else None)
        return x, new_cache, aux
    raise ValueError(kind)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device="cpu"):
    """Zeroed decode cache for one block.  A sliding-window attention
    cache is a ring buffer ``min(max_len, attn_window)`` wide; ``pos``
    -1 marks a slot never written."""
    dt = torch_dtype(cfg)
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    di = d * cfg.ssm_expand

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def attn_cache():
        if cfg.use_mla:
            return {"ckv": zeros((batch, max_len, cfg.kv_lora_rank)),
                    "kr": zeros((batch, max_len, cfg.qk_rope_dim))}
        w = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
        return {"k": zeros((batch, w, cfg.n_kv_heads, hd)),
                "v": zeros((batch, w, cfg.n_kv_heads, hd)),
                "pos": torch.full((batch, w), -1, dtype=torch.int32,
                                  device=device)}

    if kind in ("attn_dense", "attn_moe"):
        return attn_cache()
    if kind == "mlstm":
        h = cfg.n_heads
        dh = di // h
        return MlstmState(c=zeros((batch, h, dh, dh), torch.float32),
                          n=zeros((batch, h, dh), torch.float32))
    if kind == "slstm":
        z = zeros((batch, d), torch.float32)
        return SlstmState(c=z, n=z, h=z, m=z)
    if kind == "hybrid":
        return {"attn": attn_cache(),
                "ssm": {"h": zeros((batch, di, cfg.ssm_state), torch.float32),
                        "conv": zeros((batch, cfg.ssm_conv - 1, di))}}
    raise ValueError(kind)
