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

Sharded under an :class:`~.spmd.SpmdCtx` (parameters and activations
DTensors on its mesh): the matmuls and elementwise ops run on DTensors and
DTensor places their collectives; the loops (the blocked and banded
attention, the Mamba, mLSTM and sLSTM scans) run on local shards, their
inputs redistributed once to a layout the loop needs (sequence full,
batch over the token axes, heads or SSM channels over ``"model"``) and
the result wrapped back, so no loop step dispatches a DTensor op.  Block
sequence parallelism (``_bsp_active()``) places those constraints where
the reference does: KV expanded to the query heads first, the Mamba
channels pinned before the ``x_proj``.  The MoE runs the reference's
``shard_map`` bodies as manual regions on local shards
(:func:`_moe_dispatch`, :func:`_apply_moe_ep`).  Without a context no
DTensor appears and every function is the single-device code.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...nn import layer_norm, normal_init, rms_norm, zeros_init
from .attention import (_inv_sqrt, banded_attention, blocked_attention,
                        rope)
from .config import ModelConfig
from .spmd import (P, block_sp_active as _bsp_active, block_sp_dp as _bsp_dp,
                   constrain_to as _constrain_to, current_spmd,
                   from_local_as, gather_rows, heads_reshape, is_dtensor,
                   matmul as _mm, spec_of, to_local_as)
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
    slot = min(max(slot, 0), cache.shape[1] - 1)
    if is_dtensor(cache):
        # a select of a sharded dim is not a view of the DTensor's shard:
        # written into, it would change nothing
        at = torch.arange(cache.shape[1], device=cache.device) == slot
        at = at.reshape((1, -1) + (1,) * (cache.ndim - 2))
        return torch.where(at, rows.to(cache.dtype), cache)
    out = cache.clone()
    out[:, slot] = rows[:, 0].to(cache.dtype)
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
    x = gather_rows(x, p["wq"], p["wk"], p["wv"])
    q = _mm(x, p["wq"])
    k = _mm(x, p["wk"])
    v = _mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = heads_reshape(q, (b, s, nq, hd))
    k = heads_reshape(k, (b, s, nkv, hd))
    v = heads_reshape(v, (b, s, nkv, hd))
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if cache is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if is_dtensor(q):
            o = _sharded_attention(q, k, v, cfg.attn_window)
        elif cfg.attn_window and cfg.attn_window < s:
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
        cpos = _put(cache["pos"], slot, torch.full(
            (b, 1), pos, dtype=cache["pos"].dtype, device=x.device))
        low = pos - (cfg.attn_window or _FULL)
        # cpos == -1 marks a never-written slot; it must stay masked or the
        # zero keys dilute the softmax (decode != prefill).
        valid = (cpos >= 0) & (cpos <= pos) & (cpos > low)
        o = _decode_attn_ring(q, ck, cv, valid)
        new_cache = {"k": ck, "v": cv, "pos": cpos}
    o = heads_reshape(o, (b, s, nq * hd))
    return _mm(o, p["wo"]).to(x.dtype), new_cache


def _tok_dp():
    """The batch entry of a loop's layout: the token axes, or None under
    ``seq_shard`` (the sequence is over the token axes between blocks, and
    a loop needs it whole)."""
    return current_spmd().act_spec[0]


def _tok_axes() -> tuple:
    """The mesh axes of :func:`_tok_dp`: a weight used inside a loop on
    each rank's own batch rows gets a partial gradient over them."""
    e = _tok_dp()
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def _expand_kv_dt(k, n_heads: int):
    """``_expand_kv`` of a DTensor as a broadcast and a reshape (DTensor
    has sharding rules for both; the values are ``repeat_interleave``'s)."""
    b, s, nkv, hd = k.shape
    if nkv == n_heads:
        return k
    return k.unsqueeze(3).expand(b, s, nkv, n_heads // nkv, hd).reshape(
        b, s, n_heads, hd)


def _sharded_attention(q, k, v, window):
    """Blocked (or, with a ``window`` shorter than S, banded) attention of
    DTensors q [B,S,Hq,D], k/v [B,S,Hkv,D] on local shards: sequence
    full, batch over the token axes, heads over 'model'.  Under block-SP —
    and whenever the model axis does not divide both head counts — KV is
    expanded to the full query-head count FIRST (an expansion after a
    head-sharding constraint would reshard), as the reference does; GQA
    groups that divide evenly keep their KV heads and expand locally."""
    b, s, nq, _ = q.shape
    m = current_spmd().sizes.get("model", 1)
    if _bsp_active() or nq % m or k.shape[2] % m:
        k = _expand_kv_dt(k, nq)
        v = _expand_kv_dt(v, nq)
    hspec = P(_bsp_dp() if _bsp_active() else _tok_dp(), None, "model",
              None)
    ql, kl, vl = (to_local_as(t, hspec) for t in (q, k, v))
    if window and window < s:
        o = banded_attention(ql, kl, vl, window)
    else:
        o = blocked_attention(ql, kl, vl, causal=True)
    return from_local_as(o, hspec, (b, s, nq, v.shape[-1]))


def _decode_attn_ring(q, ck, cv, valid):
    """Decode attention over a (possibly ring-buffer) cache with an explicit
    per-slot validity mask.  q [B,1,Hq,hd], ck/cv [B,W,Hkv,hd]."""
    b, _, hq, hd = q.shape
    nkv = ck.shape[2]
    if is_dtensor(ck):
        return _sharded_decode_attn(q, ck, cv, valid)
    if nkv != hq:
        ck = torch.repeat_interleave(ck, hq // nkv, dim=2)
        cv = torch.repeat_interleave(cv, hq // nkv, dim=2)
    sc = torch.einsum("bohd,bshd->bhos", q.float(), ck.float()) * _inv_sqrt(hd)
    sc = torch.where(valid[:, None, None, :], sc, -1e30)
    w = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhos,bshd->bohd", w, cv.float())
    return o.to(q.dtype)


def _axes_of(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def _all_reduce(x, axes, op: str):
    """``x`` reduced (``"sum"`` or ``"max"``) over the mesh ``axes``, on
    local shards (decode: no gradient)."""
    import torch.distributed._functional_collectives as funcol
    mesh = current_spmd().mesh
    for a in axes:
        x = funcol.wait_tensor(funcol.all_reduce(x, op, mesh.get_group(a)))
    return x


def _sharded_decode_attn(q, ck, cv, valid):
    """``_decode_attn_ring`` of DTensors on local shards, in the cache's
    layout (``decode_state_specs``): batch over the token axes, kv heads
    (and the query heads with them) or head_dim over 'model', and under
    ``seq_shard`` the cache slots over the token axes.  A head_dim split
    sums the scores over 'model'; a slot split takes the softmax's max,
    sum and weighted values over the token axes (flash-decoding)."""
    b, _, hq, hd = q.shape
    kspec = spec_of(ck)
    qspec = P(kspec[0], None, kspec[2], kspec[3])
    ql = to_local_as(q, qspec)
    ckl, cvl = to_local_as(ck, kspec), to_local_as(cv, kspec)
    vl = to_local_as(valid, P(kspec[0], kspec[1]))
    if ckl.shape[2] != ql.shape[2]:
        rep = ql.shape[2] // ckl.shape[2]
        ckl = torch.repeat_interleave(ckl, rep, dim=2)
        cvl = torch.repeat_interleave(cvl, rep, dim=2)
    sc = torch.einsum("bohd,bshd->bhos", ql.float(), ckl.float())
    sc = _all_reduce(sc, _axes_of(kspec[3]), "sum") * _inv_sqrt(hd)
    sc = torch.where(vl[:, None, None, :], sc, -1e30)
    slots = _axes_of(kspec[1])
    if slots:
        m = _all_reduce(sc.amax(-1, keepdim=True), slots, "max")
        w = torch.exp(sc - m)
        den = _all_reduce(w.sum(-1, keepdim=True), slots, "sum")
        o = _all_reduce(torch.einsum("bhos,bshd->bhod", w, cvl.float()),
                        slots, "sum") / den
        o = o.permute(0, 2, 1, 3)
    else:
        w = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhos,bshd->bohd", w, cvl.float())
    return from_local_as(o.to(q.dtype), qspec, (b, 1, hq, hd))


def _apply_mla(cfg: ModelConfig, p: dict, x, positions, cache, pos):
    """DeepSeek MLA.  Train: expanded form.  Decode: absorbed/compressed."""
    b, s, d = x.shape
    nq = cfg.n_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    x = gather_rows(x, p["wdq"], p["wdkv"])
    cq = rms_norm(p["q_norm"], _mm(x, p["wdq"]))
    qall = heads_reshape(_mm(cq, p["wuq"]), (b, s, nq, nope + rdim))
    q_nope, q_rope = qall[..., :nope], qall[..., nope:]
    dkv = _mm(x, p["wdkv"])                     # [B,S,kvl+rdim]
    ckv = rms_norm(p["kv_norm"], dkv[..., :kvl])
    k_rope = dkv[..., kvl:].reshape(b, s, 1, rdim)
    if cache is None:
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        k_rope_r = rope(k_rope, positions, cfg.rope_theta)
        kv = heads_reshape(_mm(ckv, p["wukv"]), (b, s, nq, nope + vdim))
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_rope_r.expand(b, s, nq, rdim)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        if is_dtensor(q):
            # heads over 'model' (block-SP's layout, and the loop's)
            o = _sharded_attention(q, k, v, None)
        else:
            o = blocked_attention(q, k, v, causal=True)
        o = heads_reshape(o, (b, s, nq * vdim))
        return _mm(o, p["wo"]).to(x.dtype), None
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
    o = heads_reshape(o, (b, s, nq * vdim)).to(x.dtype)
    return _mm(o, p["wo"]), {"ckv": c_cache, "kr": r_cache}


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
    x = gather_rows(x, *(p[k] for k in ("wg", "wu", "wi") if k in p))
    if cfg.ffn_act == "swiglu":
        return _mm(F.silu(_mm(x, p["wg"])) * _mm(x, p["wu"]), p["wd"])
    # jax.nn.gelu's default is the tanh form
    return _mm(F.gelu(_mm(x, p["wi"]) + p["bi"], approximate="tanh"),
               p["wd"])


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


def _route(cfg: ModelConfig, router, xf, capacity_factor: float):
    """The sort-based top-k dispatch of tokens ``xf`` [T, D]: ``(gates
    [T,E], counts [E], tok_s, gate_s, keep, slot, cap)``, the assignments
    sorted by expert id (stable), each expert keeping its first ``cap =
    int(T * k / E * capacity_factor)`` in token order; ``slot`` is an
    assignment's row of the ``[E * cap]`` buffer, or ``E * cap`` (the
    sentinel) when dropped."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    dev = xf.device
    logits = xf.float() @ router
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
    return gates, counts, tok_s, gate_s, keep, slot, cap


def _dispatch_rows(xf, tok_s, keep, slot, n_rows: int):
    """The ``[n_rows, D]`` expert buffer: each kept assignment's token row
    at its slot (the sentinel row dropped)."""
    rows = torch.where(keep[:, None], xf[tok_s], 0.0)
    buf = torch.zeros((n_rows + 1, xf.shape[1]), dtype=xf.dtype,
                      device=xf.device).index_add(0, slot, rows)
    return buf[:n_rows]


def _expert_ffn(buf3, wg, wu, wd):
    """SwiGLU of each expert's rows: buf3 [E,C,D] -> [E,C,D]."""
    hg = F.silu(torch.einsum("ecd,edf->ecf", buf3, wg))
    hu = torch.einsum("ecd,edf->ecf", buf3, wu)
    return torch.einsum("ecf,efd->ecd", hg * hu, wd)


def _combine(ho_rows, tok_s, gate_s, keep, slot, t: int, dtype):
    """Each token's gate-weighted sum of its kept experts' rows
    (``ho_rows`` [E*cap, D])."""
    d = ho_rows.shape[1]
    out_rows = torch.cat([ho_rows, torch.zeros((1, d), dtype=ho_rows.dtype,
                                               device=ho_rows.device)])
    vals = torch.where(keep, gate_s, 0.0)[:, None].to(dtype) * out_rows[slot]
    return torch.zeros((t, d), dtype=dtype, device=ho_rows.device).index_add(
        0, tok_s, vals)


def _aux(cfg: ModelConfig, gates, counts):
    """The Switch-style load-balance aux loss of one dispatch."""
    t = gates.shape[0]
    me = gates.mean(0)
    frac = counts.float() / max(1, t * cfg.top_k)
    return (me * frac).sum() * cfg.n_experts


def _apply_moe(cfg: ModelConfig, p: dict, x, capacity_factor: float = 1.25):
    """Top-k MoE with sort-based capacity dispatch over the whole batch.

    Tokens are routed to ``[E, cap]`` expert buffers through a stable sort
    on expert id (no [T, E, cap] one-hot); each expert keeps its first
    ``cap = int(T * k / E * capacity_factor)`` assignments in token order,
    the rest land on a sentinel row and are dropped (the residual path
    keeps them).  Returns (out, the Switch-style load-balance aux loss).
    """
    b, s, d = x.shape
    e = cfg.n_experts
    t = b * s
    xf = x.reshape(t, d)
    gates, counts, tok_s, gate_s, keep, slot, cap = _route(
        cfg, p["router"], xf, capacity_factor)
    buf = _dispatch_rows(xf, tok_s, keep, slot, e * cap)
    ho = _expert_ffn(buf.reshape(e, cap, d), p["wg"], p["wu"], p["wd"])
    out = _combine(ho.reshape(e * cap, d), tok_s, gate_s, keep, slot, t,
                   x.dtype)
    if cfg.n_shared_experts:
        out = out + _apply_ffn(cfg, p["shared"], xf)
    aux = _aux(cfg, gates, counts)
    return out.reshape(b, s, d).to(x.dtype), aux


def _spec_axes(spec) -> set:
    named = set()
    for ax in tuple(spec):
        if ax is not None:
            named.update(ax if isinstance(ax, tuple) else (ax,))
    return named


def _dp_only_spec(act_spec, dp: tuple[str, ...], rank: int = 3):
    """Strip non-dp axes from an activation spec (the reference's
    partial-manual shard_map in_specs may only name manual axes)."""
    entries = (list(act_spec) + [None] * rank)[:rank]

    def keep(e):
        if e is None:
            return None
        axes = e if isinstance(e, tuple) else (e,)
        return e if set(axes) <= set(dp) else None

    return P(*(keep(e) for e in entries))


def _mesh_mean(x, ctx, axes):
    """``pmean`` over the mesh ``axes`` of a value every rank then holds
    and uses as one (backward: each rank's share of the cotangent)."""
    from ...dist.collectives import mesh_all_reduce
    n = 1
    for a in axes:
        x = mesh_all_reduce(x, ctx.mesh.get_group(a), varying=False)
        n *= ctx.sizes[a]
    return x / n


def _moe_dispatch(cfg: ModelConfig, p: dict, h):
    """MoE entry point.

    - No SpmdCtx (single-device), or ``h`` not a DTensor: plain
      whole-batch dispatch.
    - Token dims that do not split evenly over the axes the activation
      spec names (a 1-token decode step against a sequence-sharded spec):
      whole-batch dispatch, the tokens replicated (the reference's
      ``_apply_moe`` under GSPMD; the same capacity and values).
    - E % model_axis == 0 (deepseek-class): fully-manual **expert
      parallelism** — tokens all_to_all to expert owners over 'model',
      expert weights sharded [E/model, D/data, F] (gathered over 'data'
      per layer, FSDP-style).
    - otherwise (mixtral-class): per-dp-group dispatch (the reference's
      partial-manual shard_map over the dp axes); expert FFN dims stay
      sharded over 'model' (tensor-parallel experts).
    """
    ctx = current_spmd()
    if ctx is None or not ctx.moe_group or not is_dtensor(h):
        return _apply_moe(cfg, p, h)
    sizes = ctx.sizes
    m_size = sizes.get("model", 1)
    ep = m_size > 1 and cfg.n_experts % m_size == 0
    for dim, ax in zip(h.shape, tuple(ctx.act_spec) + (None,) * h.ndim):
        axes = ax if isinstance(ax, tuple) else (ax,) if ax else ()
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        if n > 1 and dim % n != 0:
            if ep:
                return _apply_moe_ep(cfg, p, h, ctx, act=P(None, None, None))
            return _moe_groups(cfg, p, h, ctx, P(None, None, None), ())
    if ep:
        return _apply_moe_ep(cfg, p, h, ctx)
    return _moe_groups(cfg, p, h, ctx,
                       _dp_only_spec(ctx.act_spec, ctx.dp_axes), ctx.dp_axes)


def _moe_groups(cfg: ModelConfig, p: dict, h, ctx, spec, dp,
                capacity_factor: float = 1.25):
    """``_apply_moe`` on each dp group's tokens (``h`` redistributed to
    ``spec``: sharded over the dp axes only, the same on every 'model'
    rank), ``aux`` averaged over ``dp``.  The routing runs on every
    'model' rank alike; the expert FFN (and the shared expert) run on each
    rank's slice of F, their partial sums all-reduced over 'model'."""
    from ...dist.collectives import mesh_all_reduce
    m_group = ctx.mesh.get_group("model")
    e = cfg.n_experts
    h = _constrain_to(h, spec)          # one gather, two local views
    x_route = to_local_as(h, spec)
    # each 'model' rank's F slice gives a part of the expert rows' gradient
    x_exp = to_local_as(h, spec, partial_over=("model",))
    router = to_local_as(p["router"], P(), partial_over=dp)
    wg = to_local_as(p["wg"], P(None, None, "model"), partial_over=dp)
    wu = to_local_as(p["wu"], P(None, None, "model"), partial_over=dp)
    wd = to_local_as(p["wd"], P(None, "model", None), partial_over=dp)
    b, s, d = x_route.shape
    t = b * s
    gates, counts, tok_s, gate_s, keep, slot, cap = _route(
        cfg, router, x_route.reshape(t, d), capacity_factor)
    buf = _dispatch_rows(x_exp.reshape(t, d), tok_s, keep, slot, e * cap)
    ho = mesh_all_reduce(_expert_ffn(buf.reshape(e, cap, d), wg, wu, wd),
                         m_group, varying=False)
    out = _combine(ho.reshape(e * cap, d), tok_s, gate_s, keep, slot, t,
                   h.dtype)
    if cfg.n_shared_experts:
        sh = {k: to_local_as(w, P(None, "model") if k in ("wg", "wu", "wi")
                             else P("model") if k == "bi"
                             else P("model", None), partial_over=dp)
              for k, w in p["shared"].items()}
        out = out + mesh_all_reduce(_apply_ffn(cfg, sh, x_exp.reshape(t, d)),
                                    m_group, varying=False)
    aux = _mesh_mean(_aux(cfg, gates, counts), ctx, dp)
    return (from_local_as(out.reshape(b, s, d).to(h.dtype), spec, h.shape),
            from_local_as(aux, P(), ()))


def _apply_moe_ep(cfg: ModelConfig, p: dict, x, ctx, act=None,
                  capacity_factor: float = 1.25):
    """Fully-manual expert-parallel MoE (GShard-style 2D: DP x EP).

    Every device routes its local tokens (``x`` under ``act``, default the
    context's activation spec) to expert owners with one ``all_to_all``
    over 'model', computes its E/model experts on the received rows
    (weights gathered over 'data'), and returns results with the reverse
    ``all_to_all``.  Capacity and ``aux`` are per device block; ``aux`` is
    then averaged over the whole mesh.  The shared expert is the
    reference's hand-written tensor-parallel one: each rank's F slice on
    its own tokens, summed over 'model'.
    """
    from ...dist.collectives import (mesh_all_gather, mesh_all_reduce,
                                     mesh_all_to_all)
    mesh = ctx.mesh
    names = tuple(mesh.mesh_dim_names)
    m_size = ctx.sizes["model"]
    e = cfg.n_experts
    e_loc = e // m_size
    act = P(*(list(act if act is not None else ctx.act_spec)
              + [None] * 3)[:3])
    data_axes = tuple(a for a in ("data",) if a in names)
    named = _spec_axes(act)
    m_group = mesh.get_group("model")
    # a weight's gradient is a partial sum over the token axes its copies
    # are used on (the 'data' gather's backward sums over 'data' itself)
    w_partial = tuple(a for a in names if a in named
                      and a not in ("model",) + data_axes)
    xl = to_local_as(x, act)
    router = to_local_as(p["router"], P(), partial_over=tuple(
        a for a in names if a in named))
    w_in = P("model", "data" if data_axes else None, None)
    w_out = P("model", None, "data" if data_axes else None)
    wg = to_local_as(p["wg"], w_in, partial_over=w_partial)
    wu = to_local_as(p["wu"], w_in, partial_over=w_partial)
    wd = to_local_as(p["wd"], w_out, partial_over=w_partial)

    b, s, d = xl.shape
    t = b * s
    xf = xl.reshape(t, d)
    gates, counts, tok_s, gate_s, keep, slot, cap = _route(
        cfg, router, xf, capacity_factor)
    buf = _dispatch_rows(xf, tok_s, keep, slot, e * cap)
    # ship rows to expert owners: [m, E_loc*cap, D] over 'model'
    recv = mesh_all_to_all(buf, m_group)
    rows_by_e = recv.reshape(m_size, e_loc, cap, d).permute(
        1, 0, 2, 3).reshape(e_loc, m_size * cap, d)
    # FSDP gather of this group's expert weights over 'data'
    if data_axes:
        d_group = mesh.get_group("data")
        wg = mesh_all_gather(wg, 1, d_group)
        wu = mesh_all_gather(wu, 1, d_group)
        wd = mesh_all_gather(wd, 2, d_group)
    ho = _expert_ffn(rows_by_e, wg, wu, wd)
    back = ho.reshape(e_loc, m_size, cap, d).permute(1, 0, 2, 3).reshape(
        e * cap, d)
    got = mesh_all_to_all(back, m_group)
    out = _combine(got, tok_s, gate_s, keep, slot, t, x.dtype)
    if cfg.n_shared_experts:
        sh_partial = tuple(a for a in names if a in named and a != "model")
        sh = {k: to_local_as(w, P("model", None) if k == "wd"
                             else P(None, "model"), partial_over=sh_partial)
              for k, w in p["shared"].items()}
        hg_s = F.silu(xf @ sh["wg"]) * (xf @ sh["wu"])
        # the sum is added to each rank's own tokens when they vary over
        # 'model' (train, prefill), so its transpose all-reduces too
        out = out + mesh_all_reduce(hg_s @ sh["wd"], m_group,
                                    varying="model" in named)
    aux = _mesh_mean(_aux(cfg, gates, counts), ctx, names)
    return (from_local_as(out.reshape(b, s, d), act, x.shape),
            from_local_as(aux, P(), ()))


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
    x = gather_rows(x, p["wq"], p["wk"], p["wv"], p["wz"])
    q = heads_reshape(_mm(x, p["wq"]), (b, s, h, dh))
    k = heads_reshape(_mm(x, p["wk"]), (b, s, h, dh))
    v = heads_reshape(_mm(x, p["wv"]), (b, s, h, dh))
    gif = _mm(x.float(), p["wif"])
    ig, fg = gif[..., :h], gif[..., h:]
    chunk = 1 if (cache is not None and s == 1) else 128
    if is_dtensor(q):
        y, st = _sharded_mlstm(q, k, v, ig, fg, cache, chunk)
    else:
        y, st = mlstm_chunked(q, k, v, ig, fg, state=cache, chunk=chunk)
    y = y.reshape(b, s, di) * F.silu(_mm(x, p["wz"]))
    out = _mm(y, p["wd"]).to(x.dtype)
    return out, (st if cache is not None else None)


def _sharded_mlstm(q, k, v, ig, fg, state, chunk: int):
    """``mlstm_chunked`` on local shards: batch over the token axes, the
    rest whole (the decode state's layout)."""
    dp = _tok_dp()
    s4, s3 = P(dp, None, None, None), P(dp, None, None)
    st = None
    if state is not None:
        st = MlstmState(c=to_local_as(state.c, s4), n=to_local_as(state.n, s3))
    y, st2 = mlstm_chunked(to_local_as(q, s4), to_local_as(k, s4),
                           to_local_as(v, s4), to_local_as(ig, s3),
                           to_local_as(fg, s3), state=st, chunk=chunk)
    b, s, h, _ = q.shape
    dk, dv = k.shape[-1], v.shape[-1]
    return (from_local_as(y, s4, (b, s, h, dv)),
            MlstmState(c=from_local_as(st2.c, s4, (b, h, dk, dv)),
                       n=from_local_as(st2.n, s3, (b, h, dk))))


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
    gx = _mm(x.float(), p["wg"])
    if is_dtensor(gx):
        return _sharded_slstm(cfg, gx, p["r"], cache, x.dtype)
    if cache is not None and s == 1:
        y, st = slstm_step(cache, gx[:, 0], p["r"], cfg.n_heads)
        return y[:, None].to(x.dtype), st
    y, st = slstm_scan(gx, p["r"], cfg.n_heads, state=cache)
    return y.to(x.dtype), (st if cache is not None else None)


def _sharded_slstm(cfg: ModelConfig, gx, r, cache, dtype):
    """``_apply_slstm`` past its input projection, on local shards: batch
    over the token axes, the rest whole."""
    dp = _tok_dp()
    b, s, d4 = gx.shape
    d = d4 // 4
    sst = P(dp, None)
    st = (None if cache is None else
          SlstmState(*(to_local_as(t, sst) for t in cache)))
    gl = to_local_as(gx, P(dp, None, None))
    rl = to_local_as(r, P(), partial_over=_tok_axes())
    if cache is not None and s == 1:
        y, st2 = slstm_step(st, gl[:, 0], rl, cfg.n_heads)
        y = y[:, None]
    else:
        y, st2 = slstm_scan(gl, rl, cfg.n_heads, state=st)
    y = from_local_as(y.to(dtype), P(dp, None, None), (b, s, d))
    if cache is None:
        return y, None
    return y, SlstmState(*(from_local_as(t, sst, (b, d)) for t in st2))


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
    xz = _mm(gather_rows(x, p["win"]), p["win"])
    xi, z = xz[..., :di], xz[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(xi, p["conv"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    scan_sharded = is_dtensor(xc) and s > 1
    if scan_sharded and _bsp_active():
        # block-SP: the selective scan's recurrence is elementwise in DI, so
        # pin every scan input to a seq-FULL, DI-over-'model' layout — the
        # time loop then runs on local shards with zero per-step
        # collectives.
        dspec = P(_bsp_dp(), None, "model")
        xc = _constrain_to(xc, dspec)
        z = _constrain_to(z, dspec)
    bc = _mm(xc, p["wbc"])
    b_in, c_in = bc[..., :n], bc[..., n:]
    delta = F.softplus(_mm(_mm(xc, p["wdt1"]), p["wdt2"])
                       + p["dt_b"]).float()
    if scan_sharded:
        # block-SP's constraints; without it, the loop's layout pinned
        # where the scan starts
        dspec = P(_tok_dp(), None, "model")
        rspec = P(_tok_dp(), None, None)
        xc = _constrain_to(xc, dspec)
        delta = _constrain_to(delta, dspec)
        b_in = _constrain_to(b_in, rspec)
        c_in = _constrain_to(c_in, rspec)
    if cache is not None and s == 1:
        y, h = selective_scan_step(cache["h"], xc[:, 0], delta[:, 0],
                                   p["a_log"], b_in[:, 0], c_in[:, 0],
                                   p["d_skip"])
        y = y[:, None]
    elif scan_sharded:
        y, h = _sharded_scan(xc, delta, p["a_log"], b_in, c_in, p["d_skip"],
                             cache["h"] if cache is not None else None)
    else:
        h0 = cache["h"] if cache is not None else None
        y, h = selective_scan(xc, delta, p["a_log"], b_in, c_in,
                              p["d_skip"], h0=h0)
    y = y * F.silu(z)
    out = _mm(y, p["wout"]).to(x.dtype)
    new_cache = ({"h": h, "conv": new_conv} if cache is not None else None)
    return out, new_cache


def _sharded_scan(xc, delta, a_log, b_in, c_in, d_skip, h0):
    """``selective_scan`` on local shards: DI over 'model' (x, delta,
    A, D, the state), B and C whole, batch over the token axes."""
    dp = _tok_dp()
    dspec, rspec, hspec = (P(dp, None, "model"), P(dp, None, None),
                           P(dp, "model", None))
    b, s, di = xc.shape
    n = a_log.shape[1]
    y, h = selective_scan(
        to_local_as(xc, dspec), to_local_as(delta, dspec),
        to_local_as(a_log, P("model", None), partial_over=_tok_axes()),
        # each rank's DI slice gives a part of B's and C's gradients
        to_local_as(b_in, rspec, partial_over=("model",)),
        to_local_as(c_in, rspec, partial_over=("model",)),
        to_local_as(d_skip, P("model"), partial_over=_tok_axes()),
        h0=None if h0 is None else to_local_as(h0, hspec))
    return (from_local_as(y, dspec, (b, s, di)),
            from_local_as(h, hspec, (b, di, n)))


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
            mo, aux = _moe_dispatch(cfg, p["moe"], h)
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
