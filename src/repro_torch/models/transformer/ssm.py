"""SSM / recurrent primitives: chunked mLSTM, Mamba selective scan, sLSTM,
the JAX package's ``models/transformer/ssm.py`` in plain torch.

- **mLSTM** (xLSTM): the decay is a scalar per head per step, so the
  chunkwise-parallel dual form applies: intra-chunk work is a masked,
  decay-weighted ``q @ k^T`` over ``[c, c]`` tiles, and the inter-chunk
  state ``C [H, dh, dh]`` is carried over the chunks.
- **Mamba** selective scan: the decay is per channel and per state, so it
  runs as a sequential loop over time with a small carried state
  ``[B, d_inner, N]``.
- **sLSTM** has head-block recurrent matrices R (h_{t-1} feeds the gates),
  which is inherently sequential.

The reference's ``lax.scan`` loops are Python loops over the chunks or the
time steps here.  Every scan is causal and takes and returns its state, so
decode reuses the same cell code one step at a time.  States and scan
arithmetic are f32; outputs take the input's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .attention import _inv_sqrt

__all__ = ["MlstmState", "mlstm_chunked", "mlstm_step", "selective_scan",
           "selective_scan_step", "SlstmState", "slstm_scan", "slstm_step"]


# ---------------------------------------------------------------------------
# mLSTM (chunkwise-parallel linear attention with scalar per-head gates)
# ---------------------------------------------------------------------------

class MlstmState(NamedTuple):
    c: torch.Tensor   # [B, H, dk, dv] matrix memory
    n: torch.Tensor   # [B, H, dk]     normalizer


def mlstm_chunked(q, k, v, i_gate, f_gate, state: MlstmState | None = None,
                  chunk: int = 128):
    """q/k/v [B,S,H,dh]; i_gate/f_gate [B,S,H] (pre-activations).

    f = sigmoid(f_gate) (log-decay <= 0), i = exp(clip(i_gate)) per the
    xLSTM exponential input gate (clipped for stability; the |q.n|
    denominator provides the scale normalisation).  Padding rows get
    ``f_gate = 30`` (f = 1), so they leave the state as it is.
    Returns (y [B,S,H,dh], final MlstmState).
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, 0, 0, pad))
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=30.0)
    sp = q.shape[1]
    n_chunks = sp // c
    scale = _inv_sqrt(dk)

    lf = F.logsigmoid(f_gate.float())                       # [B,S,H] <= 0
    li = torch.clamp(i_gate.float(), -20.0, 10.0)

    q_r = q.reshape(b, n_chunks, c, h, dk).permute(1, 0, 3, 2, 4)  # [n,B,H,c,dk]
    k_r = k.reshape(b, n_chunks, c, h, dk).permute(1, 0, 3, 2, 4)
    v_r = v.reshape(b, n_chunks, c, h, dv).permute(1, 0, 3, 2, 4)
    lf_r = lf.reshape(b, n_chunks, c, h).permute(1, 0, 3, 2)       # [n,B,H,c]
    li_r = li.reshape(b, n_chunks, c, h).permute(1, 0, 3, 2)

    if state is None:
        state = MlstmState(
            c=torch.zeros((b, h, dk, dv), dtype=torch.float32,
                          device=q.device),
            n=torch.zeros((b, h, dk), dtype=torch.float32, device=q.device))
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=q.device))
    c0, n0 = state
    ys = []
    for i in range(n_chunks):
        qb, kb, vb = q_r[i].float(), k_r[i].float(), v_r[i].float()
        lfb, lib = lf_r[i], li_r[i]                # [B,H,c]
        lf_cum = torch.cumsum(lfb, dim=-1)         # log prod f up to t
        # intra-chunk: D[t,i] = exp(lf_cum[t] - lf_cum[i]) for i <= t
        # (masked before the exp: above the diagonal dmat + li can reach
        # exp's overflow, and an inf there turns the gradient NaN)
        dmat = lf_cum[..., :, None] - lf_cum[..., None, :]
        wts = torch.exp(torch.where(causal, dmat + lib[..., None, :],
                                    -torch.inf))
        sc = torch.einsum("bhtd,bhid->bhti", qb, kb) * scale
        sc = sc * wts
        y_intra = torch.einsum("bhti,bhiv->bhtv", sc, vb)
        n_intra = torch.einsum("bhti,bhid->bhtd", wts, kb) * scale
        # inter-chunk: decayed read of the carried state
        decay_t = torch.exp(lf_cum)                # [B,H,c]
        y_inter = torch.einsum("bhtd,bhdv->bhtv", qb, c0) \
            * decay_t[..., None] * scale
        n_inter = torch.einsum("bhtd,bhd->bht", qb, n0) * decay_t * scale
        denom_intra = torch.einsum("bhtd,bhtd->bht", qb, n_intra)
        denom = torch.abs(denom_intra + n_inter)
        ys.append((y_intra + y_inter)
                  / torch.clamp(denom, min=1.0)[..., None])
        # state update
        total = lf_cum[..., -1]                    # [B,H]
        wts_end = torch.exp(total[..., None] - lf_cum + lib)   # [B,H,c]
        kv = torch.einsum("bhid,bhiv->bhdv", kb * wts_end[..., None], vb)
        c0 = c0 * torch.exp(total)[..., None, None] + kv
        n0 = n0 * torch.exp(total)[..., None] + torch.einsum(
            "bhid,bhi->bhd", kb, wts_end)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, sp, h, dv)[:, :s]
    return y.to(q.dtype), MlstmState(c=c0, n=n0)


def mlstm_step(state: MlstmState, q, k, v, i_gate, f_gate):
    """Single decode step.  q/k/v [B,1,H,dh], gates [B,1,H]."""
    return mlstm_chunked(q, k, v, i_gate, f_gate, state=state, chunk=1)


# ---------------------------------------------------------------------------
# Mamba selective scan
# ---------------------------------------------------------------------------

def selective_scan(x, delta, a_log, b_in, c_in, d_skip,
                   h0: torch.Tensor | None = None):
    """Mamba S4D-real selective scan (sequential over time).

    x      [B,S,DI]      input (post conv+silu)
    delta  [B,S,DI]      softplus'd step sizes
    a_log  [DI,N]        A = -exp(a_log)
    b_in   [B,S,N]
    c_in   [B,S,N]
    d_skip [DI]
    h0     [B,DI,N] carried state (zeros if None)
    Returns (y [B,S,DI], h_final).
    """
    bsz, s, di = x.shape
    n = a_log.shape[1]
    a = -torch.exp(a_log.float())                     # [DI,N]
    h = h0 if h0 is not None else torch.zeros(
        (bsz, di, n), dtype=torch.float32, device=x.device)
    xs, ds = x.float(), delta.float()
    bs, cs = b_in.float(), c_in.float()
    ys = []
    for t in range(s):
        xt, dt, bt, ct = xs[:, t], ds[:, t], bs[:, t], cs[:, t]
        decay = torch.exp(dt[..., None] * a)          # [B,DI,N]
        h = h * decay + (dt * xt)[..., None] * bt[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, ct))
    y = torch.stack(ys, dim=1) + x.float() * d_skip
    return y.to(x.dtype), h


def selective_scan_step(h, xt, dt, a_log, bt, ct, d_skip):
    """One decode step: xt/dt [B,DI], bt/ct [B,N], h [B,DI,N]."""
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt.float()[..., None] * a)
    h = h * decay + (dt * xt).float()[..., None] * bt[:, None, :].float()
    y = torch.einsum("bdn,bn->bd", h, ct.float())
    y = y + xt.float() * d_skip
    return y.to(xt.dtype), h


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating, block-diagonal recurrence)
# ---------------------------------------------------------------------------

class SlstmState(NamedTuple):
    c: torch.Tensor   # [B, D]
    n: torch.Tensor   # [B, D]
    h: torch.Tensor   # [B, D]
    m: torch.Tensor   # [B, D] stabilizer


def _slstm_cell(state: SlstmState, gates_x, r_blocks, n_heads):
    """gates_x [B, 4D] = W x_t + b (z,i,f,o pre-acts before recurrence)."""
    c0, n0, h0, m0 = state
    bsz, d = c0.shape
    dh = d // n_heads
    h_heads = h0.reshape(bsz, n_heads, dh)
    rec = torch.einsum("bhd,hgde->bhge", h_heads, r_blocks)   # [B,H,4,dh]
    rec = rec.permute(0, 2, 1, 3).reshape(bsz, 4 * d)
    z_, i_, f_, o_ = torch.chunk(gates_x + rec, 4, dim=-1)
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    # stabilized exponential gating (xLSTM eq. 15-17)
    log_f = F.logsigmoid(f_)
    m1 = torch.maximum(log_f + m0, i_)
    i = torch.exp(i_ - m1)
    f = torch.exp(log_f + m0 - m1)
    c1 = f * c0 + i * z
    n1 = f * n0 + i
    h1 = o * (c1 / torch.clamp(n1, min=1.0))
    return SlstmState(c=c1, n=n1, h=h1, m=m1)


def slstm_scan(gates_x, r_blocks, n_heads: int,
               state: SlstmState | None = None):
    """gates_x [B,S,4D]; r_blocks [H,4,dh,dh].  Returns (h [B,S,D], state)."""
    bsz, s, d4 = gates_x.shape
    d = d4 // 4
    if state is None:
        z = torch.zeros((bsz, d), dtype=torch.float32, device=gates_x.device)
        state = SlstmState(c=z, n=z, h=z, m=z)
    gx = gates_x.float()
    hs = []
    for t in range(s):
        state = _slstm_cell(state, gx[:, t], r_blocks, n_heads)
        hs.append(state.h)
    return torch.stack(hs, dim=1).to(gates_x.dtype), state


def slstm_step(state: SlstmState, gates_x, r_blocks, n_heads: int):
    """One decode step: gates_x [B, 4D]."""
    st = _slstm_cell(state, gates_x.float(), r_blocks, n_heads)
    return st.h.to(gates_x.dtype), st
