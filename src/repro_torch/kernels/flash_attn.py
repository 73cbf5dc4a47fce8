"""The transformer zoo's attention on the card: ``csrc/flash_attn.cu`` (a
flash-attention forward), ``csrc/flash_attn_bwd.cu`` (its backward in two
launches, on ``wgmma`` and TMA in bf16) and ``csrc/decode_attn.cu``
(one-token attention over a ring cache), and the ``torch.library`` ops the
model calls on every device.

Kernel wrappers, each with a plain integer launch counter
(``<wrapper>.launches``):

- :func:`flash_attention_fwd` — ``(o, lse)`` of q [B, S, Hq, Dqk] over
  k [B, S, Hkv, Dqk], v [B, S, Hkv, Dv], causal or not, with an optional
  sliding ``window`` (causal only);
- :func:`flash_attention_bwd_dq` — ``(dq, delta)``, ``delta =
  rowsum(dO * o)`` [B, Hq, S] written for the next launch;
- :func:`flash_attention_bwd_dkdv` — ``(dk, dv)``, summed over each KV
  head's group of query heads in registers (no atomics);
- :func:`decode_attention` — q [B, 1, Hq, D] over caches [B, W, Hkv, D]
  with a per-slot mask ``valid`` [B, W].

They take f32 or bf16 operands (one dtype) at the head widths of
:data:`WIDTHS` (flash) and :data:`DECODE_WIDTHS` (decode), copy an operand
that is not contiguous (the backward's also a q, k, v or do whose storage
is not 16-byte aligned: its TMA reads them), and raise on anything else;
each launches on the current stream of the operands' device without
synchronising and raises if the launch fails.

The ops (``torch.ops.repro_torch.*``):

- ``flash_attention(q, k, v, causal, window, q_chunk, k_chunk) -> (o,
  lse)`` with a fake implementation, an autograd formula whose backward
  is ``flash_attention_bwd`` (its CUDA implementation: the two backward
  launches), and FLOP formulas in ``torch.utils.flop_counter``'s registry
  (the visible (q, k) pairs x 2 x (Dqk + Dv) a head; the backward 2.5x
  that), so ``launch.hlo_cost.OpCounter`` reads the same FLOPs and bytes
  on every device and under ``FakeTensorMode``;
- ``decode_attention(q, k_cache, v_cache, valid) -> o`` with a fake
  implementation and a FLOP formula (every slot: the kernel scores the
  masked ones too).

On CUDA tensors an op launches the kernels; on CPU tensors it runs the
plain versions of :mod:`.ref` (``q_chunk`` / ``k_chunk`` shape only
those: the kernels pick their own tiles).  Nothing is built at import.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from . import ref
from .ell_spmm import _entry, _launch

__all__ = ["WIDTHS", "DECODE_WIDTHS", "MAX_DECODE_GROUP",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkdv", "decode_attention", "visible_pairs",
           "attention_flops"]

# (Dqk, Dv) of every config of repro_torch.configs, full and reduced:
# hymba reduced, deepseek reduced (MLA), the reduced widths of the rest
# and musicgen / hymba full, phi-3-vision, the 128-wide models, deepseek
# full (MLA)
WIDTHS = ((32, 32), (48, 32), (64, 64), (96, 96), (128, 128), (192, 128))
# head widths of the decode kernel (MLA decodes in its absorbed form, plain)
DECODE_WIDTHS = (32, 64, 96, 128)
MAX_DECODE_GROUP = 8          # query heads a KV head serves, at most

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, o, lse, B, S, Hq, Hkv, dqk, dv, causal, window, scale, bf16,
#  device, stream)
_FWD_ARGTYPES = [_PTR] * 5 + [_INT] * 8 + [_F32, _INT, _INT, _PTR]
# (q, k, v, o, dout, lse, delta, dq, ...) and (q, k, v, dout, lse, delta,
#  dk, dv, ...): the same sizes after
_BWD_ARGTYPES = [_PTR] * 8 + [_INT] * 8 + [_F32, _INT, _INT, _PTR]
# (q, k, v, valid, out, B, W, hkv, rep, D, scale, bf16, device, stream)
_DECODE_ARGTYPES = [_PTR] * 5 + [_INT] * 5 + [_F32, _INT, _INT, _PTR]


def _operands(kernel: str, named: dict) -> dict:
    """The operands contiguous, all on one CUDA device, all f32 or all
    bf16."""
    first = next(iter(named.values()))
    dev, dtype = first.device, first.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel} kernel: float32 or bfloat16 operands, "
                        f"got {dtype}")
    out = {}
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}, "
                             f"not on the CUDA device of the operands")
        if t.dtype != dtype:
            raise TypeError(f"{kernel} kernel: {name} is {t.dtype}, the "
                            f"other operands {dtype}")
        out[name] = t.contiguous()
    return out


def _aligned(ops: dict) -> dict:
    """``ops`` with a copy of each of q, k, v and do whose storage is not
    16-byte aligned (a view into a larger tensor): the backward's TMA
    reads them, and from 16-byte aligned addresses only."""
    return {n: t.clone() if n in ("q", "k", "v", "do")
            and t.data_ptr() % 16 else t for n, t in ops.items()}


def _shape(kernel: str, q, k, v, causal: bool, window: int):
    """``(B, S, Hq, Hkv, Dqk, Dv)``, checked."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{kernel} kernel: q, k, v [B, S, H, D] expected")
    b, s, hq, dqk = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    if (k.shape[:2] != (b, s) or v.shape[:3] != k.shape[:3]
            or k.shape[3] != dqk or hkv < 1 or hq % hkv):
        raise ValueError(f"{kernel} kernel: q [B, S, Hq, Dqk], k [B, S, "
                         f"Hkv, Dqk], v [B, S, Hkv, Dv] with Hq % Hkv == 0 "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (dqk, dv) not in WIDTHS:
        raise ValueError(f"{kernel} kernel: head widths (Dqk, Dv) = "
                         f"{(dqk, dv)} not among {WIDTHS}")
    if window < 0 or (window and not causal):
        raise ValueError(f"{kernel} kernel: a window must be >= 0 and "
                         "needs causal attention")
    return b, s, hq, hkv, dqk, dv


def _sizes(q, k, v, causal: bool, window: int, kernel: str) -> list:
    b, s, hq, hkv, dqk, dv = _shape(kernel, q, k, v, causal, window)
    return [b, s, hq, hkv, dqk, dv, int(causal), int(window),
            ref.inv_sqrt(dqk), int(q.dtype == torch.bfloat16)]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, S, Hq, Dv] in q's dtype, lse [B, Hq, S] f32)``: one launch
    of ``csrc/flash_attn.cu``'s forward."""
    ops = _operands("flash_attention_fwd", {"q": q, "k": k, "v": v})
    q, k, v = ops["q"], ops["k"], ops["v"]
    if not q.numel():              # a rank's empty shard: nothing to launch
        b, s, hq = q.shape[:3]
        return (q.new_empty((b, s, hq, v.shape[-1])),
                q.new_empty((b, hq, s), dtype=torch.float32))
    sizes = _sizes(q, k, v, causal, window, "flash_attention_fwd")
    b, s, hq, dv = sizes[0], sizes[1], sizes[2], sizes[5]
    o = torch.empty((b, s, hq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _launch(_entry("flash_attn", "flash_attention_fwd", _FWD_ARGTYPES),
            q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), *sizes)
    flash_attention_fwd.launches += 1
    return o, lse


def _lse_like(kernel: str, t: torch.Tensor, b: int, hq: int, s: int,
              dev) -> torch.Tensor:
    if t.shape != (b, hq, s) or t.dtype != torch.float32 or t.device != dev:
        raise ValueError(f"{kernel} kernel: f32 [B, Hq, S] = {(b, hq, s)} "
                         f"on {dev} expected, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def flash_attention_bwd_dq(do: torch.Tensor, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, lse: torch.Tensor,
                           causal: bool = True, window: int = 0
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dq [B, S, Hq, Dqk] in q's dtype, delta [B, Hq, S] f32)`` from
    the forward's operands, its ``o`` and ``lse`` and the cotangent ``do``:
    one launch."""
    ops = _aligned(_operands("flash_attention_bwd_dq",
                             {"q": q, "k": k, "v": v, "o": o, "do": do}))
    sizes = _sizes(ops["q"], ops["k"], ops["v"], causal, window,
                   "flash_attention_bwd_dq")
    b, s, hq, dqk, dv = sizes[0], sizes[1], sizes[2], sizes[4], sizes[5]
    for name in ("o", "do"):
        if ops[name].shape != (b, s, hq, dv):
            raise ValueError(f"flash_attention_bwd_dq kernel: {name} "
                             f"[B, S, Hq, Dv] = {(b, s, hq, dv)} expected, "
                             f"got {tuple(ops[name].shape)}")
    dev = ops["q"].device
    lse = _lse_like("flash_attention_bwd_dq", lse, b, hq, s, dev)
    dq = torch.empty((b, s, hq, dqk), dtype=q.dtype, device=dev)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    _launch(_entry("flash_attn_bwd", "flash_attention_bwd_dq",
                   _BWD_ARGTYPES),
            dev.index, *(ops[n].data_ptr() for n in ("q", "k", "v", "o",
                                                     "do")),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *sizes)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd_dkdv(do: torch.Tensor, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor,
                             causal: bool = True, window: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dk [B, S, Hkv, Dqk], dv [B, S, Hkv, Dv])`` in k's dtype, each
    summed over its KV head's query heads, from the forward's operands,
    ``lse``, ``delta`` (:func:`flash_attention_bwd_dq`'s) and ``do``: one
    launch."""
    ops = _aligned(_operands("flash_attention_bwd_dkdv",
                             {"q": q, "k": k, "v": v, "do": do}))
    sizes = _sizes(ops["q"], ops["k"], ops["v"], causal, window,
                   "flash_attention_bwd_dkdv")
    b, s, hq, hkv, dqk, dv = sizes[:6]
    if ops["do"].shape != (b, s, hq, dv):
        raise ValueError(f"flash_attention_bwd_dkdv kernel: do [B, S, Hq, "
                         f"Dv] = {(b, s, hq, dv)} expected, got "
                         f"{tuple(ops['do'].shape)}")
    dev = ops["q"].device
    lse = _lse_like("flash_attention_bwd_dkdv", lse, b, hq, s, dev)
    delta = _lse_like("flash_attention_bwd_dkdv", delta, b, hq, s, dev)
    dk = torch.empty((b, s, hkv, dqk), dtype=k.dtype, device=dev)
    dvv = torch.empty((b, s, hkv, dv), dtype=k.dtype, device=dev)
    _launch(_entry("flash_attn_bwd", "flash_attention_bwd_dkdv",
                   _BWD_ARGTYPES),
            dev.index, *(ops[n].data_ptr() for n in ("q", "k", "v", "do")),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            *sizes)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dvv


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """o [B, 1, Hq, D] in q's dtype: one launch of ``csrc/decode_attn.cu``
    (a block per KV head and batch row)."""
    ops = _operands("decode_attention", {"q": q, "k_cache": k_cache,
                                         "v_cache": v_cache})
    q, ck, cv = ops["q"], ops["k_cache"], ops["v_cache"]
    if q.dim() != 4 or ck.dim() != 4 or q.shape[1] != 1 \
            or cv.shape != ck.shape or ck.shape[0] != q.shape[0] \
            or ck.shape[3] != q.shape[3]:
        raise ValueError(f"decode_attention kernel: q [B, 1, Hq, D] and "
                         f"caches [B, W, Hkv, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(ck.shape)}, "
                         f"{tuple(cv.shape)}")
    b, _, hq, d = q.shape
    w, hkv = ck.shape[1], ck.shape[2]
    if d not in DECODE_WIDTHS:
        raise ValueError(f"decode_attention kernel: head width {d} not "
                         f"among {DECODE_WIDTHS}")
    if hq % hkv or hq // hkv > MAX_DECODE_GROUP:
        raise ValueError(f"decode_attention kernel: {hq} query heads over "
                         f"{hkv} KV heads (at most {MAX_DECODE_GROUP} a "
                         f"group)")
    if valid.dtype != torch.bool or valid.shape != (b, w) \
            or valid.device != q.device:
        raise ValueError(f"decode_attention kernel: valid bool [B, W] = "
                         f"{(b, w)} on {q.device} expected, got "
                         f"{valid.dtype} {tuple(valid.shape)} on "
                         f"{valid.device}")
    valid = valid.contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_entry("decode_attn", "decode_attention", _DECODE_ARGTYPES),
            q.device.index, q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
            valid.data_ptr(), out.data_ptr(), b, w, hkv, hq // hkv, d,
            ref.inv_sqrt(d), int(q.dtype == torch.bfloat16))
    decode_attention.launches += 1
    return out


for _fn in (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkdv, decode_attention):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def visible_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of one head that score: ``s * s``, the
    causal triangle ``s (s + 1) / 2``, or with a window ``w < s`` the band
    ``w (w + 1) / 2 + (s - w) w``."""
    if not causal:
        return s * s
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_flops(q_shape, v_shape, causal: bool, window: int) -> int:
    """The forward's FLOPs: visible pairs x 2 x (Dqk + Dv) a head."""
    b, s, hq, dqk = q_shape
    return b * hq * visible_pairs(s, causal, window) * 2 * (dqk + v_shape[-1])


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, window: int, q_chunk: int, k_chunk: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.flash_attention_ref(q, k, v, causal, window, q_chunk, k_chunk)


@_flash_attention.register_kernel("cuda")
def _(q, k, v, causal, window, q_chunk, k_chunk):
    return flash_attention_fwd(q, k, v, causal, window)


@_flash_attention.register_fake
def _(q, k, v, causal, window, q_chunk, k_chunk):
    b, s, hq, _ = q.shape
    return (q.new_empty((b, s, hq, v.shape[-1])),
            q.new_empty((b, hq, s), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd",
                         mutates_args=(), device_types="cpu")
def _flash_attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                         causal: bool, window: int, q_chunk: int,
                         k_chunk: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return ref.flash_attention_bwd_ref(do, q, k, v, o, lse, causal, window,
                                       q_chunk, k_chunk)


@_flash_attention_bwd.register_kernel("cuda")
def _(do, q, k, v, o, lse, causal, window, q_chunk, k_chunk):
    if not q.numel():              # a rank's empty shard
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = flash_attention_bwd_dq(do, q, k, v, o, lse, causal, window)
    dk, dv = flash_attention_bwd_dkdv(do, q, k, v, lse, delta, causal,
                                      window)
    return dq, dk, dv


@_flash_attention_bwd.register_fake
def _(do, q, k, v, o, lse, causal, window, q_chunk, k_chunk):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, q_chunk, k_chunk = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = (causal, window, q_chunk, k_chunk)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
        do, q, k, v, o, lse, *ctx.args)
    return dq, dk, dv, None, None, None, None


_flash_attention.register_autograd(_backward, setup_context=_setup_context)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cpu")
def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    return ref.decode_attention_ref(q, k_cache, v_cache, valid)


@_decode_attention.register_kernel("cuda")
def _(q, k_cache, v_cache, valid):
    return decode_attention(q, k_cache, v_cache, valid)


@_decode_attention.register_fake
def _(q, k_cache, v_cache, valid):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args,
                 out_shape=None, **kwargs) -> int:
    return attention_flops(q_shape, v_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(do_shape, q_shape, k_shape, v_shape, o_shape, lse_shape,
                     causal, window, *args, out_shape=None, **kwargs) -> int:
    return attention_flops(q_shape, v_shape, causal, window) * 5 // 2


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_flops(q_shape, k_shape, v_shape, valid_shape, *args,
                  out_shape=None, **kwargs) -> int:
    b, _, hq, d = q_shape
    return b * hq * k_shape[1] * 2 * (d + v_shape[-1])
