"""Unified transformer-family model configuration.

One dataclass covers the 10 assigned architectures (dense GQA, MoE, MLA,
xLSTM, Mamba-hybrid, VLM/audio backbones).  Each
``src/repro_torch/configs/<id>.py`` instantiates it with the published
numbers (source cited there).  A copy of the JAX package's
``models/transformer/config.py`` (it holds no JAX): the port imports
nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

__all__ = ["ModelConfig", "BlockKind"]

BlockKind = Literal["attn_dense", "attn_moe", "mlstm", "slstm", "hybrid"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 => d_model // n_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    attn_window: Optional[int] = None    # sliding-window size (None = full)
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    ffn_act: str = "swiglu"              # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                    # per-expert FFN width (0 = d_ff)
    n_dense_layers: int = 0              # leading dense layers (deepseek)
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    slstm_every: int = 0                 # xLSTM: every k-th block is sLSTM
    # frontends (stubs per brief)
    vision_tokens: int = 0               # VLM: patch embeddings prepended
    audio_frontend: bool = False
    # numerics / training
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    remat: bool = False                  # activation checkpoint per block
    # citation for the numbers above
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (shardable over 16-way model
        axis with lane-aligned 128-multiples per shard)."""
        return ((self.vocab_size + 255) // 256) * 256

    def block_kinds(self) -> list[str]:
        kinds: list[str] = []
        for i in range(self.num_layers):
            if self.arch_type == "ssm":
                if self.slstm_every and i % self.slstm_every == 0:
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.arch_type == "hybrid":
                kinds.append("hybrid")
            elif self.n_experts > 0 and i >= self.n_dense_layers:
                kinds.append("attn_moe")
            else:
                kinds.append("attn_dense")
        return kinds

    def block_runs(self) -> list[tuple[str, int, int]]:
        """Contiguous (kind, start, length) runs — each run is one scan."""
        kinds = self.block_kinds()
        runs: list[tuple[str, int, int]] = []
        i = 0
        while i < len(kinds):
            j = i
            while j < len(kinds) and kinds[j] == kinds[i]:
                j += 1
            runs.append((kinds[i], i, j - i))
            i = j
        return runs

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for kind in self.block_kinds():
            if kind in ("attn_dense", "attn_moe"):
                if self.use_mla:
                    ql = self.q_lora_rank or d
                    attn = d * ql + ql * nq * (self.qk_nope_dim + self.qk_rope_dim)
                    attn += d * (self.kv_lora_rank + self.qk_rope_dim)
                    attn += self.kv_lora_rank * nq * (self.qk_nope_dim + self.v_head_dim)
                    attn += nq * self.v_head_dim * d
                else:
                    attn = d * (nq + 2 * nkv) * hd + nq * hd * d
                total += attn
                if kind == "attn_dense":
                    ff = self.d_ff
                    total += d * ff * (3 if self.ffn_act == "swiglu" else 2)
                else:
                    fe = self.moe_d_ff or self.d_ff
                    total += self.n_experts * d * fe * 3
                    total += self.n_shared_experts * d * fe * 3
                    total += d * self.n_experts  # router
            elif kind == "mlstm":
                di = self.d_model * self.ssm_expand
                # wq,wk,wv,wz [d,di] + wd [di,d] + if-gates [d,2H]
                total += 5 * d * di + 2 * d * self.n_heads
            elif kind == "slstm":
                dh = d // max(1, self.n_heads)
                total += 4 * d * d + 4 * self.n_heads * dh * dh
            elif kind == "hybrid":
                attn = d * (nq + 2 * nkv) * hd + nq * hd * d
                di = d * self.ssm_expand
                ssm = d * di * 2 + di * d + di * (2 * self.ssm_state + 1)
                total += attn + ssm + d * self.d_ff * 3
            total += 2 * d  # norms
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        fe = self.moe_d_ff or self.d_ff
        inactive = (self.n_experts - self.top_k) * d * fe * 3
        n_moe = sum(1 for k in self.block_kinds() if k == "attn_moe")
        return int(self.param_count() - n_moe * inactive)
