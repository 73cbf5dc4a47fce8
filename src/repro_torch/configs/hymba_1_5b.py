"""Hymba-1.5B — hybrid heads: parallel attention + Mamba in every block.
[arXiv:2411.13676]

head_dim = 64 (25 heads x 64 = 1600); sliding-window attention (the
published model mixes SWA + 3 global-attention layers; we use SWA
throughout — DESIGN.md notes the simplification); vocab 32001 padded to
32256 for 16-way sharding.
"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", arch_type="hybrid",
    num_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    attn_window=1024, norm="rmsnorm", ffn_act="swiglu",
    source="arXiv:2411.13676",
)

REDUCED = dataclasses.replace(
    CONFIG, name="hymba-1.5b-reduced", num_layers=2, d_model=160, n_heads=5,
    n_kv_heads=1, head_dim=32, d_ff=320, ssm_state=8, attn_window=32,
    vocab_size=512)
