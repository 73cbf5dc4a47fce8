"""Mixtral-8x7B — sparse MoE (8 experts, top-2) with sliding-window
attention.  [arXiv:2401.04088]"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2, moe_d_ff=14336,
    attn_window=4096, rope_theta=1e6, norm="rmsnorm", ffn_act="swiglu",
    remat=True, source="arXiv:2401.04088",
)

REDUCED = dataclasses.replace(
    CONFIG, name="mixtral-8x7b-reduced", num_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, moe_d_ff=512,
    n_experts=4, top_k=2, attn_window=64, vocab_size=512, remat=False)
