"""Qwen3-1.7B — dense GQA decoder with qk-norm.  [hf:Qwen/Qwen3-8B]"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", arch_type="dense",
    num_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, norm="rmsnorm", ffn_act="swiglu",
    tie_embeddings=True, source="hf:Qwen/Qwen3-8B (1.7B sibling config)",
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen3-1.7b-reduced", num_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
