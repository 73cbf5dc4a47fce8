"""Qwen2-1.5B — dense GQA decoder with QKV bias.  [arXiv:2407.10671]"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", arch_type="dense",
    num_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, norm="rmsnorm", ffn_act="swiglu",
    tie_embeddings=True, source="arXiv:2407.10671",
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2-1.5b-reduced", num_layers=2, d_model=192, n_heads=3,
    n_kv_heads=1, head_dim=64, d_ff=384, vocab_size=512)
