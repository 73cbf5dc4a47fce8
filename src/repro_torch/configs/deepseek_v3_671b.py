"""DeepSeek-V3-671B — MLA + fine-grained MoE (1 shared + 256 routed,
top-8).  [arXiv:2412.19437]

Brief's d_ff=2048 is the per-expert (routed) width; the 3 leading dense
layers use the report's 18432.  MTP (multi-token prediction) is a training
objective add-on and is not reproduced (DESIGN.md §Arch-applicability).
"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", arch_type="moe",
    num_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    n_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=1e4, norm="rmsnorm", ffn_act="swiglu", remat=True,
    source="arXiv:2412.19437",
)

REDUCED = dataclasses.replace(
    CONFIG, name="deepseek-v3-671b-reduced", num_layers=2, d_model=256,
    n_heads=4, n_kv_heads=4, d_ff=512, moe_d_ff=128, n_experts=4, top_k=2,
    n_dense_layers=1, q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
    qk_rope_dim=16, v_head_dim=32, vocab_size=512, remat=False)
