"""CodeQwen1.5-7B — dense MHA (kv=32) decoder, Qwen1.5 arch (QKV bias).
[hf:Qwen/CodeQwen1.5-7B]"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", arch_type="dense",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True, rope_theta=1e6, norm="rmsnorm", ffn_act="swiglu",
    remat=True, source="hf:Qwen/CodeQwen1.5-7B",
)

REDUCED = dataclasses.replace(
    CONFIG, name="codeqwen1.5-7b-reduced", num_layers=2, d_model=256,
    n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
    remat=False)
