"""Phi-3-vision-4.2B — phi3-mini decoder + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct]

Frontend carve-out: the CLIP ViT + projector is a stub — input_specs()
provides 256 pre-computed patch embeddings of width d_model, prepended to
the text sequence; loss is computed on text positions only.
"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", arch_type="vlm",
    num_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    norm="rmsnorm", ffn_act="swiglu", vision_tokens=256, remat=True,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

REDUCED = dataclasses.replace(
    CONFIG, name="phi-3-vision-4.2b-reduced", num_layers=2, d_model=256,
    n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
    vision_tokens=16, remat=False)
