"""MusicGen-large — decoder-only LM over EnCodec tokens.  [arXiv:2306.05284]

Frontend carve-out: the EnCodec conv codec is a stub — input_specs()
provides token ids in the 2048-entry codec vocabulary (delay-pattern
interleave applied upstream).  LayerNorm+GELU per the original; RoPE
substitutes the learned positional embedding (TPU adaptation note in
DESIGN.md).
"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", arch_type="audio",
    num_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    norm="layernorm", ffn_act="gelu", audio_frontend=True, remat=True,
    source="arXiv:2306.05284",
)

REDUCED = dataclasses.replace(
    CONFIG, name="musicgen-large-reduced", num_layers=2, d_model=256,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=512, remat=False)
