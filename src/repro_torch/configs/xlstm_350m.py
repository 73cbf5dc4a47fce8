"""xLSTM-350M — sLSTM + mLSTM blocks (xLSTM[7:1]).  [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own up/down projections (expand=2);
every 8th block is sLSTM (scalar memory, sequential), rest mLSTM (matrix
memory, chunkwise-parallel).
"""
import dataclasses
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", arch_type="ssm",
    num_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm_expand=2, slstm_every=8, norm="layernorm",
    source="arXiv:2405.04517",
)

REDUCED = dataclasses.replace(
    CONFIG, name="xlstm-350m-reduced", num_layers=2, d_model=128, n_heads=2,
    n_kv_heads=2, vocab_size=512, slstm_every=2)
