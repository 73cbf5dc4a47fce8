"""Architecture config registry + input-shape suite.

``get_config(name)`` returns the full published config;
``get_reduced(name)`` returns the family-preserving smoke variant
(<=2 layers, d_model<=512, <=4 experts) used by CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer.config import ModelConfig

ARCH_IDS = [
    "qwen3_14b", "qwen2_1_5b", "xlstm_350m", "musicgen_large", "qwen3_1_7b",
    "phi3_vision_4_2b", "mixtral_8x7b", "deepseek_v3_671b", "hymba_1_5b",
    "codeqwen1_5_7b",
]

_ALIASES = {
    "qwen3-14b": "qwen3_14b", "qwen2-1.5b": "qwen2_1_5b",
    "xlstm-350m": "xlstm_350m", "musicgen-large": "musicgen_large",
    "qwen3-1.7b": "qwen3_1_7b", "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "mixtral-8x7b": "mixtral_8x7b", "deepseek-v3-671b": "deepseek_v3_671b",
    "hymba-1.5b": "hymba_1_5b", "codeqwen1.5-7b": "codeqwen1_5_7b",
}

# (seq_len, global_batch, kind)
INPUT_SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.REDUCED


def list_configs() -> list[str]:
    return list(ARCH_IDS)


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant for long_500k: dense archs get a 4096 sliding
    window (`+swa`); SSM/hybrid archs are already sub-quadratic."""
    if cfg.arch_type in ("ssm", "hybrid") or cfg.attn_window:
        return cfg
    return dataclasses.replace(cfg, attn_window=4096,
                               name=cfg.name + "+swa")
