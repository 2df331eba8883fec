"""Qwen3-8B — 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk-norm [hf:Qwen/Qwen3-8B; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512,
    dtype="float32", param_dtype="float32",
)
