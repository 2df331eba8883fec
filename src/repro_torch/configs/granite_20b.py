"""Granite 20B (code) — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-arch [arXiv:2405.04324; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=256,
    vocab=512,
    dtype="float32", param_dtype="float32",
)
