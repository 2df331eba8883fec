"""Mixtral 8x22B — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral_8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    top_k=2,
    moe_parallel="tp",          # the reference's mesh setting, as data
    dispatch_groups=16,
    sliding_window=4096,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, n_experts=4, top_k=2, sliding_window=64,
    dispatch_groups=2,
    dtype="float32", param_dtype="float32",
)
