"""Zamba2-7B — 81L Mamba2 backbone (ssm_state=64) + weight-shared
attention blocks (32H, GQA kv=32, d_ff=14336) interleaved every 6
layers [arXiv:2411.15242; unverified]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=32, attn_every=2,
    dtype="float32", param_dtype="float32",
)
