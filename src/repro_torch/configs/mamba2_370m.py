"""Mamba2-370M — 48L d_model=1024 attention-free SSD, ssm_state=128,
vocab=50280 [arXiv:2405.21060; unverified]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2_370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
    vocab=512,
    dtype="float32", param_dtype="float32",
)
