"""Yi-34B — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-arch GQA [arXiv:2403.04652; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi_34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512,
    dtype="float32", param_dtype="float32",
)
