"""InternVL2-1B — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655;
InternViT frontend stubbed (input_specs supplies patch embeddings),
Qwen2-0.5B language backbone [arXiv:2404.16821; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2_1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    n_patches=256,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, n_patches=8,
    dtype="float32", param_dtype="float32",
)
