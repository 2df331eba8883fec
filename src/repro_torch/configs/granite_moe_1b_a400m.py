"""IBM Granite 3.0 1B-A400M — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_moe_1b_a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    top_k=8,
    moe_parallel="ep",          # the reference's mesh setting, as data
    dispatch_groups=16,
    rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=512, n_experts=8, top_k=4,
    dispatch_groups=2,
    dtype="float32", param_dtype="float32",
)
