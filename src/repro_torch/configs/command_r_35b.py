"""Cohere Command-R 35B — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, parallel attn||FFN blocks, no bias
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="command_r_35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    parallel_block=True,
    rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512,
    dtype="float32", param_dtype="float32",
)
