"""Whisper-base — 6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865;
conv frontend stubbed (input_specs supplies frame embeddings)
[arXiv:2212.04356; unverified]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper_base",
    family="encdec",
    n_layers=6,             # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    enc_len=1500,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, enc_len=32,
    dtype="float32", param_dtype="float32",
)
