"""Model configuration — one dataclass covering every family of the
reference (:mod:`repro.models.config`).

The fields and derived properties are the reference's; only the dtype
accessors differ: :meth:`ModelConfig.act_dtype` and
:meth:`ModelConfig.p_dtype` return torch dtypes.  Every family runs in
the port (:mod:`repro_torch.models.model`).
"""

from __future__ import annotations

import dataclasses

import torch


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    parallel_block: bool = False    # command-r style attn || mlp
    sliding_window: int = 0         # 0 = full attention
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_parallel: str = "auto"      # tp | ep | auto
    dispatch_groups: int = 1

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (Zamba2): shared attention block every k SSM layers
    attn_every: int = 0

    # encoder-decoder (Whisper)
    n_enc_layers: int = 0
    enc_len: int = 1500             # precomputed frame embeddings (stub)

    # VLM (InternVL2)
    n_patches: int = 0              # precomputed patch embeddings (stub)

    attn_p_bf16: bool = False       # flash: round the probability tile to
                                    # bf16 before the PV product
    remat_policy: str = "full"      # full | dots | none: forward_train block remat
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_padded(self) -> int:
        """Embedding tables padded to a multiple of 256, as the reference
        pads them (so that weights map one to one)."""
        return _round_up(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True

    def act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def p_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.param_dtype == "bfloat16" else torch.float32
