"""Architecture registry, shape grid and input specs (counterpart of
:mod:`repro.configs.registry`).

Each ``<arch>.py`` module defines ``CONFIG`` (the published shape) and
``SMOKE`` (a reduced config of the same family), as data.  The shape grid
is the reference's four cells; ``shape_applicable`` encodes its skips
(``long_500k`` only for the sub-quadratic families); ``input_specs``
gives ``meta`` tensors of every input of a cell, for the dry run
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "mixtral_8x22b",
    "granite_moe_1b_a400m",
    "internvl2_1b",
    "granite_20b",
    "command_r_35b",
    "yi_34b",
    "qwen3_8b",
    "mamba2_370m",
    "whisper_base",
    "zamba2_7b",
]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}: expected one of {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(applicable, the reason if not), the reference's rule and words."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.arch_id} is a full-attention arch (skip per DESIGN.md)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, per_pod_batch: int | None = None
                ) -> dict:
    """Every model input of a cell as ``meta`` tensors (shapes and dtypes,
    no data), the reference's shapes and dtypes; ``per_pod_batch`` takes
    the place of the shape's global batch, as in the reference.

    train: ``tokens``, ``targets`` (B, S) int32; prefill: ``tokens``; a vlm
    also takes ``patches`` (B, n_patches, d) and S - n_patches text tokens,
    an encdec ``frames`` (B, enc_len, d), both in the activation dtype:
    stand-ins for the frontends, as in the reference.  decode: ``token``
    (B, 1) int32, ``pos`` () int32 and ``cache``, the port's
    :func:`~repro_torch.models.model.init_decode_cache` at ``seq_len``
    (its leaves carry the reference's names).
    """
    bsz = per_pod_batch if per_pod_batch is not None else shape.global_batch
    s = shape.seq_len
    act = cfg.act_dtype()

    def t(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        s_text = s - cfg.n_patches if cfg.family == "vlm" else s
        specs = {"tokens": t((bsz, s_text))}
        if shape.kind == "train":
            specs["targets"] = t((bsz, s_text))
        if cfg.family == "vlm":
            specs["patches"] = t((bsz, cfg.n_patches, cfg.d_model), act)
        if cfg.family == "encdec":
            specs["frames"] = t((bsz, cfg.enc_len, cfg.d_model), act)
        return specs

    from repro_torch.models.model import init_decode_cache

    return {"token": t((bsz, 1)), "pos": t(()),
            "cache": init_decode_cache(cfg, bsz, s, device="meta")}
