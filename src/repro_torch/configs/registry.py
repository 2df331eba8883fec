"""Architecture registry (counterpart of :mod:`repro.configs.registry`).

Each ``<arch>.py`` module defines ``CONFIG`` (the published shape) and
``SMOKE`` (a reduced config of the same family), as data.  The shape
grid and ``input_specs`` belong to the dry run, which is not ported yet
(ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import importlib

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
