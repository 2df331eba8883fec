"""Per-architecture sharding-rule construction (counterpart of
:mod:`repro.distributed.rules`; pure functions of the port's
:class:`~repro_torch.models.config.ModelConfig`, equal to the reference's).

Two jobs, two rule-sets:

* **train/prefill** — attention sharded over q-heads when the head count
  divides the model axis ("heads mode": zero collectives inside the
  flash scan); falls back to head_dim sharding (contraction psums) when
  heads don't divide (yi-34b: 56 heads, internvl2: 14, whisper: 8), and
  to replicated attention otherwise.
* **decode** — KV caches dominate memory, so everything attention-side
  shards on head_dim (divides the model axis for every assigned arch);
  q heads stay unsharded, and the score/value contractions carry the
  psum.  SSM states shard on heads.

Embeddings/logits always shard the padded vocab; FSDP shards the
``embed`` (d_model) dimension of every weight over the data axis; the
pod axis is pure DP.
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.models.config import ModelConfig


def _divides(a: int, b: int) -> bool:
    return b > 0 and a > 0 and b % a == 0


def make_rules(
    cfg: ModelConfig,
    *,
    multi_pod: bool = False,
    job: str = "train",          # train | prefill | decode
    model_axis: int = 16,
) -> dict[str, object]:
    batch = ("pod", "data") if multi_pod else "data"
    rules: dict[str, object] = {
        "batch": batch,
        "layers": None,
        "embed": "data",                     # FSDP shard dim
        "vocab": "model",
        "seq": None,
        "state": None,
        "expert": "model" if cfg.moe_parallel == "ep" else None,
        "moe_grp": "data",
        "ff": "model",
        "inner": "model" if _divides(model_axis, cfg.d_inner) else None,
        "ssm_heads": "model" if _divides(model_axis, cfg.ssm_heads or 0) else None,
    }

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rules["attn_batch"] = batch
    if job == "decode":
        # cache-memory-optimal: shard head_dim everywhere
        if _divides(model_axis, dh):
            rules.update(q_heads=None, kv_heads=None, head_dim="model")
        else:
            rules.update(q_heads=None, kv_heads=None, head_dim=None)
    else:
        if _divides(model_axis, h):
            rules.update(
                q_heads="model",
                kv_heads="model" if _divides(model_axis, kv) else None,
                head_dim=None,
            )
        elif _divides(model_axis, dh):
            rules.update(q_heads=None, kv_heads=None, head_dim="model")
        else:
            rules.update(q_heads=None, kv_heads=None, head_dim=None)
    return rules


def apply_attn_batch_layout(
    rules: dict[str, object], cfg: ModelConfig, global_batch: int,
    *, multi_pod: bool, data_axis: int = 16, model_axis: int = 16,
) -> dict[str, object]:
    """Perf lever for archs whose head count doesn't divide the model
    axis (yi-34b: 56 heads): instead of head_dim sharding (which turns
    every flash-block contraction into a psum/all-gather storm), shard
    the *batch* over (data, model) inside attention — attention becomes
    fully local, at the cost of one activation reshard per layer.

    Applies only when the batch covers data*model; multi-pod keeps the
    baseline (batch 256 < 512 devices).
    """
    out = dict(rules)
    if multi_pod:
        return out
    if out.get("q_heads") == "model" or out.get("head_dim") != "model":
        return out                      # heads-mode archs unaffected
    if global_batch % (data_axis * model_axis) != 0:
        return out
    out["attn_batch"] = ("data", "model")
    out["q_heads"] = None
    out["kv_heads"] = None
    out["head_dim"] = None
    return out


def batch_axis_for(global_batch: int, multi_pod: bool, data_axis: int = 16) -> object:
    """Shrink the batch mapping when the batch can't cover the axes
    (long_500k has batch 1 -> replicate)."""
    total = data_axis * (2 if multi_pod else 1)
    if global_batch % total == 0:
        return ("pod", "data") if multi_pod else "data"
    if multi_pod and global_batch % 2 == 0:
        return "pod"
    return None


def adjust_batch_rule(rules: Mapping[str, object], global_batch: int,
                      multi_pod: bool) -> dict[str, object]:
    out = dict(rules)
    out["batch"] = batch_axis_for(global_batch, multi_pod)
    return out
