"""Prefill and decode on a mesh, in the style of the sharded train step
(:func:`repro_torch.training.step.make_sharded_train_step`): FSDP storage,
replicated compute over ``"model"``.

The reference runs ``prefill`` and ``decode_step`` under ``jit`` with
parameter, batch and cache shardings, and GSPMD splits the work.  Here
the parameters are DTensors placed by ``param_specs`` and a decode
cache by ``cache_logical_axes``; each rank gathers every parameter whole
and, for decode, its rows of the cache whole over ``"model"``, runs the
unchanged one-device :func:`~repro_torch.models.model.prefill` or
:func:`~repro_torch.models.model.decode_step` on its rows of the batch
(split over the batch rule's axes), and keeps of the results what the
reference's ``out_shardings`` give it (``repro/launch/dryrun.py:165,
180``): logits sharded as ``(batch, "model")``, the cache by its logical
axes, local slices without a collective.  K8 sees plain tensors only.
The dry run traces these steps on ``meta`` (:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.distributed.sharding import param_specs, place_rows, rank_rows, rule_axes
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    cache_logical_axes,
    decode_step,
    gather_params,
    prefill,
    release_params,
)

# the decode cache's batch dimension (its leaves are (layers, batch, ...))
CACHE_BATCH_DIM = 1


def _cache_rows(cache: dict, mesh, axes) -> dict:
    """This rank's rows of every cache leaf (DTensors placed by their
    logical axes), gathered whole over the other mesh axes."""
    from torch.distributed.tensor import Replicate, Shard

    held = [Shard(CACHE_BATCH_DIM) if a in axes else Replicate() for a in mesh.mesh_dim_names]
    return {n: c.redistribute(mesh, held).to_local() for n, c in cache.items()}


def _place_outputs(cfg: ModelConfig, mesh, rules: Mapping, cache_rules: Mapping, logits,
                   cache: dict):
    axes = rule_axes(rules["batch"])
    specs = param_specs(cache_logical_axes(cfg), cache_rules)
    return (place_rows(logits, mesh, axes, 0, (rules["batch"], "model")),
            {n: place_rows(c, mesh, axes, CACHE_BATCH_DIM, specs[n]) for n, c in cache.items()})


def make_sharded_prefill(cfg: ModelConfig, mesh, rules: Mapping, cache_rules: Mapping,
                         max_seq: int):
    """``prefill_step(params, batch) -> (logits, cache)`` on ``mesh``:
    ``params`` are DTensors by state-dict name, ``batch`` the global batch
    (every member rank passes the same); this rank's rows are split over
    ``rules["batch"]``'s axes.  The cache comes out placed by
    ``cache_rules`` (the decode rules, as the reference's ``cache_out``)."""
    axes = rule_axes(rules["batch"])
    model = None

    def prefill_step(params: dict, batch: dict):
        nonlocal model
        model = gather_params(cfg, params, model)
        logits, cache = prefill(model, {k: rank_rows(x, mesh, axes) for k, x in batch.items()},
                                cfg, max_seq)
        release_params(model)
        return _place_outputs(cfg, mesh, rules, cache_rules, logits, cache)

    return prefill_step


def make_sharded_decode_step(cfg: ModelConfig, mesh, rules: Mapping):
    """``decode(params, token, pos, cache) -> (logits, cache)`` on ``mesh``:
    ``params`` and ``cache`` are DTensors (the cache placed by
    ``cache_logical_axes`` under ``rules``, the decode rules), ``token``
    the global (B, 1) tokens, ``pos`` replicated.  Each rank gathers its
    cache rows over ``"model"``, steps them, and keeps its shard of the
    updated cache (a new DTensor; the input's shards are not written)."""
    axes = rule_axes(rules["batch"])
    model = None

    def decode(params: dict, token: torch.Tensor, pos, cache: dict):
        nonlocal model
        model = gather_params(cfg, params, model)
        logits, rows = decode_step(model, rank_rows(token, mesh, axes), pos,
                                   _cache_rows(cache, mesh, axes), cfg)
        release_params(model)
        return _place_outputs(cfg, mesh, rules, rules, logits, rows)

    return decode
