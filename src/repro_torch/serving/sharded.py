"""Prefill and decode on a mesh, in the style of the sharded train step
(:func:`repro_torch.training.step.make_sharded_train_step`): FSDP storage,
and tensor parallelism over ``"model"`` in every family.

The reference runs ``prefill`` and ``decode_step`` under ``jit`` with
parameter, batch and cache shardings, and GSPMD splits the work.  Here
the parameters are DTensors placed by ``param_specs`` and a decode
cache by ``cache_logical_axes``, and each rank runs
:func:`~repro_torch.models.model.prefill` or
:func:`~repro_torch.models.model.decode_step` on its rows of the batch
(split over the batch rule's axes).  A rank gathers each leaf over the
batch axes alone and computes its ``"model"`` share
(:func:`~repro_torch.models.model.gather_params`; an MoE's experts, or
their ``ff`` columns; a Mamba block's ``inner`` columns and SSM heads):
prefill in heads mode (its q heads) emits the K/V cache by the decode
rules, every kv head and its ``head_dim`` columns, in one all-to-all (an
encdec's cross K/V, ``xk`` and ``xv``, in one more); decode in head_dim
mode works on its columns of every cache leaf, ``xk`` and ``xv`` too
(``_cache_rows``), which it keeps, with no gather.  A
Mamba block's rank prefills and steps the ``ssm`` state of its SSM heads
(``ssm_heads`` on ``"model"``), with no gather, and keeps the ``conv``
window whole, as the rules replicate it: prefill gathers its columns of
the window's x-seg, decode its columns of each new x-seg.  An MoE
dispatches the reference's groups of the global batch, in decode one
flat group at capacity factor 2 (:mod:`repro_torch.models.moe`).  Each
rank keeps of the results what the reference's
``out_shardings`` give it (``repro/launch/dryrun.py:165, 180``): logits
sharded as ``(batch, "model")``, the cache by its logical axes, local
slices without a collective.  K8 sees plain tensors only.  The dry run
traces these steps on ``meta`` (:mod:`repro_torch.launch.dryrun`).
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
    logical axes), gathered whole over the other mesh axes but
    ``"model"``, whose shard each rank keeps."""
    from torch.distributed.tensor import Replicate, Shard

    def held(c):
        return [Shard(CACHE_BATCH_DIM) if a in axes else p if a == "model" else Replicate()
                for a, p in zip(mesh.mesh_dim_names, c.placements)]

    return {n: c.redistribute(mesh, held(c)).to_local() for n, c in cache.items()}


def _place_outputs(cfg: ModelConfig, mesh, rules: Mapping, cache_rules: Mapping, logits,
                   cache: dict, split=None):
    """The step's logits and cache as the reference's ``out_shardings``
    place them, from this rank's rows (under tensor parallelism ``split``
    its vocab columns of the logits, and of each cache leaf its share on
    the dimension that the cache rules put on ``"model"``: the K/V and
    cross K/V caches' ``head_dim`` columns, the ``ssm`` state's SSM
    heads)."""
    axes = rule_axes(rules["batch"])
    specs = param_specs(cache_logical_axes(cfg), cache_rules)

    def model_dim(spec):
        if split is None:
            return None
        return next((d for d, entry in enumerate(spec) if "model" in rule_axes(entry)), None)

    return (place_rows(logits, mesh, axes, 0, (rules["batch"], "model"),
                       None if split is None else 1),
            {n: place_rows(c, mesh, axes, CACHE_BATCH_DIM, specs[n], model_dim(specs[n]))
             for n, c in cache.items()})


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
        model = gather_params(cfg, params, model, axes)
        logits, cache = prefill(model, {k: rank_rows(x, mesh, axes) for k, x in batch.items()},
                                cfg, max_seq)
        release_params(model)
        return _place_outputs(cfg, mesh, rules, cache_rules, logits, cache, model.split)

    return prefill_step


def make_sharded_decode_step(cfg: ModelConfig, mesh, rules: Mapping):
    """``decode(params, token, pos, cache) -> (logits, cache)`` on ``mesh``:
    ``params`` and ``cache`` are DTensors (the cache placed by
    ``cache_logical_axes`` under ``rules``, the decode rules), ``token``
    the global (B, 1) tokens, ``pos`` replicated.  Each rank steps its
    ``"model"`` share of its rows of the cache (the K/V and cross K/V
    caches' ``head_dim`` columns, the ``ssm`` state's SSM heads, the
    ``conv`` window whole; every leaf whole on a mesh without
    ``"model"``) and keeps its shard of the updated cache (a new DTensor
    over the input's shards, written in place)."""
    axes = rule_axes(rules["batch"])
    model = None

    def decode(params: dict, token: torch.Tensor, pos, cache: dict):
        nonlocal model
        model = gather_params(cfg, params, model, axes)
        logits, rows = decode_step(model, rank_rows(token, mesh, axes), pos,
                                   _cache_rows(cache, mesh, axes), cfg)
        release_params(model)
        return _place_outputs(cfg, mesh, rules, rules, logits, rows, model.split)

    return decode
