"""One rank of the sharded train step and its elastic re-shard on gloo
(run by tests/test_torch_distributed.py, 8 processes):

    python tests/torch_distributed_worker.py RANK WORLD STORE_FILE OUT_DIR

Two AdamW steps of the SMOKE Qwen3-8B on the (2, 4) ("data", "model")
mesh, then ``plan_mesh(4)``, a re-shard to (2, 2) under
``make_rules(cfg, model_axis=2)`` and two more steps on its ranks (the
others only take part in the re-shard), as the reference's
tests/test_distributed.py does on 8 forced host devices; once on its
batch (every token 3) and once on a seeded one (:func:`batches`).  Then
two steps on (2, 4) with the attention batch layout (:func:`layout_sequence`).
Rank 0 writes, per batch, the losses, the parameters after each phase
gathered whole, and the local shard shapes of a few leaves to
OUT_DIR/rank0.pt.
"""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.elastic import plan_mesh
from repro_torch.distributed.rules import make_rules
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch.mesh import make_debug_mesh, mesh_context
from repro_torch.optim.adamw import adamw
from repro_torch.training.step import (
    full_params,
    init_train_state,
    make_sharded_train_step,
    shard_train_state,
)

SEED = 0
LEAVES = ("embed", "blocks.0.attn.wq", "blocks.0.attn.wk")


def batches(vocab: int) -> dict:
    """The reference's batch (tokens = targets = 3) and a seeded one of
    next-token targets."""
    tokens = np.random.default_rng(SEED).integers(0, vocab, (4, 33)).astype(np.int32)
    three = torch.zeros((4, 32), dtype=torch.int32) + 3
    return {"threes": {"tokens": three, "targets": three},
            "seeded": {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
                       "targets": torch.from_numpy(tokens[:, 1:].copy())}}


def sequence(cfg, batch: dict) -> dict:
    opt = adamw(1e-3)
    losses, out = [], {}
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(SEED), device="cpu")
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    rules = {**make_rules(cfg, model_axis=4), "batch": "data"}
    with mesh_context(mesh), use_rules(rules):
        state = shard_train_state(state, cfg, mesh, rules)
        out["local_shapes_2x4"] = {n: tuple(state["params"][n].to_local().shape) for n in LEAVES}
        step = make_sharded_train_step(cfg, opt, mesh)
        for _ in range(2):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        out["params_2"] = full_params(state)

    plan = plan_mesh(4)
    mesh2 = plan.build()
    rules2 = {**make_rules(cfg, model_axis=plan.model), "batch": "data"}
    state = shard_train_state(state, cfg, mesh2, rules2)
    if mesh2.get_coordinate() is not None:
        with mesh_context(mesh2), use_rules(rules2):
            step2 = make_sharded_train_step(cfg, opt, mesh2)
            for _ in range(2):
                state, metrics = step2(state, batch)
                losses.append(float(metrics["loss"]))
            out["params_4"] = full_params(state)
            out["local_shapes_2x2"] = {n: tuple(state["params"][n].to_local().shape)
                                       for n in LEAVES}
    out.update(losses=losses, plan=(plan.pods, plan.data, plan.model), step=state["step"],
               opt_step=state["opt_state"]["step"])
    return out


def layout_batch(vocab: int) -> dict:
    """A seeded batch of 8 rows: 4 a "data" rank, 1 a "model" rank in
    attention."""
    tokens = np.random.default_rng(SEED + 1).integers(0, vocab, (8, 33)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
            "targets": torch.from_numpy(tokens[:, 1:].copy())}


def layout_sequence(cfg) -> dict:
    """Two AdamW steps on (2, 4) with the attention batch layout (attention
    on each "model" rank's share of its "data" rank's rows, the output
    all-gathered): the losses, the parameters gathered whole, and the
    number of the layout's all-gathers."""
    opt = adamw(1e-3)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(SEED), device="cpu")
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    rules = {**make_rules(cfg, model_axis=4), "batch": "data", "attn_batch": ("data", "model")}
    gathers, gather = [], sharding.AttnBatchSplit.gather

    def counted(split, x):
        gathers.append(tuple(x.shape))
        return gather(split, x)

    sharding.AttnBatchSplit.gather = counted
    losses = []
    try:
        with mesh_context(mesh), use_rules(rules):
            state = shard_train_state(state, cfg, mesh, rules)
            step = make_sharded_train_step(cfg, opt, mesh)
            for _ in range(2):
                state, metrics = step(state, layout_batch(cfg.vocab))
                losses.append(float(metrics["loss"]))
            params = full_params(state)
    finally:
        sharding.AttnBatchSplit.gather = gather
    return {"losses": losses, "params_2": params, "gathers": len(gathers)}


def main(rank: int, world: int, store_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    try:
        cfg = get_smoke_config("qwen3_8b")
        results = {}
        for name, batch in batches(cfg.vocab).items():
            results[name] = sequence(cfg, batch)
        results["layout"] = layout_sequence(cfg)
        if rank == 0:
            torch.save(results, Path(out_dir) / "rank0.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
