"""One rank of the sharded train step and its elastic re-shard on gloo
(run by tests/test_torch_distributed.py, 8 processes):

    python tests/torch_distributed_worker.py RANK WORLD STORE_FILE OUT_DIR

and, with a fifth argument ``tensor_parallel``, of the dense family's
tensor-parallel steps (run by tests/test_torch_tensor_parallel.py;
:func:`tensor_parallel_main`), with ``expert_parallel`` of the MoE
family's (run by tests/test_torch_expert_parallel.py;
:func:`expert_parallel_main`), or with ``ssm_parallel`` of the SSM and
hybrid families' (run by tests/test_torch_ssm_parallel.py;
:func:`ssm_parallel_main`), or with ``encdec_parallel`` of the vlm and
encdec families' (run by tests/test_torch_encdec_parallel.py;
:func:`encdec_parallel_main`).

Two AdamW steps of the SMOKE Qwen3-8B on the (2, 4) ("data", "model")
mesh, then ``plan_mesh(4)``, a re-shard to (2, 2) under
``make_rules(cfg, model_axis=2)`` and two more steps on its ranks (the
others only take part in the re-shard), as the reference's
tests/test_distributed.py does on 8 forced host devices; once on its
batch (every token 3) and once on a seeded one (:func:`batches`).  Then
two steps on (2, 4) with the attention batch layout (:func:`layout_sequence`).
Rank 0 writes, per batch, the losses, the parameters after each phase
and the step-1 gradients gathered whole, and the local shard shapes of a
few leaves to OUT_DIR/rank0.pt.
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
from repro_torch.models import model as tmodel
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.serving.sharded import make_sharded_decode_step, make_sharded_prefill
from repro_torch.training.step import (
    full_params,
    init_train_state,
    make_sharded_train_step,
    shard_train_state,
)

SEED = 0
LR = 1e-3
LEAVES = ("embed", "blocks.0.attn.wq", "blocks.0.attn.wk")


def recording(opt: Optimizer, out: dict) -> Optimizer:
    """``opt``, whose first update keeps the gradients it is given (the
    rank's shards of the gradients averaged over the batch axes, before
    the clip) in ``out["grads"]``, and every update's in
    ``out["steps"]``."""
    def update(grads, state, params, **kw):
        out.setdefault("steps", []).append({n: g.detach().clone() for n, g in grads.items()})
        out.setdefault("grads", out["steps"][0])
        return opt.update(grads, state, params, **kw)

    return Optimizer(init=opt.init, update=update)


def gathered(local: dict, like: dict) -> dict:
    """Shards placed as the DTensors of ``like`` gathered whole (a
    collective over their mesh)."""
    from torch.distributed.tensor import DTensor

    return {n: DTensor.from_local(g, like[n].device_mesh, like[n].placements, run_check=False,
                                  shape=like[n].shape, stride=like[n].stride()).full_tensor()
            for n, g in local.items()}


def adam_first_step_gap(got: dict, want: dict, lr: float = LR, eps: float = 1e-8,
                        clip: float = 1.0) -> dict:
    """Per leaf and element, how far AdamW's first step from the step-1
    gradients ``got`` lands from its step from ``want``: lr |u(got) -
    u(want)|, u = g / (|g| + eps) of the gradients clipped by their global
    norm.  Where a gradient is within a few eps of zero, u turns its
    rounding into a step of any size up to lr."""
    def u(grads: dict) -> dict:
        g64 = {n: g.double() for n, g in grads.items()}
        norm = float(torch.sqrt(sum(torch.sum(g * g) for g in g64.values())))
        c = min(1.0, clip / max(norm, 1e-12))
        return {n: g * c / ((g * c).abs() + eps) for n, g in g64.items()}

    ug, uw = u(got), u(want)
    return {n: lr * (ug[n] - uw[n]).abs() for n in want}


def adam_step_gaps(got: list, want: list, lr: float = LR, eps: float = 1e-8, clip: float = 1.0,
                   b1: float = 0.9, b2: float = 0.95) -> list:
    """:func:`adam_first_step_gap` at every step: per step, leaf and
    element, lr |u_k(got) - u_k(want)| of AdamW's update u_k = m^ /
    (sqrt(v^) + eps) from each run's own gradients of steps 1..k
    (``got``/``want``: one dict a step), each step's clipped by its global
    norm.  At step 1 it is :func:`adam_first_step_gap`; later, where the
    moments nearly cancel (a gradient that changes sign near zero), u
    turns the two runs' rounding into steps of any size up to lr."""
    def updates(seq: list) -> list:
        mu, nu, out = {}, {}, []
        for k, grads in enumerate(seq, start=1):
            g64 = {n: g.double() for n, g in grads.items()}
            norm = float(torch.sqrt(sum(torch.sum(g * g) for g in g64.values())))
            c = min(1.0, clip / max(norm, 1e-12))
            step = {}
            for n, g in g64.items():
                mu[n] = b1 * mu.get(n, 0.0) + (1 - b1) * g * c
                nu[n] = b2 * nu.get(n, 0.0) + (1 - b2) * (g * c) ** 2
                step[n] = (mu[n] / (1 - b1 ** k)) / (torch.sqrt(nu[n] / (1 - b2 ** k)) + eps)
            out.append(step)
        return out

    return [{n: lr * (ug[n] - uw[n]).abs() for n in uw}
            for ug, uw in zip(updates(got), updates(want), strict=True)]


def batches(vocab: int) -> dict:
    """The reference's batch (tokens = targets = 3) and a seeded one of
    next-token targets."""
    tokens = np.random.default_rng(SEED).integers(0, vocab, (4, 33)).astype(np.int32)
    three = torch.zeros((4, 32), dtype=torch.int32) + 3
    return {"threes": {"tokens": three, "targets": three},
            "seeded": {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
                       "targets": torch.from_numpy(tokens[:, 1:].copy())}}


def sequence(cfg, batch: dict) -> dict:
    losses, out, rec = [], {}, {}
    opt = recording(adamw(1e-3), rec)
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
        out["grads_1"] = gathered(rec["grads"], state["params"])

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
    all-gathered): the losses, the parameters gathered whole, the step-1
    gradients gathered whole, and the number of the layout's
    all-gathers."""
    rec = {}
    opt = recording(adamw(1e-3), rec)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(SEED), device="cpu")
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    # the layout's rules as apply_attn_batch_layout makes them: attention's
    # leaves off "model", the rest tensor parallel
    rules = {**make_rules(cfg, model_axis=4), "batch": "data", "attn_batch": ("data", "model"),
             "q_heads": None, "kv_heads": None, "head_dim": None}
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
            grads = gathered(rec["grads"], state["params"])
    finally:
        sharding.AttnBatchSplit.gather = gather
    return {"losses": losses, "params_2": params, "grads_1": grads, "gathers": len(gathers)}


# ------------------------------------------------ tensor parallelism

TP_ARCHS = ("qwen3_8b", "command_r_35b", "granite_20b")
TP_STEPS = 3
TP_PROMPT, TP_MAX_SEQ, TP_DECODES = 12, 24, 4


def tp_batches(vocab: int, seq: int = 32) -> dict:
    """The seeded train batch (next-token targets, ``seq`` tokens a row)
    and prompts of the tensor-parallel cases."""
    rng = np.random.default_rng(SEED + 2)
    tokens = rng.integers(0, vocab, (4, seq + 1)).astype(np.int32)
    return {"train": {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
                      "targets": torch.from_numpy(tokens[:, 1:].copy())},
            "prompts": torch.from_numpy(rng.integers(0, vocab, (4, TP_PROMPT))
                                        .astype(np.int32))}


def tp_rules(cfg, job: str, head_dim_mode: bool = False, model_axis: int = 4) -> dict:
    """The reference's rules of ``job`` on a mesh of ``model_axis``
    "model" ranks ((2, 4) by default); with ``head_dim_mode`` the
    head_dim rules that heads not dividing the axis give (yi_34b's
    route, forced)."""
    rules = {**make_rules(cfg, job=job, model_axis=model_axis), "batch": "data"}
    if head_dim_mode:
        rules.update(q_heads=None, kv_heads=None, head_dim="model")
    return rules


def _model(cfg, params: dict):
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    model.load_state_dict(params)
    return model


def tp_train(cfg, params: dict, mesh, rules, batch: dict, steps: int = TP_STEPS) -> dict:
    """``steps`` AdamW steps on ``mesh``: the losses and aux losses, every
    parameter gathered whole after each step, and the step-1 gradients
    gathered whole."""
    rec = {}
    opt = recording(adamw(LR), rec)
    model = _model(cfg, params).requires_grad_(True)
    state = {"params": model, "opt_state": opt.init(dict(model.named_parameters())),
             "step": 0}
    losses, aux, snaps = [], [], []
    with mesh_context(mesh), use_rules(rules):
        state = shard_train_state(state, cfg, mesh, rules)
        step = make_sharded_train_step(cfg, opt, mesh)
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            aux.append(float(metrics["aux"]))
            snaps.append(full_params(state))
        grads = [gathered(g, state["params"]) for g in rec["steps"]]
    return {"losses": losses, "aux": aux, "params": snaps, "grads_1": grads[0],
            "grads_steps": grads}


def decode_start(cfg) -> int:
    """The first decode position after a TP_PROMPT-token prompt: a vlm's
    positions count its patches."""
    return TP_PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)


def tp_serve(cfg, params: dict, mesh, prompts: torch.Tensor, model_axis: int = 4,
             extra: dict | None = None, head_dim_mode: bool = False) -> dict:
    """A sharded prefill (heads mode, or with ``head_dim_mode`` forced
    head_dim mode; the cache out by the decode rules) and TP_DECODES
    greedy decode steps (head_dim mode) on a mesh of ``model_axis``
    "model" ranks, ``extra`` a vlm's patches or an encdec's frames: the
    logits gathered whole, the cache after the prefill and after the last
    decode step gathered whole, the tokens."""
    from repro_torch.distributed.elastic import reshard_state

    pre = tp_rules(cfg, "prefill", head_dim_mode, model_axis=model_axis)
    dec = tp_rules(cfg, "decode", model_axis=model_axis)
    named = {n: p.detach() for n, p in _model(cfg, params).named_parameters()}
    axes = tmodel.param_logical_axes(cfg)
    with mesh_context(mesh), use_rules(pre):
        step = make_sharded_prefill(cfg, mesh, pre, dec, TP_MAX_SEQ)
        logits, cache = step(reshard_state(named, axes, mesh, pre),
                             {"tokens": prompts, **(extra or {})})
    out = {"prefill_logits": logits.full_tensor(),
           "cache": {n: c.full_tensor() for n, c in cache.items()},
           "cache_local": {n: tuple(c.to_local().shape) for n, c in cache.items()},
           "decode_logits": [], "tokens": []}
    sharded = reshard_state(named, axes, mesh, dec)
    token = logits.full_tensor().argmax(-1)[:, None].to(torch.int32)
    with mesh_context(mesh), use_rules(dec):
        step = make_sharded_decode_step(cfg, mesh, dec)
        for i in range(TP_DECODES):
            out["tokens"].append(token)
            logits, cache = step(sharded, token, torch.tensor(decode_start(cfg) + i), cache)
            whole = logits.full_tensor()
            out["decode_logits"].append(whole)
            token = whole.argmax(-1)[:, None].to(torch.int32)
        out["decode_cache"] = {n: c.full_tensor() for n, c in cache.items()}
    out["tokens"].append(token)
    return out


def tp_hand_case(mesh) -> dict:
    """The head_dim decode attention of one layer by hand: seeded q (B, 1,
    H, dh), a cache and positions, each "model" rank its dh / 4 columns;
    RoPE's exchange and apply_rope_columns, then decode_attention with the
    whole head's scale and the scores summed over "model"; the ranks'
    output columns gathered.  The test computes the same in numpy."""
    from repro_torch.distributed.sharding import ModelSplit
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.layers import apply_rope_columns

    b, s, h, kv, dh, theta = 2, 10, 4, 2, 16, 1e4
    rng = np.random.default_rng(SEED + 3)
    q, k = (torch.from_numpy(rng.standard_normal((b, 1, n, dh)).astype(np.float32))
            for n in (h, kv))
    cache_k, cache_v = (torch.from_numpy(rng.standard_normal((b, s, kv, dh)).astype(np.float32))
                        for _ in range(2))
    pos = torch.tensor([6, 9])
    group = mesh.get_group("model")
    index, count = mesh.get_local_rank("model"), mesh.size(1)
    split = ModelSplit(group=group, index=index, count=count, attn="head_dim", head_dim=dh,
                       heads=h, kv_heads=kv, kv_first=0, kv_sliced=False, q_per_kv=h // kv,
                       ff=0, vocab=0)
    c = dh // count
    cols = slice(index * c, (index + 1) * c)
    partner = split.rope_partner(torch.cat([q[..., cols], k[..., cols]], dim=2))
    qr = apply_rope_columns(q[..., cols], partner[:, :, :h], pos[:, None], theta, dh,
                            index * c)
    kr = apply_rope_columns(k[..., cols], partner[:, :, h:], pos[:, None], theta, dh,
                            index * c)
    ck = cache_k[..., cols].clone()
    ck[torch.arange(b), pos] = kr[:, 0]
    o = decode_attention(qr, ck, cache_v[..., cols].contiguous(), pos, head_dim=dh,
                         reduce_scores=split.reduce)
    parts = [torch.empty_like(o) for _ in range(count)]
    dist.all_gather(parts, o.contiguous(), group=group)
    return {"q": q, "k": k, "cache_k": cache_k, "cache_v": cache_v, "pos": pos,
            "theta": theta, "out": torch.cat(parts, dim=-1)}


def tensor_parallel_main(rank: int, out_dir: str) -> None:
    """Each arch of TP_ARCHS from the parameters the test wrote
    (OUT_DIR/params_<arch>.pt, the reference's converted): TP_STEPS
    train steps in heads mode, and for qwen3_8b in forced head_dim mode,
    the prefill and decode steps, on the (2, 4) mesh; and the hand case.
    Rank 0 writes OUT_DIR/tp_rank0.pt."""
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    results = {"hand": tp_hand_case(mesh)}
    for arch in TP_ARCHS:
        cfg = get_smoke_config(arch)
        params = torch.load(Path(out_dir) / f"params_{arch}.pt", weights_only=True)
        data = tp_batches(cfg.vocab)
        res = {"train": tp_train(cfg, params, mesh, tp_rules(cfg, "train"), data["train"]),
               **tp_serve(cfg, params, mesh, data["prompts"])}
        if arch == "qwen3_8b":
            res["train_head_dim"] = tp_train(cfg, params, mesh,
                                             tp_rules(cfg, "train", head_dim_mode=True),
                                             data["train"])
        results[arch] = res
    if rank == 0:
        torch.save(results, Path(out_dir) / "tp_rank0.pt")


# ------------------------------------------------ expert parallelism

EP_ARCHS = ("granite_moe_1b_a400m", "mixtral_8x22b")
# (2, 4): 2 batch shards and 2 dispatch groups, a group a rank; (4, 2): a
# group spans two ranks (decode's one group spans four)
EP_MESHES = ((2, 4), (4, 2))


def spread_over_model(grads: dict, mesh, suffixes=("moe.w_router",)) -> dict:
    """For each gradient of a leaf replicated over "model" whose name ends
    in one of ``suffixes`` (by default the routers'), the largest
    difference between a "model" rank's and rank 0's, relative to its
    largest element."""
    group, out = mesh.get_group("model"), {}
    for n, g in grads.items():
        if n.endswith(suffixes):
            parts = [torch.empty_like(g) for _ in range(group.size())]
            dist.all_gather(parts, g.contiguous(), group=group)
            out[n] = max(float((q - parts[0]).abs().max()) for q in parts) / float(
                parts[0].abs().max())
    return out


def expert_parallel_main(rank: int, out_dir: str) -> None:
    """Each arch of EP_ARCHS from the parameters the test wrote
    (OUT_DIR/params_<arch>.pt, the reference's converted) on each mesh of
    EP_MESHES: TP_STEPS train steps on the seeded batch and on the
    reference's (every token 3: the capacity binds), the spread of the
    routers' step-1 gradients over "model", then the prefill and decode
    steps.  Rank 0 writes OUT_DIR/ep_rank0.pt, keyed by (mesh, arch)."""
    results = {}
    for shape in EP_MESHES:
        mesh = make_debug_mesh(shape, ("data", "model"))
        m = shape[1]
        for arch in EP_ARCHS:
            cfg = get_smoke_config(arch)
            params = torch.load(Path(out_dir) / f"params_{arch}.pt", weights_only=True)
            data = tp_batches(cfg.vocab)
            rules = tp_rules(cfg, "train", model_axis=m)
            train = tp_train(cfg, params, mesh, rules, data["train"])
            results[shape, arch] = {
                "train": train,
                "train_threes": tp_train(cfg, params, mesh, rules,
                                         batches(cfg.vocab)["threes"]),
                "router_grad_spread": spread_over_model(train["grads_1"], mesh),
                **tp_serve(cfg, params, mesh, data["prompts"], model_axis=m)}
    if rank == 0:
        torch.save(results, Path(out_dir) / "ep_rank0.pt")


# ------------------------------------------------ SSM and hybrid tensor parallelism

SSM_ARCHS = ("mamba2_370m", "zamba2_7b")
# (2, 4): SMOKE's 8 SSM heads 2 a rank, Zamba2's 4 attention heads 1 a rank
# and in decode 4 of head_dim's 16 columns; (4, 2): 4 SSM heads, 2
# attention heads and 8 columns a rank
SSM_MESHES = ((2, 4), (4, 2))
# the train sequence: two of SMOKE's 32-token SSD chunks, so that the
# inter-chunk scan runs
SSM_SEQ = 64
# a Mamba block's leaves replicated over "model" (whole on every rank),
# whose gradients must come out whole and equal on every "model" rank
WHOLE_LEAVES = ("ln", "w_bc", "conv_bc_w", "conv_bc_b", "w_dt", "dt_bias", "a_log", "d_skip")
# the gated norm's mean square taken two wrong ways: each rank's own
# columns' (no sum), and summed outside autograd, its gradient passed
# through unsummed (Megatron's g, ModelSplit.exit).  ModelSplit.reduce is no
# such sum here: PyTorch's functional all_reduce, which it calls, has a
# backward of its own once torch.distributed._functional_collectives is
# imported (an all-reduce of the gradient, in torch 2.13)
BROKEN_NORMS = {"rank_local": lambda split, x: x,
                "outside_autograd": lambda split, x: split.exit(x) / split.count}


def held_leaves(cfg, sharded: dict) -> dict:
    """The local shapes of the first Mamba block's leaves as a rank's
    tensor-parallel model holds them (``gather_params`` over "data"), and
    its split's SSM and attention fields."""
    model = tmodel.gather_params(cfg, sharded, batch_axes=("data",))
    sp = model.split
    return {"shapes": {n: tuple(p.shape) for n, p in model.blocks[0].named_parameters()},
            "split": {k: getattr(sp, k) for k in ("ssm", "ssm_heads", "ssm_first", "attn",
                                                    "heads", "kv_heads", "count", "index")}}


def broken_norm_grads(cfg, params: dict, mesh, rules, batch: dict) -> dict:
    """The step-1 gradient of ``blocks.0.w_x`` (gathered whole) under each
    of BROKEN_NORMS in place of ``ModelSplit.mean_over``."""
    from repro_torch.distributed.sharding import ModelSplit

    saved, out = ModelSplit.mean_over, {}
    try:
        for name, broken in BROKEN_NORMS.items():
            ModelSplit.mean_over = broken
            out[name] = tp_train(cfg, params, mesh, rules, batch, steps=1)["grads_1"][
                "blocks.0.w_x"]
    finally:
        ModelSplit.mean_over = saved
    return out


def ssm_parallel_main(rank: int, out_dir: str) -> None:
    """Each arch of SSM_ARCHS from the parameters the test wrote
    (OUT_DIR/params_<arch>.pt, the reference's converted) on each mesh of
    SSM_MESHES: TP_STEPS train steps on a seeded batch of SSM_SEQ tokens a
    row, the spread over "model" of the step-1 gradients of the leaves
    replicated there, the leaves a rank holds, then the prefill and decode
    steps on the tensor-parallel cases' prompts; on (2, 4) the SMOKE Mamba2's step-1 gradient of ``w_x`` with
    the gated norm's sum broken.  Rank 0 writes OUT_DIR/ssm_rank0.pt,
    keyed by (mesh, arch)."""
    from repro_torch.distributed.elastic import reshard_state

    results = {}
    for shape in SSM_MESHES:
        mesh = make_debug_mesh(shape, ("data", "model"))
        m = shape[1]
        for arch in SSM_ARCHS:
            cfg = get_smoke_config(arch)
            params = torch.load(Path(out_dir) / f"params_{arch}.pt", weights_only=True)
            rules = tp_rules(cfg, "train", model_axis=m)
            train = tp_train(cfg, params, mesh, rules, tp_batches(cfg.vocab, SSM_SEQ)["train"])
            named = {n: p.detach() for n, p in _model(cfg, params).named_parameters()}
            with mesh_context(mesh):
                held = held_leaves(cfg, reshard_state(named, tmodel.param_logical_axes(cfg),
                                                      mesh, rules))
            results[shape, arch] = {
                "train": train, "held": held,
                "whole_grad_spread": spread_over_model(
                    train["grads_1"], mesh, tuple("." + n for n in WHOLE_LEAVES)),
                **tp_serve(cfg, params, mesh, tp_batches(cfg.vocab)["prompts"],
                           model_axis=m)}
    cfg = get_smoke_config("mamba2_370m")
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    results["broken_norms"] = broken_norm_grads(
        cfg, torch.load(Path(out_dir) / "params_mamba2_370m.pt", weights_only=True), mesh,
        tp_rules(cfg, "train"), tp_batches(cfg.vocab, SSM_SEQ)["train"])
    if rank == 0:
        torch.save(results, Path(out_dir) / "ssm_rank0.pt")


# ------------------------------------------------ vlm and encdec tensor parallelism

ENCDEC_ARCHS = ("internvl2_1b", "whisper_base")
# (mesh, attention mode of train and prefill): (2, 4) in heads mode
# (InternVL2 1 q head a rank over a sliced kv head, Whisper 1 q and 1 kv
# head), the same mesh in forced head_dim mode (the production route of
# both models: q, k and v gathered to whole heads), and (4, 2) in heads
# mode (2 q heads and 1 or 2 kv heads a rank); decode 4 or 8 of head_dim's
# 16 columns
ENCDEC_CASES = (((2, 4), "heads"), ((2, 4), "head_dim"), ((4, 2), "heads"))
# the leaves replicated over "model", used after a region's g or before
# its f, whose gradients must come out whole and equal on every "model"
# rank, by family (suffixes of their names)
ENCDEC_WHOLE_LEAVES = {
    "vlm": (".ln1", ".ln2", "final_norm"),
    "encdec": tuple(f".{ln}.{w}" for ln in ("ln1", "ln2", "ln_x") for w in ("scale", "bias"))
    + (".mlp.b_down", "enc_final_norm", "final_norm")}
# Whisper's b_down leaves drawn at this scale (seeded) for the planted fault
# that adds them before g: at the reference's zeros the fault changes
# nothing
B_DOWN_SCALE = 0.1


def encdec_inputs(cfg, rows: int = 4) -> dict:
    """A vlm's seeded patch embeddings (rows, n_patches, d) or an encdec's
    frame embeddings (rows, enc_len, d), float32, the same for the train
    batch and the prompts."""
    rng = np.random.default_rng(SEED + 4)
    name, length = (("patches", cfg.n_patches) if cfg.family == "vlm"
                    else ("frames", cfg.enc_len))
    return {name: torch.from_numpy(rng.standard_normal((rows, length, cfg.d_model))
                                   .astype(np.float32))}


def encdec_train_batch(cfg) -> dict:
    """The tensor-parallel cases' seeded train batch with
    :func:`encdec_inputs`."""
    return {**tp_batches(cfg.vocab)["train"], **encdec_inputs(cfg)}


def with_b_down(params: dict) -> dict:
    """``params`` with every ``mlp.b_down`` drawn seeded, N(0,
    B_DOWN_SCALE^2)."""
    rng = np.random.default_rng(SEED + 5)
    return {n: torch.from_numpy((rng.standard_normal(tuple(p.shape)) * B_DOWN_SCALE)
                                .astype(np.float32)) if n.endswith("mlp.b_down") else p
            for n, p in params.items()}


# the planted faults of Whisper's split: b_down added to each rank's
# partial sum before g (so ``count`` times), the cross K/V projections' f
# left out (the encoder's output takes a rank's share of their gradient),
# and that f at each layer's projection as well as at the encoder's exit
# (the shares summed ``count`` times)
ENCDEC_FAULTS = ("b_down_before_g", "cross_f_left_out", "cross_f_doubled")


def encdec_faults() -> dict:
    """Each of ENCDEC_FAULTS as (the function of
    ``repro_torch.models.blocks`` it replaces, the broken one)."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import gelu_mlp

    cross_kv, cross_source = blocks.encdec_cross_kv, blocks.cross_source

    def b_down_before_g(x, p, exit=None):
        y = gelu_mlp(x, p)
        return y if exit is None else exit(y)

    def doubled(p, cfg, enc_out, *, tp=None):
        return cross_kv(p, cfg, cross_source(enc_out, tp), tp=tp)

    return {"b_down_before_g": ("gelu_mlp", b_down_before_g),
            "cross_f_left_out": ("cross_source", lambda enc_out, tp=None: enc_out),
            "cross_f_doubled": ("encdec_cross_kv", doubled)}


def encdec_fault_grads(cfg, params: dict, mesh, rules, batch: dict) -> dict:
    """One sharded train step of Whisper on ``mesh`` under each planted
    fault of ENCDEC_FAULTS, its step-1 gradients gathered whole: at
    ``with_b_down(params)`` for ``b_down_before_g`` (the correct step's
    beside it, ``b_down_ok``), at ``params`` for the cross K/V
    projections' f."""
    from repro_torch.models import blocks

    out = {"b_down_ok": tp_train(cfg, with_b_down(params), mesh, rules, batch,
                                 steps=1)["grads_1"]}
    for name, (attr, broken) in encdec_faults().items():
        saved = getattr(blocks, attr)
        setattr(blocks, attr, broken)
        try:
            at = with_b_down(params) if name == "b_down_before_g" else params
            out[name] = tp_train(cfg, at, mesh, rules, batch, steps=1)["grads_1"]
        finally:
            setattr(blocks, attr, saved)
    return out


def held_model(cfg, sharded: dict, mesh, named: dict) -> dict:
    """The local shapes of every leaf as a rank's model holds them
    (``gather_params`` over "data") and its split's attention fields; for
    a vlm also its first block's input on its rows of the train batch
    (the patches, then the vocab-parallel lookup of the tokens) and the
    one-device input from the whole table ``named["embed"]``."""
    from repro_torch.distributed.sharding import rank_rows

    model = tmodel.gather_params(cfg, sharded, batch_axes=("data",))
    sp = model.split
    out = {"shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
           "split": {k: getattr(sp, k) for k in ("attn", "heads", "kv_heads", "kv_sliced",
                                                   "ff", "vocab", "count", "index")}}
    if cfg.family == "vlm":
        rows = {k: rank_rows(x, mesh, ("data",)) for k, x in encdec_train_batch(cfg).items()}
        tokens = rows["tokens"].long()
        with torch.no_grad():
            out["vlm_input"] = torch.cat([rows["patches"], tmodel._embed(model, tokens)], 1)
        out["vlm_input_one_device"] = torch.cat([rows["patches"], named["embed"][tokens]], 1)
    return out


def encdec_parallel_main(rank: int, out_dir: str) -> None:
    """Each arch of ENCDEC_ARCHS from the parameters the test wrote
    (OUT_DIR/params_<arch>.pt, the reference's converted) in each case of
    ENCDEC_CASES: TP_STEPS train steps on the seeded batch with its
    patches or frames, the spread over "model" of the step-1 gradients of
    the leaves replicated there, the leaves a rank holds, then the
    prefill and decode steps; on (2, 4) in heads mode Whisper's step-1
    gradients under each planted fault.  Rank 0 writes
    OUT_DIR/encdec_rank0.pt, keyed by (mesh, mode, arch)."""
    from repro_torch.distributed.elastic import reshard_state

    results = {}
    for shape, mode in ENCDEC_CASES:
        mesh = make_debug_mesh(shape, ("data", "model"))
        m = shape[1]
        for arch in ENCDEC_ARCHS:
            cfg = get_smoke_config(arch)
            params = torch.load(Path(out_dir) / f"params_{arch}.pt", weights_only=True)
            rules = tp_rules(cfg, "train", mode == "head_dim", model_axis=m)
            train = tp_train(cfg, params, mesh, rules, encdec_train_batch(cfg))
            named = {n: p.detach() for n, p in _model(cfg, params).named_parameters()}
            with mesh_context(mesh):
                held = held_model(cfg, reshard_state(named, tmodel.param_logical_axes(cfg),
                                                     mesh, rules), mesh, named)
            results[shape, mode, arch] = {
                "train": train, "held": held,
                "whole_grad_spread": spread_over_model(train["grads_1"], mesh,
                                                       ENCDEC_WHOLE_LEAVES[cfg.family]),
                **tp_serve(cfg, params, mesh, tp_batches(cfg.vocab)["prompts"], model_axis=m,
                           extra=encdec_inputs(cfg), head_dim_mode=mode == "head_dim")}
    cfg = get_smoke_config("whisper_base")
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    results["faults"] = encdec_fault_grads(
        cfg, torch.load(Path(out_dir) / "params_whisper_base.pt", weights_only=True), mesh,
        tp_rules(cfg, "train"), encdec_train_batch(cfg))
    if rank == 0:
        torch.save(results, Path(out_dir) / "encdec_rank0.pt")


def main(rank: int, world: int, store_file: str, out_dir: str, mode: str = "") -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    try:
        if mode:
            {"tensor_parallel": tensor_parallel_main,
             "expert_parallel": expert_parallel_main,
             "ssm_parallel": ssm_parallel_main,
             "encdec_parallel": encdec_parallel_main}[mode](rank, out_dir)
            dist.barrier()
            return
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
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], *sys.argv[5:6])
