"""Dry run: trace every (architecture x input shape) cell without data,
on one card or on a production mesh, and count its work, memory,
collectives and roofline.

Counterpart of :mod:`repro.launch.dryrun`.  The reference lowers each
cell to XLA HLO on meshes of 256 and 512 TPU chips and reads FLOPs, bytes,
collective bytes and memory sizes from it.  The port has no HLO: it runs
the cell's step (a train step with AdamW(3e-4) and block remat, a
prefill or a decode step) on the ``meta`` device, on parameters and
inputs that are shapes and dtypes without data, under
:class:`~repro_torch.roofline.cost.CostCounter`, and models the card
(:mod:`repro_torch.roofline.analysis`).  K8 and its backward enter as
one counted operation each (``kernels/flash_attention.py``); nothing is
launched and no plain version runs in K8's place.

Meshes.  ``single_card`` runs the one-device step: nothing is sharded
and no collective runs.  ``single_pod`` ((16, 16) ``("data", "model")``,
256 ranks) and ``multi_pod`` ((2, 16, 16) ``("pod", "data", "model")``,
512 ranks) trace one rank's step, rank 0 of a ``"fake"`` process group
(:func:`repro_torch.launch.mesh.fake_world`) in this process, which takes
every collective and moves nothing.  The rules are the reference's:
``make_rules``, ``adjust_batch_rule``, then, with ``attn_batch_layout``,
``apply_attn_batch_layout``.  Outside the counter the state is placed by
``param_specs`` (AdamW's moments as the parameters) and a decode cache
by ``cache_logical_axes`` under the decode rules, as DTensors: the
counterpart of ``in_shardings``.  The counted step is the port's sharded
step: :func:`~repro_torch.training.step.make_sharded_train_step`
(gradients all-reduced over the batch axes, AdamW on the shards) and
:mod:`repro_torch.serving.sharded` for prefill and decode (the outputs
kept as the reference's ``out_shardings`` place them), on the rank's
rows.  Every family's rank is tensor parallel over ``"model"``, as
GSPMD splits the reference's: its leaves gathered over the batch axes
alone, its share computed (heads mode: its q heads; head_dim mode in
decode: its columns of q, k, v and the caches; head_dim mode in train
and prefill, yi_34b's, InternVL2's and Whisper's: q, k and v gathered to
whole heads, attention replicated over ``"model"``, item 14.5), the MLP
and the logits split, partial sums all-reduced; Whisper's cross
attention as its self-attention, the encoder's output entering the
decoder through one f, its GELU MLP's ``b_down`` added after the sum;
an MoE rank's experts are its own (Granite-MoE, expert parallel: the
experts' outputs gathered) or its ``ff`` columns of every expert
(Mixtral: their partial sums all-reduced), and its dispatch groups the
global batch's; a Mamba block's rank its ``inner`` columns and SSM heads
(the gated norm's mean square all-reduced, the conv window's new columns
gathered), Zamba2's shared block and InternVL2's blocks as the dense
family's.  The rank's rows follow the batch rule (``long_500k``'s batch
of 1 is replicated).  With the attention batch layout (``train_4k`` on
``single_pod`` for yi_34b, internvl2_1b and whisper_base) each
``"model"`` rank runs self-attention on its 1/16 of the rows and the
output is all-gathered (``models/blocks.py:attn_forward``).

The result keeps the reference's keys, per rank: ``n_chips``,
``collectives`` (result bytes by kind, from the counter), ``roofline``
(``roofline_report(n_chips=...)``) and ``memory`` (``argument_size_b``
the local shards and the rank's rows, ``temp_size_b`` with the leaves
the rank gathers).  ``"compute"`` says how a rank computes:
``"tensor parallel over model"`` (dense, vlm, SSM, hybrid, encdec),
``"expert parallel over model"`` (Granite-MoE) or ``"tensor parallel
inside experts over model"`` (Mixtral), with ``"attention"`` naming the
attention's mode (none for Mamba2, which has no attention).

Usage (the CPU suffices; nothing runs on a card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single_pod --workers 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --workers 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k
    (--baseline leaves the attention batch layout out; --workers N traces
    cells in N processes; --smoke takes the SMOKE configs)
Results land in results/dryrun/<mesh><tag>/<arch>__<shape>.json.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    get_config,
    get_smoke_config,
    input_specs,
    shape_applicable,
)
from repro_torch.distributed.elastic import reshard_state
from repro_torch.distributed.rules import adjust_batch_rule, apply_attn_batch_layout, make_rules
from repro_torch.distributed.sharding import rank_rows, rule_axes, use_rules
from repro_torch.launch.mesh import fake_world, mesh_context
from repro_torch.models.model import (
    cache_logical_axes,
    count_active_params,
    decode_step,
    init_params,
    model_flops,
    param_logical_axes,
    prefill,
)
from repro_torch.optim.adamw import adamw
from repro_torch.roofline.analysis import HardwareSpec, roofline_report, spec_for_card
from repro_torch.roofline.cost import CostCounter
from repro_torch.serving.sharded import make_sharded_decode_step, make_sharded_prefill
from repro_torch.training.step import (
    init_train_state,
    make_sharded_train_step,
    make_train_step,
    shard_train_state,
)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun"
# the reference's production meshes, traced over a fake process group
SHARDED_MESHES = ("single_pod", "multi_pod")
MESHES = ("single_card",) + SHARDED_MESHES


def sharded_compute(cfg) -> str:
    """The result's ``"compute"`` of a cell of ``cfg`` on a production
    mesh: every rank computes its share over ``"model"`` (an MoE's
    experts by its ``moe_parallel``: its experts, or its ``ff`` columns
    of every expert)."""
    if cfg.family == "moe":
        return ("expert parallel over model" if cfg.moe_parallel == "ep"
                else "tensor parallel inside experts over model")
    return "tensor parallel over model"


def attention_mode(shape, rules) -> str:
    """How a rank's attention splits under ``rules`` (the result's
    ``"attention"``): over its q heads, over head_dim (decode),
    replicated over ``"model"`` with q, k and v gathered whole (head_dim
    rules in train and prefill), on its share of the rows (the attention
    batch layout), or replicated (neither heads nor head_dim on the
    axis)."""
    if "model" in rule_axes(rules.get("attn_batch")):
        return "batch layout over model"
    if rules.get("q_heads") == "model":
        return "heads"
    if rules.get("head_dim") == "model":
        if shape.kind == "decode":
            return "head_dim"
        return "replicated over model (head_dim: q, k, v gathered)"
    return "replicated over model"
# the card the port targets: the spec the dry run models unless told
TARGET_CARD = "NVIDIA H100 80GB HBM3"


def tensor_tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (dicts, lists, modules), each
    storage once; a DTensor counts its local shard."""
    from torch.distributed.tensor import DTensor

    seen, total = set(), 0

    def visit(x):
        nonlocal total
        if isinstance(x, DTensor):
            visit(x.to_local())
        elif isinstance(x, torch.Tensor):
            key = x.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
        elif isinstance(x, torch.nn.Module):
            for t in x.state_dict(keep_vars=True).values():
                visit(t)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    return total


def cell_rules(cfg, shape, mesh_name: str, attn_batch_layout: bool) -> dict:
    """The reference's rules of a cell on a production mesh (its
    ``run_cell``, ``repro/launch/dryrun.py:123-133``)."""
    multi_pod = mesh_name == "multi_pod"
    rules = adjust_batch_rule(make_rules(cfg, multi_pod=multi_pod, job=shape.kind),
                              shape.global_batch, multi_pod)
    if attn_batch_layout:
        rules = apply_attn_batch_layout(rules, cfg, shape.global_batch, multi_pod=multi_pod)
    return rules


def trace_cell(cfg, shape) -> tuple[CostCounter, dict]:
    """Run the cell's step on ``meta`` under a counter.  Returns the
    counter and what the step read and wrote: ``args``, ``outputs``, the
    parameters (``params``), the tokens it processes (``n_tokens``) and
    whether it trains (``train``)."""
    specs = input_specs(cfg, shape)
    counter = CostCounter(device="meta")
    if shape.kind == "train":
        optimizer = adamw(3e-4)
        state = init_train_state(cfg, optimizer, None, device="meta")
        step = make_train_step(cfg, optimizer)
        args = (state["params"], state["opt_state"], specs)
        with counter:
            state, metrics = step(state, specs)
        return counter, dict(args=args, outputs=(state["params"], state["opt_state"], metrics),
                             params=state["params"], n_tokens=shape.global_batch * shape.seq_len,
                             train=True)
    params = init_params(cfg, None, device="meta")
    if shape.kind == "prefill":
        with counter:
            out = prefill(params, specs, cfg, max_seq=shape.seq_len)
        n_tokens = shape.global_batch * shape.seq_len
    else:
        with counter:
            out = decode_step(params, specs["token"], specs["pos"], specs["cache"], cfg)
        n_tokens = shape.global_batch          # one token a sequence
    return counter, dict(args=(params, specs), outputs=out, params=params, n_tokens=n_tokens,
                         train=False)


def trace_sharded_cell(cfg, shape, mesh, rules) -> tuple[CostCounter, dict]:
    """Run one rank's sharded step of the cell on ``meta`` under a
    counter, with ``rules`` and ``mesh`` active (the attention batch
    layout reads them).  The state and a decode cache are placed before
    the counter starts.  Returns what :func:`trace_cell` returns, with
    ``args`` and ``outputs`` as this rank holds them."""
    axes = rule_axes(rules["batch"])
    specs = input_specs(cfg, shape)

    def rows(batch: dict) -> dict:
        # this rank's rows of the global inputs, as tensors of their own
        return {k: torch.empty_like(rank_rows(x, mesh, axes)) for k, x in batch.items()}

    counter = CostCounter(device="meta")
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    params = init_params(cfg, None, device="meta")
    with mesh_context(mesh), use_rules(rules):
        if shape.kind == "train":
            if axes != tuple(a for a in mesh.mesh_dim_names if a != "model"):
                # the sharded step splits the batch over every axis but "model"
                raise NotImplementedError(f"a train batch rule of {axes} on {mesh.mesh_dim_names}")
            optimizer = adamw(3e-4)
            state = shard_train_state(init_train_state(cfg, optimizer, None, device="meta"),
                                      cfg, mesh, rules)
            step = make_sharded_train_step(cfg, optimizer, mesh)
            args = (state["params"], state["opt_state"], rows(specs))
            with counter:
                state, metrics = step(state, specs)
            return counter, dict(args=args, outputs=(state["params"], state["opt_state"], metrics),
                                 params=params, n_tokens=n_tokens, train=True)
        sharded = reshard_state(dict(params.named_parameters()), param_logical_axes(cfg), mesh,
                                rules)
        if shape.kind == "prefill":
            multi_pod = "pod" in mesh.mesh_dim_names
            cache_rules = adjust_batch_rule(make_rules(cfg, multi_pod=multi_pod, job="decode"),
                                            shape.global_batch, multi_pod)
            step = make_sharded_prefill(cfg, mesh, rules, cache_rules, shape.seq_len)
            args = (sharded, rows(specs))
            with counter:
                out = step(sharded, specs)
        else:
            cache = reshard_state(specs["cache"], cache_logical_axes(cfg), mesh, rules)
            step = make_sharded_decode_step(cfg, mesh, rules)
            args = (sharded, rows({"token": specs["token"]}), specs["pos"], cache)
            with counter:
                out = step(sharded, specs["token"], specs["pos"], cache)
    return counter, dict(args=args, outputs=out, params=params, n_tokens=n_tokens, train=False)


def run_cell(arch: str, shape_name: str, mesh_name: str = "single_card", *,
             attn_batch_layout: bool = False, smoke: bool = False,
             hw: HardwareSpec | None = None) -> dict:
    """One cell: the reference's result keys (``status``, ``reason`` when
    skipped; ``n_chips``, ``memory``, ``cost``, ``collectives``,
    ``roofline``, ``active_params``), ``host_s`` (the host seconds of the
    trace) in place of ``compile_s``, ``kernels`` (K8's counted
    operations) and, on a production mesh, ``compute``.
    ``attn_batch_layout`` applies the reference's attention batch layout
    on a production mesh (``single_card`` has no rules, and ignores it);
    ``smoke`` takes the arch's SMOKE config; ``hw`` the card modelled
    (default: the target card's spec)."""
    if mesh_name not in MESHES:
        raise ValueError(f"unknown mesh {mesh_name!r}: expected one of {MESHES}")
    hw = hw or spec_for_card(TARGET_CARD)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}

    t0 = time.perf_counter()
    if mesh_name == "single_card":
        n_chips = 1
        counter, run = trace_cell(cfg, shape)
    else:
        rules = cell_rules(cfg, shape, mesh_name, attn_batch_layout)
        with fake_world(multi_pod=mesh_name == "multi_pod") as mesh:
            n_chips = mesh.size()
            counter, run = trace_sharded_cell(cfg, shape, mesh, rules)
    host_s = time.perf_counter() - t0
    mf = model_flops(run["params"], cfg, run["n_tokens"], train=run["train"])
    coll = counter.collectives()
    roof = roofline_report(flops=float(counter.flops), bytes_accessed=float(counter.bytes),
                           collective_bytes=coll["total"], n_chips=n_chips, model_flops=mf,
                           hw=hw, dtype=cfg.act_dtype())
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "n_chips": n_chips,
        "host_s": round(host_s, 1),
        "memory": {
            "argument_size_b": tensor_tree_bytes(run["args"]),
            "output_size_b": tensor_tree_bytes(run["outputs"]),
            "temp_size_b": counter.peak_temp_bytes,
            "generated_code_size_b": None,
        },
        "cost": {"flops": float(counter.flops), "bytes_accessed": float(counter.bytes)},
        "collectives": coll,
        "roofline": roof,
        "active_params": count_active_params(run["params"], cfg),
        "kernels": counter.kernels,
    }
    if mesh_name != "single_card":
        res["compute"] = sharded_compute(cfg)
        if not cfg.is_attention_free:
            res["attention"] = attention_mode(shape, rules)
    return res


def cell_or_error(arch: str, shape_name: str, mesh_name: str, smoke: bool, hw: HardwareSpec,
                  attn_batch_layout: bool = False) -> dict:
    """:func:`run_cell`, or a result of status ``"error"`` with the
    traceback when the cell raises."""
    try:
        return run_cell(arch, shape_name, mesh_name, smoke=smoke, hw=hw,
                        attn_batch_layout=attn_batch_layout)
    except Exception as e:  # noqa: BLE001 - a failed cell is recorded, the rest run
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "error",
                "error": repr(e), "traceback": traceback.format_exc()}


def run_cells(cells, mesh_name: str = "single_card", *, workers: int = 1, smoke: bool = False,
              hw: HardwareSpec | None = None, attn_batch_layout: bool = False) -> list[dict]:
    """:func:`cell_or_error` of every (arch, shape) of ``cells``, in order;
    with ``workers > 1`` in that many spawned processes (a trace is host
    work, one core each; a production mesh's fake process group lives in
    the process that traces the cell)."""
    hw = hw or spec_for_card(TARGET_CARD)
    jobs = [(arch, shape, mesh_name, smoke, hw, attn_batch_layout) for arch, shape in cells]
    if workers <= 1:
        return [cell_or_error(*job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = [pool.submit(cell_or_error, *job) for job in jobs]
        return [f.result() for f in futures]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES), default="single_card")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both production meshes, single_pod and multi_pod")
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--baseline", action="store_true",
                    help="leave out the attention batch layout on the production meshes")
    ap.add_argument("--smoke", action="store_true", help="the archs' SMOKE configs")
    ap.add_argument("--workers", type=int, default=1, help="processes that trace cells")
    ap.add_argument("--tag", default="", help="suffix for the results directory")
    args = ap.parse_args(argv)

    meshes = SHARDED_MESHES if args.both_meshes else (args.mesh,)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(arch, shape) for arch in archs for shape in shapes]
    failures = []
    for mesh_name in meshes:
        results = run_cells(cells, mesh_name, workers=args.workers, smoke=args.smoke,
                            attn_batch_layout=not args.baseline)
        outdir = RESULTS_DIR / (mesh_name + args.tag)
        outdir.mkdir(parents=True, exist_ok=True)
        for res in results:
            tag = f"{mesh_name}{args.tag}/{res['arch']}__{res['shape']}"
            (outdir / f"{res['arch']}__{res['shape']}.json").write_text(
                json.dumps(res, indent=2))
            extra = ""
            if res["status"] == "ok":
                r = res["roofline"]
                extra = (f" dominant={r['dominant']}"
                         f" bound={r['step_time_lower_bound_s']:.4f}s"
                         f" temp={res['memory']['temp_size_b'] / 2**30:.1f}GiB"
                         f" coll={res['collectives']['total'] / 2**30:.2f}GiB"
                         f" host={res['host_s']}s")
            elif res["status"] == "skipped":
                extra = f" ({res['reason'][:60]})"
            else:
                failures.append(tag)
            print(f"[{res['status']:7s}] {tag}{extra}", flush=True)

    if failures:
        print(f"\nFAILED cells: {failures}")
        raise SystemExit(1)
    print("\nDRY-RUN PASSED")


if __name__ == "__main__":
    main()
