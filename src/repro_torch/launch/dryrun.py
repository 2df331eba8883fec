"""Dry run: trace every (architecture x input shape) cell on one card
without data, and count its work, memory and roofline.

Counterpart of :mod:`repro.launch.dryrun`.  The reference lowers each
cell to XLA HLO on meshes of 256 and 512 TPU chips and reads FLOPs, bytes,
collective bytes and memory sizes from it.  The port has no HLO: it runs
the cell's step (a train step with AdamW(3e-4) and block remat, a
prefill or a decode step) on the ``meta`` device, on parameters and
inputs that are shapes and dtypes without data, under
:class:`~repro_torch.roofline.cost.CostCounter`, and models one card
(:mod:`repro_torch.roofline.analysis`).  K8 and its backward enter as
one counted operation each (``kernels/flash_attention.py``); nothing is
launched and no plain version runs in K8's place.

Only ``single_card`` is ported: nothing is sharded, and no collective
runs (its bytes are 0).  The production meshes ``single_pod`` and
``multi_pod``, and the attention batch layout that applies on them, wait
on the sharded trace of ROADMAP Queue 1 item 13 and raise
:class:`NotImplementedError`; the sharding rules they use are ported
(:mod:`repro_torch.distributed`).

Usage (the CPU suffices; nothing runs on a card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k
    (--workers N traces cells in N processes; --smoke takes the SMOKE configs)
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
from repro_torch.models.model import (
    count_active_params,
    decode_step,
    init_params,
    model_flops,
    prefill,
)
from repro_torch.optim.adamw import adamw
from repro_torch.roofline.analysis import HardwareSpec, roofline_report, spec_for_card
from repro_torch.roofline.cost import CostCounter
from repro_torch.training.step import init_train_state, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun"
MESHES = ("single_card",)
# the reference's production meshes: they need item 13's sharded trace
SHARDED_MESHES = ("single_pod", "multi_pod")
# the card the port targets: the spec the dry run models unless told
TARGET_CARD = "NVIDIA H100 80GB HBM3"


def _sharding_missing(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the production meshes' sharded trace, which is not ported yet "
        "(ROADMAP Queue 1 item 13); the port's dry run runs on mesh 'single_card'")


def tensor_tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (dicts, lists, modules), each
    storage once."""
    seen, total = set(), 0

    def visit(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
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


def run_cell(arch: str, shape_name: str, mesh_name: str = "single_card", *,
             attn_batch_layout: bool = False, smoke: bool = False,
             hw: HardwareSpec | None = None) -> dict:
    """One cell: the reference's result keys (``status``, ``reason`` when
    skipped; ``memory``, ``cost``, ``collectives``, ``roofline``,
    ``active_params``), ``host_s`` (the host seconds of the trace) in
    place of ``compile_s``, and ``kernels`` (K8's counted operations).
    ``smoke`` takes the arch's SMOKE config; ``hw`` the card modelled
    (default: the target card's spec)."""
    if mesh_name in SHARDED_MESHES:
        raise _sharding_missing(f"mesh {mesh_name!r}")
    if mesh_name not in MESHES:
        raise ValueError(f"unknown mesh {mesh_name!r}: expected one of "
                         f"{MESHES + SHARDED_MESHES}")
    if attn_batch_layout:
        raise _sharding_missing("the attention batch layout")
    hw = hw or spec_for_card(TARGET_CARD)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}

    t0 = time.perf_counter()
    counter, run = trace_cell(cfg, shape)
    host_s = time.perf_counter() - t0
    mf = model_flops(run["params"], cfg, run["n_tokens"], train=run["train"])
    coll = counter.collectives()
    roof = roofline_report(flops=float(counter.flops), bytes_accessed=float(counter.bytes),
                           collective_bytes=coll["total"], n_chips=1, model_flops=mf, hw=hw,
                           dtype=cfg.act_dtype())
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "n_chips": 1,
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


def cell_or_error(arch: str, shape_name: str, mesh_name: str, smoke: bool,
                  hw: HardwareSpec) -> dict:
    """:func:`run_cell`, or a result of status ``"error"`` with the
    traceback when the cell raises."""
    try:
        return run_cell(arch, shape_name, mesh_name, smoke=smoke, hw=hw)
    except Exception as e:  # noqa: BLE001 - a failed cell is recorded, the rest run
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "error",
                "error": repr(e), "traceback": traceback.format_exc()}


def run_cells(cells, mesh_name: str = "single_card", *, workers: int = 1, smoke: bool = False,
              hw: HardwareSpec | None = None) -> list[dict]:
    """:func:`cell_or_error` of every (arch, shape) of ``cells``, in order;
    with ``workers > 1`` in that many spawned processes (a trace is host
    work, one core each)."""
    hw = hw or spec_for_card(TARGET_CARD)
    jobs = [(arch, shape, mesh_name, smoke, hw) for arch, shape in cells]
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
    ap.add_argument("--mesh", choices=list(MESHES + SHARDED_MESHES), default="single_card")
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--smoke", action="store_true", help="the archs' SMOKE configs")
    ap.add_argument("--workers", type=int, default=1, help="processes that trace cells")
    ap.add_argument("--tag", default="", help="suffix for the results directory")
    args = ap.parse_args(argv)
    if args.mesh in SHARDED_MESHES:
        raise _sharding_missing(f"mesh {args.mesh!r}")

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(arch, shape) for arch in archs for shape in shapes]
    results = run_cells(cells, args.mesh, workers=args.workers, smoke=args.smoke)
    outdir = RESULTS_DIR / (args.mesh + args.tag)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    for res in results:
        tag = f"{args.mesh}{args.tag}/{res['arch']}__{res['shape']}"
        (outdir / f"{res['arch']}__{res['shape']}.json").write_text(json.dumps(res, indent=2))
        extra = ""
        if res["status"] == "ok":
            r = res["roofline"]
            extra = (f" dominant={r['dominant']}"
                     f" bound={r['step_time_lower_bound_s']:.4f}s"
                     f" temp={res['memory']['temp_size_b'] / 2**30:.1f}GiB"
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
