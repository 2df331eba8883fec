#!/usr/bin/env python3
"""Where a tensor-parallel rank's decode step spends its device time.

    PYTHONPATH=src python3 scripts/tp_rank_profile.py [--steps N]

One rank of Qwen3-8B's ``decode_32k`` on ``single_pod`` (8 rows, its 8 of
each head's 128 columns of a 32,768-token cache, bf16, its share of every
leaf), built as ``chip_smoke.py``'s counted case builds it: rank 0 of a
fake world of 16 "model" ranks, whose collectives move nothing.  Beside
it the same rows' one-device decode step over the whole cache and model,
the step each rank ran before tensor parallelism.  After one warm-up
step each, N steps under ``torch.profiler``: prints one JSON line per
step kind with the device ms a step, and the kernels that take most of it
(device ms a step and calls a step, by kernel name).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TOP = 12


def profile(fn, steps: int) -> dict:
    """Device ms a step of ``fn``, and the TOP kernels by device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    return dict(device_ms=total, kernels=[
        dict(name=e.key[:120], device_ms=e.self_device_time_total / 1e3 / steps,
             calls=e.count / steps) for e in kernels[:TOP]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tp_rank_profile.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, production_axis_sizes
    from repro_torch.models.model import decode_step, init_decode_cache

    build.load_library()
    dev = torch.device("cuda", 0)
    cfg = get_config(smoke.RANK_ARCH)
    shape = SHAPES[smoke.RANK_SHAPE]
    rules = dryrun.cell_rules(cfg, shape, smoke.RANK_MESH, True)
    rows = shape.global_batch // production_axis_sizes()["data"]
    token = smoke.counted_tokens(dev, (rows, 1), cfg.vocab)
    pos = torch.full((), shape.seq_len - 1, dtype=torch.int32, device=dev)
    print(smoke.nvidia_smi(), flush=True)
    with fake_world(mesh_shape=(1, smoke.TP_RANKS)) as mesh:
        model = smoke.tp_rank_model(cfg, mesh, rules, dev)
        cache = {n: torch.zeros((cfg.n_layers, rows, shape.seq_len, cfg.n_kv_heads,
                                 cfg.head_dim // smoke.TP_RANKS), dtype=cfg.act_dtype(),
                                device=dev) for n in ("k", "v")}
        res = profile(lambda: decode_step(model, token, pos, cache, cfg), args.steps)
        print(json.dumps(dict(step="tensor_parallel_rank", rows=rows, **res)), flush=True)
    del model, cache
    torch.cuda.empty_cache()
    params = smoke.counted_params(cfg, dev)
    cache = init_decode_cache(cfg, rows, shape.seq_len, device=dev)
    res = profile(lambda: decode_step(params, token, pos, cache, cfg), args.steps)
    print(json.dumps(dict(step="one_device_rows", rows=rows, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
