#!/usr/bin/env python3
"""Bit-level record of the solve path and the solve service on a CUDA device.

    PYTHONPATH=<tree>/src python3 scripts/service_bits.py --save FILE.npz
    python3 scripts/service_bits.py --compare A.npz B.npz

``--save`` runs, with whichever ``repro_torch`` is first on the path,
``solve_batch(method="analog_2n", compute_settling=True)`` on the slice's
systems of ``chip_smoke.py`` (dense n = 48 and 256, matrix-free n = 1024,
B = 4), the other methods at n = 64, and the smoke's service stream (the
benchmark's mix, 72 requests) at one and two CUDA streams and one and two
micro-batches in flight; it saves every delivered x, settle step and flag,
and prints the wall of each call and each drain with the drain's
``device_wait_s``.  ``--compare`` prints whether two saved runs (for
example two commits of the package on one card) agree bit for bit, and
exits 1 if any array differs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def save(path: str) -> None:
    import repro_torch
    from repro_torch import solve_batch
    from repro_torch.serving import SolveService

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out: dict[str, np.ndarray] = {}
    walls: dict[str, float] = {}
    for n, matrix_free in ((smoke.N_DENSE_SMALL, False), (smoke.N_DENSE, False),
                           (smoke.N_MATRIX_FREE, True)):
        a, x, b = smoke.systems(n, smoke.BATCH)
        kw = {"settle_matrix_free": True, "x_ref": x} if matrix_free else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_batch(a, b, method="analog_2n", compute_settling=True,
                          settle_method="euler", settle_max_steps=smoke.MAX_STEPS,
                          device=dev, **kw)
        torch.cuda.synchronize()
        walls[f"slice_n{n}"] = time.perf_counter() - t0
        out[f"slice_n{n}_x"] = res.x
        out[f"slice_n{n}_settle_steps"] = res.info["settle_steps"]
        out[f"slice_n{n}_stable"] = res.stable
    a, _x, b = smoke.systems(64, smoke.BATCH)
    for method in ("cholesky", "cg", "jacobi", "analog_n"):
        out[f"{method}_n64_x"] = solve_batch(a, b, method=method, device=dev).x
    stream = smoke.service_stream()
    for n_streams in (1, 2):
        for inflight in (1, 2):
            key = f"mix_streams_{n_streams}_inflight_{inflight}"
            svc = SolveService(batch_slots=smoke.SERVICE_SLOTS, devices=[dev] * n_streams,
                               inflight_per_device=inflight)
            rids = [svc.submit(a, b, method=m) for a, b, m in stream]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = svc.drain()
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
            walls[key + "_device_wait"] = svc.stats["device_wait_s"]
            out[key + "_x"] = np.concatenate([res[r].x for r in rids])
    np.savez(path, **out)
    print(json.dumps({"saved": path, "package": str(Path(repro_torch.__file__).parent),
                      "device": torch.cuda.get_device_name(0), "walls_s": walls}))


def compare(a_path: str, b_path: str) -> int:
    a, b = np.load(a_path), np.load(b_path)
    keys = sorted(set(a.files) | set(b.files))
    same = {k: bool(k in a.files and k in b.files and np.array_equal(a[k], b[k]))
            for k in keys}
    print(json.dumps({"compared": [a_path, b_path], "arrays": len(keys),
                      "differ": [k for k, v in same.items() if not v]}))
    return 0 if all(same.values()) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--save", metavar="FILE")
    group.add_argument("--compare", nargs=2, metavar="FILE")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("service_bits.py: no CUDA device", file=sys.stderr)
        return 2
    save(args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
