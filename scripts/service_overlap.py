#!/usr/bin/env python3
"""Where the solve service's wall goes on a CUDA device, by in-flight
depth and by where the netlist build runs.

    PYTHONPATH=src python3 scripts/service_overlap.py [--repeats 3]

Drains ``chip_smoke.py``'s two service streams — the benchmark's mix (72
requests, 8 slots) and the FEM stream (32 meshes, n = 256-1024) — on one
CUDA stream at ``inflight_per_device`` 1 and 2, with the netlist build on
the service's build stream (as shipped) and, for comparison, on the
service stream itself (the naive port: the build's ``.cpu()`` copy then
waits for the stream's previous DC solve).  The variants run in turns,
``--repeats`` times, and every drain's answers must equal the first's
bit for bit.  Prints one JSON line per drain (wall and the stats'
split), then a ``torch.profiler`` table per variant of the benchmark's
stream: the host time of the CUDA runtime calls and of the DC solve's
operator, which say what the host waits on.
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

PROFILED = ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaDeviceSynchronize",
            "cudaMalloc", "cudaFree", "cudaLaunchKernel", "aten::linalg_solve_ex",
            "aten::linalg_lu_factor_ex", "aten::_to_copy")


def drain(stream, inflight: int, build_on_service_stream: bool):
    from repro_torch.serving import SolveService

    svc = SolveService(batch_slots=smoke.SERVICE_SLOTS, devices=["cuda"],
                       inflight_per_device=inflight)
    if build_on_service_stream:
        svc._on_build_stream = svc._on_stream
    rids = [svc.submit(a, b, method=m) for a, b, m in stream]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, svc.stats, [out[r].x for r in rids]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("service_overlap.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.fem import mesh_stream

    count, grids = smoke.SERVICE_FEM
    streams = {
        "benchmark_mix": smoke.service_stream(),
        "fem": [(m.a, m.b, "analog_2n") for m in mesh_stream(smoke.SEED, count, grids=grids)],
    }
    variants = [(inflight, naive) for naive in (False, True) for inflight in (1, 2)]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smoke.nvidia_smi()}),
          flush=True)
    first = {}
    for name, stream in streams.items():
        drain(stream, 2, False)                       # warm-up
        for rep in range(args.repeats):
            order = variants if rep % 2 == 0 else variants[::-1]
            for inflight, naive in order:
                wall, st, xs = drain(stream, inflight, naive)
                ref = first.setdefault(name, xs)
                same = all(np.array_equal(x, y) for x, y in zip(xs, ref))
                print(json.dumps(dict(
                    stream=name, repeat=rep, inflight_per_device=inflight,
                    build="service_stream" if naive else "build_stream", wall_s=wall,
                    requests_per_s=len(stream) / wall, same_bytes=same,
                    **{k: st[k] for k in smoke.STAGES[1:]})), flush=True)
                if not same:
                    return 1
    from torch.profiler import ProfilerActivity, profile

    for inflight, naive in variants:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, _st, _xs = drain(streams["benchmark_mix"], inflight, naive)
        rows = {e.key: dict(calls=e.count, host_ms=e.self_cpu_time_total / 1e3)
                for e in prof.key_averages() if e.key in PROFILED}
        print(json.dumps(dict(profile="benchmark_mix", inflight_per_device=inflight,
                              build="service_stream" if naive else "build_stream",
                              wall_s=wall, host_calls=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
