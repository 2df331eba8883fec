#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

1. device — the card's name and power limit, the kernel build time;
2. kernels — each hand-written Hopper kernel (K1 ELL sweep and K2 ELL
   step, in float32 and bfloat16; K3 dense sweep, K4 dense step) held
   against its plain PyTorch version on the card at every operator shape
   the main path assembles (ELL n = 256, 1024, 2048; dense n = 48, 256)
   and at dense n = 64, 80, 128 around the persistent route's limit, plus each
   persistent sweep against the loop of its row-tiled step; kernel,
   plain-version and library-call times, and the per-step times of both
   routes of each pair at each shape;
3. slice — the main path through the public entry points, with every
   launch count reset just before and read just after, and each case
   failing unless its operator is routed to the kernel it is there to
   drive and that kernel launched:
   ``solve_batch(method="analog_2n", compute_settling=True,
   settle_method="euler")`` matrix-free at n = 1024 and 2048 and on the
   dense operator at n = 256 (B = 4, the sparse size-sweep protocol of
   benchmarks/tpu_complexity.py) and on a dense operator at n = 48,
   small enough for the persistent dense sweep; then
   ``transient_batch(method="euler")`` on the ELL and the dense operator
   at n = 256, and ``euler_settle_batch`` on both against one reference
   point (their settle steps must agree within one 50-step chunk);
4. the kernels line, the nvidia-smi line, and the contract's last line.

It imports no JAX and nothing of the JAX package.  Without CUDA it
exits with code 2 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet), used for bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SEED = 99
BATCH = 4
MAX_STEPS = 30_000
KERNEL_STEPS = 64
N_MATRIX_FREE = 1024     # ELL operator, nz = 8192: the size sweep's scale
N_MATRIX_FREE_LARGE = 2048  # ELL operator, nz = 16384: past the persistent limit
N_DENSE = 256            # dense operator, nz = 2048
N_DENSE_SMALL = 48       # dense operator small enough for the persistent sweep
# dense operators of 1, 1.6 and 4 MiB per system (nz = 512, 640, 1024),
# on both sides of the persistent dense route's 1 MiB limit
DENSE_ROUTE_PROBES = (64, 80, 128)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per ``fn()`` with the host out of the loop:
    ``reps`` calls captured in one CUDA graph, replayed three times."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * reps)


def systems(n: int, count: int):
    """The sparse size-sweep protocol (benchmarks/tpu_complexity.py):
    row degree 16, paper-protocol solutions, from a per-size seed."""
    from repro_torch.data.spd import random_rhs_from_solution, random_spd

    rng = np.random.default_rng(SEED)
    density = min(1.0, 16 / n)
    a, x, b = [], [], []
    for _ in range(count):
        ak = random_spd(rng, n, density=density)
        xk, bk = random_rhs_from_solution(rng, ak)
        a.append(ak), x.append(xk), b.append(bk)
    return np.stack(a), np.stack(x), np.stack(b)


def max_rel(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-30)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def ell_operands(n: int, dev):
    """Dt-folded, padded, slot-major ELL operands of the size-n batch,
    prepared as euler_settle_batch prepares them."""
    from repro_torch.core import engine
    from repro_torch.core.network import build_proposed_batch
    from repro_torch.kernels import ops

    a, _x, b = systems(n, BATCH)
    ell = engine.assemble_batch_ell(build_proposed_batch(a, b, device=dev), device=dev)
    dt = torch.as_tensor(engine._settle_dt(ell, 0.5, "diag"), device=dev)
    w32 = (ell.weights * dt[:, None, None]).float()
    idx_t, w_t = ops.ell_prepare(ell.indices, w32, "float32")
    _, w_bf = ops.ell_prepare(ell.indices, w32.bfloat16(), "bfloat16")
    c = ops.pad_rows((ell.c * dt[:, None]).float(), (1,))
    return ell, idx_t, w_t, w_bf, c


def dense_operands(n: int, dev):
    from repro_torch.core import engine
    from repro_torch.core.network import build_proposed_batch
    from repro_torch.kernels import ops

    a, _x, b = systems(n, BATCH)
    bss = engine.assemble_batch(build_proposed_batch(a, b, device=dev), device=dev)
    dt = torch.as_tensor(engine._settle_dt(bss, 0.5, "diag"), device=dev)
    m = ops.pad_rows((bss.m * dt[:, None, None]).float(), (1, 2)).contiguous()
    c = ops.pad_rows((bss.c * dt[:, None]).float(), (1,))
    return bss, m, m.transpose(1, 2).contiguous(), c


def start_state(c: torch.Tensor) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(SEED)
    return (torch.rand(c.shape, generator=g) - 0.5).to(c.device)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time of one call: its inputs read once and outputs written
    once at the HBM rate, or its flops at the f32 peak, the larger.  A
    cold call brings its inputs from HBM; where the timing loop keeps
    them in L2 (the ELL operands, small dense ones) the bound is loose."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# f32 reassociation (kernel: sequential slot/column order; plain: torch's
# reduction order) grows over the steps but stays ~1e-7 relative per
# step; 1e-5 of max|z| after 64 steps leaves margin.  The residual is a
# difference of large terms, so it gets 1e-4 relative.  In bf16 a 1-ulp
# f32 difference of the state can flip the bf16 rounding of a gathered
# value (2^-8 relative), hence 2e-3.
TOL_Z, TOL_RES, TOL_BF16 = 1e-5, 1e-4, 2e-3


def ell_pair(n: int, dev, steps: int) -> dict:
    """K1 and K2 on the size-n ELL operator: each against its plain version
    in float32 and bfloat16, K1 against ``steps`` K2 launches plus the dt=0
    launch; per-call times of both."""
    from repro_torch.kernels import ell_transient as ek
    from repro_torch.kernels import ops

    ell, idx_t, w_t, w_bf, c = ell_operands(n, dev)
    route = ops.sweep_backend(ell.n_states, ell.ell_width)
    z0 = start_state(c)
    bsz, k, nz = idx_t.shape
    zk, rk = ek.ell_sweep(idx_t, w_t, z0, c, n_steps=steps)
    zp, rp = ek.ell_sweep_plain(idx_t, w_t, z0, c, n_steps=steps)
    e1, r1 = max_rel(zk, zp)
    _, rr1 = max_rel(rk, rp)
    zkb, _ = ek.ell_sweep(idx_t, w_bf, z0, c, n_steps=steps)
    zpb, _ = ek.ell_sweep_plain(idx_t, w_bf, z0, c, n_steps=steps)
    e1b, r1b = max_rel(zkb, zpb)
    check(r1 <= TOL_Z and rr1 <= TOL_RES, f"K1 n={n} vs plain: state {r1}, residual {rr1}")
    check(r1b <= TOL_BF16, f"K1 bf16 n={n} vs plain: state {r1b}")

    zs, rs = ek.ell_step(idx_t, w_t, z0, c)
    zsp, rsp = ek.ell_step_plain(idx_t, w_t, z0, c)
    e2, r2 = max_rel(zs, zsp)
    _, rr2 = max_rel(rs, rsp)
    zsb, _ = ek.ell_step(idx_t, w_bf, z0, c)
    zsbp, _ = ek.ell_step_plain(idx_t, w_bf, z0, c)
    e2b, r2b = max_rel(zsb, zsbp)
    check(r2 <= TOL_Z and rr2 <= TOL_RES, f"K2 n={n} vs plain: state {r2}, residual {rr2}")
    check(r2b <= TOL_BF16, f"K2 bf16 n={n} vs plain: state {r2b}")

    zl = z0
    for _ in range(steps):
        zl, _ = ek.ell_step(idx_t, w_t, zl, c)
    _, rl = ek.ell_step(idx_t, w_t, zl, c, 0.0)
    _, x12 = max_rel(zl, zk)
    _, xr12 = max_rel(rl.amax(dim=1), rk[:, 0])
    check(x12 <= TOL_Z and xr12 <= TOL_RES, f"K1 vs K2 loop n={n}: {x12}, {xr12}")

    t_k1 = cuda_ms(lambda: ek.ell_sweep(idx_t, w_t, z0, c, n_steps=steps), 20)
    t_k1b = cuda_ms(lambda: ek.ell_sweep(idx_t, w_bf, z0, c, n_steps=steps), 20)
    t_k1p = cuda_ms(lambda: ek.ell_sweep_plain(idx_t, w_t, z0, c, n_steps=steps), 3)
    t_k2 = cuda_ms(lambda: ek.ell_step(idx_t, w_t, z0, c), 200)
    t_k2g = graph_ms(lambda: ek.ell_step(idx_t, w_t, z0, c), 100)
    t_k2p = cuda_ms(lambda: ek.ell_step_plain(idx_t, w_t, z0, c), 50)
    idx_l = idx_t.long()
    t_k2l = cuda_ms(lambda: (w_t * z0.unsqueeze(1).expand(-1, k, -1).gather(2, idx_l)).sum(1), 50)
    op_bytes = bsz * nz * k * (4 + 4)
    vec_bytes = bsz * nz * 4
    k1_bytes = op_bytes + 3 * vec_bytes + bsz * 4
    k2_bytes = op_bytes + 3 * vec_bytes + bsz * (nz // ops.ROW_BLOCK) * 4
    return dict(
        route=route,
        ell_sweep=dict(
            shape=[bsz, k, nz], n_steps=steps, ms=t_k1, ms_bf16=t_k1b, plain_ms=t_k1p,
            library_ms=None, max_abs_err=e1, max_abs_err_bf16=e1b,
            bytes=k1_bytes, flops=(steps + 1) * bsz * nz * (2 * k + 2)),
        ell_step=dict(
            shape=[bsz, k, nz], ms=t_k2, device_ms=t_k2g, plain_ms=t_k2p,
            library_ms=t_k2l, max_abs_err=e2, max_abs_err_bf16=e2b,
            bytes=k2_bytes, flops=bsz * nz * (2 * k + 2)),
        per_step={"route": route, "k1_ms_per_step": t_k1 / steps, "k2_ms_per_step": t_k2,
                  "k2_device_ms_per_step": t_k2g,
                  "operator_bytes_per_system": nz * k * 8},
    )


def dense_pair(n: int, dev, steps: int) -> dict:
    """K3 and K4 on the size-n dense operator: each against its plain
    version, K3 against ``steps`` K4 launches plus the dt=0 launch;
    per-call times of both."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import transient_step as sk

    bss, m, m_t, c = dense_operands(n, dev)
    route = ops.sweep_backend(bss.n_states, None)
    z0 = start_state(c)
    bsz, nz, _ = m.shape
    zk, rk = sk.transient_sweep(m_t, z0, c, n_steps=steps)
    zp, rp = sk.transient_sweep_plain(m_t, z0, c, n_steps=steps)
    e3, r3 = max_rel(zk, zp)
    _, rr3 = max_rel(rk, rp)
    check(r3 <= TOL_Z and rr3 <= TOL_RES, f"K3 n={n} vs plain: state {r3}, residual {rr3}")
    zs, rs = sk.transient_step_batched(m, z0, c)
    zsp, rsp = sk.transient_step_batched_plain(m, z0, c)
    e4, r4 = max_rel(zs, zsp)
    _, rr4 = max_rel(rs, rsp)
    check(r4 <= TOL_Z and rr4 <= TOL_RES, f"K4 n={n} vs plain: state {r4}, residual {rr4}")
    zl = z0
    for _ in range(steps):
        zl, _ = sk.transient_step_batched(m, zl, c)
    _, rl = sk.transient_step_batched(m, zl, c, 0.0)
    _, x34 = max_rel(zl, zk)
    _, xr34 = max_rel(rl.amax(dim=1), rk[:, 0])
    check(x34 <= TOL_Z and xr34 <= TOL_RES, f"K3 vs K4 loop n={n}: {x34}, {xr34}")

    t_k3 = cuda_ms(lambda: sk.transient_sweep(m_t, z0, c, n_steps=steps), 5)
    t_k3p = cuda_ms(lambda: sk.transient_sweep_plain(m_t, z0, c, n_steps=steps), 3)
    t_k4 = cuda_ms(lambda: sk.transient_step_batched(m, z0, c), 200)
    t_k4g = graph_ms(lambda: sk.transient_step_batched(m, z0, c), 100)
    t_k4p = cuda_ms(lambda: sk.transient_step_batched_plain(m, z0, c), 50)
    cz, zz = c.unsqueeze(-1), z0.unsqueeze(-1)
    t_k4l = cuda_ms(lambda: torch.baddbmm(cz, m, zz), 50)
    op_bytes = bsz * nz * nz * 4
    vec_bytes = bsz * nz * 4
    k3_bytes = op_bytes + 3 * vec_bytes + bsz * 4
    k4_bytes = op_bytes + 3 * vec_bytes + bsz * (nz // ops.ROW_BLOCK) * 4
    return dict(
        route=route,
        transient_sweep=dict(
            shape=[bsz, nz, nz], n_steps=steps, ms=t_k3, plain_ms=t_k3p, library_ms=None,
            max_abs_err=e3, bytes=k3_bytes, flops=(steps + 1) * bsz * nz * (2 * nz + 2)),
        transient_step_batched=dict(
            shape=[bsz, nz, nz], ms=t_k4, device_ms=t_k4g, plain_ms=t_k4p,
            library_ms=t_k4l, max_abs_err=e4, bytes=k4_bytes,
            flops=bsz * nz * (2 * nz + 2)),
        per_step={"route": route, "k3_ms_per_step": t_k3 / steps, "k4_ms_per_step": t_k4,
                  "k4_device_ms_per_step": t_k4g,
                  "operator_bytes_per_system": nz * nz * 4},
    )


# The shape at which each kernel's row of the kernels line is timed: the
# main-path case that launches it.
MAIN_SHAPE = {
    "ell_sweep": ("ell", N_MATRIX_FREE),
    "ell_step": ("ell", N_MATRIX_FREE_LARGE),
    "transient_sweep": ("dense", N_DENSE_SMALL),
    "transient_step_batched": ("dense", N_DENSE),
}


def phase_kernels(dev) -> tuple[dict, dict]:
    """Both kernels of each pair at every operator shape the main path
    builds (ELL at n = 256, 1024, 2048; dense at n = 48, 256), plus the
    dense operators of DENSE_ROUTE_PROBES around the persistent dense
    route's limit.  Returns the per-shape results and the route each
    shape takes."""
    pairs: dict[tuple[str, int], dict] = {}
    for n in (N_DENSE, N_MATRIX_FREE, N_MATRIX_FREE_LARGE):
        pairs[("ell", n)] = ell_pair(n, dev, KERNEL_STEPS)
    for n in (N_DENSE_SMALL, N_DENSE, *DENSE_ROUTE_PROBES):
        pairs[("dense", n)] = dense_pair(n, dev, KERNEL_STEPS)
    return pairs, {key: p["route"] for key, p in pairs.items()}


# ---------------------------------------------------------------------------
# phase 3: the slice through the public entry points
# ---------------------------------------------------------------------------


def drive(fn, launches: dict) -> tuple[object, dict, dict, float]:
    """Run one main-path call with the launch counts reset just before and
    read just after; add them to ``launches``."""
    from repro_torch.kernels import ops

    timings: dict = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = fn(timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for name, v in counts.items():
        launches[name] = launches.get(name, 0) + v
    return result, counts, timings, wall


# the kernel each sweep_backend route launches
KERNEL_OF_ROUTE = {"ell": "ell_sweep", "ell-step": "ell_step",
                   "dense": "transient_sweep", "dense-step": "transient_step_batched"}


def phase_slice(dev, routes: dict) -> dict:
    """The main path through the public entry points.  Each case names the
    kernel it is there to drive; it fails unless sweep_backend routes its
    operator to that kernel and the kernel launched in that case's run."""
    from repro_torch import solve_batch
    from repro_torch.core import engine
    from repro_torch.core.network import build_proposed_batch

    launches: dict[str, int] = {}

    def check_route(label, form, n, counts, expect):
        chosen = KERNEL_OF_ROUTE[routes[(form, n)]]
        check(chosen == expect, f"{label}: sweep_backend chose {chosen}, not {expect}")
        check(counts[expect] > 0, f"{label}: {expect} was not launched")

    def solve_case(label, n, expect, matrix_free=False):
        a, x, b = systems(n, BATCH)
        kw = {"settle_matrix_free": True, "x_ref": x} if matrix_free else {}
        res, counts, timings, wall = drive(lambda t: solve_batch(
            a, b, method="analog_2n", compute_settling=True, settle_method="euler",
            settle_max_steps=MAX_STEPS, device=dev, timings=t, **kw), launches)
        check_route(label, "ell" if matrix_free else "dense", n, counts, expect)
        err = float(np.max(np.abs(res.x - x)) / np.max(np.abs(x)))
        steps = res.info["settle_steps"]
        settled = steps < MAX_STEPS
        check(err <= 1e-8, f"{label}: x vs x_ref relative {err}")
        check(bool(np.all(res.stable[settled])), f"{label}: settled but not stable")
        check(bool(np.all(np.isfinite(res.settle_time[settled]))), f"{label}: settle_time")
        emit(dict(
            phase="slice", case=label, n=n, batch=BATCH,
            kernels=[k for k, v in counts.items() if v], launches=counts,
            settle_steps=steps.tolist(), stable=res.stable.tolist(),
            x_rel_err=err, wall_s=wall, stage_s=timings,
        ))

    # (a) matrix-free at n = 1024, the size-sweep scale, and at n = 2048,
    # whose slots pass the persistent sweep's limit
    solve_case(f"matrix_free_n{N_MATRIX_FREE}", N_MATRIX_FREE, "ell_sweep",
               matrix_free=True)
    solve_case(f"matrix_free_n{N_MATRIX_FREE_LARGE}", N_MATRIX_FREE_LARGE, "ell_step",
               matrix_free=True)
    # (b) default settle against the DC fixed point on the dense operator
    solve_case(f"dense_n{N_DENSE}", N_DENSE, "transient_step_batched")
    # (c) a dense operator small enough for the persistent dense sweep
    solve_case(f"dense_n{N_DENSE_SMALL}", N_DENSE_SMALL, "transient_sweep")

    # (d) transient_batch on the ELL and the dense operator at N_DENSE.
    # The ELL run settles against x_ref, the dense one against the DC point
    # of the finite-gain amps, so their steps differ by where the band
    # sits (the reference gives the same pair); the kernels' own agreement
    # is checked on one reference point below.
    a, x, b = systems(N_DENSE, BATCH)
    nets = build_proposed_batch(a, b, device=dev)
    bss = engine.assemble_batch(nets, device=dev)
    x_dc = engine.dc_solve_batch(bss)[:, :N_DENSE]
    ell = engine.assemble_batch_ell(nets, device=dev)
    expect = {"ell": "ell_sweep", "dense": "transient_step_batched"}
    steps = {}
    for label, kw, ref in (("ell", {"x_ref": x}, x), ("dense", {}, x_dc)):
        res, counts, timings, wall = drive(lambda t: engine.transient_batch(
            nets, method="euler", max_steps=MAX_STEPS, device=dev, timings=t, **kw),
            launches)
        case = f"transient_batch_{label}_n{N_DENSE}"
        check_route(case, label, N_DENSE, counts, expect[label])
        settled = res.settle_steps < MAX_STEPS
        check(bool(np.all(res.stable[settled])), f"{case}: stable")
        band = np.maximum(0.01 * np.abs(ref), 1e-4)
        inside = np.all(np.abs(res.x_converged - ref) <= band, axis=1)
        check(bool(np.all(inside[settled])), f"{case}: x_converged off band")
        emit(dict(phase="slice", case=case,
                  launches=counts, settle_steps=res.settle_steps.tolist(),
                  stable=res.stable.tolist(), wall_s=wall, stage_s=timings))
    # one reference point, both operator forms: the two kernels add in
    # different orders, which may move a band crossing by one chunk (50)
    for label, op in (("ell", ell), ("dense", bss)):
        (st, _xf, _r, _dt), counts, _t, wall = drive(
            lambda t: engine.euler_settle_batch(op, x_dc, max_steps=MAX_STEPS,
                                                timings=t), launches)
        case = f"euler_settle_{label}_n{N_DENSE}_vs_dc_point"
        check_route(case, label, N_DENSE, counts, expect[label])
        steps[label] = st
        emit(dict(phase="slice", case=case,
                  launches=counts, settle_steps=st.tolist(), wall_s=wall))
    diff = np.abs(steps["ell"] - steps["dense"])
    check(bool(np.all(diff <= 50)), f"ELL vs dense settle_steps differ by {diff.tolist()}")

    for name, v in launches.items():
        check(v > 0, f"kernel {name} was not launched on the main path")
    emit(dict(phase="slice", case="launch_totals", launches=launches))
    return launches


def kernels_line(pairs: dict, launches: dict) -> list[dict]:
    """One row per kernel: timed at its main-path shape (MAIN_SHAPE), its
    error the largest over every shape, its launches from the main path."""
    replaces = {
        "ell_sweep": ("K1", "src/repro_torch/kernels/csrc/ell_transient.cu",
                      "src/repro/kernels/ell_transient.py:89"),
        "ell_step": ("K2", "src/repro_torch/kernels/csrc/ell_transient.cu",
                     "src/repro/kernels/ell_transient.py:153"),
        "transient_sweep": ("K3", "src/repro_torch/kernels/csrc/transient_step.cu",
                            "src/repro/kernels/transient_step.py:231"),
        "transient_step_batched": ("K4", "src/repro_torch/kernels/csrc/transient_step.cu",
                                   "src/repro/kernels/transient_step.py:163"),
    }
    rows = []
    for name, (tag, source, rep) in replaces.items():
        k = pairs[MAIN_SHAPE[name]][name]
        # the largest disagreement with the plain version over every shape
        err = max(p[name]["max_abs_err"] for p in pairs.values() if name in p)
        bound_ms, bound_by = bound(k["bytes"], k["flops"])
        rows.append(dict(
            name=f"{tag} {name}", route="cuda", source=source, replaces=rep,
            launches=launches[name], max_abs_err=err, ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=k["library_ms"], shape=k["shape"], device_ms=k.get("device_ms"),
        ))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    t0 = time.perf_counter()
    lib = build.load_library()
    build_s = time.perf_counter() - t0
    emit(dict(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              kernel_build_s=build_s, nvcc_build_s=lib.build_seconds))

    pairs, routes = phase_kernels(dev)
    emit(dict(phase="kernels_vs_plain",
              shapes={f"{form}_n{n}": {k: v for k, v in p.items() if k != "per_step"}
                      for (form, n), p in pairs.items()}))
    emit(dict(phase="route_times",
              per_step={f"{form}_n{n}": p["per_step"] for (form, n), p in pairs.items()}))
    launches = phase_slice(dev, routes)

    emit({"kernels": kernels_line(pairs, launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
