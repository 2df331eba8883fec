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
   persistent sweep against the loop of its row-tiled step (K1 bit for
   bit, in both dtypes); K1 and K3, one system per thread-block cluster,
   also bit for bit from launch to launch, with their cluster size,
   variant (slots or slab resident in shared memory, or streamed; both
   variants of each must run) and clusters per wave at every shape, and
   at the main shape a planted fault (the last rank's rows never
   broadcast) that the bar must reject by more than 1000x; K4, split over
   a cluster, also bit for bit from launch to launch, against its split
   order in plain PyTorch and at dt = 0 at every dense shape, and at the
   main shape its split within one wave and a planted fault (the last
   rank's columns left out) that its bar must reject; kernel (in a Python
   loop and in a CUDA graph), plain-version and library-call times, and
   the per-step times of both routes of each pair at each shape;
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
3b. settling — the options of ``solve_batch`` beyond the slice, through
   the public entry points: (1) the predicted form,
   ``settle_dt_policy="spectral"``, on the slice's four operators (K1 at
   n = 1024, K2 at n = 2048 matrix-free, K4 at dense n = 256, K3 at n =
   48), launch counts reset just before and read just after each, each
   failing unless its kernel launched in chunks of the length
   ``sweep_chunk_schedule`` gives the spectral pass's prediction (the
   launches and every settle step must fit those chunks), with the
   spectral and ``diag`` dt, predicted and measured settle steps and the
   spectral pass as a stage of ``timings``; (2) the estimator alone,
   ``settle_method="spectral"``, at n = 1024 and 2048 (every system
   stable; slow mode, residual and certificate printed); (3) the
   settling-accuracy guard (``repro_torch.settling_guard``: spectral slow
   mode within [0.5, 2]x exact eig, unstable systems flagged); (4) graded
   recovery at dense n = 256 (int8 pots under ``refine="ir"`` and
   ``"fcg"`` delivered analog or refined, int4 through its fallback,
   every delivered residual <= 1e-10); (5) the nonlinear RK4 transient at
   n = 24 and 48 with the last system negated (saturated exactly there,
   the others stable); (6) the spectral estimate, refinement and the RK4
   transient at n = 24 on the card against the CPU, within the CPU
   tests' bars;
4. kernel_api — the kernel API through the public wrappers, launch
   counts reset just before and read just after, failing unless K5, K6,
   K7a and K7b each launched: ``spd_transform_arrays`` (K7a + K7b) on a
   dense n = 4096 system, ``crosspoint_mvm`` (K6) on its (8192, 8192)
   crossbar from ``crosspoint_layout`` at the DC node voltages, with 64
   voltage vectors and in bf16, and 200 ``transient_step`` (K5) steps of
   one dense n = 1024 circuit (nz = 8192) from 16 start states, one step
   of it in bf16 and one on its step response alone, failing unless K7a
   took its 16-byte route, K6's b = 1 product its GEMV route, the b = 64
   float32 one its split-k route with 16-byte copies and the bf16 one its
   tensor-core route, and K5's 16-column steps its split-k route with
   16-byte copies and the one-column step its column route.  Then the
   transform against float64, each kernel against its plain version
   within a bar scaled to its largest output (K6 and K5 in bf16 element
   by element), K7a bit for bit against its order in plain PyTorch,
   planted faults that the bars must reject by more than 1000x (two for
   K6 in bf16; a cluster rank's share left out of K7a, K6 in float32, K4
   and K5), two launches of K7a, K6 float32, K4 and K5 bit for bit equal,
   the splits of K6, K4 and K5 within one wave of the card's clusters,
   K5's column 0 against 500 launches of K4, each kernel at ragged
   shapes (K5 on every route in both dtypes, K6 on every route, K7a on
   both routes, each also off the 16-byte grid), and the times of kernel,
   plain version and library call;
5. quickstart — the single-system flow of examples/quickstart.py at
   n = 24 on the card and on the CPU, which must agree;
6. serve — the language-model serving path.  K8 (flash attention)
   against its plain version, element by element, at the prefill shape
   of the path (bf16, B = 1, S = T = 2048, 32 query heads over 8 KV
   heads, D = 128, causal), a ragged S = 1000, MQA at G = 32 and 48, a
   window, non-causal cases and every head size in float32 and bf16 (p
   rounded or not), each through the route it must take (bf16 on the
   tensor cores, float32 on FMA); two planted faults that the same bar
   must reject; K8's times on each route beside
   ``scaled_dot_product_attention``'s; then ``ServeEngine`` on Qwen3-8B
   at full width and depth (36 layers, bf16, seeded random weights on
   the card) serving 6 requests of 256-2048 prompt tokens through 4
   slots, 16 greedy tokens each, failing unless K8 launched 36 times per
   prefill, all on its tensor-core route; then each prompt's prefill
   again, K8 held element by element
   against its plain version on every layer's own inputs, and the logits
   through K8 against the plain attention and against two planted faults
   (a key tile dropped for late rows, the GQA head order swapped), which
   the K8 bars and the logit bar must reject; and the SMOKE config
   (float32, K8's FMA route) on the card against the CPU;
7. the kernels line (K1-K8; K5, K6 and K8 one row per route, K4 with its
   split, K1 and K3 with their cluster layout, K7a with its route; K1-K4
   count the launches of the slice and of the settling phase's predicted
   form, ``launches_by_phase``), the
   nvidia-smi line, and the contract's last line.

It imports no JAX and nothing of the JAX package.  Without CUDA, or
outside a checkout (no ``src/repro_torch`` beside it), it exits with
code 2 before printing any result.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet), used for bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense, on the tensor cores
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


def finite(values) -> list:
    """A float array as a JSON list, non-finite entries as null."""
    return [float(v) if np.isfinite(v) else None for v in np.asarray(values, dtype=float)]


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


def bound(bytes_moved: float, flops: float,
          peak: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time of one call: its inputs read once and outputs written
    once at the HBM rate, or its flops at ``peak`` (the f32 peak unless
    the inputs are bf16), the larger.  A
    cold call brings its inputs from HBM; where the timing loop keeps
    them in L2 (the ELL operands, small dense ones) the bound is loose."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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
    in float32 and bfloat16, K1 bit for bit against ``steps`` K2 launches
    plus the dt=0 launch in both dtypes and against a second K1 launch, its
    cluster size, variant and clusters per wave, at the main shape a
    planted fault (the last rank's rows never broadcast); per-call times
    of both."""
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
    zkb, rkb = ek.ell_sweep(idx_t, w_bf, z0, c, n_steps=steps)
    zpb, _ = ek.ell_sweep_plain(idx_t, w_bf, z0, c, n_steps=steps)
    e1b, r1b = max_rel(zkb, zpb)
    check(r1 <= TOL_Z and rr1 <= TOL_RES, f"K1 n={n} vs plain: state {r1}, residual {rr1}")
    check(r1b <= TOL_BF16, f"K1 bf16 n={n} vs plain: state {r1b}")
    # K1 runs each system over a cluster; two launches give the same bits
    zk2, rk2 = ek.ell_sweep(idx_t, w_t, z0, c, n_steps=steps)
    zkb2, rkb2 = ek.ell_sweep(idx_t, w_bf, z0, c, n_steps=steps)
    check(torch.equal(zk, zk2) and torch.equal(rk, rk2)
          and torch.equal(zkb, zkb2) and torch.equal(rkb, rkb2),
          f"K1 n={n}: two launches differ")
    layout = {}
    for dtype, w in (("float32", w_t), ("bfloat16", w_bf)):
        isz = w.element_size()
        layout[dtype] = dict(ranks=ek.ell_sweep_ranks(nz, k, isz),
                             variant=ek.ell_sweep_variant(nz, k, isz),
                             clusters_per_wave=ek.ell_sweep_clusters_per_wave(nz, k, w.dtype))
        check(layout[dtype]["clusters_per_wave"] > 0, f"K1 n={n} {dtype}: no cluster fits")

    zs, rs = ek.ell_step(idx_t, w_t, z0, c)
    zsp, rsp = ek.ell_step_plain(idx_t, w_t, z0, c)
    e2, r2 = max_rel(zs, zsp)
    _, rr2 = max_rel(rs, rsp)
    zsb, _ = ek.ell_step(idx_t, w_bf, z0, c)
    zsbp, _ = ek.ell_step_plain(idx_t, w_bf, z0, c)
    e2b, r2b = max_rel(zsb, zsbp)
    check(r2 <= TOL_Z and rr2 <= TOL_RES, f"K2 n={n} vs plain: state {r2}, residual {rr2}")
    check(r2b <= TOL_BF16, f"K2 bf16 n={n} vs plain: state {r2b}")

    # K1 computes each row with K2's arithmetic: n K1 steps are n K2
    # launches, bit for bit, in both dtypes
    for label, w, zs1, rs1 in (("float32", w_t, zk, rk), ("bfloat16", w_bf, zkb, rkb)):
        zl = z0
        for _ in range(steps):
            zl, _ = ek.ell_step(idx_t, w, zl, c)
        _, rl = ek.ell_step(idx_t, w, zl, c, 0.0)
        check(torch.equal(zl, zs1) and torch.equal(rl.amax(dim=1), rs1[:, 0]),
              f"K1 vs K2 loop n={n} {label}: not bit for bit (state {max_rel(zl, zs1)}, "
              f"residual {max_rel(rl.amax(dim=1), rs1[:, 0])})")
    if n == MAIN_SHAPE["ell_sweep"][1]:
        # the bar rejects a sweep whose last rank's rows never reach its peers
        ranks = layout["float32"]["ranks"]
        layout["broadcast_dropped_of_bar"] = share_of_bar(sweep_broadcast_dropped(
            lambda z: z + ek.ell_dz_plain(idx_t, w_t, z, c), z0, steps, ranks), zp, TOL_Z)

    t_k1 = cuda_ms(lambda: ek.ell_sweep(idx_t, w_t, z0, c, n_steps=steps), 20)
    t_k1g = graph_ms(lambda: ek.ell_sweep(idx_t, w_t, z0, c, n_steps=steps), 10)
    # a launch with no step: the slots' copy, the residual pass, the launch
    t_k1g0 = graph_ms(lambda: ek.ell_sweep(idx_t, w_t, z0, c, n_steps=0), 20)
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
            shape=[bsz, k, nz], n_steps=steps, ms=t_k1, device_ms=t_k1g,
            device_ms_0_steps=t_k1g0, ms_bf16=t_k1b,
            plain_ms=t_k1p, library_ms=None, max_abs_err=e1, max_abs_err_bf16=e1b,
            bytes=k1_bytes, flops=(steps + 1) * bsz * nz * (2 * k + 2), layout=layout,
            equals_k2_loop=True),
        ell_step=dict(
            shape=[bsz, k, nz], ms=t_k2, device_ms=t_k2g, plain_ms=t_k2p,
            library_ms=t_k2l, max_abs_err=e2, max_abs_err_bf16=e2b,
            bytes=k2_bytes, flops=bsz * nz * (2 * k + 2)),
        per_step={"route": route, "k1_ms_per_step": t_k1 / steps,
                  "k1_device_ms_per_step": t_k1g / steps,
                  "k1_device_ms_per_step_past_launch": (t_k1g - t_k1g0) / steps,
                  "k2_ms_per_step": t_k2,
                  "k2_device_ms_per_step": t_k2g,
                  "operator_bytes_per_system": nz * k * 8},
    )


def sweep_broadcast_dropped(step, z0: torch.Tensor, steps: int, ranks: int) -> torch.Tensor:
    """A planted fault, in plain PyTorch: a persistent sweep over ``ranks``
    cluster ranks whose last rank never broadcasts its rows.  Its peers
    keep those rows at their start values, the last rank sees every row;
    each rank returns its own rows.  ``step(z)`` is one plain step of every
    row."""
    r0 = z0.shape[1] - z0.shape[1] // ranks
    peers, last = z0, z0
    for _ in range(steps):
        from_peers = step(peers)[:, :r0]
        own = step(last)[:, r0:]
        peers = torch.cat([from_peers, z0[:, r0:]], dim=1)
        last = torch.cat([from_peers, own], dim=1)
    return torch.cat([peers[:, :r0], last[:, r0:]], dim=1)


def dense_pair(n: int, dev, steps: int) -> dict:
    """K3 and K4 on the size-n dense operator: each against its plain
    version, K3 against ``steps`` K4 launches plus the dt=0 launch and
    against a second K3 launch, its cluster size, variant and clusters per
    wave, at the main shape a planted fault (the last rank's rows never
    broadcast); per-call times of both."""
    from repro_torch.kernels import ops
    sk = importlib.import_module("repro_torch.kernels.transient_step")

    bss, m, m_t, c = dense_operands(n, dev)
    route = ops.sweep_backend(bss.n_states, None)
    z0 = start_state(c)
    bsz, nz, _ = m.shape
    zk, rk = sk.transient_sweep(m_t, z0, c, n_steps=steps)
    zp, rp = sk.transient_sweep_plain(m_t, z0, c, n_steps=steps)
    e3, r3 = max_rel(zk, zp)
    _, rr3 = max_rel(rk, rp)
    check(r3 <= TOL_Z and rr3 <= TOL_RES, f"K3 n={n} vs plain: state {r3}, residual {rr3}")
    # K3 runs each system over a cluster; two launches give the same bits
    zk2, rk2 = sk.transient_sweep(m_t, z0, c, n_steps=steps)
    check(torch.equal(zk, zk2) and torch.equal(rk, rk2), f"K3 n={n}: two launches differ")
    layout = dict(ranks=sk.dense_sweep_ranks(nz), variant=sk.dense_sweep_variant(nz),
                  clusters_per_wave=sk.dense_sweep_clusters_per_wave(nz))
    check(layout["clusters_per_wave"] > 0, f"K3 n={n}: no cluster fits")
    if n == MAIN_SHAPE["transient_sweep"][1]:
        # the bar rejects a sweep whose last rank's rows never reach its peers
        layout["broadcast_dropped_of_bar"] = share_of_bar(sweep_broadcast_dropped(
            lambda z: z + (torch.einsum("bj,bji->bi", z, m_t) + c), z0, steps,
            layout["ranks"]), zp, TOL_Z)
    zs, rs = sk.transient_step_batched(m, z0, c)
    zsp, rsp = sk.transient_step_batched_plain(m, z0, c)
    e4, r4 = max_rel(zs, zsp)
    _, rr4 = max_rel(rs, rsp)
    check(r4 <= TOL_Z and rr4 <= TOL_RES, f"K4 n={n} vs plain: state {r4}, residual {rr4}")
    # K4 splits each row block's columns over a cluster: the same bits from
    # launch to launch, its order within the bar, and dt = 0 evaluates the
    # residual and leaves the state as it was
    zs2, rs2 = sk.transient_step_batched(m, z0, c)
    check(torch.equal(zs, zs2) and torch.equal(rs, rs2), f"K4 n={n}: two launches differ")
    zo, ro = sk.dense_step_in_kernel_order(m, z0, c)
    _, ro4 = max_rel(zo, zsp)
    check(ro4 <= TOL_Z, f"K4 n={n}: its split order in plain PyTorch vs plain {ro4}")
    zd, rd = sk.transient_step_batched(m, z0, c, 0.0)
    _, rd4 = max_rel(rd, rsp)
    check(torch.equal(zd, z0) and rd4 <= TOL_RES, f"K4 n={n} at dt = 0: residual {rd4}")
    split = dict(ranks=sk.dense_step_ranks(bsz, nz), order_vs_plain=ro4, dt0_residual=rd4)
    if n == N_DENSE:
        # at the main shape: the split fits one wave of the card's clusters,
        # and the bar rejects a step whose last rank's columns are left out
        ranks = split["ranks"]
        split["waves"] = dict(ranks=ranks, clusters=bsz * nz // ops.ROW_BLOCK,
                              per_wave={r: sk.dense_step_clusters_per_wave(r)
                                        for r in (1, 2, 4, 8)})
        check(split["waves"]["clusters"] <= split["waves"]["per_wave"][ranks],
              f"K4's split does not fit one wave: {split['waves']}")
        split["rank_dropped_of_bar"] = share_of_bar(k4_rank_dropped(m, z0, c), zsp, TOL_Z)
    # what the split buys: one step's device time at each cluster size the
    # kernel takes (R = 1 is one block per 128-row block), each held to
    # the bar first
    split["device_ms_by_ranks"] = {}
    for r in (1, 2, 4, 8):
        if r <= nz // sk.DENSE_STEP_CHUNK:
            zr, rr = k4_at_ranks(m, z0, c, r)
            check(max_rel(zr, zsp)[1] <= TOL_Z and max_rel(rr, rsp)[1] <= TOL_RES,
                  f"K4 n={n} at R = {r} vs plain")
            split["device_ms_by_ranks"][r] = graph_ms(lambda r=r: k4_at_ranks(m, z0, c, r), 100)
    zl = z0
    for _ in range(steps):
        zl, _ = sk.transient_step_batched(m, zl, c)
    _, rl = sk.transient_step_batched(m, zl, c, 0.0)
    _, x34 = max_rel(zl, zk)
    _, xr34 = max_rel(rl.amax(dim=1), rk[:, 0])
    check(x34 <= TOL_Z and xr34 <= TOL_RES, f"K3 vs K4 loop n={n}: {x34}, {xr34}")

    t_k3 = cuda_ms(lambda: sk.transient_sweep(m_t, z0, c, n_steps=steps), 10)
    t_k3g = graph_ms(lambda: sk.transient_sweep(m_t, z0, c, n_steps=steps), 10)
    # a launch with no step: the slab's copy, the residual pass, the launch
    t_k3g0 = graph_ms(lambda: sk.transient_sweep(m_t, z0, c, n_steps=0), 20)
    if n == MAIN_SHAPE["transient_sweep"][1]:
        # what more ranks buy: the resident sweep's device time at each
        # cluster size that fits, each held to the plain version's bar first
        layout["device_ms_by_ranks"] = {}
        for r in (4, 8, 16):
            if sk.dense_sweep_fits(nz, r):
                zr, rr = k3_at_ranks(m_t, z0, c, steps, r)
                check(max_rel(zr, zp)[1] <= TOL_Z and max_rel(rr, rp)[1] <= TOL_RES,
                      f"K3 n={n} at R = {r} vs plain")
                layout["device_ms_by_ranks"][r] = graph_ms(
                    lambda r=r: k3_at_ranks(m_t, z0, c, steps, r), 10)
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
            shape=[bsz, nz, nz], n_steps=steps, ms=t_k3, device_ms=t_k3g,
            device_ms_0_steps=t_k3g0, plain_ms=t_k3p,
            library_ms=None, max_abs_err=e3, bytes=k3_bytes,
            flops=(steps + 1) * bsz * nz * (2 * nz + 2), layout=layout),
        transient_step_batched=dict(
            shape=[bsz, nz, nz], ms=t_k4, device_ms=t_k4g, plain_ms=t_k4p,
            library_ms=t_k4l, max_abs_err=e4, bytes=k4_bytes,
            flops=bsz * nz * (2 * nz + 2), split=split),
        per_step={"route": route, "k3_ms_per_step": t_k3 / steps,
                  "k3_device_ms_per_step": t_k3g / steps,
                  "k3_device_ms_per_step_past_launch": (t_k3g - t_k3g0) / steps,
                  "k4_ms_per_step": t_k4,
                  "k4_device_ms_per_step": t_k4g,
                  "operator_bytes_per_system": nz * nz * 4},
    )


def k3_at_ranks(m_t: torch.Tensor, z: torch.Tensor, c: torch.Tensor, steps: int,
                ranks: int):
    """K3's resident sweep on ``ranks`` blocks a system, launched through
    the library's C entry (the wrapper takes dense_sweep_ranks' R) and not
    counted."""
    from repro_torch.kernels import build

    bsz, nz = z.shape
    out = torch.empty_like(z)
    res = torch.empty((bsz, 1), dtype=torch.float32, device=z.device)
    build.load_library().call("repro_dense_sweep", m_t.data_ptr(), z.data_ptr(), c.data_ptr(),
                              out.data_ptr(), res.data_ptr(), bsz, nz, steps, 1.0, ranks, 1,
                              build.current_stream(z.device))
    return out, res


def k4_at_ranks(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor, ranks: int):
    """K4's step with its columns split over ``ranks`` blocks of a cluster,
    launched through the library's C entry (the wrapper takes
    dense_step_ranks' R) and not counted."""
    from repro_torch.kernels import build

    bsz, nz = z.shape
    out = torch.empty_like(z)
    res = torch.empty((bsz, nz // 128), dtype=torch.float32, device=z.device)
    build.load_library().call("repro_dense_step", m.data_ptr(), z.data_ptr(), c.data_ptr(),
                              out.data_ptr(), res.data_ptr(), bsz, nz, ranks, 1.0,
                              build.current_stream(z.device))
    return out, res


def k4_rank_dropped(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """A planted fault: K4's step with the last cluster rank's column
    partial left out, in plain PyTorch around the kernel."""
    sk = importlib.import_module("repro_torch.kernels.transient_step")
    bsz, nz = z.shape
    c0, c1 = sk.dense_step_column_ranges(nz, sk.dense_step_ranks(bsz, nz))[-1]
    out, _ = sk.transient_step_batched(m, z, c)
    return out - torch.einsum("bij,bj->bi", m[:, :, c0:c1], z[:, c0:c1])


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
    route's limit; fails unless K1 and K3 each ran both variants and the
    planted lost-broadcast faults fail their bars by more than 1000x.
    Returns the per-shape results and the route each shape takes."""
    from repro_torch.kernels import ops

    pairs: dict[tuple[str, int], dict] = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for n in (N_DENSE, N_MATRIX_FREE, N_MATRIX_FREE_LARGE):
        pairs[("ell", n)] = ell_pair(n, dev, KERNEL_STEPS)
    for n in (N_DENSE_SMALL, N_DENSE, *DENSE_ROUTE_PROBES):
        pairs[("dense", n)] = dense_pair(n, dev, KERNEL_STEPS)
    by_variant = ops.launch_counts_by_variant()
    for name, counts in by_variant.items():
        for variant, launched in counts.items():
            check(launched > 0, f"{name}: the {variant} variant was not launched")
    planted = {name: pairs[MAIN_SHAPE[name]][name]["layout"]["broadcast_dropped_of_bar"]
               for name in ("ell_sweep", "transient_sweep")}
    for name, share in planted.items():
        check(share > 1000, f"{name}: the bar passes a lost broadcast, or fails it by 1000x "
                            f"or less: {share} of it")
    emit(dict(phase="kernels", case="sweep_variants", launches_by_variant=by_variant,
              broadcast_dropped_of_bar=planted))
    return pairs, {key: p["route"] for key, p in pairs.items()}


# ---------------------------------------------------------------------------
# phase 3: the slice through the public entry points
# ---------------------------------------------------------------------------


def drive(fn, launches: dict) -> tuple[object, dict, dict, float]:
    """Run one main-path call with the launch counts reset just before and
    read just after; add them to ``launches``, and the persistent sweeps'
    by variant to ``launches["by_variant"]``."""
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
    by_variant = launches.setdefault("by_variant", {})
    for name, per in ops.launch_counts_by_variant().items():
        for variant, v in per.items():
            by_variant.setdefault(name, {}).setdefault(variant, 0)
            by_variant[name][variant] += v
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

    for name in KERNEL_OF_ROUTE.values():
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    emit(dict(phase="slice", case="launch_totals", launches=launches))
    return launches


# ---------------------------------------------------------------------------
# phase 3b: settling — spectral settling, refinement and the nonlinear
# transient through the public entry points
# ---------------------------------------------------------------------------

N_NONLINEAR = (24, 48)     # dense RK4: four (B, nz, nz) products a step
N_REFINE = N_DENSE         # dense n = 256: each inner pass re-stamps on the host
N_CROSS = 24               # card against CPU
# the parity bars of tests/test_torch_{spectral,refine,transient_nl}.py
TOL_DT, TOL_SLOW, TOL_REFINE_X, TOL_NL_X = 1e-9, 1e-6, 1e-8, 1e-9


def embed(x: np.ndarray, n_states: int) -> np.ndarray:
    """euler_settle_batch's node-block embedding: x on the nodes, -x on
    their mirrors (the 2n design), amp and buffer states 0."""
    z = np.zeros((x.shape[0], n_states))
    z[:, : x.shape[1]] = x
    z[:, x.shape[1]: 2 * x.shape[1]] = -x
    return z


def expected_chunk(bss, x_target: np.ndarray) -> tuple[object, np.ndarray, int]:
    """The spectral pass transient_batch(dt_policy="spectral") runs, on the
    same operator, and the chunk sweep_chunk_schedule gives its
    amplitude-aware prediction: ``(bounds, predicted steps, chunk)``."""
    from repro_torch.core import spectral
    from repro_torch.kernels import ops

    sb = spectral.spectral_bounds(bss, rtol=0.01)
    predicted = spectral.amplitude_settle_steps(
        sb, -embed(x_target, bss.n_states), rtol=0.01,
        x_scale=np.max(np.abs(x_target), axis=1))
    return sb, predicted, ops.sweep_chunk_schedule(predicted, MAX_STEPS)


def check_chunked(label: str, kernel: str, launches: int, steps: np.ndarray,
                  chunk: int) -> None:
    """The sweep ran in chunks of ``chunk``: every settle step a multiple
    of it (or the budget), and the kernel's launches those of
    ceil(max(steps) / chunk) chunks (K1, K3: one launch a chunk; K2, K4:
    one a step and a dt = 0 launch a chunk)."""
    taken = int(steps.max())
    chunks = -(-taken // chunk)
    want = chunks if kernel in ("ell_sweep", "transient_sweep") else taken + chunks
    check(launches == want, f"{label}: {kernel} launched {launches} times, not the "
                            f"{want} of {chunks} chunks of {chunk} over {taken} steps")
    check(bool(np.all((steps % chunk == 0) | (steps == MAX_STEPS))),
          f"{label}: settle steps {steps.tolist()} off the {chunk}-step chunks")


def phase_settling(dev, routes: dict) -> dict:
    """The options of solve_batch beyond the slice: the predicted-form
    euler sweep, the spectral estimator, the settling-accuracy guard,
    graded recovery, the nonlinear transient, and card against CPU.
    Returns the K1-K4 launches of the predicted-form cases."""
    from repro_torch import settling_guard, solve_batch
    from repro_torch.core import engine, spectral, transient_nl
    from repro_torch.core.network import build_proposed_batch
    from repro_torch.core.operating_point import NonIdealities

    launches: dict[str, int] = {}
    ell_bounds = {}

    # (1) predicted-form euler: the spectral pass's dt and chunk, then the
    # sweep, on the slice's own systems and kernels
    for label, n, kernel, matrix_free in (
            (f"predicted_matrix_free_n{N_MATRIX_FREE}", N_MATRIX_FREE, "ell_sweep", True),
            (f"predicted_matrix_free_n{N_MATRIX_FREE_LARGE}", N_MATRIX_FREE_LARGE,
             "ell_step", True),
            (f"predicted_dense_n{N_DENSE}", N_DENSE, "transient_step_batched", False),
            (f"predicted_dense_n{N_DENSE_SMALL}", N_DENSE_SMALL, "transient_sweep", False)):
        a, x, b = systems(n, BATCH)
        nets = build_proposed_batch(a, b, device=dev)
        if matrix_free:
            bss = engine.assemble_batch_ell(nets, device=dev)
            x_target = x
        else:
            bss = engine.assemble_batch(nets, device=dev)
            x_target = engine.dc_solve_batch(bss)[:, :n]
        t0 = time.perf_counter()
        sb, predicted, chunk = expected_chunk(bss, x_target)
        torch.cuda.synchronize()
        spectral_s = time.perf_counter() - t0
        dt_diag = engine._settle_dt(bss, 0.5, "diag")
        if matrix_free:
            ell_bounds[n] = sb
        del bss
        kw = {"settle_matrix_free": True, "x_ref": x} if matrix_free else {}
        res, counts, timings, wall = drive(lambda t: solve_batch(
            a, b, method="analog_2n", compute_settling=True, settle_method="euler",
            settle_dt_policy="spectral", settle_max_steps=MAX_STEPS, device=dev,
            timings=t, **kw), launches)
        form = "ell" if matrix_free else "dense"
        chosen = KERNEL_OF_ROUTE[routes[(form, n)]]
        check(chosen == kernel, f"{label}: sweep_backend chose {chosen}, not {kernel}")
        check(counts[kernel] > 0, f"{label}: {kernel} was not launched")
        steps = res.info["settle_steps"]
        check_chunked(label, kernel, counts[kernel], steps, chunk)
        settled = steps < MAX_STEPS
        err = float(np.max(np.abs(res.x - x)) / np.max(np.abs(x)))
        check(err <= 1e-8, f"{label}: x vs x_ref relative {err}")
        check(bool(np.all(res.stable[settled])), f"{label}: settled but not stable")
        check("spectral" in timings, f"{label}: no spectral stage in timings")
        dt = 0.5 * sb.dt_limit
        measured_s = np.where(settled, steps * dt, np.nan)
        emit(dict(
            phase="settling", case=label, n=n, batch=BATCH, kernel=kernel, chunk=chunk,
            launches=counts, settle_steps=steps.tolist(), stable=res.stable.tolist(),
            predicted_steps=finite(predicted), blind_predicted_steps=finite(sb.settle_steps),
            dt_spectral=dt.tolist(), dt_diag=dt_diag.tolist(),
            dt_spectral_over_diag=(dt / dt_diag).tolist(),
            predicted_over_measured=finite(predicted * dt / measured_s),
            slow_residual=finite(sb.slow_residual), certified=sb.certified.tolist(),
            x_rel_err=err, wall_s=wall, stage_s=timings, spectral_alone_s=spectral_s,
        ))

    # (2) the estimator alone: settle_method="spectral" (its spectral pass
    # is case (1)'s on the same ELL operator, whose residuals it prints)
    for n in (N_MATRIX_FREE, N_MATRIX_FREE_LARGE):
        a, x, b = systems(n, BATCH)
        timings: dict = {}
        t0 = time.perf_counter()
        res = solve_batch(a, b, method="analog_2n", compute_settling=True,
                          settle_method="spectral", x_ref=x, device=dev, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(bool(np.all(res.stable)), f"spectral n={n}: not every system stable")
        check(res.info["settle_method"] == "spectral", f"spectral n={n}: method")
        # the operator is assembled anew (float64 atomics on the card), so
        # the two passes may differ in the last bits: printed, not held
        sb = ell_bounds[n]
        emit(dict(phase="settling", case=f"spectral_n{n}", n=n,
                  slow_re=res.info["max_re_eig"].tolist(),
                  certified=res.info["settle_certified"].tolist(),
                  case1_slow_residual=finite(sb.slow_residual),
                  case1_certified=sb.certified.tolist(),
                  case1_settle_steps=finite(sb.settle_steps),
                  settle_steps=finite(res.info["settle_steps"]),
                  settle_time=finite(res.settle_time), wall_s=wall, stage_s=timings))

    # (3) the settling-accuracy guard
    t0 = time.perf_counter()
    failures, rows = settling_guard.settling_accuracy(device=dev)
    emit(dict(phase="settling", case="guard", failures=failures, rows=rows,
              wall_s=time.perf_counter() - t0))
    check(not failures, f"settling guard: {failures}")

    # (4) graded recovery at dense n = 256
    a, x, b = systems(N_REFINE, BATCH)
    for label, ni, refine in (
            ("int8_ir", NonIdealities(pot_bits=8, pot_tol=0.01, seed=1), "ir"),
            ("int8_fcg", NonIdealities(pot_bits=8, pot_tol=0.01, seed=1), "fcg"),
            ("int4_default", NonIdealities(pot_bits=4, pot_tol=0.05, seed=2), True)):
        timings = {}
        t0 = time.perf_counter()
        res = solve_batch(a, b, nonideal=ni, refine=refine, device=dev, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path = res.info["precision_path"]
        emit(dict(phase="settling", case=f"refine_{label}_n{N_REFINE}",
                  precision_path=path.tolist(), refine_iters=res.info["refine_iters"].tolist(),
                  residual=finite(res.info["residual"]), fallback=res.info["fallback"].tolist(),
                  wall_s=wall, stage_s=timings))
        delivered = path != "unrefined"
        check(bool(np.all(res.info["residual"][delivered] <= 1e-10)),
              f"refine {label}: a delivered residual above tol")
        if label.startswith("int8"):
            check(set(path.tolist()) <= {"analog", "refined"},
                  f"refine {label}: paths {path.tolist()}")
        else:
            check("fallback" in set(path.tolist())
                  and np.array_equal(res.info["fallback"] != "", path == "fallback"),
                  f"refine {label}: paths {path.tolist()}, fallback "
                  f"{res.info['fallback'].tolist()}")

    # (5) the nonlinear transient, the last system negated (Fig. 8)
    nl_rows = {}
    for n in N_NONLINEAR:
        a, x, b = systems(n, BATCH)
        a[-1], b[-1] = -a[-1], -b[-1]
        nets = build_proposed_batch(a, b, device=dev)
        t0 = time.perf_counter()
        tr = transient_nl.nonlinear_transient_batch(nets, device=dev)
        wall = time.perf_counter() - t0
        timings = {}
        t0 = time.perf_counter()
        res = solve_batch(a, b, compute_settling=True, settle_method="nonlinear",
                          fallback="none", device=dev, timings=timings)
        solve_wall = time.perf_counter() - t0
        rk4_steps = int(round(tr.times[-1] / tr.dt))
        emit(dict(phase="settling", case=f"nonlinear_n{n}", n=n, rk4_steps=rk4_steps,
                  dt=tr.dt, saturated=tr.saturated.tolist(), stable=res.stable.tolist(),
                  settle_time=finite(res.settle_time), wall_s=wall,
                  solve_batch_wall_s=solve_wall, stage_s=timings))
        want = [False] * (BATCH - 1) + [True]
        check(tr.saturated.tolist() == want, f"nonlinear n={n}: saturated {tr.saturated}")
        check(bool(np.all(res.stable[:-1])) and not res.stable[-1],
              f"nonlinear n={n}: stable {res.stable}")
        nl_rows[n] = (a, b, tr)

    # (6) card against CPU at n = 24, within the CPU tests' bars
    a, x, b = systems(N_CROSS, BATCH)
    got, want = {}, {}
    # one CPU thread: the CPU runs are the plain reference, not timed
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for out, d in ((got, dev), (want, "cpu")):
        nets = build_proposed_batch(a, b, device=d)
        out["sb"] = spectral.spectral_bounds(engine.assemble_batch_ell(nets, device=d))
        out["refine"] = solve_batch(a, b, nonideal=NonIdealities(pot_bits=8, pot_tol=0.01,
                                                                 seed=1),
                                    refine=True, device=d)
    na, nb, tr_card = nl_rows[N_CROSS]
    want["nl"] = transient_nl.nonlinear_transient_batch(
        build_proposed_batch(na, nb, device="cpu"), device="cpu")
    torch.set_num_threads(threads)
    gs, ws = got["sb"], want["sb"]
    errs = dict(
        dt=float(np.max(np.abs(gs.dt / ws.dt - 1))),
        slow_re=float(np.max(np.abs(gs.slow_re / ws.slow_re - 1))),
        refine_x=float(np.max(np.abs(got["refine"].x - want["refine"].x))
                       / np.max(np.abs(want["refine"].x))),
        nl_x=float(np.max(np.abs(tr_card.x - want["nl"].x)) / np.max(np.abs(want["nl"].x))),
        nl_times=float(np.max(np.abs(tr_card.times / want["nl"].times - 1))),
    )
    emit(dict(phase="settling", case=f"cuda_vs_cpu_n{N_CROSS}", errors=errs,
              certified=[gs.certified.tolist(), ws.certified.tolist()],
              slow_residual=[finite(gs.slow_residual), finite(ws.slow_residual)],
              settle_steps=[finite(gs.settle_steps), finite(ws.settle_steps)],
              precision_path=[got["refine"].info["precision_path"].tolist(),
                              want["refine"].info["precision_path"].tolist()],
              refine_iters=[got["refine"].info["refine_iters"].tolist(),
                            want["refine"].info["refine_iters"].tolist()]))
    check(errs["dt"] <= TOL_DT and errs["slow_re"] <= TOL_SLOW, f"spectral cuda vs cpu {errs}")
    check(np.array_equal(gs.certified, ws.certified) and np.array_equal(gs.stable, ws.stable)
          and np.array_equal(gs.settle_steps, ws.settle_steps),
          "spectral cuda vs cpu: certified, stable or settle_steps differ")
    for key in ("precision_path", "refine_iters", "fallback"):
        check(np.array_equal(got["refine"].info[key], want["refine"].info[key]),
              f"refine cuda vs cpu: {key}")
    check(errs["refine_x"] <= TOL_REFINE_X, f"refine cuda vs cpu: x {errs['refine_x']}")
    check(errs["nl_x"] <= TOL_NL_X and errs["nl_times"] <= 1e-12
          and np.array_equal(tr_card.saturated, want["nl"].saturated),
          f"nonlinear cuda vs cpu: {errs}")

    for kernel in KERNEL_OF_ROUTE.values():
        check(launches.get(kernel, 0) > 0, f"settling: {kernel} was not launched")
    emit(dict(phase="settling", case="launch_totals", launches=launches))
    return launches


# ---------------------------------------------------------------------------
# phase 4: the kernel API (K5, K6, K7a, K7b) and the single-circuit modules
# ---------------------------------------------------------------------------

N_TRANSFORM = 4096        # K7a/K7b: one dense system; K6: its 8192-node crossbar
N_CIRCUIT = 1024          # K5: one dense circuit, nz = 8192
K5_COLUMNS = 16           # the zero state and 15 random start states
K5_STEPS = 200
K5_VS_K4_STEPS = 500
K6_BATCH = 64
RAGGED_TRANSFORM = 4000
# K6 at ragged shapes, (m, k, nb) and the route each takes in bf16 and in
# float32 (crosspoint_mvm_route): the GEMV, the tensor-core product (bf16)
# or the split-k FFMA product (float32) with 16-byte asynchronous copies
# and m/k tails, and their masked-load variants (k or nb off the 8- or
# 4-element grid).
RAGGED_MVM = (((300, 513, 1), "fma", "fma"), ((300, 513, 5), "mma_scalar", "f32_scalar"),
              ((257, 130, 64), "mma_scalar", "f32_scalar"),
              ((1000, 1048, 24), "mma_async", "f32_async"),
              ((300, 520, 64), "mma_async", "f32_async"),
              ((300, 520, 68), "mma_scalar", "f32_async"),
              ((300, 516, 64), "mma_scalar", "f32_async"))
# K7a at ragged shapes, (rows, cols), dtype and route (colabs_route):
# columns off the 4- or 8-column grid, a strip's columns past the end,
# fewer rows than a cluster's 8 blocks
RAGGED_COLABS = (((4000, 4004), torch.bfloat16, "scalar"),
                 ((4000, 4004), torch.float32, "vec16"),
                 ((1000, 513), torch.float32, "scalar"),
                 ((3, 4096), torch.float32, "vec16"),
                 ((4000, 4000), torch.bfloat16, "vec16"))
# K5 at ragged shapes, (n, nb) and the route each takes in float32 and in
# bf16 (transient_step_route): the column and wide tiles, and the narrow
# split-k product with 16-byte copies and its masked-load variant (n or nb
# off the 4- or 8-element grid)
RAGGED_STEP = (((137, 1), "column", "column"), ((137, 17), "wide", "wide"),
               ((130, 33), "wide", "wide"), ((137, 5), "narrow_scalar", "narrow_scalar"),
               ((8190, 16), "narrow_scalar", "narrow_scalar"),
               ((8190, 2), "narrow_scalar", "narrow_scalar"),
               ((8192, 2), "narrow_scalar", "narrow_scalar"),
               ((8192, 5), "narrow_scalar", "narrow_scalar"),
               ((1000, 16), "narrow_async", "narrow_async"),
               ((4096, 8), "narrow_async", "narrow_async"),
               ((4096, 12), "narrow_async", "narrow_scalar"))
# the reference's kernel-test bars (tests/test_kernels.py:19-23, :84-99),
# each scaled to the largest output as the CPU parity tests scale theirs:
# crossbar products 5e-5 in float32 (k <= 8192 sums in another order); the
# fused transform within 1e-5 max|K_A| of the float64 one.  K5 after 200
# and 500 steps: 1e-5 of max|z| (TOL_Z, the sweeps' bar).
TOL_MVM_F32, TOL_TRANSFORM = 5e-5, 1e-5
# bf16 crossbar products element by element: |got - want| <= 1e-2 |want| +
# 1e-3 max|want|.  Kernel and plain version round float32 sums taken in
# other orders to bf16, so a sound pair lies at most one bf16 ulp apart,
# 2^-7 |want|; the atol is scaled to the output, because currents are
# ~1e-4 A, and covers outputs near zero.  A bar of 2e-2 max|want| would
# pass a 64-deep k-step left out (an error of ~sqrt(64/8192) = 9 % of a
# typical output); the planted faults below (K6_FAULTS) show this one
# does not.
MVM_BF16_RTOL, MVM_BF16_ATOL_OF_MAX = 1e-2, 1e-3
API_KERNELS = ("transient_step", "crosspoint_mvm", "colabs", "assemble")
# the routes the counted kernel-API run must take: K6's b = 1 product the
# GEMV, its b = 64 float32 one the split-k product with 16-byte copies, its
# bf16 one the tensor cores with 16-byte copies; K7a its 16-byte loads; K5's
# 200 float32 steps and its bf16 step on 16 columns the split-k product with
# 16-byte copies, its step on one column the column tile
API_ROUTES = {"crosspoint_mvm": dict(mma_async=1, mma_scalar=0, f32_async=1, f32_scalar=0,
                                     fma=1),
              "colabs": dict(vec16=1, scalar=0),
              "transient_step": dict(narrow_async=K5_STEPS + 1, narrow_scalar=0, column=1,
                                     wide=0)}
# K5's launches of that run by dtype and route: the 200 float32 steps and
# the bf16 step share the narrow route's name
API_K5_BY_DTYPE = {"float32": dict(narrow_async=K5_STEPS, narrow_scalar=0, column=1, wide=0),
                   "bfloat16": dict(narrow_async=1, narrow_scalar=0, column=0, wide=0)}
# a planted K6 fault leaves out this many k (one 64-deep step) from the
# rows past m / 2
K6_FAULT_KSTEP = 64


def hold(errs: dict, key: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    """Fail unless max |got - want| <= tol * max |want|.  The bar scales
    with the output: a crossbar's currents are ~1e-4 A, so a bar absolute
    in amperes would pass a kernel that returned zeros.  Keeps under
    ``key`` the largest error and the largest share of its bar."""
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    bar = tol * float(want.abs().max())
    check(err <= bar, f"{key}: max err {err} past {tol} x max|want| = {bar}")
    old = errs.get(key, dict(max_abs_err=0.0, of_bar=0.0))
    errs[key] = dict(max_abs_err=max(old["max_abs_err"], err),
                     of_bar=max(old["of_bar"], err / bar if bar else 0.0))


def hold_mvm_bf16(errs: dict, key: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Fail unless every |got - want| <= 1e-2 |want| + 1e-3 max|want|
    (a bf16 crossbar product, element by element)."""
    atol = MVM_BF16_ATOL_OF_MAX * float(want.double().abs().max())
    hold_close(errs, key, got, want, MVM_BF16_RTOL, atol)


def k6_kstep_dropped(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A planted fault: K6 that leaves the first 64-deep k-step out of the
    rows past m / 2."""
    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    out = mvm.crosspoint_mvm(g, v)
    half = g.shape[0] // 2
    out[half:] = mvm.crosspoint_mvm(g[half:, K6_FAULT_KSTEP:].contiguous(),
                                    v[K6_FAULT_KSTEP:].contiguous())
    return out


def k6_column_tile_dropped(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A planted fault: K6 that drops V's last column tile (the 8 columns
    of one tensor-core product), whose outputs stay zero."""
    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    nb = v.shape[1]
    out = torch.zeros((g.shape[0], nb), dtype=v.dtype, device=v.device)
    out[:, :nb - 8] = mvm.crosspoint_mvm(g, v[:, :nb - 8].contiguous())
    return out


K6_FAULTS = {"kstep_dropped_late_rows": k6_kstep_dropped,
             "last_column_tile_dropped": k6_column_tile_dropped}


def k7a_rank_dropped(a: torch.Tensor) -> torch.Tensor:
    """A planted fault: K7a that leaves the last cluster rank's rows out of
    the second column strip (columns 128-255)."""
    from repro_torch.kernels import spd_transform as tr

    rows = a.shape[0]
    ranks = tr.colabs_ranks(rows)
    chunk = -(-rows // ranks)
    out = tr.colabs(a)
    out[128:256] = tr.colabs(a[:chunk * (ranks - 1), 128:256].contiguous())
    return out


def k6_f32_partial_dropped(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A planted fault: K6's float32 split-k product that leaves the last
    cluster rank's k partial out."""
    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    (m, k), nb = g.shape, v.shape[1]
    k0, _ = mvm.k_ranges(k, mvm.crosspoint_mvm_split(m, k, nb))[-1]
    return mvm.crosspoint_mvm(g[:, :k0].contiguous(), v[:k0].contiguous())


def share_of_bar(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max |got - want| over the bar tol max |want| (above 1 fails)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / (tol * float(want.abs().max()))


def api_operands(dev) -> dict:
    """The main-path operands: a dense n = 4096 system (K7), its crossbar
    G (K6, from crosspoint_layout), one dense n = 1024 circuit's
    dt-folded state space (K5), all from numpy seeds."""
    from repro_torch.core import engine
    from repro_torch.core import transform as T
    from repro_torch.core.crosspoint import crosspoint_layout
    from repro_torch.core.network import build_proposed
    from repro_torch.core.transient import assemble_state_space
    from repro_torch.data.spd import random_rhs_from_solution, random_spd

    f32 = torch.float32
    rng = np.random.default_rng(7)
    a = random_spd(rng, N_TRANSFORM)
    x, b = random_rhs_from_solution(rng, a)
    tr64 = T.transform_2n(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev))
    g = crosspoint_layout(tr64).g_array.to(f32).contiguous()
    y = torch.as_tensor(np.concatenate([x, -x]), dtype=f32, device=dev)
    v = torch.as_tensor(np.random.default_rng(8).uniform(-0.5, 0.5, (g.shape[1], K6_BATCH)),
                        dtype=f32, device=dev)

    rng = np.random.default_rng(7)
    ac = random_spd(rng, N_CIRCUIT)
    _xc, bc = random_rhs_from_solution(rng, ac)
    ss = assemble_state_space(build_proposed(ac, bc, device=dev), device=dev)
    dt = float(engine._settle_dt(SimpleNamespace(m=ss.m[None]), 0.5, "diag")[0])
    nz = ss.n_states
    m = (ss.m * dt).to(f32).contiguous()
    c = (ss.c * dt).to(f32)[:, None].expand(nz, K5_COLUMNS).contiguous()
    z0 = np.random.default_rng(9).uniform(-0.5, 0.5, (nz, K5_COLUMNS))
    z0[:, 0] = 0.0                       # the paper's step response
    z = torch.as_tensor(z0, dtype=f32, device=dev)
    return dict(a=torch.as_tensor(a, dtype=f32, device=dev),
                b=torch.as_tensor(b, dtype=f32, device=dev), tr64=tr64,
                g=g, g_bf=g.bfloat16(), y=y, v=v, v_bf=v.bfloat16(), m=m, c=c, z=z,
                m_bf=m.bfloat16(), c_bf=c.bfloat16(), z_bf=z.bfloat16(),
                z_col=z[:, 0].contiguous(), c_col=c[:, 0].contiguous(), nz=nz, dt=dt)


def drive_api(op: dict) -> tuple[dict, dict, float]:
    """The kernel API's main path, once, with the launch counts reset just
    before and read just after: the fused transform, the crossbar at its
    DC voltages, with 64 voltage vectors and in bf16, 200 steps of one
    circuit from 16 start states, and one step of it in bf16 and one of
    its step response alone (one column)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = dict(transform=ops.spd_transform_arrays(op["a"], op["b"]),
               i_dc=ops.crosspoint_mvm(op["g"], op["y"]),
               i_v=ops.crosspoint_mvm(op["g"], op["v"]),
               i_bf=ops.crosspoint_mvm(op["g_bf"], op["v_bf"]))
    z = op["z"]
    for _ in range(K5_STEPS):
        z = ops.transient_step(op["m"], z, op["c"], 1.0)
    out["z"] = z
    out["z_bf"] = ops.transient_step(op["m_bf"], op["z_bf"], op["c_bf"], 1.0)
    out["z_b1"] = ops.transient_step(op["m"], op["z_col"], op["c_col"], 1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_route = ops.launch_counts_by_route()
    for name in API_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the kernel-API path")
    for name, want in API_ROUTES.items():
        check(by_route[name] == want, f"{name} routes on the kernel-API path: {by_route[name]}")
        counts[f"{name}_by_route"] = by_route[name]
    counts["transient_step_by_dtype"] = ops.launch_counts_by_dtype()
    check(counts["transient_step_by_dtype"] == API_K5_BY_DTYPE,
          f"K5 by dtype on the kernel-API path: {counts['transient_step_by_dtype']}")
    return out, counts, wall


def ragged_checks(dev) -> dict:
    """Each kernel at ragged shapes against its plain version: K5 in both
    dtypes on every route (RAGGED_STEP: n off the tile, nb = 1, 2, 5, 8,
    12, 16, > 16) and off the 16-byte grid, K6 in both dtypes once or more
    per route (RAGGED_MVM) and off the 16-byte grid, K7a on both routes
    (RAGGED_COLABS) and off the grid, bit for bit against its order in
    plain PyTorch; each checked for the route it took."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import spd_transform as tr

    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    st = importlib.import_module("repro_torch.kernels.transient_step")
    rng = np.random.default_rng(10)

    def t(shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape), device=dev).to(dtype)

    errs: dict = {}
    n = RAGGED_TRANSFORM
    a = t((n, n)) * 1e-4
    b = t(n) * 1e-4
    ka, kb, d, ks = ops.spd_transform_arrays(a, b)
    hold(errs, "colabs", tr.colabs(a), tr.colabs_plain(a), 1e-5)
    pa, pb = tr.assemble_plain(a, d, ks)
    hold(errs, "assemble", ka, pa, 0.0)
    hold(errs, "assemble", kb, pb, 0.0)

    def routed(kernel, route, what, fn):
        before = ops.launch_counts_by_route()[kernel][route]
        got = fn()
        check(ops.launch_counts_by_route()[kernel][route] == before + 1,
              f"{what} did not take the {route} route")
        return got

    def held_colabs(x, route, what):
        got = routed("colabs", route, what, lambda: tr.colabs(x))
        check(torch.equal(got, tr.colabs_in_kernel_order(x)),
              f"{what}: not bit for bit its order in plain PyTorch")
        hold(errs, "colabs", got, tr.colabs_plain(x), 1e-5)

    for shape, dtype, route in RAGGED_COLABS:
        held_colabs(t(shape, dtype), route, f"K7a {shape} {dtype}")
    for dtype in (torch.float32, torch.bfloat16):     # a view off the 16-byte grid
        held_colabs(t(700 * 256 + 1, dtype)[1:].view(700, 256), "scalar",
                    f"K7a unaligned {dtype}")
    for (m_, k_, nb), route_bf16, route_f32 in RAGGED_MVM:
        g, v = t((m_, k_)), t((k_, nb))
        hold(errs, "crosspoint_mvm",
             routed("crosspoint_mvm", route_f32, f"K6 f32 {(m_, k_, nb)}",
                    lambda: mvm.crosspoint_mvm(g, v)),
             mvm.crosspoint_mvm_plain(g, v), TOL_MVM_F32)
        gb, vb = g.bfloat16(), v.bfloat16()
        hold_mvm_bf16(errs, "crosspoint_mvm_bf16",
                      routed("crosspoint_mvm", route_bf16, f"K6 bf16 {(m_, k_, nb)}",
                             lambda: mvm.crosspoint_mvm(gb, vb)),
                      mvm.crosspoint_mvm_plain(gb, vb))
    g = t(300 * 1024 + 1)[1:].view(300, 1024)          # a float32 view off the grid
    v = t((1024, 64))
    hold(errs, "crosspoint_mvm",
         routed("crosspoint_mvm", "f32_scalar", "K6 f32 unaligned",
                lambda: mvm.crosspoint_mvm(g, v)),
         mvm.crosspoint_mvm_plain(g, v), TOL_MVM_F32)
    # K5 at dt = 1, as at the main shape: the product is then as large as
    # the state, so the element-by-element bf16 bar sees a share of it lost
    for (n5, b5), route_f32, route_bf16 in RAGGED_STEP:
        m5 = t((n5, n5)) * (0.1 * min(1.0, (137 / n5) ** 0.5))
        z5, c5 = t((n5, b5)), t((n5, b5))
        hold(errs, "transient_step",
             routed("transient_step", route_f32, f"K5 f32 {(n5, b5)}",
                    lambda: st.transient_step(m5, z5, c5, 1.0)),
             st.transient_step_plain(m5, z5, c5, 1.0), TOL_MVM_F32)
        mb, zb, cb = m5.bfloat16(), z5.bfloat16(), c5.bfloat16()
        hold_mvm_bf16(errs, "transient_step_bf16",
                      routed("transient_step", route_bf16, f"K5 bf16 {(n5, b5)}",
                             lambda: st.transient_step(mb, zb, cb, 1.0)),
                      st.transient_step_plain(mb, zb, cb, 1.0))
        del m5, mb
    m5 = (t(1000 * 1000 + 1) * 0.01)[1:].view(1000, 1000)   # a view off the grid
    z5, c5 = t((1000, 16)), t((1000, 16))
    hold(errs, "transient_step",
         routed("transient_step", "narrow_scalar", "K5 f32 unaligned",
                lambda: st.transient_step(m5, z5, c5, 1.0)),
         st.transient_step_plain(m5, z5, c5, 1.0), TOL_MVM_F32)
    return errs


def k5_rank_dropped(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """A planted fault: K5's narrow step with the last cluster rank's k
    partial left out, in plain PyTorch around the kernel."""
    st = importlib.import_module("repro_torch.kernels.transient_step")
    n, nb = z.shape
    k0, k1 = st.narrow_k_ranges(n, st.transient_step_split(n))[-1]
    out = st.transient_step(m, z, c, 1.0).float()
    return out - torch.matmul(m[:, k0:k1].float(), z[k0:k1].float())


def phase_kernel_api(dev, k4_split: dict) -> tuple[dict, dict]:
    """K5, K6, K7a and K7b through the public wrappers at the size sweep's
    sizes: the counted main-path run, then each kernel against its plain
    version (and the transform against float64, K5 against K4), the ragged
    shapes, and the times.  ``k4_split`` carries K4's split checks from the
    kernels phase into this phase's line.  Returns per-kernel rows and the
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import spd_transform as tr

    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    st = importlib.import_module("repro_torch.kernels.transient_step")
    op = api_operands(dev)
    out, launches, wall = drive_api(op)
    emit(dict(phase="kernel_api", case="main_path", launches=launches, wall_s=wall,
              transform_n=N_TRANSFORM, crossbar=list(op["g"].shape),
              circuit_n=N_CIRCUIT, circuit_nz=op["nz"], k5_columns=K5_COLUMNS,
              k5_steps=K5_STEPS, dt=op["dt"]))

    # K7a/K7b: against the float64 transform and against the plain versions
    ka, kb, d, ks = out["transform"]
    tr64 = op["tr64"]
    scale = float(tr64.k_a.abs().max())
    for name, got, want in (("K_A", ka, tr64.k_a), ("K_B", kb, tr64.k_b), ("D", d, tr64.d),
                            ("K_s", ks, tr64.k_s)):
        e = float((got.double() - want).abs().max())
        check(e <= TOL_TRANSFORM * scale, f"{name} vs float64 transform: {e} > 1e-5 x {scale}")
    a = op["a"]
    errs: dict = {}
    colsum = tr.colabs(a)
    hold(errs, "colabs", colsum, tr.colabs_plain(a), 1e-5)
    check(torch.equal(colsum, tr.colabs_in_kernel_order(a)),
          "K7a at the main shape: not bit for bit its order in plain PyTorch")
    pa, pb = tr.assemble_plain(a, d, ks)
    hold(errs, "assemble", ka, pa, 0.0)
    hold(errs, "assemble", kb, pb, 0.0)
    # K6: each product against the plain version on the same inputs, b = 1
    # (the DC voltages) and b = 64 in float32 and bf16
    g, y, v = op["g"], op["y"], op["v"]
    hold(errs, "crosspoint_mvm_b1", out["i_dc"],
         mvm.crosspoint_mvm_plain(g, y[:, None])[:, 0], TOL_MVM_F32)
    hold(errs, "crosspoint_mvm", out["i_v"], mvm.crosspoint_mvm_plain(g, v), TOL_MVM_F32)
    want_bf = mvm.crosspoint_mvm_plain(op["g_bf"], op["v_bf"])
    hold_mvm_bf16(errs, "crosspoint_mvm_bf16", out["i_bf"], want_bf)
    # the bf16 bar must fail a wrong kernel: planted faults at the main shape
    k6_planted = {}
    atol = MVM_BF16_ATOL_OF_MAX * float(want_bf.double().abs().max())
    for name, fault in K6_FAULTS.items():
        err, share = bar_share(fault(op["g_bf"], op["v_bf"]), want_bf, MVM_BF16_RTOL, atol)
        k6_planted[name] = dict(max_abs_err=err, of_bar=share)
        check(share > 1, f"K6's bf16 bar passes the planted fault {name}: {share} of it")
    # the split reductions: planted faults that their bars must reject, and
    # two launches that must give the same bits
    want_v = mvm.crosspoint_mvm_plain(g, v)
    m, c, z0 = op["m"], op["c"], op["z"]
    want_z1 = st.transient_step_plain(m, z0, c, 1.0)
    split_planted = {
        "k7a_rank_rows_dropped": share_of_bar(k7a_rank_dropped(a), tr.colabs_plain(a), 1e-5),
        "k6_f32_k_partial_dropped": share_of_bar(k6_f32_partial_dropped(g, v), want_v,
                                                 TOL_MVM_F32),
        "k4_rank_columns_dropped": k4_split["rank_dropped_of_bar"],
        "k5_k_partial_dropped": share_of_bar(k5_rank_dropped(m, z0, c), want_z1,
                                             TOL_MVM_F32)}
    for name, share in split_planted.items():
        check(share > 1000, f"the bar passes the planted fault {name}, or fails it by "
                            f"1000x or less: {share} of it")
    # the split must fit one wave of the card's clusters: a second wave
    # costs nearly a whole kernel's time
    (gm, gk), gnb = g.shape, v.shape[1]
    ranks = mvm.crosspoint_mvm_split(gm, gk, gnb)
    k6_waves = dict(ranks=ranks, clusters=-(-gm // mvm.F32_BM) * -(-gnb // mvm.F32_BN),
                    per_wave={r: mvm.f32_clusters_per_wave(r) for r in (1, 2, 4)})
    check(k6_waves["clusters"] <= k6_waves["per_wave"][ranks],
          f"K6 f32's split does not fit one wave: {k6_waves}")
    nz = op["nz"]
    ranks5 = st.transient_step_split(nz)
    k5_waves = dict(ranks=ranks5, clusters=-(-nz // st.NARROW_BM),
                    per_wave={r: st.narrow_clusters_per_wave(r) for r in (1, 2, 4, 8)})
    check(k5_waves["clusters"] <= k5_waves["per_wave"][ranks5],
          f"K5's split does not fit one wave: {k5_waves}")
    z1 = st.transient_step(m, z0, c, 1.0)
    deterministic = {"colabs": torch.equal(tr.colabs(a), colsum),
                     "crosspoint_mvm_f32": torch.equal(mvm.crosspoint_mvm(g, v), out["i_v"]),
                     "transient_step_narrow": torch.equal(st.transient_step(m, z0, c, 1.0), z1),
                     "transient_step_narrow_bf16": torch.equal(
                         st.transient_step(op["m_bf"], op["z_bf"], op["c_bf"], 1.0),
                         out["z_bf"])}
    for name, same in deterministic.items():
        check(same, f"{name}: two launches on the same input differ")
    # K5: 200 steps against 200 plain steps, one step against the plain
    # version, in its split order and in bf16 (element by element, as K6's
    # bf16 products) and on one column; column 0 through 500 steps of K5
    # (one column) against 500 launches of K4 (B = 1, padded as the engine
    # pads), and K4's first step against its plain version
    zp = z0
    for _ in range(K5_STEPS):
        zp = st.transient_step_plain(m, zp, c, 1.0)
    hold(errs, "transient_step", out["z"], zp, TOL_Z)
    hold(errs, "transient_step", z1, want_z1, TOL_MVM_F32)
    hold(errs, "transient_step_order", st.transient_step_in_kernel_order(m, z0, c, 1.0),
         want_z1, TOL_MVM_F32)
    hold_mvm_bf16(errs, "transient_step_bf16", out["z_bf"],
                  st.transient_step_plain(op["m_bf"], op["z_bf"], op["c_bf"], 1.0))
    hold(errs, "transient_step_b1", out["z_b1"],
         st.transient_step_plain(m, op["z_col"][:, None], op["c_col"][:, None], 1.0)[:, 0],
         TOL_MVM_F32)
    z5, c5 = z0[:, :1].contiguous(), c[:, :1].contiguous()
    m4 = ops.pad_rows(m[None], (1, 2)).contiguous()
    z4 = ops.pad_rows(z0[:, 0][None], (1,)).contiguous()
    c4 = ops.pad_rows(c[:, 0][None], (1,)).contiguous()
    zk4, rk4 = st.transient_step_batched(m4, z4, c4, 1.0)
    zk4b, rk4b = st.transient_step_batched(m4, z4, c4, 1.0)
    deterministic["transient_step_batched"] = bool(torch.equal(zk4, zk4b)
                                                   and torch.equal(rk4, rk4b))
    check(deterministic["transient_step_batched"], "K4 at B = 1: two launches differ")
    zp4, rp4 = st.transient_step_batched_plain(m4, z4, c4, 1.0)
    hold(errs, "transient_step_batched_b1", zk4, zp4, TOL_Z)
    hold(errs, "transient_step_batched_b1_res", rk4, rp4, TOL_RES)
    for _ in range(K5_VS_K4_STEPS):
        z5 = ops.transient_step(m, z5, c5, 1.0)
        z4, _ = st.transient_step_batched(m4, z4, c4, 1.0)
    hold(errs, "k5_vs_k4", z5[:, 0], z4[0, :op["nz"]], TOL_Z)
    ragged = ragged_checks(dev)
    emit(dict(phase="kernel_api", case="vs_plain", main_path=errs, ragged=ragged,
              k6_bf16_bar=dict(rtol=MVM_BF16_RTOL, atol_of_max=MVM_BF16_ATOL_OF_MAX),
              k6_planted_faults=k6_planted, split_planted_faults_of_bar=split_planted,
              bitwise_equal_launches=deterministic, k6_f32_waves=k6_waves,
              k4_waves=k4_split["waves"], k5_waves=k5_waves,
              k4_split_order_vs_plain=k4_split["order_vs_plain"],
              k5_max_z=float(zp.abs().max()), k5_vs_k4_max_z=float(z4.abs().max()),
              i_dc_max=float(out["i_dc"].abs().max()), i_v_max=float(out["i_v"].abs().max())))

    # times at the main-path shapes (each input is larger than the 50 MB L2
    # except V, Z and C, so every call reads G, M or A from HBM).  Bytes:
    # inputs read once and outputs written once.
    rows = {}

    def timed(key, shape, kern, plain, lib, nbytes, flops, err_keys, peak=F32_FLOPS_PER_S):
        bound_ms, bound_by = bound(nbytes, flops, peak)
        rows[key] = dict(
            shape=shape, ms=cuda_ms(kern, 20), device_ms=graph_ms(kern, 20),
            plain_ms=cuda_ms(plain, 10), library_ms=None if lib is None else cuda_ms(lib, 20),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
            max_abs_err=max(e[k]["max_abs_err"] for e in (errs, ragged) for k in err_keys
                            if k in e))

    nn, nz, gm, w = N_TRANSFORM, op["nz"], g.shape[0], K6_BATCH
    bf, vbf, y1 = op["g_bf"], op["v_bf"], y[:, None]
    zc = z0 + 1.0 * c
    timed("colabs", [nn, nn], lambda: tr.colabs(a), lambda: tr.colabs_plain(a),
          lambda: torch.linalg.vector_norm(a, ord=1, dim=0),
          nn * nn * 4 + nn * 4, nn * nn, ("colabs",))
    timed("assemble", [nn, nn], lambda: tr.assemble(a, d, ks),
          lambda: tr.assemble_plain(a, d, ks), None,
          nn * nn * 4 + 2 * nn * 4 + 2 * nn * nn * 4, 4 * nn * nn, ("assemble",))
    timed("crosspoint_mvm", [gm, gm, 1], lambda: mvm.crosspoint_mvm(g, y1),
          lambda: mvm.crosspoint_mvm_plain(g, y1), lambda: torch.matmul(g, y1),
          gm * gm * 4 + 2 * gm * 4, 2 * gm * gm,
          ("crosspoint_mvm_b1", "crosspoint_mvm"))
    timed("crosspoint_mvm_b64", [gm, gm, w], lambda: mvm.crosspoint_mvm(g, v),
          lambda: mvm.crosspoint_mvm_plain(g, v), lambda: torch.matmul(g, v),
          gm * gm * 4 + 2 * gm * w * 4, 2 * gm * gm * w, ("crosspoint_mvm",))
    # bf16 inputs: the bound's rate for their type is the bf16 peak
    timed("crosspoint_mvm_b64_bf16", [gm, gm, w], lambda: mvm.crosspoint_mvm(bf, vbf),
          lambda: mvm.crosspoint_mvm_plain(bf, vbf), lambda: torch.matmul(bf, vbf),
          gm * gm * 2 + 2 * gm * w * 2, 2 * gm * gm * w, ("crosspoint_mvm_bf16",),
          BF16_FLOPS_PER_S)
    timed("transient_step", [nz, nz, K5_COLUMNS], lambda: st.transient_step(m, z0, c, 1.0),
          lambda: st.transient_step_plain(m, z0, c, 1.0), lambda: torch.addmm(zc, m, z0),
          nz * nz * 4 + 3 * nz * K5_COLUMNS * 4, nz * K5_COLUMNS * (2 * nz + 3),
          ("transient_step",))
    z1c, c1c = z0[:, :1].contiguous(), c[:, :1].contiguous()
    timed("transient_step_b1", [nz, nz, 1], lambda: st.transient_step(m, z1c, c1c, 1.0),
          lambda: st.transient_step_plain(m, z1c, c1c, 1.0),
          lambda: torch.addmm(z1c + c1c, m, z1c),
          nz * nz * 4 + 3 * nz * 4, nz * (2 * nz + 3), ("transient_step_b1",))
    # bf16 inputs: bytes bound it at the bf16 rate too, as in float32
    mb, zb, cb = op["m_bf"], op["z_bf"], op["c_bf"]
    zcb = zb + cb
    timed("transient_step_bf16", [nz, nz, K5_COLUMNS], lambda: st.transient_step(mb, zb, cb, 1.0),
          lambda: st.transient_step_plain(mb, zb, cb, 1.0), lambda: torch.addmm(zcb, mb, zb),
          nz * nz * 2 + 3 * nz * K5_COLUMNS * 2, nz * K5_COLUMNS * (2 * nz + 3),
          ("transient_step_bf16",), BF16_FLOPS_PER_S)
    emit(dict(phase="kernel_api", case="times", rows=rows))
    return rows, launches


def quickstart(device: str) -> dict:
    """The single-system flow of examples/quickstart.py at n = 24 through
    the port on ``device``."""
    from repro_torch.core import solve
    from repro_torch.core import transform as T
    from repro_torch.core.components import netlist_counts
    from repro_torch.core.network import build_proposed
    from repro_torch.core.power import system_power
    from repro_torch.data.spd import random_rhs_from_solution, random_spd

    op_mod = importlib.import_module("repro_torch.core.operating_point")
    rng = np.random.default_rng(0)
    n = 24
    a = random_spd(rng, n)
    x, b = random_rhs_from_solution(rng, a)
    res = solve(a, b, method="analog_2n", x_ref=x, compute_settling=True, device=device)
    hw = op_mod.NonIdealities(offset_mode="none", pot_bits=10, wiper_ohm=50.0)
    res_hw = solve(a, b, method="analog_2n", nonideal=hw, x_ref=x, device=device)
    res_pre = solve(a, b, method="analog_n", x_ref=x, compute_settling=True, device=device)
    chol = solve(a, b, method="cholesky", device=device)
    cg = solve(a, b, method="cg", device=device)
    net = build_proposed(a, b, device=device)
    counts = netlist_counts(net)
    k_b = T.transform_2n(torch.as_tensor(a, device=device),
                         torch.as_tensor(b, device=device)).k_b
    power = system_power(torch.as_tensor(a, device=device), k_b, torch.as_tensor(x, device=device),
                         n_amps=net.n_amps, n_switches=counts["analog_switches"])
    return dict(
        device=device, x_2n=res.x.tolist(), max_abs_error=float(res.info["max_abs_error"]),
        settle_time_2n=float(res.settle_time), n_amps_2n=int(res.info["n_amps"]),
        passive=bool(res.info["is_passive"]), err_fullscale_hw=float(res_hw.info["err_fullscale"]),
        x_hw=res_hw.x.tolist(), settle_time_n=float(res_pre.settle_time),
        x_n=res_pre.x.tolist(), n_amps_n=int(res_pre.info["n_amps"]),
        x_cholesky=chol.x.tolist(), x_cg=cg.x.tolist(), cg_iterations=int(cg.info["iterations"]),
        counts=counts, power=power, x_ref=x.tolist())


def phase_quickstart() -> None:
    """The quickstart flow on the card and on the CPU: solutions within
    1e-10, settling times within one step of the eig path's log time grid
    (3000 points over 1e-10..1 s), counts equal, power within 1e-12."""
    got, want = quickstart("cuda"), quickstart("cpu")
    emit(dict(phase="quickstart", **got))
    emit(dict(phase="quickstart", **want))
    for key in ("x_2n", "x_hw", "x_n", "x_cholesky", "x_cg"):
        e = float(np.max(np.abs(np.subtract(got[key], want[key]))))
        check(e <= 1e-10, f"quickstart {key}: cuda vs cpu {e}")
    e = float(np.max(np.abs(np.subtract(got["x_2n"], got["x_ref"]))))
    check(e <= 1e-8, f"quickstart: analog 2n x vs x_ref {e}")
    grid_step = np.log(1e10) / 2999
    for key in ("settle_time_2n", "settle_time_n"):
        check(np.isfinite(got[key]) and abs(np.log(got[key] / want[key])) <= grid_step * 1.001,
              f"quickstart {key}: {got[key]} vs {want[key]}")
    for key in ("n_amps_2n", "n_amps_n", "passive", "cg_iterations", "counts"):
        check(got[key] == want[key], f"quickstart {key}: {got[key]} vs {want[key]}")
    for key, val in want["power"].items():
        check(abs(got["power"][key] - val) <= 1e-12 * max(abs(val), 1e-30),
              f"quickstart power {key}: {got['power'][key]} vs {val}")
    check(abs(got["err_fullscale_hw"] - want["err_fullscale_hw"])
          <= 1e-6 * want["err_fullscale_hw"], "quickstart hardware-model error")


# ---------------------------------------------------------------------------
# phase 6: serve — the language-model serving path, K8 on every prefill
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen3_8b"       # full width and depth: 36 layers, d_model 4096
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 4096
SERVE_REQUESTS, SERVE_MAX_NEW = 6, 16
SERVE_PROMPT_LENS = (256, 2048)   # prompt lengths drawn in [256, 2048]
# K8 against its plain version, element by element: |got - want| <=
# atol + rtol |want|, as the reference kernel test holds it
# (tests/test_kernels.py:171), with tighter bars.  Kernel and plain version
# round float32 results that differ by a few float32 ulps (sums taken in
# other orders) to the output dtype, so a sound bf16 pair lies at most one
# bf16 ulp apart, at most 2^-7 |want|: rtol 1e-2.  atol covers outputs near
# zero and, with p rounded to bf16, a p whose rounding flips (2^-8 p/l |v|).
# The planted faults below (K8_FAULTS) show that the bar sees a wrong kernel.
K8_BARS = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (1e-5, 1e-6)}   # (rtol, atol)
# a planted fault leaves out key tile 0 from every row from FAULT_ROW on
FAULT_ROW, FAULT_KEYS = 1024, 64
# Each prompt's prefill logits through K8 against the same prefill through
# the plain attention, both on the card in bf16: the two round each
# layer's attention output to bf16 from float32 sums taken in other
# orders, so a few outputs per layer land one bf16 ulp apart, and 36
# layers carry that to the logits.  5e-2 of max|logit| lies between the
# sound readings (at most 0.024) and those of the planted faults (0.11 and
# more), which the phase checks on every run.
TOL_SERVE_LOGITS = 5e-2
# the SMOKE config on the card against the CPU, float32 throughout
# (products and attention sums in other orders): 1e-4 of max|logit|
TOL_SMOKE_LOGITS = 1e-4
# K8 at the main path's shape and around it:
# (label, dtype, b, s, t, h, kv, d, causal, window, p_dtype); p_dtype "v"
# is the reference kernel's contract (p rounded to v's dtype), driven
# through ops.flash_attention
BF16, F32 = torch.bfloat16, torch.float32
K8_MAIN = ("main", BF16, 1, 2048, 2048, 32, 8, 128, True, 0, None)
K8_CASES = (
    K8_MAIN,
    ("main_p_bf16", BF16, 1, 2048, 2048, 32, 8, 128, True, 0, BF16),
    ("ragged_s1000", BF16, 1, 1000, 1000, 32, 8, 128, True, 0, None),
    ("mqa", BF16, 1, 1024, 1024, 32, 1, 128, True, 0, None),
    ("window512", BF16, 1, 2048, 2048, 32, 8, 128, True, 512, None),
    ("non_causal", BF16, 1, 1024, 1024, 32, 8, 128, False, 0, None),
    ("non_causal_s300_t1000", BF16, 1, 300, 1000, 32, 8, 128, False, 0, None),
    ("f32_d128", F32, 1, 1024, 1024, 32, 8, 128, True, 0, None),
    *((f"{'bf16' if dt == BF16 else 'f32'}_d{d}", dt, 2, 515, 515, 8, 2, d, True, 0, "v")
      for d in (16, 32, 64) for dt in (BF16, F32)),
    # p kept float32 (the tensor cores' p_hi + p_lo split) at every head size
    *((f"bf16_d{d}_p_f32", BF16, 2, 515, 515, 8, 2, d, True, 0, None) for d in (16, 32, 64)),
    # Granite-20B's MQA: 48 query heads over one KV head, 64 % 48 != 0
    ("mqa_g48", BF16, 1, 1000, 1000, 48, 1, 128, True, 0, None),
)
# the same shape in float32: the FMA route's row of the kernels line
K8_MAIN_F32 = ("main_f32", F32, *K8_MAIN[2:])


def attn_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves: the work this input needs."""
    qpos, kpos = np.arange(s)[:, None], np.arange(t)[None, :]
    ok = np.ones((s, t), dtype=bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return int(ok.sum())


def bar_share(got: torch.Tensor, want: torch.Tensor, rtol: float,
              atol: float) -> tuple[float, float]:
    """max |got - want| and the largest share of the element's bar
    atol + rtol |want| (above 1 fails)."""
    err = (got.double() - want.double()).abs()
    return float(err.max()), float((err / (atol + rtol * want.double().abs())).max())


def hold_close(errs: dict, key: str, got: torch.Tensor, want: torch.Tensor,
               rtol: float, atol: float) -> None:
    """Fail unless every |got - want| <= atol + rtol |want|; keeps under
    ``key`` the largest error and the largest share of its bar."""
    err, share = bar_share(got, want, rtol, atol)
    check(share <= 1, f"{key}: max err {err}, {share} of the bar {atol} + {rtol} |want|")
    old = errs.get(key, dict(max_abs_err=0.0, of_bar=0.0))
    errs[key] = dict(max_abs_err=max(old["max_abs_err"], err),
                     of_bar=max(old["of_bar"], share))


def bars_json() -> dict:
    return {str(dt).removeprefix("torch."): dict(rtol=r, atol=a)
            for dt, (r, a) in K8_BARS.items()}


def attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """Softmax attention in float32 under an explicit (S, T) mask of the
    pairs to keep; query head h reads KV head h // G."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / np.sqrt(d)
    p = torch.softmax(sc.masked_fill(~keep, -np.inf), dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(b, s, h, d).to(q.dtype)


def k8_tile_dropped(q, k, v, **kw):
    """A planted fault: causal K8 that leaves the first FAULT_KEYS keys out
    of every row from FAULT_ROW on."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    out = fa.flash_attention(q, k, v, **kw)
    s, t = q.shape[1], k.shape[1]
    if s > FAULT_ROW:
        qpos = torch.arange(FAULT_ROW, s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        out[:, FAULT_ROW:] = attention_masked(q[:, FAULT_ROW:], k, v,
                                              (kpos <= qpos) & (kpos >= FAULT_KEYS))
    return out


def k8_heads_swapped(q, k, v, **kw):
    """A planted fault: K8 with query head h reading KV head h % KV
    instead of h // G (the GQA order every MHA case passes)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    h, kv = q.shape[2], k.shape[2]
    perm = torch.tensor([(i % kv) * (h // kv) + i // kv for i in range(h)], device=q.device)
    moved = torch.empty_like(q)
    moved[:, :, perm] = q
    return fa.flash_attention(moved, k, v, **kw)[:, :, perm]


K8_FAULTS = {"tile_dropped_late_rows": k8_tile_dropped, "gqa_heads_swapped": k8_heads_swapped}


def k8_operands(case, gen):
    _label, dtype, b, s, t, h, kv, d, _causal, _window, _p = case
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def phase_k8() -> dict:
    """K8 against its plain version at every case (main-path shape, ragged
    S, MQA with G = 32 and 48, a window, non-causal, S != T, each head
    size, float32 and bf16, p rounded or not), each through the route
    flash_attention_route names; then the times at the main-path shape on
    each route (bf16 -> "mma", float32 -> "fma"), keyed by route."""
    from repro_torch.kernels import ops

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs: dict = {}
    routes: dict = {}
    for case in K8_CASES:
        label, dtype, _b, _s, _t, _h, _kv, d, causal, window, p_dtype = case
        q, k, v = k8_operands(case, gen)
        route = fa.flash_attention_route(dtype, d, True)
        before = ops.launch_counts_by_route()["flash_attention"][route]
        if p_dtype == "v":
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            p_dtype = BF16 if dtype == BF16 else None
        else:
            got = fa.flash_attention(q, k, v, causal=causal, window=window, p_dtype=p_dtype)
        check(ops.launch_counts_by_route()["flash_attention"][route] == before + 1,
              f"K8 {label} did not take the {route} route")
        routes[label] = route
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, p_dtype=p_dtype)
        check(got.dtype == dtype and got.shape == q.shape, f"K8 {label}: dtype/shape")
        hold_close(errs, label, got, want, *K8_BARS[dtype])
    emit(dict(phase="serve", case="k8_vs_plain", bars=bars_json(), errors=errs, routes=routes))

    # the bar must fail a wrong kernel: planted faults at the main-path shape
    dtype = K8_MAIN[1]
    q, k, v = k8_operands(K8_MAIN, gen)
    want = fa.flash_attention_plain(q, k, v)
    planted = {}
    for name, fault in K8_FAULTS.items():
        err, share = bar_share(fault(q, k, v), want, *K8_BARS[dtype])
        planted[name] = dict(max_abs_err=err, of_bar=share)
        check(share > 1, f"K8's bar passes the planted fault {name}: {share} of it")
    emit(dict(phase="serve", case="k8_planted_faults", faults=planted))

    rows = {"mma": k8_times(q, k, v, errs, routes)}
    rows["fma"] = k8_times(*k8_operands(K8_MAIN_F32, gen), errs, routes)
    for row in rows.values():
        emit(dict(phase="serve", case="k8_times", **row))
    return rows


def k8_times(q, k, v, errs: dict, routes: dict) -> dict:
    """K8's times at the main path's shape (causal, p float32) in the
    inputs' dtype, beside the plain version, SDPA (the library call, timed
    only) and the bound at the peak of the inputs' type."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    bf16 = q.dtype == BF16
    route = fa.flash_attention_route(q.dtype, d, True)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qh, kh, vh, is_causal=True, enable_gqa=True).transpose(1, 2)
    lib_err = float((lib_out.float() - fa.flash_attention(q, k, v).float()).abs().max())
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    flops = 4 * b * h * d * attn_pairs(s, t, True, 0)
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
    return dict(
        shape=[b, s, t, h, kv, d], causal=True, dtype=str(q.dtype).removeprefix("torch."),
        route=route, ms=ms, device_ms=graph_ms(lambda: fa.flash_attention(q, k, v), 20),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 5),
        library_ms=cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True), 20),
        bound_ms=bound_ms, bound_by=bound_by,
        bound_peak=("bf16 tensor cores, 989 TFLOP/s" if bf16 else "float32 FMA, 67 TFLOP/s")
        + " (the inputs' type)",
        f32_fma_bound_ms=flops / F32_FLOPS_PER_S * 1e3, bytes=nbytes, flops=flops,
        tflop_per_s=flops / (ms * 1e-3) / 1e12,
        max_abs_err=max(e["max_abs_err"] for label, e in errs.items()
                        if routes[label] == route),
        library_max_abs_err=lib_err,
    )


def smoke_cross_device() -> dict:
    """The SMOKE config (float32, 2 layers, head size 16) on the card and
    on the CPU, one set of weights: prefill and three decode steps at
    staggered positions, then three requests through ServeEngine, K8's
    launches by route counted over the card's engine run (float32: the
    fma route)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.serving import Request, ServeEngine

    cfg = get_smoke_config(SERVE_ARCH)
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gpu = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu").to("cuda")
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab, (2, 40))
    lg_g, c_g = prefill(gpu, {"tokens": toks}, cfg, 64)
    lg_c, c_c = prefill(cpu, {"tokens": toks}, cfg, 64)
    pos = np.array([40, 37])                 # the second sequence lags by three
    worst = 0.0
    for step in range(4):
        err = float((lg_g.cpu().double() - lg_c.double()).abs().max())
        check(err <= TOL_SMOKE_LOGITS * float(lg_c.abs().max()),
              f"smoke config step {step}: cuda vs cpu logits {err}")
        worst = max(worst, err / float(lg_c.abs().max()))
        nxt = lg_c.argmax(dim=-1, keepdim=True).numpy()
        lg_g, c_g = decode_step(gpu, nxt, pos, c_g, cfg)
        lg_c, c_c = decode_step(cpu, nxt, pos, c_c, cfg)
        pos = pos + 1
    outs, by_route = {}, {}
    for dev, params in (("cuda", gpu), ("cpu", cpu)):
        eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, device=dev)
        reqs = [Request(rid=i, prompt=np.arange(3 + 4 * i) % cfg.vocab, max_new=8)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        eng.run(max_steps=100)
        torch.cuda.synchronize()
        by_route[dev] = ops.launch_counts_by_route()["flash_attention"]
        outs[dev] = [r.out for r in reqs]
    check(outs["cuda"] == outs["cpu"], f"smoke config tokens: {outs}")
    check(not any(by_route["cpu"].values()), f"the CPU run launched K8: {by_route}")
    return dict(logits_err_of_max=worst, tokens=outs["cuda"],
                k8_launches_by_route=by_route["cuda"])


def device_breakdown(fn) -> dict:
    """Run ``fn()`` under torch.profiler: its wall time, the device time of
    its kernels by kind (K8, matrix products, the rest) with the largest
    kernels, and the busy share (kernel time over wall; kernels of one
    stream do not overlap).  Device times are None where the profiler
    saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = {"k8": 0.0, "matmul": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        name = e.key.lower()
        kind = "k8" if "flash_attention" in name else (
            "matmul" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90"))
            else "other")
        kinds[kind] += us / 1e3
        top.append((us / 1e3, e.count, e.key[:80]))
    busy = sum(kinds.values())
    top.sort(reverse=True)
    return dict(wall_ms=wall * 1e3,
                device_ms=kinds if busy else None,
                busy_share=busy / (wall * 1e3) if busy else None,
                top_kernels=[dict(ms=ms, calls=n, name=k) for ms, n, k in top[:8]])


def prefill_checks(params, cfg, prompts, reqs) -> list[dict]:
    """Every prompt's prefill again, outside the counted run.  K8 is held
    element by element against its plain version on each layer's own q,
    k and v (the plain calls launch nothing); its logits against the same
    prefill through the plain attention on the card, and through each
    planted fault, all through the model's attention seam and all at
    max|logit| of the plain prefill.  Fails unless every layer holds,
    K8's logits are within TOL_SERVE_LOGITS, each planted fault that
    reaches the prompt is past it, and the greedy token is the
    engine's."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.model import prefill

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    k8 = attn_mod.flash_attention
    layers: dict = {}

    def held(q, k, v, **kw):
        got = k8(q, k, v, **kw)
        hold_close(layers, "layers", got, fa.flash_attention_plain(q, k, v, **kw),
                   *K8_BARS[q.dtype])
        return got

    def logits(attention, tokens):
        attn_mod.flash_attention = attention
        try:
            return prefill(params, tokens, cfg, tokens["tokens"].shape[1])[0].float()
        finally:
            attn_mod.flash_attention = k8

    reads = []
    for prompt, req in zip(prompts, reqs):
        tokens = {"tokens": prompt[None, :]}
        ops.reset_launch_counts()
        got = logits(held, tokens)
        check(ops.launch_counts()["flash_attention"] == cfg.n_layers, "K8 prefill launches")
        check(bool(torch.isfinite(got).all()), "non-finite prefill logits")
        want = logits(fa.flash_attention_plain, tokens)
        check(ops.launch_counts()["flash_attention"] == cfg.n_layers, "plain prefill launched K8")
        scale = float(want.abs().max())
        read = dict(prompt_len=len(prompt), max_logit=scale,
                    layers_of_bar=layers.pop("layers")["of_bar"],
                    k8_of_max=float((got - want).abs().max()) / scale)
        for name, fault in K8_FAULTS.items():
            read[f"{name}_of_max"] = float((logits(fault, tokens) - want).abs().max()) / scale
        reads.append(read)
        check(read["k8_of_max"] <= TOL_SERVE_LOGITS,
              f"prefill logits K8 vs plain: {read} past {TOL_SERVE_LOGITS}")
        for name in K8_FAULTS:      # the tile fault touches rows past FAULT_ROW only
            check(read[f"{name}_of_max"] > TOL_SERVE_LOGITS
                  or (name == "tile_dropped_late_rows" and len(prompt) <= FAULT_ROW),
                  f"the logit bar passes the planted fault {name}: {read}")
        first = int(got.argmax(dim=-1)[0])
        check(first == req.out[0], f"engine's first token {req.out[0]} vs prefill {first}")
    return reads


def phase_serve(dev) -> dict:
    """ServeEngine on Qwen3-8B at full width and depth, bf16, seeded random
    weights on the card: 6 requests through 4 slots, greedy, 16 new tokens
    each, K8's launches counted over the run.  Then every prompt's
    prefill checked again (:func:`prefill_checks`), the SMOKE config on
    the card against the CPU, and a profile of one prefill and four
    decode steps.  Returns K8's launches by route: "mma" in the counted
    run, "fma" in the SMOKE config's engine run on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import count_params, init_params
    from repro_torch.serving import Request, ServeEngine

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg = get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    lens = rng.integers(SERVE_PROMPT_LENS[0], SERVE_PROMPT_LENS[1] + 1, SERVE_REQUESTS)
    check(any(n % fa.KV_TILE for n in lens), f"no prompt length off the tile: {lens}")
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    eng = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=dev)
    reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)

    # both methods end in a host copy of the sampled tokens, so a host
    # clock around them covers their device work
    prefills, decodes = [], []
    prefill_slot, decode_active = eng._prefill_slot, eng._decode_active

    def timed_prefill(slot, req):
        t = time.perf_counter()
        prefill_slot(slot, req)
        prefills.append(dict(rid=req.rid, prompt_len=len(req.prompt),
                             ms=(time.perf_counter() - t) * 1e3))

    def timed_decode():
        t = time.perf_counter()
        out = decode_active()
        decodes.append(dict(active=sum(r is not None for r in eng.active),
                            ms=(time.perf_counter() - t) * 1e3))
        return out

    eng._prefill_slot, eng._decode_active = timed_prefill, timed_decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(max_steps=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        check(r.done and r.error is None and len(r.out) == SERVE_MAX_NEW,
              f"request {r.rid}: done={r.done} error={r.error} tokens={len(r.out)}")
        check(all(0 <= t < cfg.vocab_padded for t in r.out), f"request {r.rid}: token range")
    check(len(prefills) == SERVE_REQUESTS, f"{len(prefills)} prefills for {SERVE_REQUESTS}")
    by_route = ops.launch_counts_by_route()["flash_attention"]
    launches = counts["flash_attention"]
    check(launches == cfg.n_layers * len(prefills),
          f"K8 launched {launches} times for {len(prefills)} prefills of {cfg.n_layers} layers")
    check(by_route["mma"] == launches, f"K8 routes on the serving path: {by_route}")
    generated = sum(len(r.out) for r in reqs)
    emit(dict(phase="serve", case="engine", arch=SERVE_ARCH, n_layers=cfg.n_layers,
              d_model=cfg.d_model, params=count_params(params), param_init_s=init_s,
              slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, max_new=SERVE_MAX_NEW,
              wall_s=wall, generated_tokens=generated, tokens_per_s=generated / wall,
              prefills=prefills, decode_steps=len(decodes),
              decode_ms_mean=float(np.mean([d["ms"] for d in decodes])),
              decode_ms=[d["ms"] for d in decodes],
              peak_memory_allocated_bytes=peak, launches=counts,
              launches_by_route=by_route))

    reads = prefill_checks(params, cfg, prompts, reqs)
    cross = smoke_cross_device()
    check(cross["k8_launches_by_route"]["fma"] > 0,
          f"the SMOKE config's run did not take K8's fma route: {cross}")
    emit(dict(phase="serve", case="logits", bars=bars_json(), logit_bar=TOL_SERVE_LOGITS,
              prompts=reads, smoke_config_cuda_vs_cpu=cross))

    # where the time goes: the first prompt's prefill into a slot, then
    # four decode steps with all four slots busy (not counted above)
    eng = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=dev)
    for i in range(SERVE_SLOTS):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new=SERVE_MAX_NEW))
    prefill_prof = device_breakdown(lambda: eng._prefill_slot(0, eng.queue.pop()))
    eng._admit()
    check(all(r is not None for r in eng.active), "profile: slots not all busy")
    decode_prof = device_breakdown(lambda: [eng.step() for _ in range(4)])
    emit(dict(phase="serve", case="profile", prefill_len=int(lens[0]), prefill=prefill_prof,
              decode_steps=4, decode=decode_prof))
    return {"mma": by_route["mma"], "fma": cross["k8_launches_by_route"]["fma"]}


def kernels_line(pairs: dict, launches: dict, settling_launches: dict, api_rows: dict,
                 api_launches: dict, k8_rows: dict, k8_launches: dict) -> list[dict]:
    """One row per kernel, and for K5, K6 and K8 one per route: timed at
    its main-path shape (MAIN_SHAPE for K1-K4), its error the largest over
    every shape, its launches from the main path that drives it (the slice
    and the settling phase's predicted-form sweeps for K1-K4, split in
    ``launches_by_phase``; the kernel API for K5-K7b, the serving path for
    K8), for
    K5, K6 and K8 those of the row's route (``kernel_route``; K7a names
    its route too, K4 its split, K1 and K3 their cluster size, variant,
    clusters per wave and main-path launches by variant; K5's rows count
    their own dtype), and
    K8's fma row counts the float32 SMOKE config's engine run on the
    card."""
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
            launches=launches[name] + settling_launches[name],
            launches_by_phase=dict(slice=launches[name], settling=settling_launches[name]),
            max_abs_err=err, ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=k["library_ms"], shape=k["shape"], device_ms=k.get("device_ms"),
        ))
        if "layout" in k:
            # K1 (float32 slots) and K3: cluster size, variant, clusters per wave
            layout = k["layout"].get("float32", k["layout"])
            rows[-1].update(ranks=layout["ranks"], variant=layout["variant"],
                            clusters_per_wave=layout["clusters_per_wave"],
                            launches_by_variant=launches["by_variant"][name],
                            device_ms_0_steps=k["device_ms_0_steps"])
            if "device_ms_by_ranks" in layout:
                rows[-1]["device_ms_by_ranks"] = layout["device_ms_by_ranks"]
        if "split" in k:
            rows[-1]["ranks"] = k["split"]["ranks"]
            rows[-1]["device_ms_by_ranks"] = k["split"]["device_ms_by_ranks"]
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape",
            "max_abs_err")
    k5_by_dtype = api_launches["transient_step_by_dtype"]
    for key, label, dtype, kernel_route in (
            ("transient_step", "f32, nb = 16", "float32", "narrow_async"),
            ("transient_step_bf16", "bf16, nb = 16", "bfloat16", "narrow_async"),
            ("transient_step_b1", "f32, nb = 1", "float32", "column")):
        rows.append(dict(name=f"K5 transient_step ({label})", route="cuda",
                         source="src/repro_torch/kernels/csrc/transient_step.cu",
                         replaces="src/repro/kernels/transient_step.py:99",
                         launches=k5_by_dtype[dtype][kernel_route], kernel_route=kernel_route,
                         launches_by_route=k5_by_dtype[dtype],
                         **{k: api_rows[key][k] for k in keys}))
    api = {
        "colabs": ("K7a", "src/repro_torch/kernels/csrc/spd_transform.cu",
                   "src/repro/kernels/spd_transform.py:48"),
        "assemble": ("K7b", "src/repro_torch/kernels/csrc/spd_transform.cu",
                     "src/repro/kernels/spd_transform.py:96"),
    }
    for name, (tag, source, rep) in api.items():
        k = api_rows[name]
        row = dict(name=f"{tag} {name}", route="cuda", source=source, replaces=rep,
                   launches=api_launches[name], **{key: k[key] for key in keys})
        if name == "colabs":
            row["kernel_route"] = "vec16"
            row["launches_by_route"] = api_launches["colabs_by_route"]
        rows.append(row)
    by_route = api_launches["crosspoint_mvm_by_route"]
    for key, label, kernel_route in (("crosspoint_mvm", "f32, b = 1", "fma"),
                                     ("crosspoint_mvm_b64", "f32, b = 64", "f32_async"),
                                     ("crosspoint_mvm_b64_bf16", "bf16, b = 64", "mma_async")):
        rows.append(dict(name=f"K6 crosspoint_mvm ({label})", route="cuda",
                         source="src/repro_torch/kernels/csrc/crosspoint_mvm.cu",
                         replaces="src/repro/kernels/crosspoint_mvm.py:48",
                         launches=by_route[kernel_route], kernel_route=kernel_route,
                         **{k: api_rows[key][k] for k in keys}))
    for kernel_route, row in k8_rows.items():
        rows.append(dict(name=f"K8 flash_attention ({row['dtype']}, D = {row['shape'][-1]})",
                         route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention.py:103",
                         launches=k8_launches[kernel_route], kernel_route=kernel_route,
                         **{key: row[key] for key in keys},
                         f32_fma_bound_ms=row["f32_fma_bound_ms"],
                         tflop_per_s=row["tflop_per_s"]))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing run", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke.py: no port package at {src / 'repro_torch'}; run it from a "
              "checkout of the repository; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
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
    settling_launches = phase_settling(dev, routes)
    api_rows, api_launches = phase_kernel_api(
        dev, pairs[("dense", N_DENSE)]["transient_step_batched"]["split"])
    phase_quickstart()
    k8_rows = phase_k8()
    k8_launches = phase_serve(dev)

    emit({"kernels": kernels_line(pairs, launches, settling_launches, api_rows,
                                  api_launches, k8_rows, k8_launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
