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
3c. solve_service — the solve service (``repro_torch.serving``) on the
   card's CUDA streams, through its public entry points: (a) the
   benchmark's stream (benchmarks/solve_service.py's mix of n = 16, 24,
   64, 192 over analog_2n on SPD and SDD systems, analog_n and cholesky,
   8 times, 72 requests, 8 slots), every delivered x within 1e-9 of a
   direct ``solve`` on the card, one pattern derivation per analog_2n
   bucket, no error; (b) a FEM stream (``mesh_stream``, 32 meshes of n =
   256, 576, 1024) at one and two micro-batches in flight, the same
   parity and one derivation per bucket; (c) settling tickets (8 at dense
   n = 48, 8 at n = 256, and n = 256 with the spectral dt), launch counts
   reset just before and read just after each drain, failing unless K3
   launched at n = 48 and K4 at n = 256, each ticket's x, ``stable`` and
   ``settle_steps`` equal to one ``solve_batch`` of the same 8 systems;
   (d) stream (a) on one and two CUDA streams of the card, at one and two
   micro-batches in flight, the same bytes from all four, requests/s and
   the stats' split printed; (e) chaos at 5 % and 20 % (50/25/25 over
   device faults, NaN solutions and build errors, seeded): every request
   answered once, every delivery within 1e-9; then two streams with
   stream 0 always faulting: every ticket delivered, stream 0
   quarantined; (f) ``newton_batch`` at B = 8, n = 64 through a session:
   the direct executor's iteration counts, x within 1e-7, one pattern;
   (g) ``solve_batch(mesh=solver_mesh())`` bit for bit ``device="cuda"``;
3d. analysis — the runtime sync gate (``repro_torch.analysis.
   run_service_gate``) on one and two CUDA streams: after a warmup drain
   the same drain must make no kernel build, no host copy under the
   ``dispatch`` label and no synchronizing operation there either
   (``torch.cuda.set_sync_debug_mode("warn")``, recorded by label); a
   ``.item()`` planted in the dispatch scope must count exactly once; then
   one drain of stream (a) and the settling tickets of (c) at n = 48 (K3)
   and 256 (K4, ``diag``) under ``SyncWatch``, launch counts reset just
   before and read just after, printing host copies and synchronizing
   operations by label, by entry point and by call site (the settling
   tickets failing unless their poll counted under ``settle_poll``, each
   ticket equal to ``solve_batch``), the watched mix drain's bytes equal to
   a plain drain's, and the profiler's ``cudaStreamSynchronize`` count of a
   third drain beside the 192 that scripts/service_overlap.py recorded
   before the dispatch phase's copies were made asynchronous;
4. kernel_api — the kernel API through the public wrappers, launch
   counts reset just before and read just after, failing unless K5, K6,
   K7a and K7b each launched: ``spd_transform_arrays`` (K7a + K7b) on a
   dense n = 4096 system, ``crosspoint_mvm`` (K6) on its (8192, 8192)
   crossbar from ``crosspoint_layout`` at the DC node voltages, with 64
   voltage vectors and in bf16 (and at the DC voltages in bf16), and 200
   ``transient_step`` (K5) steps of one dense n = 1024 circuit (nz =
   8192) from 16 start states, one step of it in bf16 and one on its step
   response alone in both dtypes, failing unless K7a took its 16-byte
   route, K6's b = 1 products its GEMV route, the b = 64 float32 one its
   split-k route with 16-byte copies and the bf16 one its tensor-core
   route, and K5's 16-column steps its split-k route with 16-byte copies
   and the one-column steps its column route, the GEMV (K6 b = 1, K5 nb =
   1) on its 16-byte variant.  Then the transform against float64, each
   kernel against its plain version within a bar scaled to its largest
   output (K6 and K5 in bf16 element by element), K7a and the GEMV bit for
   bit against their orders in plain PyTorch, planted faults that the bars
   must reject by more than 1000x (two for K6 in bf16; a cluster rank's
   share left out of K7a, K6 in float32, K4 and K5; one warp's rows left
   unwritten by the GEMV of K6 and of K5), two launches of K7a, K6 float32,
   K4, K5 and the GEMV bit for bit equal, the splits of K6, K4 and K5
   within one wave of the card's clusters and the GEMV's plan (C) equal to
   its Python plan and within one wave, K5's column 0 against 500 launches
   of K4, each kernel at ragged shapes (K5 on every route in both dtypes,
   K6 on every route, K7a on both routes, each also off the 16-byte grid;
   the GEMV bit for bit against its order there too), and the times of
   kernel (a Python loop and a CUDA graph), plain version and library call
   (the same two ways);
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
   (float32, K8's FMA route) on the card against the CPU.  K8's cases
   include the families' shapes (Zamba2's D = 112 on both routes,
   InternVL2's G = 7, Mixtral's G = 6 with its 4096 window at S = 6000,
   Whisper's non-causal encoder and cross attention at T = 1500) and a
   tensor-parallel rank's heads (2, 4 and 3 q heads over one kv head at
   D = 128: Qwen3-8B's, Command-R's and Granite-20B's on 16 "model"
   ranks), and a planted fault at D = 112 (the short column group left unnormalized)
   must fail the bar by more than 1000x.  At every case on the FMA route
   the output with the row lse must be the output without it, bit for
   bit, and the forward's plan in Python (``fma_forward_plan``) the C
   launcher's, its grid within one wave at train_lm's shape; two launches
   at train_lm's shape must agree bit for bit, and two planted faults
   there (the last row tile without the last key tile of its reach; the
   last row tile left unnormalized) must fail the float32 bar by more
   than 1000x;
7. families — every other model family at its published width, bf16,
   seeded random weights on the card, greedy: InternVL2-1B (24 layers,
   256 patch embeddings and 300-1200 text tokens, through ``prefill_into``
   / ``decode_step``), Granite-MoE 1B-A400M (24 layers, ``ServeEngine`` at
   the serve phase's protocol), Mixtral-8x22B (12 of its 56 layers, the
   most that fit one card with room to run; prompts of 4500-6000 tokens,
   so K8's window masks), Mamba2-370M (48 layers, ``ServeEngine``,
   prompts of 256-2048 tokens; it launches no kernel), Zamba2-7B (81
   layers, ``ServeEngine``, prompts that are multiples of 256; K8 at D =
   112) and Whisper-base (6 + 6 layers, 1500 frame embeddings, 8-64
   decoder tokens, through ``prefill_into`` / ``decode_step``); each model
   failing unless every request finishes with its tokens in the
   vocabulary and K8 launched exactly once per attention application of
   each prefill, all on its tensor-core route, and nothing else
   launched; then two prefills again with K8 held element by element
   against its plain version on every attention layer's own inputs and
   the first token the served one, and the SMOKE config on the card
   against the CPU (logits within TOL_SMOKE_LOGITS, greedy tokens equal);
   prefill and decode times, tokens/s, peak memory and the init seconds
   of each model are printed, with no gate, and a ``torch.profiler``
   breakdown of one prefill and four decode steps;
6b. K8's backward (run after K8's forward cases, before serving) — the
   three hand-written kernels (Delta, dK/dV, dQ) against the plain
   backward on the kernel's own output and lse, element by element, at
   the forward's main shape in bf16, train_lm's attention (float32, D =
   64), D = 112, non-causal S != T, a window, G = 48, p rounded and small
   float32 cases (one windowed at G = 48, S = 515), each launching each
   kernel once, dK/dV and dQ on the route ``flash_attention_bwd_route``
   names (bf16 on the tensor cores, "mma", float32 on FMA, "fma"; checked
   by the route counters), the main and D = 112 cases also on "fma"
   through a view off the 16-byte grid, and every case run twice for the
   same bits; at every case on "fma" the dK/dV split's plan in Python
   against the C launcher's, its grid within one wave; the forward's lse
   against the plain one; Delta bit for bit against
   ``delta_in_kernel_order`` at every case, and through views off the
   16-byte grid (its scalar variant, counted as such) at the main and
   D = 112 cases; planted faults (a GQA head left out of dK/dV; one
   lane's chunk left out of Delta at train_lm's shape) that the bars must
   reject by more than 1000x; each kernel's time on
   each route at the main shape (the median of 20 calls after a warm-up,
   with its spread), its operation bound and the plain backward's and
   ``scaled_dot_product_attention``'s backward times (comparison only);
8. train — the training path: (a) examples/train_lm.py's default run on
   the port (lm_100m: 6 layers, d 768, vocab 32768, float32, K8's FMA
   route forward and backward; B = 4, S = 192, 300 AnalogNewton steps,
   three refreshes, each one ``solve_batch(analog_2n)`` of 768 systems of
   n = 32 on the card, a checkpoint every 100 steps into a temporary
   directory), failing unless every loss is finite, the last logged loss
   is at least 0.2 nats below the first, the refresh accounting is three
   calls on one pattern and ``restore_latest`` gives back the final state
   bit for bit; then (``train_profile``) a few steps of the same run from
   a fresh state under ``torch.profiler``: device ms a step by kind (K8's
   forward, each backward kernel, matrix products, the rest, and the
   optimizer's update), the busy share and the host ms a step; (b)
   Qwen3-8B at its published width with 2 of its 36
   layers, bf16, AdamW, B = 1, S = 2048, 3 steps (finite losses), the
   first layer's attention inputs captured and the backward kernels held
   against the plain backward on them; (c) every family's SMOKE config,
   one train step on the card and on the CPU from one state (loss,
   gradients, updated parameters within the CPU parity bars); ms per
   step, the refresh wall, the loss curve, K8's launches and peak memory
   are printed;
8b. dryrun — the dry run and the roofline counter
   (``repro_torch.launch.dryrun``, ``repro_torch.roofline``): (a) every
   arch x shape cell (10 x 4) traced on ``meta`` on ``single_card`` and
   on both production meshes (``single_pod`` and ``multi_pod``, one rank
   of a fake process group of 512, the attention batch layout on) with
   the card's spec, 120 cells in DRYRUN_WORKERS spawned processes while
   (b) and (c) run on the card, each ``ok`` or ``skipped`` with the
   reference's reason (``long_500k`` on a full-attention arch), a
   production mesh's ok cell with its ranks (256 or 512), collectives
   counted, at least one leaf gathered and its compute (``"tensor
   parallel over model"`` for the dense, vlm, SSM, hybrid and encdec
   families, ``"expert parallel over model"`` for Granite-MoE, ``"tensor
   parallel inside experts over model"`` for Mixtral); its
   dominant term, bound,
   ``temp_size_b`` and collective bytes printed with the host seconds;
   (b) the counter held against the card on Qwen3-8B's 1974-token
   prefill and one decode step after it (36 layers, bf16), one
   tensor-parallel rank's decode step of its ``decode_32k`` on
   ``single_pod`` at full shape (8 rows over its 8 of each head's 128
   columns of a 32,768-token cache, its share of every leaf, the
   collectives on a fake world of TP_RANKS "model" ranks, which moves
   nothing; its share printed), a Qwen3-8B train step at 2 layers
   (bf16, AdamW, B = 1, S = 2048) and train_lm's step (float32, B = 4,
   S = 192) under AdamW:
   each step counted on ``meta`` and on the card, failing unless both
   counts' FLOPs and bytes are equal and the step's kernel time under the
   profiler is at least its roofline bound and the modelled peak of live
   bytes is within PEAK_RTOL (and PEAK_ATOL_BYTES) of what the step added
   to ``torch.cuda.memory_allocated`` at its peak, with the share (bound
   over kernel time) and the peak of temporaries printed; (c) K8's
   counted FLOPs and bytes (on ``meta`` at each K8 row's shape) equal to
   the kernels line's, whose K8 rows take them from the same formulas
   (``flash_attention.forward_cost``/``backward_costs``); (d) for
   Qwen3-8B, Command-R and Granite-20B at full width and 2 layers, a
   tensor-parallel rank's prefill of 2048 tokens in heads mode (2, 4 and
   3 q heads over one kv head, on the fake world), K8 launched at the
   rank's heads once a layer (these shapes' K8 rows of the kernels line,
   held against the plain version in phase 6, count these launches); (e)
   for Mixtral-8x22B and Granite-MoE at full width and 2 layers, a
   rank's prefill of 2048 tokens on the same fake world (heads mode: 3 q
   heads and 1 q head over one kv head; Mixtral's 1,024 of each expert's
   16,384 ff columns, Granite-MoE's 2 of 32 experts), counted as (b)'s
   steps, with its kernel time by kind (the expert products under
   ``aten::bmm``, K8, the rest) and K8's launches, once a layer, counted
   from zero over the counted prefill; (f) for Zamba2-7B at full width
   and 6 layers (one shared-attention application and its 6 Mamba
   blocks), a rank's prefill of 2048 tokens on the same fake world (its 7
   of 112 SSM heads and 448 of 7,168 ``inner`` columns; the shared
   attention in heads mode, 2 q and 2 kv heads, D = 112), counted as
   (b)'s steps, with its kernel time by kind (the SSD's products under
   ``aten::bmm``, K8, the rest) and K8's one launch; (g) for
   Whisper-base at full width and depth (6 encoder and 6 decoder
   layers), a rank's prefill of its 1,500 frames and a 64-token prompt
   on the same fake world (head_dim mode: its 4 of each head's 64
   columns, q, k and v gathered to whole heads; 128 of 2,048 ``ff``
   columns; a sixteenth of the padded vocab), counted as (b)'s steps,
   with its kernel time by kind (K8, the GELU MLP under its
   ``record_function`` range, the rest) and K8's 18 launches at whole
   heads (6 in the encoder, 6 in the decoder's self-attention, 6 in its
   cross attention, counted by attention in one more prefill); the
   phase's wall printed;
8c. distributed — the sharded train step
   (``repro_torch.training.step.make_sharded_train_step``) on a world of
   one: NCCL with a ``FileStore`` rendezvous in a temporary directory,
   ``make_debug_mesh((1, 1))`` on cuda:0; for each of DIST_ARCHS, the
   SMOKE Qwen3-8B (dense: tensor parallel over a "model" axis of one),
   the SMOKE Granite-MoE 1B (expert parallel), the SMOKE Mixtral (tensor
   parallel inside the experts), the SMOKE Zamba2 (hybrid: its Mamba
   blocks and shared attention tensor parallel), the SMOKE InternVL2
   (vlm: its dense blocks tensor parallel) and the SMOKE Whisper
   (encdec: its encoder, decoder and cross attention and its GELU MLPs
   tensor parallel), each failing unless the dry run names its route so
   and the step's leaves took it (``blocks.0.moe.w_gate`` on "model" at
   dim 0 for Granite-MoE and 2 for Mixtral, ``blocks.0.w_x`` at dim 1
   for Zamba2, ``blocks.0.mlp.w_gate`` at dim 1 for InternVL2,
   ``dec_blocks.0.mlp.w_up`` at dim 1 for Whisper), all float32 (K8's
   FMA route forward and backward), AdamW(1e-3), tokens = targets = 3
   (4 x 32), InternVL2 with seeded patch embeddings and Whisper with
   seeded frame embeddings: two steps,
   ``plan_mesh`` of the world, a re-shard under ``make_rules(cfg,
   model_axis=1)``, two more steps, launch counts reset just before and
   read just after (failing unless K8's forward and every backward
   kernel launched), the losses and the parameters after steps 2 and 4
   held against the one-device step on the card from the same state bit
   for bit, or, where they differ, with why (whether the one-device step
   repeats itself bit for bit) and within the CPU test's bars
   (tests/test_torch_distributed.py); ``compress_int8`` on the card
   against the CPU over three rounds of error feedback, bit for bit (and
   within one float32 ulp), with each round's scales on both devices by
   a tensor divisor and by a Python-scalar one;
9. the kernels line (K1-K8; K5, K6 and K8 one row per route, K4 with its
   split, K1 and K3 with their cluster layout, K7a with its route; K1-K4
   count the launches of the slice and of the settling phase's predicted
   form and of the solve service's and the analysis phase's settling
   tickets, ``launches_by_phase``; K8's rows theirs by phase and family,
   ``launches_by_family``, with a row at D = 112 and the FMA route's rows
   at the main shape (which also counts the distributed phase's) and at
   train_lm's, the latter the train phase's, and a row at each
   tensor-parallel rank's heads (Zamba2's at D = 112; Whisper's rank one
   a row for its encoder, decoder and cross attention, non-causal but the
   decoder's), phase 8b's rank prefills' launches;
   K8's backward kernels a row
   each per dtype and route (bf16 on the tensor cores, float32 on FMA),
   with the train and the distributed phases' launches by case, Delta's
   also by variant and with the device time of its launch over zero
   rows), the nvidia-smi line, and the contract's last line.

It imports no JAX and nothing of the JAX package.  Without CUDA, or
outside a checkout (no ``src/repro_torch`` beside it), it exits with
code 2 before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

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


def cuda_ms_spread(fn, reps: int = 20, warmup: int = 3) -> dict:
    """Device milliseconds of ``reps`` single calls of ``fn()`` after
    ``warmup`` calls, each between two events on the stream: the median
    and the spread (min, max)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(stop) for start, stop in events)
    return dict(median=float(np.median(ms)), min=ms[0], max=ms[-1], calls=reps)


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


def card_spec():
    """The card's data-sheet peaks (``repro_torch.roofline.analysis``,
    chosen by the card's name; an unknown card raises)."""
    from repro_torch.roofline.analysis import spec_for_card

    return spec_for_card(torch.cuda.get_device_name(0))


def bound(bytes_moved: float, flops: float,
          dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """Least time of one call (``repro_torch.roofline.analysis.bound``):
    its inputs read once and outputs written once at the card's HBM rate,
    or its flops at the card's peak for ``dtype`` (the inputs' type:
    float32 on FMA, bf16 on the tensor cores), the larger.  A cold call
    brings its inputs from HBM; where the timing loop keeps them in L2
    (the ELL operands, small dense ones) the bound is loose."""
    from repro_torch.roofline.analysis import bound as roofline_bound

    hw = card_spec()
    return roofline_bound(bytes_moved, flops, hw.flops_s(dtype), hw)


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
    k2_lib = lambda: (w_t * z0.unsqueeze(1).expand(-1, k, -1).gather(2, idx_l)).sum(1)  # noqa: E731
    t_k2l, t_k2lg = cuda_ms(k2_lib, 50), graph_ms(k2_lib, 50)
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
            library_ms=t_k2l, library_device_ms=t_k2lg, max_abs_err=e2, max_abs_err_bf16=e2b,
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
    t_k4lg = graph_ms(lambda: torch.baddbmm(cz, m, zz), 50)
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
            library_ms=t_k4l, library_device_ms=t_k4lg, max_abs_err=e4, bytes=k4_bytes,
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
# phase 3c: solve_service — the solve service on CUDA streams, its
# sessions, its Newton and FEM clients, and mesh=
# ---------------------------------------------------------------------------

# benchmarks/solve_service.py:101-121, the repo's own service stream (the
# benchmark imports the JAX package, so the mix is copied here)
SERVICE_MIX = (
    (16, "analog_2n", "spd"),
    (16, "analog_2n", "sdd"),
    (16, "analog_n", "spd"),
    (16, "cholesky", "spd"),
    (24, "analog_2n", "spd"),     # off-grid: pads into the n = 32 bucket
    (64, "analog_2n", "spd"),
    (64, "cholesky", "spd"),
    (192, "analog_2n", "spd"),
    (192, "cholesky", "spd"),
)
SERVICE_REPEAT = 8            # 72 requests
SERVICE_SLOTS = 8
PARITY_ATOL = 1e-9            # the benchmark's
# a FEM stream up to the size sweep's scale: n = 256, 576, 1024
SERVICE_FEM = (32, ((16, 16), (24, 24), (32, 32)))
SERVICE_SETTLE = ((N_DENSE_SMALL, "transient_sweep", "diag"),
                  (N_DENSE, "transient_step_batched", "diag"),
                  (N_DENSE, "transient_step_batched", "spectral"))
SERVICE_FAULT_RATES = (0.05, 0.20)   # split 50/25/25, as the benchmark's
# chaos at tests/test_faults.py's 2 slots: 36 dispatches of the stream, so
# each rate draws faults (at 8 slots its 9 dispatches draw none from the
# benchmark's fault seed, SEED + 1)
CHAOS_SLOTS = 2
NEWTON_SHAPE = (8, 64)
STAGES = ("wall_s", "host_build_s", "device_wait_s", "settle_finish_s", "unpack_s")


def service_stream() -> list[tuple]:
    """The benchmark's mix, SERVICE_REPEAT times, from default_rng(SEED)."""
    from repro_torch.data.spd import random_rhs_from_solution, random_sdd, random_spd

    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(SERVICE_REPEAT):
        for n, method, kind in SERVICE_MIX:
            a = random_sdd(rng, n) if kind == "sdd" else random_spd(rng, n)
            _x, b = random_rhs_from_solution(rng, a)
            out.append((a, b, method))
    return out


def serve(stream: list, label: str, direct: list, **service_kw) -> tuple:
    """Submit ``stream`` to a fresh service and drain it once.  Fails
    unless every request is answered exactly once and every delivered x is
    within PARITY_ATOL of its direct solve.  Returns (service, answers in
    submission order, drain wall seconds, summary row)."""
    from repro_torch.serving import SolveService
    from repro_torch.serving.faults import SolveError

    svc = SolveService(**{"batch_slots": SERVICE_SLOTS, **service_kw})
    rids = [svc.submit(a, b, method=m) for a, b, m in stream]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(set(out) == set(rids) and len(svc.queue) == 0, f"{label}: not answered exactly once")
    res = [out[r] for r in rids]
    errors = [r.kind for r in res if isinstance(r, SolveError)]
    worst = max((float(np.max(np.abs(r.x - d))) for r, d in zip(res, direct)
                 if not isinstance(r, SolveError)), default=0.0)
    check(worst <= PARITY_ATOL, f"{label}: delivered x {worst} from the direct solve")
    st = svc.stats
    row = dict(phase="solve_service", case=label, requests=len(stream),
               streams=st["devices"], inflight_per_device=st["inflight_per_device"],
               batch_slots=st["batch_slots"],
               wall_s=wall, requests_per_s=len(stream) / wall, worst_abs_err=worst,
               errors=errors, stage_s={k: st[k] for k in STAGES},
               buckets=st["buckets"], pad_overhead=st["pad_overhead"],
               retries=st["retries"], bisections=st["bisections"],
               quarantines=st["quarantines"], fault_injections=st["fault_injections"],
               breaker=st["breaker"])
    return svc, res, wall, row


def phase_solve_service(dev) -> dict:
    """The solve service through its public entry points on the card:
    (a) the benchmark's stream, (b) a FEM stream, (c) settling tickets
    (K3, K4), (d) streams and in-flight depth, (e) chaos and quarantine,
    (f) Newton through a session, (g) mesh=.  Returns the K1-K4 launches
    of the settling tickets' drains."""
    from repro_torch import solve, solve_batch
    from repro_torch.data.fem import mesh_stream
    from repro_torch.distributed.sharding import solver_mesh
    from repro_torch.optim.batched_newton import BatchedNewtonConfig, newton_batch
    from repro_torch.serving import SolveService
    from repro_torch.serving.faults import FaultInjector, FaultPlan, SolveError

    t_phase = time.perf_counter()
    launches: dict[str, int] = {}
    stream = service_stream()
    direct = [solve(a, b, method=m, device=dev).x for a, b, m in stream]

    # (a) the repo's own stream on one CUDA stream, double-buffered
    svc, res, _wall, row = serve(stream, "stream", direct, devices=[dev])
    check(not row["errors"], f"stream: errors {row['errors']}")
    for key, bucket in svc.stats["buckets"].items():
        if key.endswith("/analog_2n"):
            check(bucket["pattern_derivations"] == 1,
                  f"stream: {key} derived {bucket['pattern_derivations']} patterns")
    emit(row)

    # (d) one and two CUDA streams of the card, one and two micro-batches
    # in flight: the same bytes
    xs = {}
    for n_streams in (1, 2):
        for inflight in (1, 2):
            _svc, res, _wall, row = serve(stream, f"streams_{n_streams}_inflight_{inflight}",
                                          direct, devices=[dev] * n_streams,
                                          inflight_per_device=inflight)
            check(not row["errors"], f"{row['case']}: errors {row['errors']}")
            xs[(n_streams, inflight)] = [r.x for r in res]
            emit(row)
    first = xs[(1, 1)]
    for key, got in xs.items():
        check(all(np.array_equal(g, f) for g, f in zip(got, first)),
              f"streams {key}: delivered bytes differ from one stream at inflight 1")

    # (b) a FEM stream up to the size sweep's scale, at inflight 1 and 2
    count, grids = SERVICE_FEM
    meshes = list(mesh_stream(SEED, count, grids=grids))
    fem = [(m.a, m.b, "analog_2n") for m in meshes]
    fem_direct = [solve(a, b, method="analog_2n", device=dev).x for a, b, _m in fem]
    fem_x = {}
    for inflight in (1, 2):
        svc, res, _wall, row = serve(fem, f"fem_inflight_{inflight}", fem_direct,
                                     devices=[dev], inflight_per_device=inflight)
        check(not row["errors"], f"fem: errors {row['errors']}")
        for key, bucket in svc.stats["buckets"].items():
            check(bucket["pattern_derivations"] == 1,
                  f"fem: {key} derived {bucket['pattern_derivations']} patterns")
        row["grids"] = sorted({(m.nx, m.ny) for m in meshes})
        fem_x[inflight] = [r.x for r in res]
        emit(row)
    check(all(np.array_equal(g, f) for g, f in zip(fem_x[1], fem_x[2])),
          "fem: inflight 1 and 2 delivered different bytes")

    # (c) settling tickets at exact n: the settle sweep of the service's
    # finish phase launches K3 (n = 48) and K4 (n = 256), and each ticket
    # equals one solve_batch of the same systems
    for n, kernel, dt_policy in SERVICE_SETTLE:
        label = f"settle_dense_n{n}_{dt_policy}"
        a, _x, b = systems(n, SERVICE_SLOTS)
        opts = dict(method="analog_2n", compute_settling=True, settle_method="euler",
                    settle_max_steps=MAX_STEPS, settle_dt_policy=dt_policy)
        svc = SolveService(batch_slots=SERVICE_SLOTS, devices=[dev])
        rids = [svc.submit(a[k], b[k], **opts) for k in range(SERVICE_SLOTS)]
        out, counts, _t, wall = drive(lambda t: svc.drain(), launches)
        check(counts[kernel] > 0, f"{label}: {kernel} was not launched from the service")
        want = solve_batch(a, b, device=dev, **opts)
        steps = []
        for k, rid in enumerate(rids):
            r = out[rid]
            check(not isinstance(r, SolveError), f"{label}: ticket {k} failed: {r}")
            check(r.info["service_n_padded"] == n, f"{label}: ticket {k} was padded")
            check(np.array_equal(r.x, want.x[k]) and r.stable == bool(want.stable[k])
                  and r.info["settle_steps"] == int(want.info["settle_steps"][k]),
                  f"{label}: ticket {k} differs from solve_batch")
            steps.append(r.info["settle_steps"])
        st = svc.stats
        emit(dict(phase="solve_service", case=label, n=n, tickets=SERVICE_SLOTS,
                  launches={k: v for k, v in counts.items() if v}, settle_steps=steps,
                  stable=[out[r].stable for r in rids], wall_s=wall,
                  stage_s={k: st[k] for k in STAGES}))

    # (e) chaos at the benchmark's rates, then a sick stream beside a
    # healthy one: every ticket answered once, every delivery clean
    for rate in SERVICE_FAULT_RATES:
        plan = FaultPlan(seed=SEED + 1, rates={"device_fault": rate * 0.50,
                                               "nonfinite": rate * 0.25,
                                               "build_error": rate * 0.25})
        _svc, _res, _wall, row = serve(stream, f"chaos_{rate:.2f}", direct, devices=[dev],
                                       batch_slots=CHAOS_SLOTS,
                                       fault_injector=FaultInjector(plan),
                                       breaker_backoff_s=0.01)
        check(row["fault_injections"] > 0, f"{row['case']}: nothing injected")
        emit(row)
    plan = FaultPlan(seed=SEED + 1, rates={"device_fault": 1.0}, devices=(0,))
    svc, res, _wall, row = serve(stream, "quarantine", direct, devices=[dev, dev],
                                 fault_injector=FaultInjector(plan), breaker_threshold=1,
                                 breaker_backoff_s=30.0, max_attempts=10)
    check(not row["errors"], f"quarantine: errors {row['errors']}")
    check(row["quarantines"] >= 1 and row["breaker"]["states"] == ["open", "closed"],
          f"quarantine: {row['quarantines']} quarantines, breaker {row['breaker']}")
    emit(row)

    # (f) Newton through a session: the convex quartic of
    # tests/test_solve_sessions.py at B = 8, n = 64
    bsz, n = NEWTON_SHAPE
    rng = np.random.default_rng(SEED)
    t = rng.normal(size=(bsz, n))
    m = rng.normal(size=(bsz, n, n)) / np.sqrt(n)
    q = 0.5 * np.einsum("bij,bkj->bik", m, m) + np.eye(n)

    def grad_hess(x):
        d = x - t
        return (np.einsum("bij,bj->bi", q, d) + d ** 3,
                q + (3.0 * d ** 2)[:, :, None] * np.eye(n))

    cfg = BatchedNewtonConfig(method="analog_2n", tol=1e-9, max_iter=30)
    t0 = time.perf_counter()
    tr_direct = newton_batch(grad_hess, np.zeros((bsz, n)), cfg, device=dev)
    direct_s = time.perf_counter() - t0
    sess = SolveService(batch_slots=SERVICE_SLOTS, devices=[dev]).session(method="analog_2n")
    t0 = time.perf_counter()
    tr = newton_batch(grad_hess, np.zeros((bsz, n)), cfg, rounds=sess)
    session_s = time.perf_counter() - t0
    newton_err = float(np.max(np.abs(tr.x - tr_direct.x)))
    check(bool(tr.converged.all()), "newton: a system did not converge through the session")
    check(np.array_equal(tr.iterations, tr_direct.iterations),
          f"newton: iterations {tr.iterations.tolist()} vs {tr_direct.iterations.tolist()}")
    check(newton_err <= 1e-7, f"newton: x {newton_err} from the direct executor")
    check(sess.pattern_derivations == 1, f"newton: {sess.pattern_derivations} patterns")
    emit(dict(phase="solve_service", case=f"newton_b{bsz}_n{n}",
              iterations=tr.iterations.tolist(), rounds=tr.solve_rounds,
              pattern_derivations=sess.pattern_derivations, max_abs_err=newton_err,
              session_s=session_s, direct_s=direct_s))

    # (g) mesh=: a mesh of the one card gives the bytes of device="cuda"
    a, _x, b = systems(N_DENSE, SERVICE_SLOTS)
    for method in ("analog_2n", "cholesky"):
        whole = solve_batch(a, b, method=method, device=dev)
        split = solve_batch(a, b, method=method, mesh=solver_mesh())
        check(np.array_equal(split.x, whole.x), f"mesh: {method} differs from device=cuda")
    emit(dict(phase="solve_service", case="mesh", n=N_DENSE, batch=SERVICE_SLOTS,
              devices=[str(d) for d in solver_mesh().devices], bit_equal=True))

    for kernel in ("transient_sweep", "transient_step_batched"):
        check(launches.get(kernel, 0) > 0, f"solve_service: {kernel} was not launched")
    emit(dict(phase="solve_service", case="launch_totals", launches=launches,
              wall_s=time.perf_counter() - t_phase))
    return launches


# ---------------------------------------------------------------------------
# phase 3d: analysis — the runtime sync gate and host copies by phase label
# ---------------------------------------------------------------------------

# the cudaStreamSynchronize calls scripts/service_overlap.py's profile
# counted in one drain of the benchmark's mix on an H100 (700 W) while
# every host-to-device copy of the dispatch phase still synchronized
RECORDED_STREAM_SYNCS = 192
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
              "cudaEventSynchronize")


def site(path: str) -> str:
    """``file:line`` of a warning, its path shortened to the last two parts."""
    name, _, line = path.rpartition(":")
    return "/".join(Path(name).parts[-2:]) + ":" + line


def outer_op(event) -> str:
    """The outermost ``aten::`` operation a profiler event ran under."""
    name, parent = "(none)", getattr(event, "cpu_parent", None)
    while parent is not None:
        if parent.name.startswith("aten::"):
            name = parent.name
        parent = getattr(parent, "cpu_parent", None)
    return name


def watched(dev, label: str, fn) -> tuple[object, dict]:
    """Run ``fn`` under a SyncWatch of tensors on ``dev``'s type (on the
    card with torch's synchronizing-operation warnings recorded by label);
    returns fn's result and the summary row."""
    from collections import Counter

    from repro_torch.analysis import SyncWatch

    t0 = time.perf_counter()
    with SyncWatch(device_type=dev.type) as watch:
        result = fn()
    wall = time.perf_counter() - t0
    by_entry = Counter(f"{scope} {entry}" for scope, entry in watch.calls)
    aten_by_site = Counter(f"{scope} {site(where)}" for scope, where in watch.aten_calls)
    row = dict(phase="analysis", case=label, wall_s=wall, counts=watch.counts,
               total=watch.total(), by_entry=dict(by_entry),
               aten_counts=watch.aten_counts, aten_total=sum(watch.aten_counts.values()),
               aten_by_site=dict(aten_by_site.most_common()),
               calls=watch.calls[:10], aten_calls=[[c, site(w)] for c, w in watch.aten_calls[:10]])
    return result, row


def phase_analysis(dev) -> dict:
    """The runtime sync gate on the card (1 and 2 streams), a planted
    dispatch-phase .item() that it must count once, then the host copies by
    label of one drain of the benchmark's mix and of the settling tickets
    (K3 at n = 48, K4 at n = 256), with torch's synchronizing-operation
    warnings beside them and the mix drain's CUDA syncs from the profiler.
    Returns the K1-K4 launches of the settling drains."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import solve_batch
    from repro_torch.analysis import SyncWatch, run_service_gate
    from repro_torch.serving import SolveService, solve_service
    from repro_torch.serving.faults import SolveError

    for n_streams in (1, 2):
        report = run_service_gate(device=dev, n_streams=n_streams)
        emit(dict(phase="analysis", case=f"gate_{n_streams}_streams", **report))
        check(report["ok"] and report["dispatch_aten_syncs"] == 0,
              f"gate at {n_streams} streams: {report}")

    orig, planted = solve_service.solve_batch_submit, []

    def submit(*args, **kwargs):
        if SyncWatch._active is not None and not planted:
            planted.append(torch.zeros((), device=dev).item())
        return orig(*args, **kwargs)

    solve_service.solve_batch_submit = submit
    try:
        report = run_service_gate(device=dev)
    finally:
        solve_service.solve_batch_submit = orig
    emit(dict(phase="analysis", case="gate_planted_item", **report))
    check(len(planted) == 1 and report["dispatch_syncs"] == 1 and not report["ok"],
          f"planted .item(): {len(planted)} planted, {report['dispatch_syncs']} counted, "
          f"ok {report['ok']}")

    # (a) the benchmark's mix: a plain drain, a watched one (the same bytes),
    # and a profiled one for the CUDA runtime's own sync count
    stream = service_stream()

    def mix_service():
        svc = SolveService(batch_slots=SERVICE_SLOTS, devices=[dev])
        rids = [svc.submit(a, b, method=m) for a, b, m in stream]
        return svc, rids

    svc, rids = mix_service()
    plain = svc.drain()
    svc, rids_w = mix_service()
    torch.cuda.synchronize()
    out, row = watched(dev, "mix_drain", svc.drain)
    torch.cuda.synchronize()
    check(all(np.array_equal(out[r].x, plain[p].x) for r, p in zip(rids_w, rids)),
          "mix drain: the watched drain delivered other bytes")
    check(row["counts"].get("dispatch", 0) == 0 and row["aten_counts"].get("dispatch", 0) == 0,
          f"mix drain: dispatch syncs {row['counts']}, synchronizing operations "
          f"{row['aten_counts']}")
    svc, _rids = mix_service()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.drain()
    from collections import Counter

    cuda_calls = {e.key: e.count for e in prof.key_averages() if e.key in SYNC_CALLS}
    stream_syncs_by_op = Counter(outer_op(e) for e in prof.events()
                                 if e.name == "cudaStreamSynchronize")
    row.update(requests=len(stream), profiled_cuda_calls=cuda_calls,
               profiled_stream_syncs_by_op=dict(stream_syncs_by_op.most_common()),
               recorded_stream_syncs=RECORDED_STREAM_SYNCS)
    emit(row)

    # (c) settling tickets: the sweep's poll under settle_poll, K3 and K4 launched
    launches: dict[str, int] = {}
    for n, kernel, dt_policy in SERVICE_SETTLE[:2]:
        a, _x, b = systems(n, SERVICE_SLOTS)
        opts = dict(method="analog_2n", compute_settling=True, settle_method="euler",
                    settle_max_steps=MAX_STEPS, settle_dt_policy=dt_policy)
        svc = SolveService(batch_slots=SERVICE_SLOTS, devices=[dev])
        rids = [svc.submit(a[k], b[k], **opts) for k in range(SERVICE_SLOTS)]
        label = f"settle_dense_n{n}_{dt_policy}"
        (out, row), counts, _t, _wall = drive(lambda t: watched(dev, label, svc.drain),
                                              launches)
        check(counts[kernel] > 0, f"{row['case']}: {kernel} was not launched")
        want = solve_batch(a, b, device=dev, **opts)
        for k, rid in enumerate(rids):
            r = out[rid]
            check(not isinstance(r, SolveError) and np.array_equal(r.x, want.x[k])
                  and r.info["settle_steps"] == int(want.info["settle_steps"][k]),
                  f"{row['case']}: ticket {k} differs from solve_batch")
        check(row["counts"].get("settle_poll", 0) > 0 and row["counts"].get("dispatch", 0) == 0,
              f"{row['case']}: syncs by label {row['counts']}")
        row["launches"] = {k: v for k, v in counts.items() if v}
        emit(row)
    for kernel in ("transient_sweep", "transient_step_batched"):
        check(launches.get(kernel, 0) > 0, f"analysis: {kernel} was not launched")
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
RAGGED_MVM = (((300, 513, 1), "fma", "fma"), ((4000, 4004, 1), "fma", "fma"),
              ((300, 513, 5), "mma_scalar", "f32_scalar"),
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
RAGGED_STEP = (((137, 1), "column", "column"), ((8190, 1), "column", "column"),
               ((137, 17), "wide", "wide"),
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
# the routes the counted kernel-API run must take: K6's b = 1 products
# (float32 and bf16) the GEMV, its b = 64 float32 one the split-k product
# with 16-byte copies, its bf16 one the tensor cores with 16-byte copies;
# K7a its 16-byte loads; K5's 200 float32 steps and its bf16 step on 16
# columns the split-k product with 16-byte copies, its steps on one column
# (float32 and bf16) the GEMV
API_ROUTES = {"crosspoint_mvm": dict(mma_async=1, mma_scalar=0, f32_async=1, f32_scalar=0,
                                     fma=2),
              "colabs": dict(vec16=1, scalar=0),
              "transient_step": dict(narrow_async=K5_STEPS + 1, narrow_scalar=0, column=2,
                                     wide=0)}
# K5's launches of that run by dtype and route: the 200 float32 steps and
# the bf16 step share the narrow route's name
API_K5_BY_DTYPE = {"float32": dict(narrow_async=K5_STEPS, narrow_scalar=0, column=1, wide=0),
                   "bfloat16": dict(narrow_async=1, narrow_scalar=0, column=1, wide=0)}
# the GEMV's launches of that run by variant (gemv.gemv_variant): each on
# the 16-byte loads
API_GEMV_VARIANTS = {"transient_step": dict(vec16=2, scalar=0),
                     "crosspoint_mvm": dict(vec16=2, scalar=0)}
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


def gemv_warp_rows_skipped(gemv_fn, m: int, want: torch.Tensor) -> torch.Tensor:
    """A planted fault: the GEMV (``gemv_fn()``, m rows) with the rows of
    one warp, the one that owns the largest output, left unwritten
    (zero)."""
    from repro_torch.kernels import gemv

    out = gemv_fn()
    top = int(want.reshape(-1).abs().argmax())
    plan = gemv.gemv_plan(m)
    rows = next(rows for b in range(plan["blocks"]) for w in range(plan["warps"])
                if top in (rows := gemv.gemv_rows_of(m, b, w)))
    out.view(m, -1)[rows] = 0
    return out


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
                g=g, g_bf=g.bfloat16(), y=y, y_bf=y.bfloat16(), v=v, v_bf=v.bfloat16(), m=m,
                c=c, z=z, m_bf=m.bfloat16(), c_bf=c.bfloat16(), z_bf=z.bfloat16(),
                z_col=z[:, 0].contiguous(), c_col=c[:, 0].contiguous(),
                z_col_bf=z[:, 0].contiguous().bfloat16(),
                c_col_bf=c[:, 0].contiguous().bfloat16(), nz=nz, dt=dt)


def drive_api(op: dict) -> tuple[dict, dict, float]:
    """The kernel API's main path, once, with the launch counts reset just
    before and read just after: the fused transform, the crossbar at its
    DC voltages (in float32 and bf16), with 64 voltage vectors and in bf16,
    200 steps of one circuit from 16 start states, and one step of it in
    bf16 and one of its step response alone (one column, in float32 and
    bf16).  K6's GEMV launches are also split by dtype
    (``crosspoint_mvm_fma_by_dtype``), read from its route count around
    each call."""
    from repro_torch.kernels import ops

    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = dict(transform=ops.spd_transform_arrays(op["a"], op["b"]),
               i_dc=ops.crosspoint_mvm(op["g"], op["y"]))
    fma_f32 = mvm.crosspoint_mvm.launches_by_route["fma"]
    out["i_dc_bf"] = ops.crosspoint_mvm(op["g_bf"], op["y_bf"])
    fma_bf16 = mvm.crosspoint_mvm.launches_by_route["fma"] - fma_f32
    out["i_v"] = ops.crosspoint_mvm(op["g"], op["v"])
    out["i_bf"] = ops.crosspoint_mvm(op["g_bf"], op["v_bf"])
    z = op["z"]
    for _ in range(K5_STEPS):
        z = ops.transient_step(op["m"], z, op["c"], 1.0)
    out["z"] = z
    out["z_bf"] = ops.transient_step(op["m_bf"], op["z_bf"], op["c_bf"], 1.0)
    out["z_b1"] = ops.transient_step(op["m"], op["z_col"], op["c_col"], 1.0)
    out["z_b1_bf"] = ops.transient_step(op["m_bf"], op["z_col_bf"], op["c_col_bf"], 1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    counts["crosspoint_mvm_fma_by_dtype"] = dict(float32=fma_f32, bfloat16=fma_bf16)
    by_route = ops.launch_counts_by_route()
    for name in API_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the kernel-API path")
    for name, want in API_ROUTES.items():
        check(by_route[name] == want, f"{name} routes on the kernel-API path: {by_route[name]}")
        counts[f"{name}_by_route"] = by_route[name]
    counts["transient_step_by_dtype"] = ops.launch_counts_by_dtype()
    check(counts["transient_step_by_dtype"] == API_K5_BY_DTYPE,
          f"K5 by dtype on the kernel-API path: {counts['transient_step_by_dtype']}")
    counts["gemv_by_variant"] = ops.launch_counts_by_gemv_variant()
    check(counts["gemv_by_variant"] == API_GEMV_VARIANTS,
          f"the GEMV by variant on the kernel-API path: {counts['gemv_by_variant']}")
    return out, counts, wall


def ragged_checks(dev) -> dict:
    """Each kernel at ragged shapes against its plain version: K5 in both
    dtypes on every route (RAGGED_STEP: n off the tile, nb = 1, 2, 5, 8,
    12, 16, > 16) and off the 16-byte grid, K6 in both dtypes once or more
    per route (RAGGED_MVM) and off the 16-byte grid, K7a on both routes
    (RAGGED_COLABS) and off the grid, bit for bit against its order in
    plain PyTorch, and the GEMV (K6 b = 1, K5 nb = 1) likewise, on both
    variants; each checked for the route it took (the GEMV also for its
    variant).  Returns the errors and the GEMV's bitwise checks."""
    from repro_torch.kernels import build, gemv, ops
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
    bits: dict = {}

    def gemv_held(label, got, want, variant, kernel, before):
        # the GEMV bit for bit its order, on the variant gemv_variant names
        bits[label] = bool(torch.equal(got, want))
        check(bits[label], f"{label}: not bit for bit the GEMV's order in plain PyTorch")
        moved = ops.launch_counts_by_gemv_variant()[kernel][variant] - before
        check(moved == 1, f"{label} did not take the GEMV's {variant} variant")

    def gemv_before(kernel, variant):
        return ops.launch_counts_by_gemv_variant()[kernel][variant]

    for (m_, k_, nb), route_bf16, route_f32 in RAGGED_MVM:
        g, v = t((m_, k_)), t((k_, nb))
        for gd, vd, route in ((g, v, route_f32), (g.bfloat16(), v.bfloat16(), route_bf16)):
            what = f"K6 {gd.dtype} {(m_, k_, nb)}"
            variant = gemv.gemv_variant(gd.dtype, k_, True)
            before = gemv_before("crosspoint_mvm", variant)
            got = routed("crosspoint_mvm", route, what, lambda: mvm.crosspoint_mvm(gd, vd))
            if gd.dtype == torch.float32:
                hold(errs, "crosspoint_mvm", got, mvm.crosspoint_mvm_plain(gd, vd), TOL_MVM_F32)
            else:
                hold_mvm_bf16(errs, "crosspoint_mvm_bf16", got, mvm.crosspoint_mvm_plain(gd, vd))
            if nb == 1:
                gemv_held(what, got, mvm.crosspoint_mvm_in_kernel_order(gd, vd), variant,
                          "crosspoint_mvm", before)
    for dtype in (torch.float32, torch.bfloat16):     # the GEMV on views off the grid
        g = t(300 * 1024 + 1, dtype)[1:].view(300, 1024)
        v = t(1025, dtype)[1:, None]
        check(not build.aligned16(g, v), "an off-grid view is aligned")
        what = f"K6 {dtype} b = 1 unaligned"
        before = gemv_before("crosspoint_mvm", "scalar")
        got = routed("crosspoint_mvm", "fma", what, lambda: mvm.crosspoint_mvm(g, v))
        gemv_held(what, got, mvm.crosspoint_mvm_in_kernel_order(g, v), "scalar",
                  "crosspoint_mvm", before)
        if dtype == torch.float32:
            hold(errs, "crosspoint_mvm", got, mvm.crosspoint_mvm_plain(g, v), TOL_MVM_F32)
        else:
            hold_mvm_bf16(errs, "crosspoint_mvm_bf16", got, mvm.crosspoint_mvm_plain(g, v))
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
        variant = gemv.gemv_variant(torch.float32, n5, True)
        before = gemv_before("transient_step", variant)
        got = routed("transient_step", route_f32, f"K5 f32 {(n5, b5)}",
                     lambda: st.transient_step(m5, z5, c5, 1.0))
        hold(errs, "transient_step", got, st.transient_step_plain(m5, z5, c5, 1.0), TOL_MVM_F32)
        if b5 == 1:
            gemv_held(f"K5 f32 {(n5, b5)}", got, st.transient_step_in_kernel_order(
                m5, z5, c5, 1.0), variant, "transient_step", before)
        mb, zb, cb = m5.bfloat16(), z5.bfloat16(), c5.bfloat16()
        variant = gemv.gemv_variant(torch.bfloat16, n5, True)
        before = gemv_before("transient_step", variant)
        got = routed("transient_step", route_bf16, f"K5 bf16 {(n5, b5)}",
                     lambda: st.transient_step(mb, zb, cb, 1.0))
        hold_mvm_bf16(errs, "transient_step_bf16", got, st.transient_step_plain(mb, zb, cb, 1.0))
        if b5 == 1:
            gemv_held(f"K5 bf16 {(n5, b5)}", got, st.transient_step_in_kernel_order(
                mb, zb, cb, 1.0), variant, "transient_step", before)
        del m5, mb
    m5 = (t(1000 * 1000 + 1) * 0.01)[1:].view(1000, 1000)   # a view off the grid
    z5, c5 = t((1000, 16)), t((1000, 16))
    hold(errs, "transient_step",
         routed("transient_step", "narrow_scalar", "K5 f32 unaligned",
                lambda: st.transient_step(m5, z5, c5, 1.0)),
         st.transient_step_plain(m5, z5, c5, 1.0), TOL_MVM_F32)
    z5, c5 = t(1001)[1:, None], t((1000, 1))                 # the column route off the grid
    before = gemv_before("transient_step", "scalar")
    got = routed("transient_step", "column", "K5 f32 nb = 1 unaligned",
                 lambda: st.transient_step(m5, z5, c5, 1.0))
    hold(errs, "transient_step", got, st.transient_step_plain(m5, z5, c5, 1.0), TOL_MVM_F32)
    gemv_held("K5 f32 nb = 1 unaligned", got, st.transient_step_in_kernel_order(m5, z5, c5, 1.0),
              "scalar", "transient_step", before)
    return errs, bits


def gemv_bitwise(op: dict, out: dict) -> dict:
    """The main path's GEMV outputs (K6 at the DC voltages, K5's step of
    the step response, in float32 and bf16) against their orders in plain
    PyTorch: True where bit for bit."""
    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    st = importlib.import_module("repro_torch.kernels.transient_step")
    res = {}
    for sfx, dtype in (("", "float32"), ("_bf", "bfloat16")):
        g, y = op["g" + sfx], op["y" + sfx]
        res[f"crosspoint_mvm_fma_{dtype}"] = torch.equal(
            out["i_dc" + sfx], mvm.crosspoint_mvm_in_kernel_order(g, y[:, None])[:, 0])
        m, z, c = op["m" + sfx], op["z_col" + sfx], op["c_col" + sfx]
        res[f"transient_step_column_{dtype}"] = torch.equal(
            out["z_b1" + sfx],
            st.transient_step_in_kernel_order(m, z[:, None], c[:, None], 1.0)[:, 0])
    return res


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
    from repro_torch.kernels import gemv, ops
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
    hold_mvm_bf16(errs, "crosspoint_mvm_b1_bf16", out["i_dc_bf"],
                  mvm.crosspoint_mvm_plain(op["g_bf"], op["y_bf"][:, None])[:, 0])
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
    # the GEMV (K6 b = 1, K5 nb = 1): bit for bit its order in plain
    # PyTorch at the main shape; a warp's rows left unwritten, rejected by
    # more than 1000x; its plan (C) the Python plan, within one wave
    gemv_bits = gemv_bitwise(op, out)
    for name, same in gemv_bits.items():
        check(same, f"{name}: not bit for bit the GEMV's order in plain PyTorch")
    zr, cr = z0[:, 1:2].contiguous(), c[:, :1].contiguous()
    want_zr = st.transient_step_plain(m, zr, cr, 1.0)
    want_dc = mvm.crosspoint_mvm_plain(g, y[:, None])
    gemv_planted = {
        "k6_gemv_warp_rows_skipped": share_of_bar(
            gemv_warp_rows_skipped(lambda: mvm.crosspoint_mvm(g, y[:, None]), g.shape[0],
                                   want_dc), want_dc, TOL_MVM_F32),
        "k5_gemv_warp_rows_skipped": share_of_bar(
            gemv_warp_rows_skipped(lambda: st.transient_step(m, zr, cr, 1.0), op["nz"], want_zr),
            want_zr, TOL_MVM_F32)}
    split_planted.update(gemv_planted)
    for name, share in gemv_planted.items():
        check(share > 1000, f"the bar passes the planted fault {name}, or fails it by "
                            f"1000x or less: {share} of it")
    gemv_plans = {}
    for rows_m in (g.shape[0], op["nz"]):
        got_plan = gemv.gemv_plan_on_device(rows_m)
        gemv_plans[rows_m] = got_plan
        check({key: got_plan[key] for key in gemv.gemv_plan(rows_m)} == gemv.gemv_plan(rows_m)
              and got_plan["blocks"] <= got_plan["blocks_per_wave"],
              f"the GEMV's plan at m = {rows_m}: C {got_plan}, Python {gemv.gemv_plan(rows_m)}")
    z1 = st.transient_step(m, z0, c, 1.0)
    deterministic = {"colabs": torch.equal(tr.colabs(a), colsum),
                     "crosspoint_mvm_f32": torch.equal(mvm.crosspoint_mvm(g, v), out["i_v"]),
                     "transient_step_narrow": torch.equal(st.transient_step(m, z0, c, 1.0), z1),
                     "transient_step_narrow_bf16": torch.equal(
                         st.transient_step(op["m_bf"], op["z_bf"], op["c_bf"], 1.0),
                         out["z_bf"]),
                     "crosspoint_mvm_fma": torch.equal(ops.crosspoint_mvm(g, y), out["i_dc"]),
                     "crosspoint_mvm_fma_bf16": torch.equal(
                         ops.crosspoint_mvm(op["g_bf"], op["y_bf"]), out["i_dc_bf"]),
                     "transient_step_column": torch.equal(
                         ops.transient_step(m, op["z_col"], op["c_col"], 1.0), out["z_b1"]),
                     "transient_step_column_bf16": torch.equal(
                         ops.transient_step(op["m_bf"], op["z_col_bf"], op["c_col_bf"], 1.0),
                         out["z_b1_bf"])}
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
    hold_mvm_bf16(errs, "transient_step_b1_bf16", out["z_b1_bf"],
                  st.transient_step_plain(op["m_bf"], op["z_col_bf"][:, None],
                                          op["c_col_bf"][:, None], 1.0)[:, 0])
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
    ragged, ragged_gemv_bits = ragged_checks(dev)
    emit(dict(phase="kernel_api", case="vs_plain", main_path=errs, ragged=ragged,
              k6_bf16_bar=dict(rtol=MVM_BF16_RTOL, atol_of_max=MVM_BF16_ATOL_OF_MAX),
              k6_planted_faults=k6_planted, split_planted_faults_of_bar=split_planted,
              bitwise_equal_launches=deterministic, k6_f32_waves=k6_waves,
              gemv_bitwise_order=gemv_bits, gemv_bitwise_order_ragged=ragged_gemv_bits,
              gemv_planted_faults_of_bar=gemv_planted,
              gemv_plans=gemv_plans,
              k4_waves=k4_split["waves"], k5_waves=k5_waves,
              k4_split_order_vs_plain=k4_split["order_vs_plain"],
              k5_max_z=float(zp.abs().max()), k5_vs_k4_max_z=float(z4.abs().max()),
              i_dc_max=float(out["i_dc"].abs().max()), i_v_max=float(out["i_v"].abs().max())))

    # times at the main-path shapes (each input is larger than the 50 MB L2
    # except V, Z and C, so every call reads G, M or A from HBM).  Bytes:
    # inputs read once and outputs written once.  The kernel and the library
    # call each in a Python loop (ms) and in a CUDA graph (device ms).
    rows = {}

    def timed(key, shape, kern, plain, lib, nbytes, flops, err_keys, dtype=torch.float32):
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        rows[key] = dict(
            shape=shape, ms=cuda_ms(kern, 20), device_ms=graph_ms(kern, 20),
            plain_ms=cuda_ms(plain, 10), library_ms=None if lib is None else cuda_ms(lib, 20),
            library_device_ms=None if lib is None else graph_ms(lib, 20),
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
    # bf16 inputs: bytes bound the GEMV at the bf16 rate too
    yb1 = op["y_bf"][:, None]
    timed("crosspoint_mvm_bf16", [gm, gm, 1], lambda: mvm.crosspoint_mvm(bf, yb1),
          lambda: mvm.crosspoint_mvm_plain(bf, yb1), lambda: torch.matmul(bf, yb1),
          gm * gm * 2 + 2 * gm * 2, 2 * gm * gm, ("crosspoint_mvm_b1_bf16",),
          BF16)
    timed("crosspoint_mvm_b64", [gm, gm, w], lambda: mvm.crosspoint_mvm(g, v),
          lambda: mvm.crosspoint_mvm_plain(g, v), lambda: torch.matmul(g, v),
          gm * gm * 4 + 2 * gm * w * 4, 2 * gm * gm * w, ("crosspoint_mvm",))
    # bf16 inputs: the bound's rate for their type is the bf16 peak
    timed("crosspoint_mvm_b64_bf16", [gm, gm, w], lambda: mvm.crosspoint_mvm(bf, vbf),
          lambda: mvm.crosspoint_mvm_plain(bf, vbf), lambda: torch.matmul(bf, vbf),
          gm * gm * 2 + 2 * gm * w * 2, 2 * gm * gm * w, ("crosspoint_mvm_bf16",),
          BF16)
    timed("transient_step", [nz, nz, K5_COLUMNS], lambda: st.transient_step(m, z0, c, 1.0),
          lambda: st.transient_step_plain(m, z0, c, 1.0), lambda: torch.addmm(zc, m, z0),
          nz * nz * 4 + 3 * nz * K5_COLUMNS * 4, nz * K5_COLUMNS * (2 * nz + 3),
          ("transient_step",))
    # one library call: addmm with z + c made outside the timed call
    z1c, c1c = z0[:, :1].contiguous(), c[:, :1].contiguous()
    zc1 = z1c + c1c
    timed("transient_step_b1", [nz, nz, 1], lambda: st.transient_step(m, z1c, c1c, 1.0),
          lambda: st.transient_step_plain(m, z1c, c1c, 1.0),
          lambda: torch.addmm(zc1, m, z1c),
          nz * nz * 4 + 3 * nz * 4, nz * (2 * nz + 3), ("transient_step_b1",))
    zb1, cb1 = op["z_col_bf"][:, None], op["c_col_bf"][:, None]
    zcb1 = zb1 + cb1
    timed("transient_step_b1_bf16", [nz, nz, 1],
          lambda: st.transient_step(op["m_bf"], zb1, cb1, 1.0),
          lambda: st.transient_step_plain(op["m_bf"], zb1, cb1, 1.0),
          lambda: torch.addmm(zcb1, op["m_bf"], zb1),
          nz * nz * 2 + 3 * nz * 2, nz * (2 * nz + 3), ("transient_step_b1_bf16",),
          BF16)
    # bf16 inputs: bytes bound it at the bf16 rate too, as in float32
    mb, zb, cb = op["m_bf"], op["z_bf"], op["c_bf"]
    zcb = zb + cb
    timed("transient_step_bf16", [nz, nz, K5_COLUMNS], lambda: st.transient_step(mb, zb, cb, 1.0),
          lambda: st.transient_step_plain(mb, zb, cb, 1.0), lambda: torch.addmm(zcb, mb, zb),
          nz * nz * 2 + 3 * nz * K5_COLUMNS * 2, nz * K5_COLUMNS * (2 * nz + 3),
          ("transient_step_bf16",), BF16)
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
# the dense, MoE and hybrid archs whose tensor-parallel rank (16 "model"
# ranks, heads mode) runs K8 on its own heads: q heads over the kv heads
# they read, at the main path's S = 2048 (phase 8b's rank prefills launch
# them); Mixtral's window of 4096 does not bind at 2048; Zamba2's shared
# attention keeps a kv head a q head (32 of each), D = 112
TP_RANKS = 16
K8_TP_CASES = {arch: (f"tp_{arch}_{h}_{kv}", BF16, 1, 2048, 2048, h, kv, d, True, window, None)
               for arch, h, kv, d, window in (
                   ("qwen3_8b", 2, 1, 128, 0), ("command_r_35b", 4, 1, 128, 0),
                   ("granite_20b", 3, 1, 128, 0), ("mixtral_8x22b", 3, 1, 128, 4096),
                   ("granite_moe_1b_a400m", 1, 1, 64, 0), ("zamba2_7b", 2, 2, 112, 0))}
# the MoE archs of K8_TP_CASES, whose rank prefills phase 8b also counts
# on meta and on the card
TP_MOE_ARCHS = ("mixtral_8x22b", "granite_moe_1b_a400m")
# the hybrid arch of K8_TP_CASES, whose rank prefill phase 8b counts on meta
# and on the card at TP_HYBRID_LAYERS layers: one group of attn_every (6)
# Mamba blocks behind one application of the shared attention
TP_HYBRID_ARCH, TP_HYBRID_LAYERS = "zamba2_7b", 6
# case (g): Whisper-base at full width and depth, one rank's prefill of its
# 1,500 frames and a prompt of TP_ENCDEC_PROMPT tokens; in head_dim mode its
# K8 launches run at whole heads (q, k and v gathered), the one-device
# shapes: the encoder's non-causal 1500 x 1500, the decoder's causal
# self-attention and its cross attention against the 1,500 frames, a row
# each of the kernels line
TP_ENCDEC_ARCH, TP_ENCDEC_PROMPT = "whisper_base", 64
K8_TP_WHISPER = {
    "encoder": ("encoder_whisper", BF16, 1, 1500, 1500, 8, 8, 64, False, 0, None),
    "decoder": ("tp_whisper_decoder", BF16, 1, TP_ENCDEC_PROMPT, TP_ENCDEC_PROMPT, 8, 8, 64,
                True, 0, None),
    "cross": ("tp_whisper_cross", BF16, 1, TP_ENCDEC_PROMPT, 1500, 8, 8, 64, False, 0, None)}
# the range of torch.profiler that case (g) puts around each GELU MLP
TP_ENCDEC_MLP_RANGE = "whisper_rank::gelu_mlp"
# Zamba2-7B's shared attention at a 2048-token prompt: D = 112, G = 1
K8_D112 = ("d112_zamba", BF16, 1, 2048, 2048, 32, 32, 112, True, 0, None)
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
    # the families phase's shapes: Zamba2's D = 112 (G = 1) on both routes,
    # InternVL2's G = 7 (256 patches + 1200 text), Mixtral's G = 6 with its
    # 4096 window masking at S = 6000, Whisper's non-causal encoder
    # (S = T = 1500) and cross attention (S != T = 1500)
    K8_D112,
    ("d112_p_bf16", BF16, 2, 515, 515, 8, 2, 112, True, 0, BF16),
    ("f32_d112", F32, 2, 515, 515, 8, 2, 112, True, 0, None),
    ("g7_internvl", BF16, 1, 1456, 1456, 14, 2, 64, True, 0, None),
    ("g6_window_mixtral", BF16, 1, 6000, 6000, 48, 8, 128, True, 4096, None),
    K8_TP_WHISPER["encoder"],
    ("cross_whisper", BF16, 2, 64, 1500, 8, 8, 64, False, 0, None),
    # a Whisper-base rank's decoder and cross attention at its prompt (case (g))
    K8_TP_WHISPER["decoder"],
    K8_TP_WHISPER["cross"],
    # examples/train_lm.py's attention (lm_100m: 12 heads over 4, D = 64),
    # where training launches the FMA forward
    ("train_f32_d64", F32, 4, 192, 192, 12, 4, 64, True, 0, None),
    # the FMA route with p rounded to bf16 (held at the bf16 bar, and
    # closer to the plain version that rounds p than to the one that does
    # not: fma_p_bf16_checks)
    ("f32_d64_p_bf16", F32, 2, 515, 515, 8, 2, 64, True, 0, BF16),
    # a tensor-parallel rank's heads in heads mode (16 "model" ranks): the
    # q heads of its share over the one kv head they read
    *K8_TP_CASES.values(),
)
# the same shape in float32: the FMA route's row of the kernels line
K8_MAIN_F32 = ("main_f32", F32, *K8_MAIN[2:])
# the FMA route at train_lm's shape: its own row of the kernels line
K8_TRAIN_F32 = next(c for c in K8_CASES if c[0] == "train_f32_d64")


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


def fma_tile_rows(q, k, tile_index: int) -> torch.Tensor:
    """The (S, H) selection of the rows of the FMA forward's row tile that
    its plan issues ``tile_index``-th (0: the last row tile), in every
    batch and KV head: row R = qpos G + (head % G) of the tile's range."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    r0, r1, _kt0, _n_kt = fa.fma_forward_plan(b, s, t, h, kv, d, True, 0)["tiles"][tile_index]
    rows = (torch.arange(s, device=q.device)[:, None] * g
            + torch.arange(h, device=q.device)[None, :] % g)
    return (rows >= r0) & (rows < r1)


def k8_fma_last_key_tile_dropped(q, k, v, **kw):
    """A planted fault of the FMA forward (causal): its last row tile with
    the last key tile of its reach left out."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    _r0, _r1, kt0, n_kt = fa.fma_forward_plan(b, s, t, h, kv, d, True, 0)["tiles"][0]
    out = fa.flash_attention(q, k, v, **kw)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    last = (kpos >= (kt0 + n_kt - 1) * fa.KV_TILE) & (kpos < (kt0 + n_kt) * fa.KV_TILE)
    dropped = attention_masked(q, k, v, (kpos <= qpos) & ~last)
    sel = fma_tile_rows(q, k, 0)
    out[:, sel] = dropped[:, sel]
    return out


def k8_fma_tile_unnormalized(q, k, v, **kw):
    """A planted fault of the FMA forward (causal): its last row tile left
    unnormalized, acc instead of acc / l (l from a float32 score matrix)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    out = fa.flash_attention(q, k, v, **kw)
    b, s, h, d = q.shape
    kv = k.shape[2]
    sc = torch.einsum("bqhgd,bkhd->bqhgk", q.float().reshape(b, s, kv, h // kv, d),
                      k.float()) / np.sqrt(d)
    keep = torch.arange(k.shape[1], device=q.device)[None, :] <= \
        torch.arange(s, device=q.device)[:, None]
    sc = sc.masked_fill(~keep[None, :, None, None, :], -np.inf)
    l = torch.exp(sc - sc.amax(dim=-1, keepdim=True)).sum(dim=-1).reshape(b, s, h)
    sel = fma_tile_rows(q, k, 0)
    out[:, sel] = (out.float() * l[..., None])[:, sel].to(out.dtype)
    return out


K8_FMA_FAULTS = {"last_key_tile_dropped_last_row_tile": k8_fma_last_key_tile_dropped,
                 "last_row_tile_unnormalized": k8_fma_tile_unnormalized}


def k8_last_group_unnormalized(q, k, v, **kw):
    """A planted fault at D = 112: K8 with its last 16 output columns (in
    the short second group of V's columns, which D = 112 alone has) left
    unnormalized, acc instead of acc / l, l the row's softmax denominator
    from a float32 score matrix (causal)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    out = fa.flash_attention(q, k, v, **kw)
    b, s, h, d = q.shape
    kv = k.shape[2]
    sc = torch.einsum("bqhgd,bkhd->bqhgk", q.float().reshape(b, s, kv, h // kv, d),
                      k.float()) / np.sqrt(d)
    keep = torch.arange(k.shape[1], device=q.device)[None, :] <= \
        torch.arange(s, device=q.device)[:, None]
    sc = sc.masked_fill(~keep[None, :, None, None, :], -np.inf)
    l = torch.exp(sc - sc.amax(dim=-1, keepdim=True)).sum(dim=-1).reshape(b, s, h)
    out[..., d - 16:] = (out[..., d - 16:].float() * l[..., None]).to(out.dtype)
    return out


def k8_operands(case, gen):
    _label, dtype, b, s, t, h, kv, d, _causal, _window, _p = case
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def phase_k8() -> dict:
    """K8 against its plain version at every case (main-path shape, ragged
    S, MQA with G = 32 and 48, a window, non-causal, S != T, each head
    size, float32 and bf16, p rounded or not, and the families' shapes),
    each through the route flash_attention_route names; the planted faults,
    one at D = 112; then the times at the main-path shape on each route
    (bf16 -> "mma", float32 -> "fma"), at Zamba2's D = 112 shape
    ("mma_d112") and at train_lm's float32 shape, where training launches
    the FMA route ("fma_train")."""
    from repro_torch.kernels import ops

    from repro_torch.kernels import build

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    # the forward's FMA kernel, by its mangled name (22 = its length)
    emit(dict(phase="serve", case="k8_fma_registers",
              ptxas={key[2:]: use for key, use in ptxas_usage(build.load_library().log,
                                                               "22flash_attention").items()}))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs: dict = {}
    routes: dict = {}
    fma: dict = {}
    for case in K8_CASES:
        label, dtype, b_, s_, t_, h_, kv_, d, causal, window, p_dtype = case
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
        # p rounded to bf16 takes the bf16 bar in either dtype: a p whose
        # rounding flips between two orders moves an output by 2^-8 p / l |v|
        hold_close(errs, label, got, want, *K8_BARS[BF16 if p_dtype == BF16 else dtype])
        if route == "fma":
            fma[label] = fma_forward_checks(q, k, v, got, (b_, s_, t_, h_, kv_, d, causal, window),
                                            causal=causal, window=window, p_dtype=p_dtype)
            if p_dtype == BF16:
                fma[label].update(fma_p_bf16_checks(q, k, v, got, want, causal, window))
    emit(dict(phase="serve", case="k8_vs_plain", bars=bars_json(), errors=errs, routes=routes))
    q, k, v = k8_operands(K8_TRAIN_F32, gen)
    again = [fa.flash_attention(q, k, v) for _ in range(2)]
    fma["train_f32_d64"]["same_bits_twice"] = torch.equal(again[0].view(torch.int32),
                                                          again[1].view(torch.int32))
    check(fma["train_f32_d64"]["waves"] <= 1, f"K8 fma at train_lm's shape: the grid takes "
                                              f"more than one wave: {fma['train_f32_d64']}")
    check(fma["train_f32_d64"]["same_bits_twice"], "K8 fma at train_lm's shape: two launches "
                                                   "differ")
    emit(dict(phase="serve", case="k8_fma_forward", cases=fma))

    # the bar must fail a wrong kernel: planted faults at the main-path shape
    dtype = K8_MAIN[1]
    q, k, v = k8_operands(K8_MAIN, gen)
    want = fa.flash_attention_plain(q, k, v)
    planted = {}
    for name, fault in K8_FAULTS.items():
        err, share = bar_share(fault(q, k, v), want, *K8_BARS[dtype])
        planted[name] = dict(max_abs_err=err, of_bar=share)
        check(share > 1, f"K8's bar passes the planted fault {name}: {share} of it")
    # the short column group at D = 112: a fault there must fail the bar by
    # more than 1000x
    d112 = k8_operands(K8_D112, gen)
    err, share = bar_share(k8_last_group_unnormalized(*d112),
                           fa.flash_attention_plain(*d112), *K8_BARS[BF16])
    planted["d112_last_group_unnormalized"] = dict(max_abs_err=err, of_bar=share)
    check(share > 1000, f"K8's bar passes the D = 112 planted fault, or fails it by 1000x "
                        f"or less: {share} of it")
    # the FMA forward's faults at train_lm's shape, each past 1000x the
    # float32 bar
    q, k, v = k8_operands(K8_TRAIN_F32, gen)
    want = fa.flash_attention_plain(q, k, v)
    for name, fault in K8_FMA_FAULTS.items():
        err, share = bar_share(fault(q, k, v), want, *K8_BARS[F32])
        planted[f"fma_train_{name}"] = dict(max_abs_err=err, of_bar=share)
        check(share > 1000, f"K8's float32 bar passes the planted fault {name}, or fails it by "
                            f"1000x or less: {share} of it")
    emit(dict(phase="serve", case="k8_planted_faults", faults=planted))

    rows = {"mma_d112": k8_times(*d112, errs, routes)}
    rows["mma"] = k8_times(*k8_operands(K8_MAIN, gen), errs, routes)
    rows["fma"] = k8_times(*k8_operands(K8_MAIN_F32, gen), errs, routes)
    rows["fma_train"] = k8_times(*k8_operands(K8_TRAIN_F32, gen), errs, routes)
    for arch, case in K8_TP_CASES.items():
        rows[f"tp_{arch}"] = dict(k8_times(*k8_operands(case, gen)),
                                  max_abs_err=errs[case[0]]["max_abs_err"],
                                  heads=f"{case[5]} q / {case[6]} kv heads, a tensor-parallel "
                                        f"rank of {arch}")
    for part, case in K8_TP_WHISPER.items():
        rows[f"tp_{TP_ENCDEC_ARCH}_{part}"] = dict(
            k8_times(*k8_operands(case, gen), causal=case[8]),
            max_abs_err=errs[case[0]]["max_abs_err"],
            heads=f"{case[5]} q / {case[6]} kv heads whole (head_dim mode, gathered), a "
                  f"tensor-parallel rank of {TP_ENCDEC_ARCH}'s {part}")
    for row in rows.values():
        emit(dict(phase="serve", case="k8_times", **row))
    return rows


def fma_plan_held(shape: tuple) -> dict:
    """The FMA forward's plan at ``shape`` (b, s, t, h, kv, d, causal,
    window) as the C launcher reports it (fma_forward_plan_on_device: rows,
    threads, shared memory, blocks, row tiles, blocks per SM on this card),
    held against the plan in Python (fma_forward_plan), and the waves it
    takes."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    plan, on_card = fa.fma_forward_plan(*shape), fa.fma_forward_plan_on_device(*shape)
    keys = ("rows", "threads", "smem_bytes", "blocks", "row_tiles")
    equal = all(plan[key] == on_card[key] for key in keys) and \
        [tile[2:] for tile in plan["tiles"]] == on_card["key_tiles"]
    check(equal, f"K8 fma {shape}: the plan in Python and in C differ")
    return dict(plan_equal_c=equal, **{key: on_card[key] for key in keys + ("blocks_per_sm",)},
                waves=on_card["blocks"] / (torch.cuda.get_device_properties(0).multi_processor_count
                                           * on_card["blocks_per_sm"]))


def fma_forward_checks(q, k, v, got, shape: tuple, **kw) -> dict:
    """At a case on the FMA route: the output with lse bit for bit the
    output without it, and the plan in Python equal to the C launcher's
    (fma_plan_held)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    with_lse, _ = fa.flash_attention_lse(q, k, v, **kw)
    bits = torch.int16 if q.dtype == BF16 else torch.int32
    same = torch.equal(with_lse.view(bits), got.view(bits))
    check(same, f"K8 fma {shape}: the output with lse differs from the one without")
    return dict(same_bits_with_lse=same, **fma_plan_held(shape))


def fma_p_bf16_checks(q, k, v, got, want, causal: bool, window: int) -> dict:
    """At a float32 case with p rounded to bf16: the output differs from
    the launch with p float32, and its mean |error| against the plain
    version that rounds p (``want``) is under a quarter of that against
    the plain version that does not, which a kernel ignoring p_bf16 fails."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    unrounded = fa.flash_attention(q, k, v, causal=causal, window=window)
    differs = not torch.equal(got, unrounded)
    to_rounded = float((got - want).abs().mean())
    to_unrounded = float((got - fa.flash_attention_plain(q, k, v, causal=causal,
                                                         window=window)).abs().mean())
    check(differs and to_rounded * 4 < to_unrounded,
          f"K8 fma with p rounded: the same as p float32 ({not differs}) or not closer to the "
          f"plain version that rounds p ({to_rounded} against {to_unrounded})")
    return dict(p_bf16_differs_from_p_f32=differs, p_bf16_mean_err_to_rounded=to_rounded,
                p_bf16_mean_err_to_unrounded=to_unrounded)


def k8_times(q, k, v, errs: dict | None = None, routes: dict | None = None,
             causal: bool = True) -> dict:
    """K8's times at a shape (causal unless told, p float32) in the
    inputs' dtype, beside the plain version, SDPA (the library call, timed
    only: a loop of calls between two events, and its kernels' device
    time under the profiler) and the bound at the peak of the inputs'
    type; with ``errs`` and ``routes`` (phase_k8's), the largest error of
    the route."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    bf16 = q.dtype == BF16
    route = fa.flash_attention_route(q.dtype, d, True)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qh, kh, vh, is_causal=causal, enable_gqa=True).transpose(1, 2)
    lib_err = float((lib_out.float() - fa.flash_attention(q, k, v, causal=causal).float())
                    .abs().max())
    flops, nbytes = fa.forward_cost(q, k, v, causal, 0, False)
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 20)
    prof = device_breakdown(lambda: [sdpa(qh, kh, vh, is_causal=causal, enable_gqa=True)
                                     for _ in range(20)])
    extra = {}
    if route == "fma":
        extra["fma_plan"] = fma_plan_held((b, s, t, h, kv, d, causal, 0))
    return dict(
        shape=[b, s, t, h, kv, d], causal=causal, dtype=str(q.dtype).removeprefix("torch."),
        route=route, ms=ms,
        device_ms=graph_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 20),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal), 5),
        library_ms=cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=causal, enable_gqa=True), 20),
        library_device_ms=(sum(prof["device_ms"].values()) / 20 if prof["device_ms"] else None),
        bound_ms=bound_ms, bound_by=bound_by,
        bound_peak=("bf16 tensor cores, 989 TFLOP/s" if bf16 else "float32 FMA, 67 TFLOP/s")
        + " (the inputs' type)",
        f32_fma_bound_ms=flops / card_spec().f32_flops * 1e3, bytes=nbytes, flops=flops,
        tflop_per_s=flops / (ms * 1e-3) / 1e12,
        max_abs_err=(max(e["max_abs_err"] for label, e in errs.items()
                         if routes[label] == route) if errs is not None else None),
        library_max_abs_err=lib_err, **extra,
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


# ---------------------------------------------------------------------------
# phase 7: families — the other model families' serving paths, K8 on every
# prefill's attention
# ---------------------------------------------------------------------------

FAMILY_MAX_NEW = 16
# Mixtral-8x22B's depth, cut to fit one card: ~5.0 GB of bf16 weights a
# layer (8 experts of 3 x 6144 x 16384, attention 88 M), 141 B parameters
# in all; 12 of its 56 layers are 60.9 GB with the tables
MIXTRAL_LAYERS = 12
# each family's requests: prompt lengths drawn from default_rng(SEED) in
# [lo, hi], or taken as listed; the families ServeEngine serves (as the
# reference's does) go through it with ``slots``, a vlm (patches) and an
# encdec (frames) through prefill_into / decode_step, one slot a request
FAMILY_PLANS = {
    "internvl2_1b": dict(requests=4, lens=(300, 1200)),
    "granite_moe_1b_a400m": dict(slots=SERVE_SLOTS, requests=SERVE_REQUESTS,
                                 lens=SERVE_PROMPT_LENS),
    "mixtral_8x22b": dict(slots=2, requests=2, lens=(4500, 6000)),
    "mamba2_370m": dict(slots=4, requests=4, lens=[256, 512, 1024, 2048]),
    "zamba2_7b": dict(slots=4, requests=4, lens=[768, 1280, 1536, 2048]),
    "whisper_base": dict(requests=4, lens=(8, 64)),
}


def attention_applications(cfg) -> int:
    """K8 launches of one prefill: one per attention layer (a hybrid's
    shared block once per group; an encdec's encoder self, decoder self
    and cross attention)."""
    from repro_torch.models.model import hybrid_groups

    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return hybrid_groups(cfg)[0]
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def family_inputs(cfg, gen: torch.Generator, n: int, dev) -> dict:
    """A vlm's patch or an encdec's frame embeddings for n requests (the
    stubbed front ends: (n, 1, length, d) normals in the activation dtype,
    on the card)."""
    length = {"vlm": cfg.n_patches, "encdec": cfg.enc_len}.get(cfg.family)
    if length is None:
        return {}
    x = torch.randn((n, 1, length, cfg.d_model), device=dev, generator=gen)
    return {"patches" if cfg.family == "vlm" else "frames": x.to(cfg.act_dtype())}


def family_config(arch: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "mixtral_8x22b":
        import dataclasses

        cfg = dataclasses.replace(cfg, n_layers=MIXTRAL_LAYERS)
    return cfg


def serve_direct(params, cfg, prompts, extra: dict, dev) -> tuple[list, list, list]:
    """A vlm's or an encdec's requests through prefill_into (one slot each)
    and decode_step (all slots at their own positions), greedy.  Returns
    (tokens per request, prefill times, decode step times)."""
    from repro_torch.models.model import decode_step, init_decode_cache, prefill_into

    offset = cfg.n_patches if cfg.family == "vlm" else 0
    max_seq = offset + max(len(p) for p in prompts) + FAMILY_MAX_NEW
    cache = init_decode_cache(cfg, len(prompts), max_seq, device=dev)
    outs, prefills, decodes = [], [], []
    for slot, prompt in enumerate(prompts):
        t = time.perf_counter()
        logits = prefill_into(params, prompt[None, :], cfg, cache, slot,
                              **{key: x[slot] for key, x in extra.items()})
        outs.append([int(logits.argmax(dim=-1)[0])])
        prefills.append(dict(prompt_len=len(prompt), ms=(time.perf_counter() - t) * 1e3))
    pos = np.array([offset + len(p) for p in prompts])
    for _ in range(FAMILY_MAX_NEW - 1):
        t = time.perf_counter()
        toks = np.array([[o[-1]] for o in outs])
        logits, cache = decode_step(params, toks, pos, cache, cfg)
        for o, nxt in zip(outs, logits.argmax(dim=-1).cpu().numpy()):
            o.append(int(nxt))
        decodes.append(dict(active=len(prompts), ms=(time.perf_counter() - t) * 1e3))
        pos = pos + 1
    return outs, prefills, decodes


def serve_engine(params, cfg, prompts, slots: int, dev) -> tuple[list, list, list]:
    """The requests through ServeEngine, greedy, each prefill and decode
    step timed on the host (both end in a host copy of the tokens)."""
    from repro_torch.serving import Request, ServeEngine

    max_seq = max(len(p) for p in prompts) + FAMILY_MAX_NEW + 1
    eng = ServeEngine(cfg, params, batch_slots=slots, max_seq=max_seq, device=dev)
    reqs = [Request(rid=i, prompt=p, max_new=FAMILY_MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    prefills, decodes = [], []
    prefill_slot, decode_active = eng._prefill_slot, eng._decode_active

    def timed_prefill(slot, req):
        t = time.perf_counter()
        prefill_slot(slot, req)
        prefills.append(dict(prompt_len=len(req.prompt), ms=(time.perf_counter() - t) * 1e3))

    def timed_decode():
        t = time.perf_counter()
        out = decode_active()
        decodes.append(dict(active=sum(r is not None for r in eng.active),
                            ms=(time.perf_counter() - t) * 1e3))
        return out

    eng._prefill_slot, eng._decode_active = timed_prefill, timed_decode
    eng.run(max_steps=400)
    for r in reqs:
        check(r.done and r.error is None and len(r.out) == FAMILY_MAX_NEW,
              f"{cfg.arch_id} request {r.rid}: done={r.done} error={r.error} "
              f"tokens={len(r.out)}")
    return [r.out for r in reqs], prefills, decodes


def family_prefill_checks(params, cfg, prompts, extra: dict, outs: list) -> dict:
    """The first two prompts' prefills again, outside the counted run: K8
    held element by element against its plain version on every attention
    layer's own q, k and v (the plain calls launch nothing), the greedy
    token the served one, and (reported, no gate) the logits through K8
    against the same prefill through the plain attention."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.model import prefill

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    k8 = attn_mod.flash_attention
    layers: dict = {}
    held_shapes = set()

    def held(q, k, v, **kw):
        got = k8(q, k, v, **kw)
        hold_close(layers, "layers", got, fa.flash_attention_plain(q, k, v, **kw),
                   *K8_BARS[q.dtype])
        held_shapes.add((tuple(q.shape), tuple(k.shape), kw.get("causal", True),
                         kw.get("window", 0)))
        return got

    def logits(attention, i):
        batch = {"tokens": prompts[i][None, :], **{key: x[i] for key, x in extra.items()}}
        attn_mod.flash_attention = attention
        try:
            offset = cfg.n_patches if cfg.family == "vlm" else 0
            return prefill(params, batch, cfg, offset + len(prompts[i]))[0].float()
        finally:
            attn_mod.flash_attention = k8

    reads = []
    for i in range(min(2, len(prompts))):
        ops.reset_launch_counts()
        got = logits(held, i)
        check(ops.launch_counts()["flash_attention"] == attention_applications(cfg),
              f"{cfg.arch_id}: K8 launches of the held prefill")
        check(bool(torch.isfinite(got).all()), f"{cfg.arch_id}: non-finite prefill logits")
        check(int(got.argmax(dim=-1)[0]) == outs[i][0],
              f"{cfg.arch_id}: served first token {outs[i][0]} vs prefill "
              f"{int(got.argmax(dim=-1)[0])}")
        read = dict(prompt_len=len(prompts[i]))
        if attention_applications(cfg):
            want = logits(fa.flash_attention_plain, i)
            read.update(layers_of_bar=layers.pop("layers")["of_bar"],
                        k8_vs_plain_logits_of_max=float((got - want).abs().max())
                        / float(want.abs().max()))
        reads.append(read)
    return dict(prompts=reads, k8_shapes=sorted(str(x) for x in held_shapes))


def family_profile(params, cfg, prompt, extra: dict, dev) -> dict:
    """Where one request's time goes (no gate): its prefill, then four
    decode steps from its cache, each under torch.profiler
    (:func:`device_breakdown`)."""
    from repro_torch.models.model import decode_step, init_decode_cache, prefill_into

    offset = cfg.n_patches if cfg.family == "vlm" else 0
    cache = init_decode_cache(cfg, 1, offset + len(prompt) + 8, device=dev)
    kw = {key: x[0] for key, x in extra.items()}
    prefill_prof = device_breakdown(lambda: prefill_into(params, prompt[None, :], cfg, cache,
                                                         **kw).argmax(dim=-1).cpu())

    def decode():
        tok = np.zeros((1, 1), dtype=np.int64)
        for i in range(4):
            logits, _ = decode_step(params, tok, offset + len(prompt) + i, cache, cfg)
            tok = logits.argmax(dim=-1, keepdim=True).cpu().numpy()

    return dict(prompt_len=len(prompt), prefill=prefill_prof, decode_steps=4,
                decode=device_breakdown(decode))


def family_smoke_cross_device(arch: str) -> dict:
    """The arch's SMOKE config (float32) on the card and on the CPU, one set
    of weights: prefill of two sequences and three decode steps at
    staggered positions, logits within TOL_SMOKE_LOGITS of max|logit|,
    greedy tokens equal; K8's launches by route over the card's run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, init_params, prefill

    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gpu = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu").to("cuda")
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 64))}   # 2 SMOKE ssm chunks
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(np.float32)
    s = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lg_g, c_g = prefill(gpu, batch, cfg, s + 8)
    lg_c, c_c = prefill(cpu, batch, cfg, s + 8)
    pos = np.array([s, s - 3])
    worst, tokens = 0.0, []
    for step in range(4):
        scale = float(lg_c.abs().max())
        err = float((lg_g.cpu().double() - lg_c.double()).abs().max())
        check(err <= TOL_SMOKE_LOGITS * scale, f"{arch} smoke config step {step}: cuda vs cpu "
                                               f"logits {err} of max {scale}")
        worst = max(worst, err / scale)
        nxt = lg_c.argmax(dim=-1, keepdim=True).numpy()
        check(bool((lg_g.argmax(dim=-1, keepdim=True).cpu().numpy() == nxt).all()),
              f"{arch} smoke config step {step}: greedy tokens differ")
        tokens.append(nxt[:, 0].tolist())
        lg_g, c_g = decode_step(gpu, nxt, pos, c_g, cfg)
        lg_c, c_c = decode_step(cpu, nxt, pos, c_c, cfg)
        pos = pos + 1
    torch.cuda.synchronize()
    return dict(logits_err_of_max=worst, tokens=tokens,
                k8_launches_by_route=ops.launch_counts_by_route()["flash_attention"])


def run_family(arch: str, dev) -> dict:
    """One model: seeded random bf16 weights on the card, its requests
    (FAMILY_PLANS) with K8's launches counted over the run, its outcome
    checked; then the held prefills and the SMOKE config card vs CPU."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import count_active_params, count_params, init_params
    from repro_torch.serving.engine import SERVED_FAMILIES

    plan = FAMILY_PLANS[arch]
    cfg = family_config(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    lens = plan["lens"]
    if isinstance(lens, tuple):
        lens = rng.integers(lens[0], lens[1] + 1, plan["requests"]).tolist()
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    extra = family_inputs(cfg, torch.Generator(device=dev).manual_seed(SEED), len(prompts), dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    entry = "engine" if cfg.family in SERVED_FAMILIES else "direct"
    if entry == "engine":
        outs, prefills, decodes = serve_engine(params, cfg, prompts, plan["slots"], dev)
    else:
        outs, prefills, decodes = serve_direct(params, cfg, prompts, extra, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_route = ops.launch_counts_by_route()["flash_attention"]
    peak = torch.cuda.max_memory_allocated()

    for i, out in enumerate(outs):
        check(len(out) == FAMILY_MAX_NEW and all(0 <= t < cfg.vocab_padded for t in out),
              f"{arch} request {i}: {len(out)} tokens, range")
    check(len(prefills) == len(prompts), f"{arch}: {len(prefills)} prefills")
    want = attention_applications(cfg) * len(prefills)
    check(counts["flash_attention"] == want,
          f"{arch}: K8 launched {counts['flash_attention']} times, want {want}")
    check(by_route["mma"] == want, f"{arch}: K8 routes {by_route}")
    check(not any(v for k, v in counts.items() if k != "flash_attention"),
          f"{arch}: a kernel other than K8 launched: {counts}")
    generated = sum(len(o) for o in outs)
    row = dict(phase="families", case="serve", arch=arch, family=cfg.family,
               entry=entry, n_layers=cfg.n_layers, d_model=cfg.d_model,
               head_dim=cfg.head_dim, params=count_params(params),
               active_params=count_active_params(params, cfg), param_init_s=init_s,
               prompt_lens=lens, max_new=FAMILY_MAX_NEW, wall_s=wall,
               generated_tokens=generated, tokens_per_s=generated / wall,
               prefills=prefills, prefill_ms_mean=float(np.mean([p["ms"] for p in prefills])),
               decode_steps=len(decodes),
               decode_ms_mean=float(np.mean([d["ms"] for d in decodes])),
               peak_memory_allocated_bytes=peak, allocated_before_run_bytes=held,
               k8_launches=counts["flash_attention"],
               k8_launches_by_route=by_route)
    if arch == "mixtral_8x22b":
        row["reduced"] = dict(n_layers=f"{MIXTRAL_LAYERS} of 56 (141 B parameters do not fit "
                                        "one 80 GB card)")
    emit(row)
    checks = family_prefill_checks(params, cfg, prompts, extra, outs)
    emit(dict(phase="families", case="profile", arch=arch,
              **family_profile(params, cfg, prompts[0], extra, dev)))
    del params, extra
    gc.collect()
    torch.cuda.empty_cache()
    cross = family_smoke_cross_device(arch)
    emit(dict(phase="families", case="checks", arch=arch, bars=bars_json(), **checks,
              smoke_config_cuda_vs_cpu=cross))
    return dict(mma=by_route["mma"], head_dim=cfg.head_dim,
                fma=cross["k8_launches_by_route"]["fma"], wall_s=wall)


def phase_families(dev) -> dict:
    """Every family beside the dense one at its published width (Mixtral at
    MIXTRAL_LAYERS layers), one after the other, each model freed before
    the next.  Returns K8's launches by family: those of each served run
    (all on the tensor-core route) and the fma launches of each SMOKE
    config's card run."""
    # the serve phase's engine holds its model through a reference cycle
    # (its timing closures): collect it, so the first family's peak is its own
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {arch: run_family(arch, dev) for arch in FAMILY_PLANS}
    emit(dict(phase="families", case="wall", wall_s=time.perf_counter() - t0,
              served_wall_s={arch: r["wall_s"] for arch, r in out.items()}))
    return out


# ---------------------------------------------------------------------------
# K8's backward: the hand-written kernels against their plain version
# ---------------------------------------------------------------------------

# (label, dtype, b, s, t, h, kv, d, causal, window, p_dtype): the forward's
# main shape in bf16, train_lm's attention (float32, D = 64), D = 112,
# non-causal S != T, a window, G = 48, p rounded, and small float32 cases,
# one of them windowed at G = 48 with a ragged S
K8_BWD_MAIN = ("bwd_main", BF16, 1, 2048, 2048, 32, 8, 128, True, 0, None)
K8_BWD_F32 = ("bwd_f32_d64", F32, 4, 192, 192, 12, 4, 64, True, 0, None)
K8_BWD_CASES = (
    K8_BWD_MAIN,
    K8_BWD_F32,
    ("bwd_d112", BF16, 1, 2048, 2048, 32, 32, 112, True, 0, None),
    ("bwd_f32_d112", F32, 2, 515, 515, 8, 2, 112, True, 0, None),
    ("bwd_non_causal_s300_t1000", BF16, 1, 300, 1000, 32, 8, 128, False, 0, None),
    ("bwd_cross_whisper", BF16, 2, 64, 1500, 8, 8, 64, False, 0, None),
    ("bwd_window512", BF16, 1, 2048, 2048, 32, 8, 128, True, 512, None),
    ("bwd_mqa_g48", BF16, 1, 1000, 1000, 48, 1, 128, True, 0, None),
    ("bwd_main_p_bf16", BF16, 1, 2048, 2048, 32, 8, 128, True, 0, BF16),
    ("bwd_f32_d16", F32, 2, 515, 515, 8, 2, 16, True, 0, None),
    ("bwd_f32_d32_non_causal", F32, 2, 515, 300, 8, 2, 32, False, 0, None),
    ("bwd_f32_window_g48", F32, 1, 515, 515, 48, 1, 64, True, 100, None),
)
# The backward kernels against the plain backward on the same forward
# output and lse, element by element: |got - want| <= atol max|want| +
# rtol |want|.  Both sum in float32 in other orders (1e-5 of the largest
# element, as the CPU parity bars); bf16 gradients are rounded once, so a
# sound pair lies at most one bf16 ulp apart (2^-8 |want| < rtol 1e-2).
# With p rounded, a p whose bf16 rounding flips between the two moves dV
# by 2^-8 p |dO|: atol 1e-2.
K8_BWD_BARS = {BF16: (1e-2, 1e-5), F32: (0.0, 1e-5)}
K8_BWD_P_BF16_ATOL = 1e-2
K8_BWD_KERNELS = ("flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
                  "flash_attention_bwd_dq")
K8_BWD_ROUTED = ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
# cases also run on the FMA route through a view off the 16-byte grid
K8_BWD_FMA_VIEW = ("bwd_main", "bwd_d112")
K8_BWD_TIMING_CALLS = 20
# Delta's device ms is, as every kernel's, the graph of 5 launches; its
# ~4 us is close to a graph replay's own cost, so a graph of 50 is timed
# beside it (device_ms_graph_of_50, and the same for its einsum and its
# launch over zero rows)
DELTA_GRAPH_CALLS = 50
K8_BWD_REPLACES = "none: replaces jax.grad through src/repro/models/attention.py:42"


def delta_bits(o, do, delta, label: str) -> dict:
    """Delta bit for bit against delta_in_kernel_order (its sum order in
    plain PyTorch) on the 16-byte grid ("vec16") and, at the cases of
    K8_BWD_FMA_VIEW, through views off it ("scalar"), each launch counted
    on its variant."""
    from repro_torch.kernels import ops

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    want = fa.delta_in_kernel_order(o, do).view(torch.int32)
    out = {"vec16_bit_equal": torch.equal(delta.view(torch.int32), want),
           "plan_equal_c": delta_plan_held(o)["plan_equal_c"]}
    if label in K8_BWD_FMA_VIEW:
        dt = str(o.dtype).removeprefix("torch.")
        before = ops.launch_counts_bwd_delta_by_variant()[dt]["scalar"]
        got = fa.flash_attention_bwd_delta(off_grid(o), off_grid(do))
        check(ops.launch_counts_bwd_delta_by_variant()[dt]["scalar"] == before + 1,
              f"Delta {label} off the grid did not take the scalar variant")
        out["scalar_bit_equal"] = torch.equal(got.view(torch.int32), want)
    check(all(out.values()), f"Delta {label}: not bit for bit its kernel order: {out}")
    return out


def bwd_share(got: torch.Tensor, want: torch.Tensor, rtol: float, atol_rel: float
              ) -> tuple[float, float]:
    """max |got - want| and the largest share of the bar atol_rel max|want|
    + rtol |want| (above 1 fails)."""
    err = (got.double() - want.double()).abs()
    bar = atol_rel * float(want.double().abs().max()) + rtol * want.double().abs()
    return float(err.max()), float((err / bar).max())


def k8_bwd_operands(case, gen):
    q, k, v = k8_operands(case, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    return q, k, v, do


def ptxas_usage(log: str, pattern: str) -> dict:
    """Registers and spill bytes that nvcc's ``-Xptxas=-v`` output (the
    kernel build's log) gives each kernel instantiation whose name starts
    with ``pattern``, keyed ``name<dtype,template ints>``."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            base = re.search("(" + re.escape(pattern) + r"\w*?_kernel)I(.*?)EEv", name)
            key = None
            if base:
                tmpl = base.group(2)
                dtype = "bf16" if tmpl.startswith("13__nv_bfloat16") else (
                    "f32" if tmpl.startswith("f") else "")
                args = ([dtype] if dtype else []) + re.findall(r"L[ib](\d+)E", tmpl + "E")
                key = f"{base.group(1)}<{','.join(args)}>"
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def off_grid(x: torch.Tensor) -> torch.Tensor:
    """x's values in a view whose base lies 2 bytes off the 16-byte grid."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    return y.copy_(x)


def k8_bwd_routed(q, k, v, o, lse, do, route: str, label: str, **kw):
    """The backward, failing unless dK/dV and dQ launched once each, on
    ``route``, and every backward kernel once."""
    from repro_torch.kernels import ops

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    before, before_route = ops.launch_counts(), ops.launch_counts_bwd_by_route()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    after, after_route = ops.launch_counts(), ops.launch_counts_bwd_by_route()
    check(all(after[n] == before[n] + 1 for n in K8_BWD_KERNELS),
          f"K8 backward {label}: not one launch of each kernel")
    check(all(after_route[n][r] == before_route[n][r] + (r == route)
              for n in K8_BWD_ROUTED for r in ("mma", "fma")),
          f"K8 backward {label}: dK/dV and dQ not launched once each on {route!r}")
    return got


def k8_bwd_head_dropped(q, k, v, o, lse, do, **kw):
    """A planted fault: the backward with the last query head of every GQA
    group left out of dK and dV (its dO zeroed)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    g = q.shape[2] // k.shape[2]
    dropped = do.clone()
    dropped[:, :, g - 1::g] = 0
    return fa.flash_attention_bwd(q, k, v, o, lse, dropped, **kw)


def phase_k8_bwd() -> dict:
    """K8's backward kernels (Delta, dK/dV, dQ) against the plain backward
    at every case of K8_BWD_CASES, on the kernel's own forward output and
    lse, each kernel launched once per case and dK/dV and dQ on the route
    flash_attention_bwd_route names (bf16 "mma", float32 "fma"); the cases
    of K8_BWD_FMA_VIEW also on "fma" through views off the 16-byte grid;
    each case twice, the same bits (float32 and bf16 alike); at each case
    on "fma" the dK/dV split's plan in Python (fma_dkdv_plan) against the C
    launcher's, with its clusters per wave; the forward's lse against the
    plain one; a planted fault (a GQA head left out of dK, dV) that the
    bar must reject by more than 1000x; then the times of each kernel on
    each route, the plain backward and scaled_dot_product_attention's
    backward at the main shape (bf16) and at train_lm's (float32, D =
    64)."""
    from repro_torch.kernels import build

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    emit(dict(phase="train", case="k8_bwd_registers",
              ptxas=ptxas_usage(build.load_library().log, "flash_attention_bwd_")))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs: dict = {}
    plans: dict = {}
    for case in K8_BWD_CASES:
        label, dtype, b_, s_, t_, h_, kv_, d_, causal, window, p_dtype = case
        q, k, v, do = k8_bwd_operands(case, gen)
        o, lse = fa.flash_attention_lse(q, k, v, causal=causal, window=window, p_dtype=p_dtype)
        _, lse_plain = fa.flash_attention_plain_lse(q, k, v, causal=causal, window=window,
                                                    p_dtype=p_dtype)
        err, share = bwd_share(lse, lse_plain, 0.0, 1e-5)
        check(share <= 1, f"K8 lse {label}: {err}, {share} of its bar")
        kw = dict(causal=causal, window=window, p_dtype=p_dtype)
        route = fa.flash_attention_bwd_route(dtype, q.shape[-1], True)
        got = k8_bwd_routed(q, k, v, o, lse, do, route, label, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        rtol, atol = K8_BWD_BARS[dtype]
        if p_dtype is not None:
            atol = K8_BWD_P_BF16_ATOL
        row = dict(route=route, lse=dict(max_abs_err=err, of_bar=share))
        for name, g_, w in zip(("dq", "dk", "dv"), got, want):
            check(g_.dtype == dtype and g_.shape == w.shape, f"K8 backward {label}: {name}")
            e, sh = bwd_share(g_, w, rtol, atol)
            check(sh <= 1, f"K8 backward {label} {name}: max err {e}, {sh} of its bar")
            row[name] = dict(max_abs_err=e, of_bar=sh)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        row["same_bits_twice"] = all(torch.equal(a, b) for a, b in zip(got, again))
        check(row["same_bits_twice"], f"K8 backward {label}: two runs differ")
        if route == "fma" or label in K8_BWD_FMA_VIEW:
            shape = (b_, s_, t_, h_, kv_, d_, causal, window)
            plan, on_card = fa.fma_dkdv_plan(*shape), fa.fma_dkdv_plan_on_device(*shape)
            tiles = b_ * kv_ * len(plan["tiles"])
            plans[label] = dict(ranks=plan["ranks"], key_tiles=tiles,
                                clusters_per_wave=on_card["clusters_per_wave"])
            check(plan == {key: on_card[key] for key in ("ranks", "tiles")},
                  f"K8 backward {label}: the dK/dV plan in Python and in C differ")
            check(plan["ranks"] == 1 or tiles <= on_card["clusters_per_wave"],
                  f"K8 backward {label}: the dK/dV split runs in more than one wave: {plans}")
        if label in K8_BWD_FMA_VIEW:
            views = [off_grid(x) for x in (q, k, v, do)]
            got_fma = k8_bwd_routed(*views[:3], o, lse, views[3], "fma", f"{label} off grid",
                                    **kw)
            row["fma_view"] = {}
            for name, g_, w in zip(("dq", "dk", "dv"), got_fma, want):
                e, sh = bwd_share(g_, w, rtol, atol)
                check(sh <= 1, f"K8 backward {label} {name} on fma: max err {e}, {sh} of its bar")
                row["fma_view"][name] = dict(max_abs_err=e, of_bar=sh)
        delta = fa.flash_attention_bwd_delta(o, do)
        e, sh = bwd_share(delta, (do.float() * o.float()).sum(-1).transpose(1, 2), 0.0, 1e-5)
        check(sh <= 1, f"K8 backward {label} delta: {e}, {sh} of its bar")
        row["delta"] = dict(max_abs_err=e, of_bar=sh, **delta_bits(o, do, delta, label))
        errs[label] = row
    emit(dict(phase="train", case="k8_bwd_vs_plain",
              bars={str(dt).removeprefix("torch."): dict(rtol=r, atol_of_max=a)
                    for dt, (r, a) in K8_BWD_BARS.items()},
              p_bf16_atol_of_max=K8_BWD_P_BF16_ATOL, errors=errs, fma_dkdv_plans=plans))

    q, k, v, do = k8_bwd_operands(K8_BWD_MAIN, gen)
    o, lse = fa.flash_attention_lse(q, k, v)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    _dq, dk, _dv = k8_bwd_head_dropped(q, k, v, o, lse, do)
    err, share = bwd_share(dk, want[1], *K8_BWD_BARS[BF16])
    check(share > 1000, f"K8 backward's bar passes the planted fault, or fails it by 1000x or "
                        f"less: {share} of it")
    faults = {"gqa_head_dropped_dk": dict(max_abs_err=err, of_bar=share)}
    # Delta with one lane's chunk (row elements 4 .. 7 in float32) left
    # out, at train_lm's shape, against Delta's bar
    q, k, v, do = k8_bwd_operands(K8_BWD_F32, gen)
    o, _ = fa.flash_attention_lse(q, k, v)
    e = 16 // o.element_size()
    dropped = fa.flash_attention_bwd_delta(o, do) - \
        (do[..., e:2 * e].float() * o[..., e:2 * e].float()).sum(-1).transpose(1, 2)
    err, share = bwd_share(dropped, (do.float() * o.float()).sum(-1).transpose(1, 2), 0.0, 1e-5)
    check(share > 1000, f"Delta's bar passes the planted fault, or fails it by 1000x or less: "
                        f"{share} of it")
    faults["delta_lane_chunk_dropped"] = dict(max_abs_err=err, of_bar=share)
    emit(dict(phase="train", case="k8_bwd_planted_fault", faults=faults))

    rows = {}
    for key, case in (("bf16", K8_BWD_MAIN), ("f32", K8_BWD_F32)):
        rows[key] = k8_bwd_times(*k8_bwd_operands(case, gen), errs)
        emit(dict(phase="train", case="k8_bwd_times", **rows[key]))
    return rows


def k8_bwd_times(q, k, v, do, errs: dict | None = None) -> dict:
    """Each backward kernel's time (causal, p float32) on the route the
    inputs take, and in bf16 also dK/dV and dQ on the FMA route through
    views off the 16-byte grid (``fma_ms``): the median of
    K8_BWD_TIMING_CALLS calls after a warm-up, with the spread; each
    kernel's bound at the peak of the inputs' type, counting the products
    the algorithm needs (8 d and 6 d flops a pair; with p float32 the
    tensor-core route's P and dS split does 12 d and 8 d, 1.5x and 1.33x
    that, on the tensor cores); the plain backward's time and that
    of scaled_dot_product_attention's backward (the library call, timed
    only, the same way); with ``errs`` (phase_k8_bwd's), each kernel's
    largest error in the inputs' dtype."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    bf16 = q.dtype == BF16
    dtype = str(q.dtype).removeprefix("torch.")
    o, lse = fa.flash_attention_lse(q, k, v)
    lse = lse.contiguous()
    delta = fa.flash_attention_bwd_delta(o, do)
    route = fa.flash_attention_bwd_route(q.dtype, d, True)
    qu, ku, vu, dou = (off_grid(x) for x in (q, k, v, do))
    calls = {
        "flash_attention_bwd_delta": (lambda: fa.flash_attention_bwd_delta(o, do), None),
        "flash_attention_bwd_dkdv": (lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta),
                                     lambda: fa.flash_attention_bwd_dkdv(qu, ku, vu, dou, lse,
                                                                         delta)),
        "flash_attention_bwd_dq": (lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                                   lambda: fa.flash_attention_bwd_dq(qu, ku, vu, dou, lse, delta)),
    }
    costs = fa.backward_costs(q, k, v, True, 0)
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                                enable_gqa=True)
    do_h = do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qh, kh, vh), do_h, retain_graph=True)

    lib_dq = sdpa_bwd()[0].transpose(1, 2)
    got_dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    library = cuda_ms_spread(sdpa_bwd, K8_BWD_TIMING_CALLS)
    # the library call's device time: its kernels under the profiler
    prof = device_breakdown(lambda: [sdpa_bwd() for _ in range(K8_BWD_TIMING_CALLS)])
    library_device = (sum(prof["device_ms"].values()) / K8_BWD_TIMING_CALLS
                      if prof["device_ms"] else None)
    out = dict(shape=[b, s, t, h, kv, d], causal=True, dtype=dtype, route=route,
               bound_peak=("bf16 tensor cores, 989 TFLOP/s" if bf16 else "float32 FMA, 67 TFLOP/s")
               + " (the inputs' type)",
               plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do), 3),
               plain_covers="the whole plain backward (dq, dk, dv)",
               library_backward_ms=library["median"], library_backward_spread_ms=library,
               library_backward_device_ms=library_device,
               library_backward_kernels=prof["top_kernels"][:4],
               library_max_abs_err_dq=float((lib_dq.float() - got_dq.float()).abs().max()),
               timing=f"median of {K8_BWD_TIMING_CALLS} calls after 3, each between two events",
               kernels={})
    for name, (fn, fma_fn) in calls.items():
        flops, nbytes = costs[name]
        bound_ms, bound_by = bound(nbytes, flops, q.dtype)
        spread = cuda_ms_spread(fn, K8_BWD_TIMING_CALLS)
        ms = spread["median"]
        row = dict(kernel_route=route if fma_fn is not None else None, ms=ms, spread_ms=spread,
                   device_ms=graph_ms(fn, 5),
                   bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops, tflop_per_s=flops / (ms * 1e-3) / 1e12)
        if fma_fn is not None and route == "mma":
            fma = cuda_ms_spread(fma_fn, K8_BWD_TIMING_CALLS)
            row.update(fma_ms=fma["median"], fma_spread_ms=fma, fma_device_ms=graph_ms(fma_fn, 5))
        if name == "flash_attention_bwd_delta":
            # Delta's one-call yardstick (in bf16 the einsum's result is
            # bf16, Delta's float32: the same sum, rounded once more)
            lib_delta = lambda: torch.einsum("bshd,bshd->bhs", do, o)  # noqa: E731
            lib_t = cuda_ms_spread(lib_delta, K8_BWD_TIMING_CALLS)
            row.update(library='torch.einsum("bshd,bshd->bhs", do, o)'
                       + (" (bf16 result)" if bf16 else ""), library_ms=lib_t["median"],
                       library_spread_ms=lib_t,
                       library_device_ms=graph_ms(lib_delta, 5),
                       library_device_ms_graph_of_50=graph_ms(lib_delta, DELTA_GRAPH_CALLS),
                       device_ms_graph_of_50=graph_ms(fn, DELTA_GRAPH_CALLS), **delta_fixed_ms(o))
        out["kernels"][name] = row
    out["backward_ms"] = sum(r["ms"] for r in out["kernels"].values())
    out["dkdv_dq_device_ms"] = sum(out["kernels"][n]["device_ms"] for n in K8_BWD_ROUTED)
    if errs is None:
        return out
    out["max_abs_err"] = {
        "flash_attention_bwd_delta": max(r["delta"]["max_abs_err"] for lbl, r in errs.items()
                                         if case_dtype(lbl) == q.dtype),
        "flash_attention_bwd_dkdv": max(max(r["dk"]["max_abs_err"], r["dv"]["max_abs_err"])
                                        for lbl, r in errs.items() if case_dtype(lbl) == q.dtype),
        "flash_attention_bwd_dq": max(r["dq"]["max_abs_err"] for lbl, r in errs.items()
                                      if case_dtype(lbl) == q.dtype),
    }
    return out


def delta_plan_held(o: torch.Tensor) -> dict:
    """Delta's grid for ``o`` as the C entry point reports it
    (delta_plan_on_device: lanes, warps a block, blocks), held against the
    plan in Python (delta_plan)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, s, h, d = o.shape
    plan, on_card = fa.delta_plan(o.dtype, d, b * s * h), fa.delta_plan_on_device(o.dtype, b, s,
                                                                                   h, d)
    equal = {key: plan[key] for key in on_card} == on_card
    check(equal, f"Delta {tuple(o.shape)}: the plan in Python {plan} and in C {on_card} differ")
    return dict(plan_equal_c=equal, **on_card)


def delta_fixed_ms(o: torch.Tensor) -> dict:
    """Delta's launch over zero rows on the grid it takes for ``o`` (the C
    entry point's, delta_plan_held), in CUDA graphs of 5 and of 50 (device
    ms): the launch's fixed cost, which weighs at train_lm's 4.7 MB."""
    from repro_torch.kernels import build

    b, s, h, d = o.shape
    plan = delta_plan_held(o)
    lib = build.load_library()
    is_bf16 = int(o.dtype == BF16)

    def empty():
        lib.call("repro_flash_attention_bwd_delta_empty", is_bf16, b, s, h, d,
                 build.current_stream(o.device))

    return dict(fixed_device_ms=graph_ms(empty, 5),
                fixed_device_ms_graph_of_50=graph_ms(empty, DELTA_GRAPH_CALLS),
                fixed_blocks=plan["blocks"], fixed_warps_a_block=plan["warps"])


def case_dtype(label: str) -> torch.dtype:
    return next(c[1] for c in K8_BWD_CASES if c[0] == label)


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

# (a) examples/train_lm.py's default run: lm_100m, B = 4, S = 192, 300
# AnalogNewton steps, a refresh and a checkpoint every 100
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 300, 4, 192, 0.02
TRAIN_LOSS_DROP = 0.2          # the reference's own bar (tests/test_training_optim.py:53)
# (b) Qwen3-8B at its published width, 2 of its 36 layers (the full model
# with AdamW's float32 moments does not fit one 80 GB card), bf16, AdamW
WIDE_ARCH, WIDE_LAYERS, WIDE_BATCH, WIDE_SEQ, WIDE_STEPS = "qwen3_8b", 2, 1, 2048, 3
# (c) every family's SMOKE config, one AdamW step at TRAIN_SMOKE_LR, card
# against CPU, with the CPU parity bars (tests/test_torch_training.py): the
# loss 1e-5, every gradient leaf 1e-4 of its largest element, the updated
# parameters 1e-4 of their largest wherever the gradient stands above the
# gradient bar's noise (|g| > TOL_TRAIN_SIGNAL max|g|).  Below it Adam's
# first step u = g / (|g| + eps) is sign-like, any value in (-1, 1) for a
# noise-level g, so there the bar is the step itself: 2 lr.
TRAIN_SMOKE_ARCHS = ("qwen3_8b", "internvl2_1b", "granite_moe_1b_a400m", "mixtral_8x22b",
                     "mamba2_370m", "zamba2_7b", "whisper_base")
TRAIN_SMOKE_LR = 1e-3
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, TOL_TRAIN_PARAM, TOL_TRAIN_SIGNAL = 1e-5, 1e-4, 1e-4, 1e-3


def load_example(name: str):
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k8_counts() -> dict:
    from repro_torch.kernels import ops

    counts = ops.launch_counts()
    return dict(forward_by_route=ops.launch_counts_by_route()["flash_attention"],
                backward={n: counts[n] for n in K8_BWD_KERNELS},
                delta_by_variant=ops.launch_counts_bwd_delta_by_variant(),
                backward_by_dtype=ops.launch_counts_bwd_by_dtype(),
                backward_by_route=ops.launch_counts_bwd_by_route())


def same_tensors(a, b) -> bool:
    """Every tensor and int of two train states equal, bit for bit."""
    if isinstance(a, torch.nn.Module):
        pb = dict(b.named_parameters())
        return all(torch.equal(p, pb[n]) for n, p in a.named_parameters())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def train_lm_default(dev) -> dict:
    """Case (a): examples/train_lm.py's default run on the port."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_optimizer, train_loop
    from repro_torch.training import init_train_state

    an = importlib.import_module("repro_torch.optim.analog_newton")
    ex = load_example("train_lm_torch")
    cfg, acfg = ex.lm_100m(), ex.analog_config(False)
    an.reset_refresh_stats()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    timings: dict = {}
    lines: list = []
    with tempfile.TemporaryDirectory(prefix="repro_train_smoke_") as ckpt:
        t0 = time.perf_counter()
        out = train_loop(cfg, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         optimizer_name="analog_newton", lr=TRAIN_LR, ckpt_dir=ckpt,
                         ckpt_every=100, analog_cfg=acfg, log_fn=lines.append, device=dev,
                         timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k8_counts()
        peak = torch.cuda.max_memory_allocated()
        rs = an.REFRESH_STATS
        optimizer, _ = build_optimizer("analog_newton", TRAIN_LR, TRAIN_STEPS, acfg)
        fresh = init_train_state(cfg, optimizer, torch.Generator(device=dev).manual_seed(SEED),
                                 device=dev)
        step, restored, ds = CheckpointManager(ckpt).restore_latest(fresh)
        restored_equal = step == TRAIN_STEPS and same_tensors(out["state"], restored)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    res = dict(case="train_lm_100m", steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               optimizer="analog_newton", lr=TRAIN_LR, wall_s=wall,
               ms_per_step=timings["step"] / TRAIN_STEPS * 1e3, timings_s=timings,
               refresh_wall_s=timings.get("refresh", 0.0),
               refresh_s_each=timings.get("refresh", 0.0) / max(rs.refreshes, 1),
               refresh_stats=dict(refreshes=rs.refreshes, solve_batch_calls=rs.solve_batch_calls,
                                  systems_solved=rs.systems_solved,
                                  pattern_derivations=rs.pattern_derivations),
               loss_curve=[[h["step"], h["loss"]] for h in hist], first_loss=losses[0],
               last_loss=losses[-1], k8=launches, peak_memory_bytes=peak,
               restored_bit_for_bit=restored_equal, data_state=ds, log_tail=lines[-3:])
    emit(dict(phase="train", **res))
    check(all(np.isfinite(losses)), f"train_lm 100M: non-finite loss {losses}")
    check(losses[-1] <= losses[0] - TRAIN_LOSS_DROP,
          f"train_lm 100M: loss {losses[0]} -> {losses[-1]}, less than {TRAIN_LOSS_DROP} nats")
    check(rs.refreshes == rs.solve_batch_calls == TRAIN_STEPS // acfg.refresh_every
          and rs.pattern_derivations == 1 and rs.systems_solved == 3 * 768,
          f"train_lm 100M refresh accounting: {res['refresh_stats']}")
    check(launches["forward_by_route"]["fma"] > 0
          and all(launches["backward"][n] > 0 for n in K8_BWD_KERNELS)
          and all(launches["backward_by_route"][n]["fma"] > 0 for n in K8_BWD_ROUTED),
          f"train_lm 100M: K8 forward/backward not launched: {launches}")
    check(restored_equal, "train_lm 100M: restore_latest did not give back the final state")
    return res


# train_lm's step under the profiler: steps after a warm-up, from a fresh state
TRAIN_PROFILE_WARMUP, TRAIN_PROFILE_STEPS = 3, 5
TRAIN_PROFILE_RANGE = "train_profile::optimizer_update"
TRAIN_PROFILE_KINDS = ("k8_forward", "flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
                       "flash_attention_bwd_dq", "matmul", "other")


def train_kernel_kind(name: str) -> str:
    """The kind of a device kernel of train_lm's step, by its name."""
    name = name.lower()
    for bwd in TRAIN_PROFILE_KINDS[1:4]:
        if bwd in name:
            return bwd
    if "flash_attention" in name:
        return "k8_forward"
    if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
        return "matmul"
    return "other"


def train_profile(dev) -> dict:
    """train_lm's step (case (a): lm_100m, B = 4, S = 192, float32,
    AnalogNewton at TRAIN_LR) under torch.profiler: TRAIN_PROFILE_STEPS
    steps after TRAIN_PROFILE_WARMUP, from a fresh state, the batches made
    on the card before the window.  Device ms a step by kind (K8's forward,
    each backward kernel, matrix products, the rest), the optimizer's
    update (AnalogNewton's preconditioned step: the device time of the
    kernels launched inside it, which the kinds also count), the busy
    share (kernel time over the window's wall time; one stream, so kernels
    do not overlap) and the host ms a step.  AnalogNewton's refresh runs
    every 100 steps, outside the window (train (a)'s ``refresh_s_each``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.launch.train import build_optimizer
    from repro_torch.optim.adamw import Optimizer
    from repro_torch.training import init_train_state, make_train_step

    ex = load_example("train_lm_torch")
    cfg, acfg = ex.lm_100m(), ex.analog_config(False)
    opt, _ = build_optimizer("analog_newton", TRAIN_LR, TRAIN_STEPS, acfg)

    def update(*args):
        with record_function(TRAIN_PROFILE_RANGE):
            return opt.update(*args)

    ranged = Optimizer(init=opt.init, update=update)
    state = init_train_state(cfg, ranged, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    step_fn = make_train_step(cfg, ranged)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=SEED)
    batches = [{k: torch.as_tensor(x, device=dev) for k, x in next(data).items()}
               for _ in range(TRAIN_PROFILE_WARMUP + TRAIN_PROFILE_STEPS)]
    data.close()
    for batch in batches[:TRAIN_PROFILE_WARMUP]:
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[TRAIN_PROFILE_WARMUP:]:
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = dict.fromkeys(TRAIN_PROFILE_KINDS, 0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            kinds[train_kernel_kind(e.key)] += us / 1e3
    optimizer_ms = sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
                       if e.name == TRAIN_PROFILE_RANGE) / 1e3
    busy = sum(kinds.values())
    n = TRAIN_PROFILE_STEPS
    return dict(case="train_profile", steps=n, warmup=TRAIN_PROFILE_WARMUP,
                device_ms_per_step={k: v / n for k, v in kinds.items()} if busy else None,
                device_ms_per_step_total=busy / n if busy else None,
                optimizer_update_device_ms_per_step=optimizer_ms / n if busy else None,
                busy_share=busy / wall_ms if busy else None, host_ms_per_step=wall_ms / n)


def train_wide(dev) -> dict:
    """Case (b): Qwen3-8B's width, WIDE_LAYERS layers, bf16, AdamW, with the
    first layer's attention inputs captured and its backward held against
    the plain backward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import adamw
    from repro_torch.training import init_train_state, make_train_step

    attn_mod = importlib.import_module("repro_torch.models.attention")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg = dataclasses.replace(get_config(WIDE_ARCH), n_layers=WIDE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw(3e-4)
    state = init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    n_params = sum(p.numel() for p in state["params"].parameters())
    step_fn = make_train_step(cfg, opt)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=WIDE_SEQ, batch_size=WIDE_BATCH, seed=SEED)
    captured = []
    real = attn_mod.flash_attention

    def capture(q, k, v, **kw):
        if not captured:
            captured.append((q.detach(), k.detach(), v.detach(), kw))
        return real(q, k, v, **kw)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, step_ms = [], []
    attn_mod.flash_attention = capture
    try:
        for _ in range(WIDE_STEPS):
            batch = {k: torch.as_tensor(x, device=dev) for k, x in next(data).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        attn_mod.flash_attention = real
        data.close()
    launches = k8_counts()
    peak = torch.cuda.max_memory_allocated()
    q, k, v, kw = captured[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    errs = {}
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        e, sh = bwd_share(g_, w, *K8_BWD_BARS[q.dtype])
        errs[name] = dict(max_abs_err=e, of_bar=sh)
    res = dict(case="qwen3_8b_width_2_layers", layers=WIDE_LAYERS, params=n_params,
               batch=WIDE_BATCH, seq=WIDE_SEQ, optimizer="adamw", dtype="bfloat16",
               losses=losses, ms_per_step=step_ms, k8=launches, peak_memory_bytes=peak,
               first_layer_attention=dict(shape=list(q.shape), kv_shape=list(k.shape),
                                          errors=errs))
    emit(dict(phase="train", **res))
    del state, step_fn, captured
    check(all(np.isfinite(losses)), f"Qwen3-8B width: non-finite loss {losses}")
    check(all(e["of_bar"] <= 1 for e in errs.values()),
          f"Qwen3-8B width: first layer's backward off its bar: {errs}")
    check(launches["forward_by_route"]["mma"] > 0
          and all(launches["backward_by_dtype"][n]["bfloat16"] > 0 for n in K8_BWD_KERNELS)
          and all(launches["backward_by_route"][n]["mma"] > 0 for n in K8_BWD_ROUTED),
          f"Qwen3-8B width: K8 forward/backward not launched on the tensor cores: {launches}")
    return res


def train_smoke_cross_device(arch: str, dev) -> dict:
    """Case (c): one AdamW train step of the arch's SMOKE config (float32) on
    the card and on the CPU from one state: loss, every gradient leaf and
    every updated parameter within the CPU parity bars."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import forward_train
    from repro_torch.optim.adamw import adamw
    from repro_torch.training import cross_entropy_loss, init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    opt = adamw(TRAIN_SMOKE_LR)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)   # 2 SMOKE ssm chunks
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        state = init_train_state(cfg, opt, torch.Generator().manual_seed(SEED), device="cpu")
        state["params"].to(where)
        state["opt_state"] = opt.init(dict(state["params"].named_parameters()))
        feed = {k: torch.from_numpy(x).to(where) for k, x in batch.items()}
        logits, aux = forward_train(state["params"], feed, cfg)
        loss = cross_entropy_loss(logits, feed["targets"], cfg.vocab)[0] + 0.01 * aux
        loss.backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in state["params"].named_parameters()}
        state["params"].zero_grad(set_to_none=True)
        state, m = make_train_step(cfg, opt)(state, feed)
        params = {n: p.detach().double().cpu() for n, p in state["params"].named_parameters()}
        out[where if where == "cpu" else "cuda"] = (float(m["loss"]), grads, params)
    (loss_cpu, grad_cpu, param_cpu), (loss_gpu, grad_gpu, param_gpu) = out["cpu"], out["cuda"]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = max(float((grad_gpu[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                   for n, w in grad_cpu.items())
    signal_err, noise_err = 0.0, 0.0
    for n, w in param_cpu.items():
        err = (param_gpu[n] - w).abs()
        signal = grad_cpu[n].abs() > TOL_TRAIN_SIGNAL * float(grad_cpu[n].abs().max())
        if bool(signal.any()):
            signal_err = max(signal_err, float(err[signal].max()) / float(w.abs().max()))
        if bool((~signal).any()):
            noise_err = max(noise_err, float(err[~signal].max()) / TRAIN_SMOKE_LR)
    check(loss_err <= TOL_TRAIN_LOSS,
          f"{arch} train step: loss {loss_gpu} vs {loss_cpu} on the CPU")
    check(grad_err <= TOL_TRAIN_GRAD, f"{arch} train step: a gradient {grad_err} of its max")
    check(signal_err <= TOL_TRAIN_PARAM and noise_err <= 2,
          f"{arch} train step: parameters {signal_err} of their max where the gradient is "
          f"signal, {noise_err} lr where it is noise")
    return dict(loss_err_of_loss=loss_err, grad_err_of_max=grad_err,
                param_err_of_max=signal_err, param_err_in_lr_where_noise=noise_err)


def phase_train(dev) -> dict:
    """The training path: cases (a), (b) and (c).  Returns K8's launches by
    case: forward by route, backward by kernel and dtype."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    res = {"train_lm_100m": train_lm_default(dev)}
    profiled = train_profile(dev)
    emit(dict(phase="train", **profiled))
    check(profiled["device_ms_per_step"] is not None
          and all(profiled["device_ms_per_step"][n] > 0 for n in TRAIN_PROFILE_KINDS[:4]),
          f"train_lm profile: no device time of K8's kernels: {profiled}")
    res["qwen3_8b_width"] = train_wide(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    smoke = {arch: train_smoke_cross_device(arch, dev) for arch in TRAIN_SMOKE_ARCHS}
    res["smoke"] = dict(k8=k8_counts())
    emit(dict(phase="train", case="smoke_card_vs_cpu", archs=smoke, k8=res["smoke"]["k8"],
              bars=dict(loss=TOL_TRAIN_LOSS, grad=TOL_TRAIN_GRAD, param=TOL_TRAIN_PARAM,
                        signal=TOL_TRAIN_SIGNAL, param_where_noise_in_lr=2)))
    emit(dict(phase="train", case="wall", wall_s=time.perf_counter() - t0))
    return {case: r["k8"] for case, r in res.items()}


# ---------------------------------------------------------------------------
# phase 8b: the dry run and the roofline counter
# ---------------------------------------------------------------------------

# the dry run's cells are traced on meta in this many processes (host work,
# one core each: the machine's eight), while the counted steps of case (b)
# run on the card
DRYRUN_WORKERS = 8
# serve: the 1974-token prefill of one prompt into a cache of the serve
# phase's length, then one decode step at position 1974
COUNTED_PROMPT = 1974
# the counter's modelled peak (what a step adds to what it found
# allocated) against the card's max_memory_allocated() less
# memory_allocated() before the step: the caching allocator rounds every
# block up to 512 bytes and may hand a request above 1 MiB a larger block
# it does not split, so 5 % of the card's figure, and 16 MiB for the
# small steps
PEAK_RTOL = 0.05
PEAK_ATOL_BYTES = 16 * 2**20
# one rank's step of a production mesh run on the card at its full shape
RANK_ARCH, RANK_SHAPE, RANK_MESH = "qwen3_8b", "decode_32k", "single_pod"
# case (d): the depth of each tensor-parallel rank's prefill (K8_TP_CASES)
TP_PREFILL_LAYERS = 2
N_CHIPS = {"single_pod": 256, "multi_pod": 512}


def dryrun_jobs() -> list[tuple]:
    """Every arch x shape cell on ``single_card`` and on both production
    meshes (the attention batch layout on, as the dry run's CLI runs
    them): ``repro_torch.launch.dryrun.cell_or_error``'s arguments."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun

    return [(arch, shape, mesh, False, card_spec(), mesh != "single_card")
            for mesh in dryrun.MESHES for arch in ARCH_IDS for shape in SHAPES]


def start_cells(pool) -> dict:
    """The cells of :func:`dryrun_jobs` submitted to ``pool``, by (mesh,
    arch, shape)."""
    from repro_torch.launch import dryrun

    return {(job[2], job[0], job[1]): pool.submit(dryrun.cell_or_error, *job)
            for job in dryrun_jobs()}


def dryrun_cells(results: dict, host_s: float) -> dict:
    """Case (a): ``repro_torch.launch.dryrun`` over every arch x shape on
    ``single_card`` and both production meshes, the card's spec modelled.
    Each cell must be ``ok``, or ``skipped`` with the reference's reason
    where the reference skips it (``long_500k`` on a full-attention arch);
    an ok cell of a production mesh must trace its mesh's ranks, count
    collectives and gather at least one leaf."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch import dryrun

    out = {mesh: {} for mesh in dryrun.MESHES}
    bad = []
    for (mesh, arch, shape), r in results.items():
        applies, reason = shape_applicable(get_config(arch), SHAPES[shape])
        sharded_ok = mesh == "single_card" or r.get("status") != "ok" or (
            r["n_chips"] == N_CHIPS[mesh] and r["collectives"]["total"] > 0
            and r["collectives"]["all-gather"] > 0
            and r["compute"] == dryrun.sharded_compute(get_config(arch)))
        if r["status"] == "ok" and applies and sharded_ok:
            roof = r["roofline"]
            out[mesh][f"{arch}__{shape}"] = dict(
                dominant=roof["dominant"], bound_s=roof["step_time_lower_bound_s"],
                temp_size_b=r["memory"]["temp_size_b"],
                argument_size_b=r["memory"]["argument_size_b"],
                collective_b=r["collectives"]["total"],
                useful_flops_ratio=roof["useful_flops_ratio"], host_s=r["host_s"])
        elif r["status"] == "skipped" and not applies and r["reason"] == reason:
            out[mesh][f"{arch}__{shape}"] = dict(skipped=r["reason"])
        else:
            bad.append(dict(cell=f"{mesh}/{arch}__{shape}", status=r["status"],
                            error=r.get("error"), traceback=r.get("traceback")))
    for mesh, cells in out.items():
        emit(dict(phase="dryrun", case="cells" if mesh == "single_card" else f"cells_{mesh}",
                  mesh=mesh, hw=card_spec().name, workers=DRYRUN_WORKERS,
                  ok=sum("dominant" in c for c in cells.values()),
                  skipped=sum("skipped" in c for c in cells.values()), cells=cells))
    emit(dict(phase="dryrun", case="cells_host", host_s=host_s, cells=len(results),
              failed=bad))
    check(not bad and len(results) == len(dryrun_jobs()), f"dry run: cells failed: {bad}")
    return out


def counted_tokens(device, shape: tuple, vocab: int) -> torch.Tensor:
    """int32 tokens: seeded on the card, shape and dtype alone on meta."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.int32, device="meta")
    gen = torch.Generator(device=device).manual_seed(SEED)
    return torch.randint(0, vocab, shape, generator=gen, device=device, dtype=torch.int32)


def counted_params(cfg, device):
    from repro_torch.models.model import init_params

    meta = torch.device(device).type == "meta"
    return init_params(cfg, None if meta else torch.Generator(device=device).manual_seed(SEED),
                       device=device)


def count_step(label: str, build, dev, cfg, *, train: bool, n_tokens: int,
               ranges: tuple = ()) -> dict:
    """One step, counted by ``repro_torch.roofline.cost.CostCounter`` on
    meta and on the card.  ``build(device)`` returns ``(step, params)``:
    ``step()`` runs the step once.  On the card one uncounted step first
    (libraries load), then the counted step under torch.profiler.  Fails
    unless both counts' FLOPs and bytes are equal, the step's kernel time
    (the profiler's sum) is at least the roofline bound, and the modelled
    peak of live bytes is within PEAK_RTOL and PEAK_ATOL_BYTES of what the
    step added to the card's allocated memory at its peak.  Beside it the
    kernel time by kind (K8, the kernels under ``aten::bmm``: an MoE's
    expert products in a prefill or train step; the rest) and K8's
    launches by route in the counted step, counted from zero; with
    ``ranges``, the device time of the kernels launched inside each
    ``record_function`` range of those names (``device_ms_by_range``, the
    host-side range's; its device-side annotation, whose time is its span,
    stays out of the kernel time)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models.model import model_flops
    from repro_torch.roofline.analysis import roofline_report
    from repro_torch.roofline.cost import CostCounter

    # each step's outputs are held until its counter ends: they are not
    # temporaries
    step, _ = build("meta")
    with CostCounter(device="meta") as on_meta:
        out = step()
    del step, out
    step, params = build(dev)
    step()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with CostCounter(device="cuda") as on_card:
            out = step()
        torch.cuda.synchronize()
    k8_launches = ops.launch_counts_by_route()["flash_attention"]
    del out
    peak = torch.cuda.max_memory_allocated()
    events = prof.key_averages()
    # a record_function range also shows on the device as an annotation
    # whose "self" time is its span, idle gaps included: not a kernel's
    device_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.key not in ranges) / 1e3
    k8_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "flash_attention" in e.key) / 1e3
    bmm_ms = sum(getattr(e, "device_time_total", 0.0) for e in events
                 if e.key == "aten::bmm") / 1e3
    # device-to-device copies: a fake world's collectives copy their input
    # into each rank's slot of the output on the card
    dtod_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                  if e.key.startswith("Memcpy DtoD")) / 1e3
    by_range = {name: sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
                          if e.name == name
                          and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
                for name in ranges}
    roof = roofline_report(flops=float(on_card.flops), bytes_accessed=float(on_card.bytes),
                           collective_bytes=0.0, n_chips=1,
                           model_flops=model_flops(params, cfg, n_tokens, train=train),
                           hw=card_spec(), dtype=cfg.act_dtype())
    bound_ms = roof["step_time_lower_bound_s"] * 1e3
    # operators whose FLOPs or bytes differ ([calls, flops, bytes]); the
    # kernels' wrappers allocate their outputs (no bytes) in their own ways
    differ = {op: dict(meta=on_meta.by_op.get(op), card=on_card.by_op.get(op))
              for op in set(on_meta.by_op) | set(on_card.by_op)
              if (on_meta.by_op.get(op) or [0, 0, 0])[1:]
              != (on_card.by_op.get(op) or [0, 0, 0])[1:]}
    res = dict(phase="dryrun", case=label, flops=on_card.flops, bytes=on_card.bytes,
               meta_flops=on_meta.flops, meta_bytes=on_meta.bytes, ops_that_differ=differ,
               compute_ms=roof["compute_s"] * 1e3, memory_ms=roof["memory_s"] * 1e3,
               dominant=roof["dominant"], bound_ms=bound_ms, device_ms=device_ms,
               share=bound_ms / device_ms if device_ms else None,
               useful_flops_ratio=roof["useful_flops_ratio"],
               modelled_peak_live_bytes=on_card.peak_live_bytes,
               meta_peak_live_bytes=on_meta.peak_live_bytes,
               card_peak_live_bytes=peak - held,
               modelled_peak_temp_bytes=on_card.peak_temp_bytes,
               meta_peak_temp_bytes=on_meta.peak_temp_bytes,
               max_memory_allocated_bytes=peak, allocated_before_step_bytes=held,
               device_ms_by_kind=dict(k8=k8_ms, bmm=bmm_ms, other=device_ms - k8_ms - bmm_ms,
                                      of_other_dtod_copies=dtod_ms),
               device_ms_by_range=by_range, k8_launches=k8_launches,
               kernels=on_card.kernels, hw=roof["hw"], compute_dtype=roof["compute_dtype"])
    emit(res)
    del step, params
    gc.collect()
    torch.cuda.empty_cache()
    check(not differ and on_meta.flops == on_card.flops and on_meta.bytes == on_card.bytes,
          f"{label}: meta and the card counted differently: {differ}")
    check(device_ms >= bound_ms > 0,
          f"{label}: the card's kernel time {device_ms} ms is under the bound {bound_ms} ms")
    check(abs(on_card.peak_live_bytes - (peak - held))
          <= PEAK_RTOL * (peak - held) + PEAK_ATOL_BYTES,
          f"{label}: modelled peak {on_card.peak_live_bytes} B against the card's "
          f"{peak - held} B")
    return res


def tp_rank_model(cfg, mesh, rules, device):
    """Rank 0's tensor-parallel model on ``mesh`` (a fake world: its
    collectives move nothing) under ``rules``: each leaf its shard,
    gathered over "data" alone, drawn from SEED on the card (norms 1,
    weights N(0, 0.02)), shapes and dtypes alone on meta; its ``split``
    says how the rank computes its share."""
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.models.model import gather_params, init_params, param_logical_axes

    params = dict(init_params(cfg, None, device="meta").named_parameters())
    model = gather_params(cfg, reshard_state(params, param_logical_axes(cfg), mesh, rules))
    if torch.device(device).type == "meta":
        return model
    model = model.to_empty(device=device).requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(SEED)
    for p in model.parameters():
        if p.ndim == 1:
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
    return model


def tp_share(cfg, rules, mesh) -> dict:
    """What a tensor-parallel rank holds under ``rules``: its split (the
    attention's mode, its q and kv heads, ff columns and vocab rows) and
    its leaves' bytes against the whole model's."""
    from repro_torch.models.model import init_params

    model = tp_rank_model(cfg, mesh, rules, "meta")
    sp = model.split

    def nbytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())

    return dict(attn=sp.attn, ranks=sp.count, heads=sp.heads, kv_heads=sp.kv_heads,
                kv_sliced=sp.kv_sliced, ff=sp.ff, vocab=sp.vocab, moe=sp.moe,
                experts=sp.experts, leaf_bytes=nbytes(model),
                model_bytes=nbytes(init_params(cfg, None, device="meta")))


def tp_rank_prefills(dev) -> dict:
    """Case (d): each dense arch of K8_TP_CASES at full width, cut to
    TP_PREFILL_LAYERS layers, one tensor-parallel rank's prefill (heads
    mode on 16 "model" ranks of a fake world: its q heads over the kv head
    they read, a sixteenth of ff and of the vocab; one prompt of
    K8_TP_CASES' 2048 tokens) on the card: K8 launched at the rank's
    heads, each layer once, counted from zero over the prefill; its share
    and the rank's logits' finiteness printed.  Returns the launches by
    arch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.rules import make_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models.model import prefill

    out = {**moe_rank_prefills(dev), **hybrid_rank_prefill(dev), **encdec_rank_prefill(dev)}
    for arch, case in K8_TP_CASES.items():
        if arch in TP_MOE_ARCHS or arch == TP_HYBRID_ARCH:
            continue
        cfg = dataclasses.replace(get_config(arch), n_layers=TP_PREFILL_LAYERS)
        rules = {**make_rules(cfg, job="prefill"), "batch": "data"}
        t0 = time.perf_counter()
        with fake_world(mesh_shape=(1, TP_RANKS)) as mesh:
            model = tp_rank_model(cfg, mesh, rules, dev)
            check((model.split.attn, model.split.heads, model.split.kv_heads)
                  == ("heads", case[5], case[6]),
                  f"{arch}: a rank's heads are not {case[5]} q / {case[6]} kv: {model.split}")
            tokens = counted_tokens(dev, (case[2], case[3]), cfg.vocab)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            logits, _ = prefill(model, {"tokens": tokens}, cfg, case[3])
            torch.cuda.synchronize()
            launches = ops.launch_counts_by_route()["flash_attention"]["mma"]
            share = tp_share(cfg, rules, mesh)
        del model
        out[arch] = launches
        emit(dict(phase="dryrun", case=f"tp_rank_prefill_{arch}", layers=TP_PREFILL_LAYERS,
                  tokens=case[3], k8_launches=launches, share=share,
                  logits_shape=list(logits.shape), logits_finite=bool(logits.isfinite().all()),
                  wall_s=time.perf_counter() - t0))
        check(launches == TP_PREFILL_LAYERS, f"{arch}: K8 launched {launches} times in a rank's "
                                             f"prefill of {TP_PREFILL_LAYERS} layers")
    return out


def moe_rank_prefills(dev) -> dict:
    """Case (e): each MoE arch of TP_MOE_ARCHS at full width, cut to
    TP_PREFILL_LAYERS layers, one rank's prefill on 16 "model" ranks of a
    fake world (heads mode: its q heads over the kv head they read; its
    experts' share: Granite-MoE's 2 of 32 experts, Mixtral's 1,024 of
    each expert's 16,384 ff columns; one prompt of K8_TP_CASES' 2048
    tokens in the config's 16 dispatch groups), counted on meta and on the
    card by :func:`count_step` (its kernel time by kind: the expert
    products, K8, the rest; the bound and share; the modelled peak), K8
    launched at the rank's heads once a layer in the counted prefill.
    Returns the launches by arch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.rules import make_rules
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models.model import prefill

    out = {}
    for arch in TP_MOE_ARCHS:
        case = K8_TP_CASES[arch]
        cfg = dataclasses.replace(get_config(arch), n_layers=TP_PREFILL_LAYERS)
        rules = {**make_rules(cfg, job="prefill"), "batch": "data"}
        t0 = time.perf_counter()
        with fake_world(mesh_shape=(1, TP_RANKS)) as mesh:
            def build(device):
                model = tp_rank_model(cfg, mesh, rules, device)
                tokens = counted_tokens(device, (case[2], case[3]), cfg.vocab)
                return (lambda: prefill(model, {"tokens": tokens}, cfg, case[3])), model

            sp = tp_rank_model(cfg, mesh, rules, "meta").split
            want = ("heads", case[5], case[6],
                    "experts" if cfg.moe_parallel == "ep" else "ff")
            check((sp.attn, sp.heads, sp.kv_heads, sp.moe) == want,
                  f"{arch}: a rank's split is not {want}: {sp}")
            res = count_step(f"moe_rank_prefill_{arch}", build, dev, cfg, train=False,
                             n_tokens=case[2] * case[3])
            res["share_of_model"] = tp_share(cfg, rules, mesh)
        launches = res["k8_launches"]["mma"]
        out[arch] = launches
        emit(dict(phase="dryrun", case=f"moe_rank_prefill_{arch}_summary",
                  layers=TP_PREFILL_LAYERS, tokens=case[3], k8_launches=launches,
                  device_ms_by_kind=res["device_ms_by_kind"], bound_ms=res["bound_ms"],
                  device_ms=res["device_ms"], share=res["share"],
                  share_of_model=res["share_of_model"], wall_s=time.perf_counter() - t0))
        check(launches == TP_PREFILL_LAYERS, f"{arch}: K8 launched {launches} times in a "
                                             f"rank's prefill of {TP_PREFILL_LAYERS} layers")
    return out


def hybrid_rank_prefill(dev) -> dict:
    """Case (f): Zamba2-7B at full width, cut to TP_HYBRID_LAYERS layers
    (one shared-attention application and its group of Mamba blocks), one
    rank's prefill on 16 "model" ranks of a fake world (its 7 of 112 SSM
    heads, 448 of 7,168 ``inner`` columns; the shared attention in heads
    mode, 2 q and 2 kv heads; one prompt of K8_TP_CASES' 2048 tokens, 8
    SSD chunks of 256), counted on meta and on the card by
    :func:`count_step` (its kernel time by kind: the SSD's products under
    ``aten::bmm``, K8, the rest; the bound and share; the modelled peak),
    K8 launched at the rank's heads once, for the one application, in the
    counted prefill.  Returns the launches by arch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.rules import make_rules
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models.model import hybrid_groups, prefill

    arch, case = TP_HYBRID_ARCH, K8_TP_CASES[TP_HYBRID_ARCH]
    cfg = dataclasses.replace(get_config(arch), n_layers=TP_HYBRID_LAYERS)
    rules = {**make_rules(cfg, job="prefill"), "batch": "data"}
    applications = hybrid_groups(cfg)[0]
    t0 = time.perf_counter()
    with fake_world(mesh_shape=(1, TP_RANKS)) as mesh:
        def build(device):
            model = tp_rank_model(cfg, mesh, rules, device)
            tokens = counted_tokens(device, (case[2], case[3]), cfg.vocab)
            return (lambda: prefill(model, {"tokens": tokens}, cfg, case[3])), model

        model = tp_rank_model(cfg, mesh, rules, "meta")
        sp, inner = model.split, model.blocks[0].w_x.shape[1]
        want = ("heads", case[5], case[6], "heads", cfg.ssm_heads // TP_RANKS,
                cfg.d_inner // TP_RANKS)
        got = (sp.attn, sp.heads, sp.kv_heads, sp.ssm, sp.ssm_heads, inner)
        check(got == want, f"{arch}: a rank's split is not {want}: {got}")
        res = count_step(f"hybrid_rank_prefill_{arch}", build, dev, cfg, train=False,
                         n_tokens=case[2] * case[3])
        res["share_of_model"] = tp_share(cfg, rules, mesh)
    launches = res["k8_launches"]["mma"]
    by_kind = res["device_ms_by_kind"]
    emit(dict(phase="dryrun", case=f"hybrid_rank_prefill_{arch}_summary",
              layers=TP_HYBRID_LAYERS, attention_applications=applications, tokens=case[3],
              ssm_heads=sp.ssm_heads, inner_columns=inner, k8_launches=launches,
              device_ms_by_kind=dict(ssd_products=by_kind["bmm"], k8=by_kind["k8"],
                                     other=by_kind["other"]),
              bound_ms=res["bound_ms"], device_ms=res["device_ms"], share=res["share"],
              flops=res["flops"], meta_flops=res["meta_flops"], bytes=res["bytes"],
              meta_bytes=res["meta_bytes"],
              modelled_peak_live_bytes=res["modelled_peak_live_bytes"],
              card_peak_live_bytes=res["card_peak_live_bytes"],
              share_of_model=res["share_of_model"], wall_s=time.perf_counter() - t0))
    check(launches == applications, f"{arch}: K8 launched {launches} times in a rank's prefill "
                                    f"of {applications} shared-attention applications")
    return {arch: launches}


def counted_frames(device, cfg) -> torch.Tensor:
    """An encdec's frame embeddings (1, enc_len, d) in the activation
    dtype: seeded on the card, shape and dtype alone on meta."""
    shape, dt = (1, cfg.enc_len, cfg.d_model), cfg.act_dtype()
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dt, device="meta")
    gen = torch.Generator(device=device).manual_seed(SEED)
    return torch.randn(shape, generator=gen, device=device).to(dt)


@contextlib.contextmanager
def gelu_mlp_ranged(name: str):
    """Every GELU MLP of ``repro_torch.models.blocks`` run inside the
    ``torch.profiler`` range ``name``, inside the block."""
    from torch.profiler import record_function

    from repro_torch.models import blocks

    plain = blocks.gelu_mlp

    def ranged(*args, **kwargs):
        with record_function(name):
            return plain(*args, **kwargs)

    blocks.gelu_mlp = ranged
    try:
        yield
    finally:
        blocks.gelu_mlp = plain


@contextlib.contextmanager
def k8_calls_by_mask(calls: dict):
    """Every flash attention the models call (``repro_torch.models.
    attention.flash_attention``, K8's wrapper) counted in ``calls`` by
    (query rows, keys, causal), inside the block."""
    from repro_torch.models import attention

    plain = attention.flash_attention

    def counted(q, k, v, *, causal=True, **kwargs):
        key = (q.shape[1], k.shape[1], causal)
        calls[key] = calls.get(key, 0) + 1
        return plain(q, k, v, causal=causal, **kwargs)

    attention.flash_attention = counted
    try:
        yield calls
    finally:
        attention.flash_attention = plain


def encdec_rank_prefill(dev) -> dict:
    """Case (g): Whisper-base at full width and depth (6 encoder and 6
    decoder layers), one rank's prefill of its 1,500 frames and a prompt
    of TP_ENCDEC_PROMPT tokens on 16 "model" ranks of a fake world
    (head_dim mode: its 4 of each head's 64 columns, q, k and v gathered
    to whole heads; 128 of 2,048 ``ff`` columns; a sixteenth of the
    padded vocab), counted on meta and on the card by :func:`count_step`
    (its kernel time by kind: K8, the GELU MLP inside
    TP_ENCDEC_MLP_RANGE, the rest; the bound and share; the modelled
    peak), K8 launched 18 times at whole heads in the counted prefill, 6
    by each of K8_TP_WHISPER's attentions in one more prefill, whose
    logits must be finite.  Returns the launches by K8_TP_WHISPER's
    rows."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.rules import make_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models.model import prefill

    cfg = get_config(TP_ENCDEC_ARCH)
    rules = {**make_rules(cfg, job="prefill"), "batch": "data"}
    t0 = time.perf_counter()
    with fake_world(mesh_shape=(1, TP_RANKS)) as mesh:
        def build(device):
            model = tp_rank_model(cfg, mesh, rules, device)
            batch = {"tokens": counted_tokens(device, (1, TP_ENCDEC_PROMPT), cfg.vocab),
                     "frames": counted_frames(device, cfg)}
            return (lambda: prefill(model, batch, cfg, TP_ENCDEC_PROMPT)), model

        model = tp_rank_model(cfg, mesh, rules, "meta")
        sp = model.split
        want = ("head_dim", cfg.n_heads, cfg.n_kv_heads, cfg.d_ff // TP_RANKS,
                cfg.vocab_padded // TP_RANKS, cfg.head_dim // TP_RANKS)
        got = (sp.attn, sp.heads, sp.kv_heads, sp.ff, sp.vocab,
               model.dec_blocks[0].xattn.wq.shape[2])
        check(got == want, f"{TP_ENCDEC_ARCH}: a rank's split is not {want}: {got}")
        with gelu_mlp_ranged(TP_ENCDEC_MLP_RANGE):
            res = count_step(f"encdec_rank_prefill_{TP_ENCDEC_ARCH}", build, dev, cfg,
                             train=False, n_tokens=TP_ENCDEC_PROMPT, ranges=(TP_ENCDEC_MLP_RANGE,))
        res["share_of_model"] = tp_share(cfg, rules, mesh)
        step, _ = build(dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with k8_calls_by_mask({}) as calls:
            logits, cache = step()
        torch.cuda.synchronize()
        again = ops.launch_counts_by_route()["flash_attention"]["mma"]
        del step, cache
    by_part = {part: calls.get((case[3], case[4], case[8]), 0)
               for part, case in K8_TP_WHISPER.items()}
    launches = res["k8_launches"]["mma"]
    by_kind = res["device_ms_by_kind"]
    mlp_ms = res["device_ms_by_range"][TP_ENCDEC_MLP_RANGE]
    layers = cfg.n_enc_layers + 2 * cfg.n_layers
    emit(dict(phase="dryrun", case=f"encdec_rank_prefill_{TP_ENCDEC_ARCH}_summary",
              encoder_layers=cfg.n_enc_layers, decoder_layers=cfg.n_layers,
              frames=cfg.enc_len, tokens=TP_ENCDEC_PROMPT, head_dim_columns=got[5],
              ff_columns=sp.ff, vocab_rows=sp.vocab, k8_launches=launches,
              k8_launches_by_attention=by_part, k8_launches_again=again,
              device_ms_by_kind=dict(k8=by_kind["k8"], gelu_mlp=mlp_ms,
                                     other=res["device_ms"] - by_kind["k8"] - mlp_ms,
                                     of_other_dtod_copies=by_kind["of_other_dtod_copies"]),
              bound_ms=res["bound_ms"], device_ms=res["device_ms"], share=res["share"],
              flops=res["flops"], meta_flops=res["meta_flops"], bytes=res["bytes"],
              meta_bytes=res["meta_bytes"],
              modelled_peak_live_bytes=res["modelled_peak_live_bytes"],
              card_peak_live_bytes=res["card_peak_live_bytes"],
              logits_shape=list(logits.shape), logits_finite=bool(logits.isfinite().all()),
              share_of_model=res["share_of_model"], wall_s=time.perf_counter() - t0))
    check(launches == layers and again == layers,
          f"{TP_ENCDEC_ARCH}: K8 launched {launches} and {again} times in a rank's prefill of "
          f"{cfg.n_enc_layers} encoder and {cfg.n_layers} decoder layers, not {layers}")
    check(by_part == {"encoder": cfg.n_enc_layers, "decoder": cfg.n_layers,
                      "cross": cfg.n_layers},
          f"{TP_ENCDEC_ARCH}: K8's launches by attention {by_part}")
    check(bool(logits.isfinite().all()), f"{TP_ENCDEC_ARCH}: a rank's logits are not finite")
    return {f"{TP_ENCDEC_ARCH}_{part}": n for part, n in by_part.items()}


def counted_cases(dev) -> dict:
    """Case (b): the counter against the card on the steps the smoke runs
    at full width: Qwen3-8B's 1974-token prefill and one decode step after
    it (bf16, 36 layers), one tensor-parallel rank's decode step of
    Qwen3-8B's ``decode_32k`` on ``single_pod`` at its full shape (8 rows
    over its head_dim columns of a 32,768-token cache, bf16: 2.4 GB of
    cache and its 1.0 GB share of the weights, its collectives on a fake
    world of 16 "model" ranks), a Qwen3-8B train step at 2 layers (bf16,
    AdamW, B = 1, S = 2048) and train_lm's step (lm_100m, float32, B = 4,
    S = 192) under AdamW."""
    import dataclasses
    import math

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import rule_axes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, production_axis_sizes
    from repro_torch.models.model import decode_step, init_decode_cache, prefill
    from repro_torch.optim.adamw import adamw
    from repro_torch.training import init_train_state, make_train_step

    cfg = get_config(SERVE_ARCH)

    def prefill_step(device):
        params = counted_params(cfg, device)
        batch = {"tokens": counted_tokens(device, (1, COUNTED_PROMPT), cfg.vocab)}
        return (lambda: prefill(params, batch, cfg, SERVE_MAX_SEQ)), params

    def decode(device):
        params = counted_params(cfg, device)
        if torch.device(device).type == "meta":
            cache = init_decode_cache(cfg, 1, SERVE_MAX_SEQ, device="meta")
        else:
            batch = {"tokens": counted_tokens(device, (1, COUNTED_PROMPT), cfg.vocab)}
            cache = prefill(params, batch, cfg, SERVE_MAX_SEQ)[1]
        token = counted_tokens(device, (1, 1), cfg.vocab)
        pos = torch.full((), COUNTED_PROMPT, dtype=torch.int32, device=device)
        return (lambda: decode_step(params, token, pos, cache, cfg)), params

    def train(tcfg, batch, seq):
        def build(device):
            opt = adamw(3e-4)
            meta = torch.device(device).type == "meta"
            state = init_train_state(
                tcfg, opt, None if meta else torch.Generator(device=device).manual_seed(SEED),
                device=device)
            step_fn = make_train_step(tcfg, opt)
            data = {k: counted_tokens(device, (batch, seq), tcfg.vocab)
                    for k in ("tokens", "targets")}
            return (lambda: step_fn(state, data)), state["params"]
        return build

    # one rank of decode_32k on single_pod: its rows of the batch, its
    # tensor-parallel share (head_dim mode: its 8 of each head's 128
    # columns, of the cache too; a sixteenth of ff and of the vocab), the
    # step the sharded decode runs after its gathers over "data"
    rank_shape = SHAPES[RANK_SHAPE]
    rules = dryrun.cell_rules(cfg, rank_shape, RANK_MESH, True)
    sizes = production_axis_sizes(multi_pod=RANK_MESH == "multi_pod")
    rank_batch = rank_shape.global_batch // math.prod(sizes[a]
                                                      for a in rule_axes(rules["batch"]))

    def decode_rank(device):
        model = tp_rank_model(cfg, mesh, rules, device)
        cache = {n: torch.zeros((cfg.n_layers, rank_batch, rank_shape.seq_len, cfg.n_kv_heads,
                                 cfg.head_dim // TP_RANKS), dtype=cfg.act_dtype(), device=device)
                 for n in ("k", "v")}
        token = counted_tokens(device, (rank_batch, 1), cfg.vocab)
        pos = torch.full((), rank_shape.seq_len - 1, dtype=torch.int32, device=device)
        return (lambda: decode_step(model, token, pos, cache, cfg)), model

    res = {}
    res["qwen3_8b_prefill"] = count_step("qwen3_8b_prefill_1974", prefill_step, dev, cfg,
                                         train=False, n_tokens=COUNTED_PROMPT)
    res["qwen3_8b_decode"] = count_step("qwen3_8b_decode_step", decode, dev, cfg, train=False,
                                        n_tokens=1)
    with fake_world(mesh_shape=(1, TP_RANKS)) as mesh:
        res["qwen3_8b_decode_rank"] = count_step(
            f"{RANK_ARCH}_{RANK_SHAPE}_{RANK_MESH}_rank", decode_rank, dev, cfg, train=False,
            n_tokens=rank_batch)
        res["qwen3_8b_decode_rank"]["share"] = tp_share(cfg, rules, mesh)
    wide = dataclasses.replace(get_config(WIDE_ARCH), n_layers=WIDE_LAYERS)
    res["qwen3_8b_train"] = count_step(
        "qwen3_8b_width_2_layers_train", train(wide, WIDE_BATCH, WIDE_SEQ), dev, wide,
        train=True, n_tokens=WIDE_BATCH * WIDE_SEQ)
    lm = load_example("train_lm_torch").lm_100m()
    res["train_lm"] = count_step("train_lm_100m_adamw", train(lm, TRAIN_BATCH, TRAIN_SEQ), dev,
                                 lm, train=True, n_tokens=TRAIN_BATCH * TRAIN_SEQ)
    return res


def k8_counted_terms(k8_rows: dict, k8_bwd_rows: dict) -> dict:
    """Case (c): K8's operations as the counter records them (on meta, at
    each K8 row's shape and mask of the kernels line, p float32) equal to
    the row's ``flops`` and ``bytes``."""
    from repro_torch.roofline.cost import CostCounter

    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    def operands(shape, dtype):
        b, s, t, h, kv, d = shape
        return [torch.empty(dims, dtype=dtype, device="meta")
                for dims in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]

    out, bad = {}, []
    for key, row in k8_rows.items():
        q, k, v = operands(row["shape"], getattr(torch, row["dtype"]))
        with CostCounter(device="meta") as c:
            fa.flash_attention(q, k, v, causal=row["causal"])
        got = c.kernels["flash_attention"]
        out[f"forward_{key}"] = dict(counted=[got["flops"], got["bytes"]],
                                     line=[row["flops"], row["bytes"]])
    for key, row in k8_bwd_rows.items():
        q, k, v = operands(row["shape"], getattr(torch, row["dtype"]))
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                          device="meta")
        with CostCounter(device="meta") as c:
            fa.flash_attention_bwd(q, k, v, torch.empty_like(q), lse, torch.empty_like(q))
        for name, k_row in row["kernels"].items():
            got = c.kernels[name]
            out[f"{name}_{key}"] = dict(counted=[got["flops"], got["bytes"]],
                                        line=[k_row["flops"], k_row["bytes"]])
    bad = [k for k, r in out.items() if r["counted"] != r["line"]]
    emit(dict(phase="dryrun", case="k8_terms", rows=out, differ=bad))
    check(not bad, f"K8's counted flops/bytes differ from the kernels line's: {bad}")
    return out


def phase_dryrun(dev, k8_rows: dict, k8_bwd_rows: dict) -> dict:
    """The dry run over every cell of the three meshes (a), traced in
    DRYRUN_WORKERS spawned processes (a production mesh's fake process
    group lives in the process that traces the cell, so the distributed
    phase's NCCL world still opens here) while the counter is held
    against the card (b) and K8's counted terms against the kernels line
    (c)."""
    import concurrent.futures
    import multiprocessing

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=DRYRUN_WORKERS,
                                                mp_context=ctx) as pool:
        futures = start_cells(pool)
        steps = counted_cases(dev)
        k8 = k8_counted_terms(k8_rows, k8_bwd_rows)
        tp_prefill = tp_rank_prefills(dev)
        results = {key: f.result() for key, f in futures.items()}
    res = dict(cells=dryrun_cells(results, time.perf_counter() - t0), steps=steps, k8=k8,
               tp_prefill=tp_prefill)
    emit(dict(phase="dryrun", case="wall", wall_s=time.perf_counter() - t0))
    return res


# ---------------------------------------------------------------------------
# phase 8c: the distributed runtime on a world of one
# ---------------------------------------------------------------------------

DIST_LR = 1e-3
# the CPU test's bars: losses 1e-5 relative, parameters 1e-5 of their
# leaf's max|p|, but a leaf whose step-1 gradient is under DIST_NOISE_SHARE
# of the model's largest (zero in exact arithmetic, float32 rounding) is
# held to Adam's own step, 2 lr a step
DIST_NOISE_SHARE = 1e-6
# the SMOKE configs of the sharded steps, by how a rank computes: a dense
# one (tensor parallel over "model"), the two MoE modes (expert parallel;
# tensor parallel inside the experts), the hybrid (its Mamba blocks and
# shared attention tensor parallel), the vlm (its dense blocks over its
# patches and tokens) and the encdec (its encoder, decoder and cross
# attention, its GELU MLPs); no family computes replicated over "model"
DIST_ARCHS = {"qwen3_8b": "tensor parallel over model",
              "granite_moe_1b_a400m": "expert parallel over model",
              "mixtral_8x22b": "tensor parallel inside experts over model",
              "zamba2_7b": "tensor parallel over model",
              "internvl2_1b": "tensor parallel over model",
              "whisper_base": "tensor parallel over model"}
# the route each config's step took: the dimension of a leaf that its
# route puts on "model": an MoE's experts' w_gate (E, d, ff), 0 expert
# parallel and 2 tensor parallel inside the experts; a Mamba block's w_x
# (d, d_inner), 1 (its inner columns); a dense MLP's w_gate and a GELU
# MLP's w_up (d, ff), 1 (its ff columns)
DIST_ROUTE_DIMS = {"granite_moe_1b_a400m": ("blocks.0.moe.w_gate", 0),
                   "mixtral_8x22b": ("blocks.0.moe.w_gate", 2),
                   "zamba2_7b": ("blocks.0.w_x", 1),
                   "internvl2_1b": ("blocks.0.mlp.w_gate", 1),
                   "whisper_base": ("dec_blocks.0.mlp.w_up", 1)}


def dist_batch(cfg, dev) -> dict:
    """Phase 8c's batch: tokens = targets = 3 (4 x 32), and a vlm's seeded
    patch embeddings (4, n_patches, d) or an encdec's seeded frame
    embeddings (4, enc_len, d), float32."""
    tokens = torch.zeros((4, 32), dtype=torch.int32, device=dev) + 3
    batch = {"tokens": tokens, "targets": tokens}
    extra = {"vlm": ("patches", cfg.n_patches), "encdec": ("frames", cfg.enc_len)}
    if cfg.family in extra:
        name, length = extra[cfg.family]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        batch[name] = torch.randn((4, length, cfg.d_model), generator=gen, device=dev)
    return batch


def dist_run(dev, cfg, batch: dict, sharded: bool) -> dict:
    """Four AdamW steps of ``cfg`` on the card from the seeded state: on
    one device, or sharded (two on the (1, 1) mesh, plan_mesh of the
    world, a re-shard, two more).  Losses and the parameters after steps 2
    and 4."""
    import torch.distributed as dist

    from repro_torch.distributed.elastic import plan_mesh
    from repro_torch.distributed.rules import make_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.adamw import adamw
    from repro_torch.training.step import (
        full_params,
        init_train_state,
        make_sharded_train_step,
        make_train_step,
        shard_train_state,
    )

    opt = adamw(DIST_LR)
    state = init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    losses, params = [], {}
    if not sharded:
        step = make_train_step(cfg, opt)
        for i in range(4):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            params[i + 1] = {n: p.detach().clone()
                             for n, p in state["params"].named_parameters()}
        return dict(losses=losses, params=params)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    state = shard_train_state(state, cfg, mesh, {**make_rules(cfg, model_axis=1),
                                                 "batch": "data"})
    step = make_sharded_train_step(cfg, opt, mesh)
    for i in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    params[2] = full_params(state)
    plan = plan_mesh(dist.get_world_size())
    mesh2 = plan.build()
    state = shard_train_state(state, cfg, mesh2, {**make_rules(cfg, model_axis=plan.model),
                                                  "batch": "data"})
    step = make_sharded_train_step(cfg, opt, mesh2)
    for i in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    params[4] = full_params(state)
    leaves = [n for n in ("embed", "blocks.0.attn.wq", "blocks.0.moe.w_gate", "blocks.0.w_x",
                          "blocks.0.mlp.w_gate", "dec_blocks.0.mlp.w_up", "final_norm")
              if n in state["params"]]
    axis = mesh2.mesh_dim_names.index("model")
    return dict(losses=losses, params=params, plan=[plan.pods, plan.data, plan.model],
                placements={n: [str(x) for x in state["params"][n].placements] for n in leaves},
                model_dims={n: getattr(state["params"][n].placements[axis], "dim", None)
                            for n in leaves})


def dist_compare(got: dict, want: dict, noise: set) -> dict:
    """Bit for bit or not; the largest loss error (relative) and
    parameter error (of the leaf's max|p|, and in lr for noise leaves)."""
    bitwise = got["losses"] == want["losses"] and all(
        torch.equal(got["params"][k][n], want["params"][k][n])
        for k in (2, 4) for n in want["params"][k])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    param_err, noise_err_lr, worst = 0.0, 0.0, None
    for k in (2, 4):
        for n, w in want["params"][k].items():
            err = float((got["params"][k][n] - w).abs().max())
            if n in noise:
                noise_err_lr = max(noise_err_lr, err / DIST_LR / k)
            elif err / float(w.abs().max()) > param_err:
                param_err, worst = err / float(w.abs().max()), f"{n} after step {k}"
    return dict(bitwise=bitwise, loss_err=loss_err, param_err_of_max=param_err,
                worst_leaf=worst, noise_leaf_err_in_lr_a_step=noise_err_lr)


def compress_on_card(dev) -> dict:
    """compress_int8 on the card and on the CPU, three rounds of error
    feedback on seeded gradients (per-layer names share a scale): bit
    for bit, or within one float32 ulp of max|g + e|.  Beside it the
    scale of each round's groups on both devices, by the divisor a
    tensor on the device (``compression.int8_scale``) and by the Python
    scalar 127.0 (a CUDA division by a host scalar multiplies by its
    reciprocal), as hex floats, and the same on 4096 seeded amaxes."""
    from repro_torch.distributed.compression import compress_int8, int8_scale, scale_group

    rng = np.random.default_rng(SEED)
    shapes = {"embed": (512, 64), "blocks.0.attn.wq": (64, 4, 16),
              "blocks.1.attn.wq": (64, 4, 16), "final_norm": (64,)}
    err = {"cpu": None, "cuda": None}
    bitwise, worst, amax = True, 0.0, []
    for _ in range(3):
        g = {n: torch.from_numpy((rng.standard_normal(s) * 10.0 ** rng.uniform(-6, 1))
                                 .astype(np.float32)) for n, s in shapes.items()}
        groups: dict[str, float] = {}
        for n, x in g.items():
            m = float((x if err["cpu"] is None else x + err["cpu"][n]).abs().max())
            groups[scale_group(n)] = max(groups.get(scale_group(n), 0.0), m)
        amax.extend(groups.values())
        c_cpu, err["cpu"] = compress_int8(g, err["cpu"])
        c_gpu, err["cuda"] = compress_int8({n: x.to(dev) for n, x in g.items()}, err["cuda"])
        for n in g:
            for a, b in ((c_gpu[n].cpu(), c_cpu[n]), (err["cuda"][n].cpu(), err["cpu"][n])):
                bitwise &= torch.equal(a, b)
                scale = float(c_cpu[n].abs().max() + err["cpu"][n].abs().max())
                worst = max(worst, float((a - b).abs().max()) / (scale * 2.0 ** -23))

    def scales(a: torch.Tensor) -> dict:
        # the product with float32's 1/127, what CUDA computes for a divisor
        # that is a host scalar, if that is the cause
        reciprocal = torch.clamp(a, min=1e-30) * (torch.tensor(1.0) / torch.tensor(127.0))
        out = {"tensor_cpu": int8_scale(a), "tensor_card": int8_scale(a.to(dev)).cpu(),
               "scalar_cpu": torch.clamp(a, min=1e-30) / 127.0,
               "scalar_card": (torch.clamp(a.to(dev), min=1e-30) / 127.0).cpu()}
        return {**out, "differ_tensor": int((out["tensor_cpu"] != out["tensor_card"]).sum()),
                "differ_scalar": int((out["scalar_cpu"] != out["scalar_card"]).sum()),
                "differ_reciprocal_cpu": int((reciprocal != out["scalar_cpu"]).sum()),
                "scalar_card_is_reciprocal": bool(torch.equal(out["scalar_card"], reciprocal))}

    rounds = scales(torch.tensor(amax, dtype=torch.float32))
    wide = scales(torch.from_numpy((rng.uniform(1.0, 2.0, 4096)
                                    * 10.0 ** rng.integers(-6, 2, 4096)).astype(np.float32)))
    return dict(bitwise=bitwise, err_in_f32_ulps_of_max=worst,
                round_scales={k: [float(x).hex() for x in v] if torch.is_tensor(v) else v
                              for k, v in rounds.items()},
                seeded_amax_4096={k: v for k, v in wide.items() if not torch.is_tensor(v)})


def phase_distributed(dev) -> dict:
    """Phase 8c (see the module docstring).  Returns K8's launches of each
    config's sharded run, by case."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import sharded_compute
    from repro_torch.optim.adamw import adamw
    from repro_torch.training.step import AUX_WEIGHT, init_train_state, loss_and_grads

    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="repro_dist_smoke_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1)
        try:
            for arch in DIST_ARCHS:
                cfg = get_smoke_config(arch)
                batch = dist_batch(cfg, dev)
                one = dist_run(dev, cfg, batch, sharded=False)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                sharded = dist_run(dev, cfg, batch, sharded=True)
                torch.cuda.synchronize()
                runs[arch] = (cfg, batch, one, sharded, k8_counts())
            backend = str(dist.get_backend())
        finally:
            dist.destroy_process_group()
    launches = {}
    for arch, (cfg, batch, one, sharded, k8) in runs.items():
        again = dist_run(dev, cfg, batch, sharded=False)
        state = init_train_state(cfg, adamw(DIST_LR),
                                 torch.Generator(device=dev).manual_seed(SEED), device=dev)
        _, grads = loss_and_grads(state["params"], batch, cfg, AUX_WEIGHT)
        gmax = {n: float(g.abs().max()) for n, g in grads.items()}
        noise = {n for n, g in gmax.items() if g < DIST_NOISE_SHARE * max(gmax.values())}
        held = dist_compare(sharded, one, noise)
        repeat = dist_compare(again, one, noise)
        compute = sharded_compute(cfg)
        res = dict(phase="distributed", case=f"sharded_step_world_1_{arch}", arch=arch,
                   family=cfg.family, compute=compute, backend=backend, mesh=[1, 1],
                   plan=sharded["plan"], placements=sharded["placements"],
                   losses=sharded["losses"], one_device_losses=one["losses"], held=held,
                   one_device_repeats_bitwise=repeat["bitwise"], one_device_repeat=repeat,
                   noise_leaves=sorted(noise), k8=k8)
        if not held["bitwise"]:
            res["why_not_bitwise"] = (
                "the one-device step does not repeat itself bit for bit on the card"
                if not repeat["bitwise"] else
                "the sharded step differs from a one-device step that repeats itself")
        emit(res)
        check(k8["forward_by_route"]["fma"] > 0
              and all(k8["backward"][n] > 0 for n in K8_BWD_KERNELS),
              f"distributed {arch}: K8 forward/backward not launched: {k8}")
        check(held["bitwise"] or (held["loss_err"] <= 1e-5 and held["param_err_of_max"] <= 1e-5
                                  and held["noise_leaf_err_in_lr_a_step"] <= 2),
              f"distributed {arch}: the sharded step against the one-device step: {held}")
        launches[f"distributed_{arch}"] = k8
    computes = {a: sharded_compute(runs[a][0]) for a in DIST_ARCHS}
    check(computes == DIST_ARCHS, f"distributed: the configs' routes {computes}, not "
                                  f"{DIST_ARCHS}")
    # the route the MoE, hybrid, vlm and encdec steps took: their experts'
    # w_gate split over "model" on the expert dimension (expert parallel) or
    # on ff (inside the experts), a Mamba block's w_x on its inner columns,
    # a dense or GELU MLP's ff columns
    taken = {a: (leaf, runs[a][3]["model_dims"][leaf])
             for a, (leaf, _) in DIST_ROUTE_DIMS.items()}
    check(taken == DIST_ROUTE_DIMS, f"distributed: the steps' leaves split over model on "
                                    f"dims {taken}, not {DIST_ROUTE_DIMS}")
    comp = compress_on_card(dev)
    emit(dict(phase="distributed", case="compress_int8", compress_int8=comp,
              wall_s=time.perf_counter() - t0))
    check(comp["err_in_f32_ulps_of_max"] <= 1, f"distributed: compress_int8 card vs CPU {comp}")
    check(comp["bitwise"], f"distributed: compress_int8 on the card is not the CPU's bits {comp}")
    return launches


def kernels_line(pairs: dict, launches: dict, settling_launches: dict,
                 service_launches: dict, analysis_launches: dict, api_rows: dict,
                 api_launches: dict, k8_rows: dict, k8_launches: dict, k8_bwd_rows: dict,
                 train_launches: dict) -> list[dict]:
    """One row per kernel, and for K5, K6 and K8 one per route: timed at
    its main-path shape (MAIN_SHAPE for K1-K4), its error the largest over
    every shape, its launches from the main path that drives it (the slice,
    the settling phase's predicted-form sweeps and the solve service's and
    the analysis phase's settling tickets for K1-K4, split in
    ``launches_by_phase``; the kernel
    API for K5-K7b, the serving path for K8), for
    K5, K6 and K8 those of the row's route (``kernel_route``; K7a names
    its route too, K4 its split, K1 and K3 their cluster size, variant,
    clusters per wave and main-path launches by variant; K5's rows and
    K6's GEMV rows count their own dtype, and the GEMV rows (K5 "column",
    K6 "fma") carry its launches by variant), and
    K8's rows count by phase and family (``launches_by_family``): the
    tensor-core row at D = 128 the serve phase's and every family's but
    Zamba2's, the D = 112 row Zamba2's, the fma row at D = 128 the float32
    SMOKE configs' serving runs on the card and the distributed phase's,
    the fma row at train_lm's shape the train phase's; the tensor-core
    rows also the train and the distributed phases'.  K8's backward
    kernels have a row each per dtype (bf16 at the forward's main shape,
    float32 at train_lm's), their launches those of the train phase by
    case and of the distributed phase, ``launches_by_phase``."""
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
        by_phase = dict(slice=launches[name], settling=settling_launches[name],
                        solve_service=service_launches.get(name, 0),
                        analysis=analysis_launches.get(name, 0))
        rows.append(dict(
            name=f"{tag} {name}", route="cuda", source=source, replaces=rep,
            launches=sum(by_phase.values()), launches_by_phase=by_phase,
            max_abs_err=err, ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=k["library_ms"], library_device_ms=k.get("library_device_ms"),
            shape=k["shape"], device_ms=k.get("device_ms"),
        ))
        if "layout" in k:
            # K1 (float32 slots) and K3: cluster size, variant, clusters per wave
            layout = k["layout"].get("float32", k["layout"])
            rows[-1].update(ranks=layout["ranks"], variant=layout["variant"],
                            clusters_per_wave=layout["clusters_per_wave"],
                            launches_by_variant=launches["by_variant"][name],
                            device_ms_0_steps=k["device_ms_0_steps"])
            # the step-to-step dependency through cluster.sync(), which
            # bound_ms does not model: KERNEL_STEPS times the least per-step
            # device time past the launch over every shape (route_times),
            # where a rank's own row work is smallest
            key = {"ell_sweep": "k1", "transient_sweep": "k3"}[name]
            key += "_device_ms_per_step_past_launch"
            rows[-1]["latency_bound_ms"] = KERNEL_STEPS * min(
                p["per_step"][key] for p in pairs.values() if key in p["per_step"])
            if "device_ms_by_ranks" in layout:
                rows[-1]["device_ms_by_ranks"] = layout["device_ms_by_ranks"]
        if "split" in k:
            rows[-1]["ranks"] = k["split"]["ranks"]
            rows[-1]["device_ms_by_ranks"] = k["split"]["device_ms_by_ranks"]
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
            "bound_by", "shape", "max_abs_err")
    k5_by_dtype = api_launches["transient_step_by_dtype"]
    gemv_by_variant = api_launches["gemv_by_variant"]
    for key, label, dtype, kernel_route in (
            ("transient_step", "f32, nb = 16", "float32", "narrow_async"),
            ("transient_step_bf16", "bf16, nb = 16", "bfloat16", "narrow_async"),
            ("transient_step_b1", "f32, nb = 1", "float32", "column"),
            ("transient_step_b1_bf16", "bf16, nb = 1", "bfloat16", "column")):
        rows.append(dict(name=f"K5 transient_step ({label})", route="cuda",
                         source="src/repro_torch/kernels/csrc/transient_step.cu",
                         replaces="src/repro/kernels/transient_step.py:99",
                         launches=k5_by_dtype[dtype][kernel_route], kernel_route=kernel_route,
                         launches_by_route=k5_by_dtype[dtype],
                         **{k: api_rows[key][k] for k in keys}))
        if kernel_route == "column":
            rows[-1]["launches_by_variant"] = gemv_by_variant["transient_step"]
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
    fma_by_dtype = api_launches["crosspoint_mvm_fma_by_dtype"]
    for key, label, kernel_route in (("crosspoint_mvm", "f32, b = 1", "fma"),
                                     ("crosspoint_mvm_bf16", "bf16, b = 1", "fma"),
                                     ("crosspoint_mvm_b64", "f32, b = 64", "f32_async"),
                                     ("crosspoint_mvm_b64_bf16", "bf16, b = 64", "mma_async")):
        rows.append(dict(name=f"K6 crosspoint_mvm ({label})", route="cuda",
                         source="src/repro_torch/kernels/csrc/crosspoint_mvm.cu",
                         replaces="src/repro/kernels/crosspoint_mvm.py:48",
                         launches=by_route[kernel_route], kernel_route=kernel_route,
                         **{k: api_rows[key][k] for k in keys}))
        if kernel_route == "fma":
            rows[-1]["launches"] = fma_by_dtype["bfloat16" if "bf16" in label else "float32"]
            rows[-1]["launches_by_route"] = by_route
            rows[-1]["launches_by_variant"] = gemv_by_variant["crosspoint_mvm"]
    for key, row in k8_rows.items():
        by_family = k8_launches[key]
        heads = f", {row['heads']}" if "heads" in row else ""
        rows.append(dict(name=f"K8 flash_attention ({row['dtype']}, D = {row['shape'][-1]}"
                              f"{heads})",
                         route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention.py:103",
                         launches=sum(by_family.values()), launches_by_family=by_family,
                         kernel_route=row["route"],
                         **{k: row[k] for k in keys},
                         f32_fma_bound_ms=row["f32_fma_bound_ms"],
                         tflop_per_s=row["tflop_per_s"],
                         **({"fma_plan": row["fma_plan"]} if "fma_plan" in row else {})))
    return rows + k8_bwd_line_rows(k8_bwd_rows, train_launches)


def k8_bwd_line_rows(k8_bwd_rows: dict, train_launches: dict) -> list[dict]:
    """The kernels line's rows of K8's backward kernels: one per kernel and
    dtype, and so per route of dK/dV and dQ (bf16 on the tensor cores,
    ``kernel_route`` "mma", with the FMA route's time at the same shape in
    ``fma_ms``; float32 on "fma"), timed at the row's shape, its launches
    the train phase's in that dtype (dK/dV and dQ: on that route) by case.
    No single library call computes dK/dV's or dQ's part of the gradient
    (``library_ms`` null); float32 Delta's is one einsum (``library_ms``);
    SDPA's whole backward is ``library_backward_ms``."""
    rows = []
    for row in k8_bwd_rows.values():
        dtype = row["dtype"]
        for name, k in row["kernels"].items():
            if name in K8_BWD_ROUTED:
                by_phase = {case: counts["backward_by_route"][name][row["route"]]
                            if row["route"] == "mma" else counts["backward_by_dtype"][name][dtype]
                            for case, counts in train_launches.items()}
            else:
                by_phase = {case: counts["backward_by_dtype"][name][dtype]
                            for case, counts in train_launches.items()}
            extra = {key: k[key] for key in ("fma_ms", "fma_device_ms", "spread_ms",
                                             "library_device_ms", "device_ms_graph_of_50",
                                             "library_device_ms_graph_of_50", "fixed_device_ms",
                                             "fixed_device_ms_graph_of_50", "fixed_blocks",
                                             "fixed_warps_a_block") if key in k}
            if name in K8_BWD_ROUTED:
                extra["kernel_route"] = row["route"]
            else:
                # Delta's launches of the row's dtype by variant, by case
                extra["launches_by_variant"] = {
                    case: counts["delta_by_variant"][dtype]
                    for case, counts in train_launches.items()}
            rows.append(dict(
                name=f"K8 {name} ({dtype}, D = {row['shape'][-1]}"
                     + (f", {row['route']})" if name in K8_BWD_ROUTED else ")"),
                route="cuda", **extra,
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces=K8_BWD_REPLACES, launches=sum(by_phase.values()),
                launches_by_phase=by_phase, max_abs_err=row["max_abs_err"][name],
                ms=k["ms"], device_ms=k["device_ms"], plain_ms=row["plain_ms"],
                plain_covers=row["plain_covers"], bound_ms=k["bound_ms"],
                bound_by=k["bound_by"], library_ms=k.get("library_ms"),
                library_backward_ms=row["library_backward_ms"],
                library_backward_device_ms=row["library_backward_device_ms"], shape=row["shape"],
                tflop_per_s=k["tflop_per_s"]))
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
    service_launches = phase_solve_service(dev)
    analysis_launches = phase_analysis(dev)
    api_rows, api_launches = phase_kernel_api(
        dev, pairs[("dense", N_DENSE)]["transient_step_batched"]["split"])
    phase_quickstart()
    k8_rows = phase_k8()
    k8_bwd_rows = phase_k8_bwd()
    serve_launches = phase_serve(dev)
    families = phase_families(dev)
    train_launches = phase_train(dev)
    tp_launches = phase_dryrun(dev, k8_rows, k8_bwd_rows)["tp_prefill"]
    dist_launches = phase_distributed(dev)
    # K8's launches by row: the tensor-core rows split by head size (D =
    # 112 is Zamba2's alone), the FMA rows the float32 SMOKE configs' card
    # runs in serving (the D = 128 row) and the train phase's (train_lm's
    # shape); each by the phase or family that made them
    train_fwd = {route: sum(c["forward_by_route"][route] for c in train_launches.values())
                 for route in ("mma", "fma")}
    k8_launches = {
        "mma": {"serve": serve_launches["mma"],
                **{a: r["mma"] for a, r in families.items() if r["head_dim"] != 112},
                "train": train_fwd["mma"],
                **{case: c["forward_by_route"]["mma"] for case, c in dist_launches.items()}},
        "mma_d112": {a: r["mma"] for a, r in families.items() if r["head_dim"] == 112},
        "fma": {"serve": serve_launches["fma"], **{a: r["fma"] for a, r in families.items()},
                **{case: c["forward_by_route"]["fma"] for case, c in dist_launches.items()}},
        "fma_train": {"train": train_fwd["fma"]},
        **{f"tp_{arch}": {"dryrun_tp_rank_prefill": n} for arch, n in tp_launches.items()},
    }

    emit({"kernels": kernels_line(pairs, launches, settling_launches, service_launches,
                                  analysis_launches,
                                  api_rows, api_launches, k8_rows, k8_launches, k8_bwd_rows,
                                  {**train_launches, **dist_launches})})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
