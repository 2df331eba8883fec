"""The GEMV of K6 at b = 1 and K5 at nb = 1: its variant, plan and order.

Both kernels run ``csrc/common.cuh:gemv_rows`` (K6's ``"fma"`` route,
``csrc/crosspoint_mvm.cu:crosspoint_mvm_kernel``, and K5's ``"column"``
route, ``csrc/transient_step.cu:transient_step_column_kernel``), which
streams ``A`` (m, k) once from HBM in 16-byte loads and adds each row's
products in a fixed order, with no atomics.  This module holds what the
CPU tests can check of it:

* :func:`gemv_variant` — ``"vec16"`` (16-byte loads) or ``"scalar"``
  (masked scalar loads of the same chunks), a pure function of dtype, k
  and alignment;
* :func:`gemv_plan` — the split of the rows over blocks and warps, the
  same function as ``common.cuh:gemv_plan`` (which
  :func:`gemv_plan_on_device` reads through ``repro_gemv_plan``);
* :func:`gemv_in_kernel_order` — the kernel's float32 sums in plain
  PyTorch, bit for bit, on any device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

VARIANTS = ("vec16", "scalar")
# csrc/common.cuh: GEMV_SMS, GEMV_WARPS, GEMV_ROWS
GEMV_SMS = 132        # the grid's blocks at most: one wave, one an SM of an H100 SXM
GEMV_WARPS = 16       # warps of a block at most
GEMV_ROWS = 2         # rows a warp walks at once
LANES = 32


def chunk_elems(dtype: torch.dtype) -> int:
    """Elements of a 16-byte chunk: 4 float32 or 8 bf16."""
    return 16 // dtype.itemsize


def gemv_variant(dtype: torch.dtype, k: int, aligned: bool) -> str:
    """The GEMV's variant, a pure function of dtype, row length and
    alignment (``aligned``: A's and x's bases on 16-byte boundaries):
    ``"vec16"`` where every row is a whole number of 16-byte chunks
    (``k % 4 == 0`` in float32, ``k % 8 == 0`` in bf16) and the bases are
    aligned, else ``"scalar"``."""
    return "vec16" if k % chunk_elems(dtype) == 0 and aligned else "scalar"


def gemv_plan(m: int) -> dict:
    """The split of ``m`` rows, as ``csrc/common.cuh:gemv_plan``: at most
    GEMV_SMS blocks (one wave, a block an SM), block b owning rows
    ``[b m // B, (b + 1) m // B)`` (so no block holds more than one row
    above the mean: 63 against 62.06 at m = 8192); up to GEMV_WARPS warps
    a block, warp w walking the groups of GEMV_ROWS rows w, w + warps, ...
    Returns ``blocks``, ``warps``, ``rows_per_block`` (the largest block's)
    and ``rows_per_warp`` (the most rows a warp walks)."""
    blocks = min(m, GEMV_SMS)
    rows_per_block = -(-m // blocks)
    groups = -(-rows_per_block // GEMV_ROWS)
    warps = min(groups, GEMV_WARPS)
    return dict(blocks=blocks, warps=warps, rows_per_block=rows_per_block,
                rows_per_warp=min(-(-groups // warps) * GEMV_ROWS, rows_per_block))


def gemv_rows_of(m: int, block: int, warp: int) -> list[int]:
    """The rows warp ``warp`` of block ``block`` adds under
    :func:`gemv_plan` (as ``common.cuh:gemv_rows`` walks them)."""
    plan = gemv_plan(m)
    blocks, warps = plan["blocks"], plan["warps"]
    r0, r1 = block * m // blocks, (block + 1) * m // blocks
    return [r for g in range(r0 + warp * GEMV_ROWS, r1, warps * GEMV_ROWS)
            for r in range(g, min(g + GEMV_ROWS, r1))]


def lane_chunks(k: int, dtype: torch.dtype) -> torch.Tensor:
    """The element each lane adds at each of its steps: ``(steps, 32, E)``
    indices into a row, lane l taking the chunks ``c = l + 32 j``, j
    ascending, E elements a chunk; indices past ``k`` are chunks' padding
    (the kernel adds 0 x 0 there)."""
    e = chunk_elems(dtype)
    chunks = -(-k // e)
    steps = -(-chunks // LANES)
    return torch.arange(steps * LANES * e).view(steps, LANES, e)


def gemv_in_kernel_order(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` (a (m, k), x (k,)) as the GEMV adds it, in float32 and
    plain PyTorch: the same bits as the kernel on any device.

    Lane l adds the chunks ``c = l + 32 j`` of a row (E = 4 float32 or 8
    bf16 elements each; :func:`lane_chunks`), j ascending, one accumulator
    per element of a chunk, each product rounded before its add; a chunk
    past the row's end adds 0 x 0.  The E accumulators are added pairwise,
    ``(a0 + a1) + (a2 + a3)``, and then the 32 lanes by the shuffle tree,
    lane l + o into lane l for o = 16, 8, 4, 2, 1.  Every step is one
    elementwise float32 operation, which rounds the same on every device.
    """
    m, k = a.shape
    idx = lane_chunks(k, a.dtype)
    steps, _, e = idx.shape
    width = steps * LANES * e
    ap = torch.nn.functional.pad(a.float(), (0, width - k)).view(m, steps, LANES, e)
    xp = torch.nn.functional.pad(x.float(), (0, width - k)).view(steps, LANES, e)
    acc = torch.zeros((m, LANES, e), dtype=torch.float32, device=a.device)
    for j in range(steps):
        acc = acc + ap[:, j] * xp[j]
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    s = acc[..., 0]
    o = LANES // 2
    while o:
        s = s[:, :o] + s[:, o:2 * o]
        o //= 2
    return s[:, 0]


def gemv_plan_on_device(m: int) -> dict:
    """:func:`gemv_plan` as the kernel library computes it
    (``repro_gemv_plan``), with ``blocks_per_wave``: how many of the
    GEMV's blocks the current CUDA device runs at once."""
    plan = (ctypes.c_int * 5)()
    build.load_library().call("repro_gemv_plan", m, ctypes.addressof(plan), 5)
    return dict(zip(("blocks", "warps", "rows_per_block", "rows_per_warp",
                     "blocks_per_wave"), plan))
