"""Fused Sec. IV transform kernels K7a and K7b (Eqs. 15-16, 22).

Counterpart of :mod:`repro.kernels.spd_transform` (the Hopper source is
``csrc/spd_transform.cu``):

* :func:`colabs` (K7a) — ``sum_i |A[i, j]|`` per column in float32, the
  transform's only O(n^2) reduction (Eq. 22).
* :func:`assemble` (K7b) — ``K_A = diag(D - K_s) + 0.5 (A - |A|)`` and
  ``K_B = diag(D) - 0.5 (A + |A|)`` from one read of A, in float32,
  stored in A's dtype.

A is float32 or bfloat16.  Each wrapper launches its kernel for CUDA
tensors and runs its plain PyTorch version (``*_plain``) for CPU
tensors.  :func:`repro_torch.kernels.ops.spd_transform_arrays` chains
them with the D of Eq. 22 in between.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

# "vec16": 16-byte loads (cols a multiple of 4 in float32 or 8 in bf16,
# base on the 16-byte grid); "scalar": the same kernel with masked scalar
# loads, for every other input
COLABS_ROUTES = ("vec16", "scalar")

# K7a's order (csrc/spd_transform.cu: COLABS_WARPS, COLABS_UNROLL): the rows
# of a cluster rank go to 8 warps in interleaved groups of 8 rows
COLABS_WARPS, COLABS_UNROLL, COLABS_MAX_RANKS = 8, 8, 8


def colabs_route(dtype: torch.dtype, rows: int, cols: int, aligned: bool) -> str:
    """K7a's route, a pure function of dtype, shape and alignment
    (``aligned``: the base on a 16-byte boundary): ``"vec16"`` where each
    lane's 16 bytes (4 float32 or 8 bf16 columns) lie wholly inside the
    row, else ``"scalar"``.  ``rows`` does not change the route."""
    del rows
    return "vec16" if cols % (16 // dtype.itemsize) == 0 and aligned else "scalar"


def colabs_ranks(rows: int) -> int:
    """How many blocks of a cluster split each column strip's rows: a power
    of two up to 8, at least one pass of the block's 8 x 8 row loads each
    (8 at 4096 rows, 1 up to 64)."""
    want = min(COLABS_MAX_RANKS, -(-rows // (COLABS_WARPS * COLABS_UNROLL)))
    return 1 << (max(want, 1).bit_length() - 1)


def colabs_in_kernel_order(a: torch.Tensor, ranks: int | None = None) -> torch.Tensor:
    """K7a's float32 sums added in the kernel's order, in plain PyTorch: the
    same bits as the kernel on any device.

    Rank r of ``ranks`` (default :func:`colabs_ranks`) takes rows
    ``[r c, (r + 1) c)``, ``c = ceil(rows / ranks)``; within it warp w sums
    the groups of 8 rows whose index is w modulo 8, row by row; the warps'
    sums are added in warp order and the ranks' in rank order.  Rows past
    the end add zeros, which leave a sum of non-negative terms unchanged.
    """
    rows, cols = a.shape
    ranks = colabs_ranks(rows) if ranks is None else ranks
    x = a.float().abs()
    chunk = -(-rows // ranks)
    per = COLABS_WARPS * COLABS_UNROLL
    span = -(-chunk // per) * per
    total = None
    for r in range(ranks):
        part = x[r * chunk:min(rows, (r + 1) * chunk)]
        part = torch.nn.functional.pad(part, (0, 0, 0, span - part.shape[0]))
        part = part.reshape(span // per, COLABS_WARPS, COLABS_UNROLL, cols)
        s = torch.zeros((COLABS_WARPS, cols), dtype=torch.float32, device=a.device)
        for step in range(part.shape[0]):
            for u in range(COLABS_UNROLL):
                s = s + part[step, :, u]
        block = s[0]
        for w in range(1, COLABS_WARPS):
            block = block + s[w]
        total = block if total is None else total + block
    return total


def colabs_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`colabs`.

    Matches ``repro.kernels.ref.colabs_ref`` (which keeps a leading axis
    of 1: here the result is ``(cols,)``).
    """
    return a.float().abs().sum(dim=0)


def assemble_plain(a: torch.Tensor, d: torch.Tensor,
                   k_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`assemble`; matches
    ``repro.kernels.ref.assemble_ref`` (Eqs. 15-16 in float32, cast back
    to ``a``'s dtype)."""
    a32 = a.float()
    abs_a = a32.abs()
    ka = torch.diag(d - k_s) + 0.5 * (a32 - abs_a)
    kb = torch.diag(d) - 0.5 * (a32 + abs_a)
    return ka.to(a.dtype), kb.to(a.dtype)


def colabs(a: torch.Tensor) -> torch.Tensor:
    """K7a: column absolute sums ``out[j] = sum_i |a[i, j]|`` of a 2-D
    float32 or bfloat16 ``a``, in float32, shape ``(cols,)``.

    Replaces ``repro/kernels/spd_transform.py:colabs_pallas``.  Bound by
    bytes (A read once); the rows are split over the warps of a block and
    over the blocks of a cluster, and the partials added in a fixed order
    (:func:`colabs_in_kernel_order`), so two launches give the same bits
    (``csrc/spd_transform.cu``).  The route is :func:`colabs_route`'s.
    """
    dev = build.check_tensors(build.FLOAT_DTYPES, a=a)
    if a.ndim != 2:
        raise ValueError(f"a must be 2-D, got {tuple(a.shape)}")
    if dev.type == "cpu":
        return colabs_plain(a)
    rows, cols = a.shape
    route = colabs_route(a.dtype, rows, cols, build.aligned16(a))
    lib = build.load_library()
    out = torch.empty(cols, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = build.current_stream(dev)
        lib.call("repro_colabs", a.data_ptr(), int(a.dtype == torch.bfloat16),
                 out.data_ptr(), rows, cols, colabs_ranks(rows), int(route == "vec16"),
                 stream)
    colabs.launches += 1
    colabs.launches_by_route[route] += 1
    return out


def assemble(a: torch.Tensor, d: torch.Tensor,
             k_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K7b: ``(K_A, K_B)`` of Eqs. 15-16 from a square float32 or bfloat16
    ``a`` and the float32 diagonals ``d``, ``k_s`` (n,); both outputs in
    ``a``'s dtype.

    Replaces ``repro/kernels/spd_transform.py:assemble_pallas``.  Bound
    by bytes (A read once, K_A and K_B written once); an elementwise pass
    (``csrc/spd_transform.cu``).
    """
    dev = build.check_tensors(build.FLOAT_DTYPES, a=a)
    if build.check_tensors((torch.float32,), d=d, k_s=k_s) != dev:
        raise ValueError(f"d and k_s must be on {dev}, with a")
    n = a.shape[0]
    if a.shape != (n, n) or d.shape != (n,) or k_s.shape != (n,):
        raise ValueError(f"need a (n, n), d and k_s (n,), got {tuple(a.shape)}, "
                         f"{tuple(d.shape)}, {tuple(k_s.shape)}")
    if dev.type == "cpu":
        return assemble_plain(a, d, k_s)
    lib = build.load_library()
    ka = torch.empty_like(a)
    kb = torch.empty_like(a)
    with torch.cuda.device(dev):
        stream = build.current_stream(dev)
        lib.call("repro_assemble", a.data_ptr(), int(a.dtype == torch.bfloat16),
                 d.data_ptr(), k_s.data_ptr(), ka.data_ptr(), kb.data_ptr(), n, stream)
    assemble.launches += 1
    return ka, kb


# launch counts of the CUDA kernels, K7a's also by route (plain-version
# calls do not count)
colabs.launches = 0
colabs.launches_by_route = dict.fromkeys(COLABS_ROUTES, 0)
assemble.launches = 0
