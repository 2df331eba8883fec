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
    bytes (A read once); one thread per column loops over the rows
    (``csrc/spd_transform.cu``).
    """
    dev = build.check_tensors(build.FLOAT_DTYPES, a=a)
    if a.ndim != 2:
        raise ValueError(f"a must be 2-D, got {tuple(a.shape)}")
    if dev.type == "cpu":
        return colabs_plain(a)
    rows, cols = a.shape
    lib = build.load_library()
    out = torch.empty(cols, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.call("repro_colabs", a.data_ptr(), int(a.dtype == torch.bfloat16),
                 out.data_ptr(), rows, cols, stream)
    colabs.launches += 1
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.call("repro_assemble", a.data_ptr(), int(a.dtype == torch.bfloat16),
                 d.data_ptr(), k_s.data_ptr(), ka.data_ptr(), kb.data_ptr(), n, stream)
    assemble.launches += 1
    return ka, kb


# launch counts of the CUDA kernels (plain-version calls do not count)
colabs.launches = 0
assemble.launches = 0
