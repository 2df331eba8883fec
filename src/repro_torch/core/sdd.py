"""Symmetric-diagonally-dominant detection — the O(1) passive path.

Counterpart of :mod:`repro.core.sdd`.  Eq. 25: the proposed design is
*fully passive* (no op-amps, settling at parasitic-RC speed, independent
of n) exactly when

    A_ii >= (K_s)_ii + sum_{j != i} |A_ji|     for all i,

i.e. (A - K_s) is (column) diagonally dominant.  Dominance of A alone is
not enough: the supply conductance K_s = |b| / x_s needs its own room.
"""

from __future__ import annotations

import torch

from repro_torch.core.transform import column_abs_sums, supply_conductance
from repro_torch.device import as_float64


def sdd_margin(a, b, supply_v: float = 4.0, *, device=None) -> torch.Tensor:
    """Per-column margin of Eq. 25 (>= 0 everywhere -> passive network),
    float64:

    margin_i = A_ii - (K_s)_ii - sum_{j != i} |A_ji|

    A tensor ``a`` is used where it lies, an array goes to ``device``
    (default ``"cuda"``); ``b`` follows ``a``.
    """
    a = as_float64(a, device)
    k_s = supply_conductance(as_float64(b, a.device), supply_v)
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    off = column_abs_sums(a) - diag.abs()
    return diag - k_s - off


def is_diagonally_dominant(a, b, supply_v: float = 4.0, tol: float = 0.0, *,
                           device=None) -> torch.Tensor:
    """True iff the transformed network needs no negative-resistance cell
    (a 0-d bool tensor per system)."""
    return torch.all(sdd_margin(a, b, supply_v, device=device) >= -tol, dim=-1)
