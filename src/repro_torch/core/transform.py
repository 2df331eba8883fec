"""The paper's 2n x 2n SPD transform (Sec. IV, Eqs. 13-23), in PyTorch.

Counterpart of :mod:`repro.core.transform`.  Given ``A x = b`` (A
symmetric positive-definite), build

    [[K_A, K_B], [K_B, K_A]] {x; -x} = {b - K_s x; -b - K_s (-x)}      (14)

with

    K_A = D + 0.5 (A - |A|) - K_s                                      (15)
    K_B = D - 0.5 (A + |A|)                                            (16)

Every function takes one system (``a`` (n, n), ``b`` (n,)) or a batch
(``a`` (B, n, n), ``b`` (B, n)) — the reference's ``vmap`` written out
as leading batch dimensions.  Callers pass float64 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.specs import CircuitParams, DEFAULT_PARAMS


def column_abs_sums(a: torch.Tensor) -> torch.Tensor:
    """sum_j |A_ji| per column i — the paper's only O(n^2) digital cost."""
    return a.abs().sum(dim=-2)


def supply_conductance(b: torch.Tensor, supply_v: float = 4.0) -> torch.Tensor:
    """Eq. 13: k_si = |b_i| / x_s  (= |0.25 b_i| at 4 V rails)."""
    return b.abs() / supply_v


def d_matrix_scaled(a: torch.Tensor, beta: float) -> torch.Tensor:
    """Eq. 21: D = beta * max_i(sum_j |A_ji|) * I, beta >= 0.5."""
    scale = beta * column_abs_sums(a).amax(dim=-1, keepdim=True)
    return scale * torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)


def d_matrix_proposed(a: torch.Tensor, k_s: torch.Tensor) -> torch.Tensor:
    """Eq. 22 — the paper's D.

    D_ii = (K_s)_ii + 0.5 sum_j |A_ji|          for i = 1 (first node)
    D_ii = 0.5 (K_s)_ii + 0.5 sum_j |A_ji|      otherwise
    """
    d = 0.5 * k_s + 0.5 * column_abs_sums(a)
    # first node gets the full K_s term -> acts as the single support
    d[..., 0] += 0.5 * k_s[..., 0]
    return d


class Transformed2N(NamedTuple):
    """Result of the proposed 2n transform (one system or a batch)."""

    k_a: torch.Tensor        # (..., n, n)  Eq. 15
    k_b: torch.Tensor        # (..., n, n)  Eq. 16
    d: torch.Tensor          # (..., n)     diagonal of D
    k_s: torch.Tensor        # (..., n)     supply conductances, Eq. 13
    b_sign: torch.Tensor     # (..., n)     sign of b (selects +/- rail; 0 = NC)
    supply_v: float

    @property
    def n(self) -> int:
        return self.k_a.shape[-1]

    def assembled(self) -> torch.Tensor:
        """The circuit's DC operator  M = [[K_A + K_s, K_B], [K_B, K_A + K_s]]."""
        return assemble_2n(self.k_a + torch.diag_embed(self.k_s), self.k_b)

    def rhs(self) -> torch.Tensor:
        """{b; -b} = {K_s x_s; -K_s x_s}."""
        b = self.k_s * self.b_sign * self.supply_v
        return torch.cat([b, -b], dim=-1)

    def negative_cell_conductances(self) -> torch.Tensor:
        """diag(K_B) — positive entries need a negative-resistance cell.

        Eq. 26: K_Bii = -(1/2)(A_ii - K_sii - sum_{j!=i} |A_ji|) is the
        per-column deviation of (A - K_s) from diagonal dominance.
        """
        return torch.diagonal(self.k_b, dim1=-2, dim2=-1)

    def max_conductance(self) -> torch.Tensor:
        """Max branch conductance of the transformed network (per system).

        Branches are the off-diagonals of K_A/K_B plus |diag(K_B)|; the
        complexity studies (Figs. 12-14) show this — not n — controls
        settling time.
        """
        def off_max(k):
            off = k - torch.diag_embed(torch.diagonal(k, dim1=-2, dim2=-1))
            return off.abs().amax(dim=(-2, -1))

        diag_b = self.negative_cell_conductances().abs().amax(dim=-1)
        return torch.maximum(torch.maximum(off_max(self.k_a), off_max(self.k_b)), diag_b)


def transform_2n(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    d_policy: str = "proposed",
    beta: float = 0.5,
    params: CircuitParams = DEFAULT_PARAMS,
) -> Transformed2N:
    """Transform ``A x = b`` into the proposed 2n-unknown system.

    d_policy:
      * "proposed" — Eq. 22 (the paper's final design)
      * "scaled"   — Eq. 21 with scaling factor ``beta`` (Fig. 10 study)
      * "gremban"  — D = diag(A), K_s = 0 (the support-tree transform)
    """
    abs_a = a.abs()
    if d_policy == "gremban":
        k_s = torch.zeros_like(b)
        d = torch.diagonal(a, dim1=-2, dim2=-1)
    else:
        k_s = supply_conductance(b, params.supply_v)
        if d_policy == "proposed":
            d = d_matrix_proposed(a, k_s)
        elif d_policy == "scaled":
            d = d_matrix_scaled(a, beta)
        else:
            raise ValueError(f"unknown d_policy: {d_policy!r}")

    k_a = torch.diag_embed(d) + 0.5 * (a - abs_a) - torch.diag_embed(k_s)  # Eq. 15
    k_b = torch.diag_embed(d) - 0.5 * (a + abs_a)                         # Eq. 16
    return Transformed2N(
        k_a=k_a, k_b=k_b, d=d, k_s=k_s, b_sign=torch.sign(b),
        supply_v=params.supply_v,
    )


def assemble_2n(k_a: torch.Tensor, k_b: torch.Tensor) -> torch.Tensor:
    """[[K_A, K_B], [K_B, K_A]] (Eq. 14 left-hand block matrix)."""
    top = torch.cat([k_a, k_b], dim=-1)
    bot = torch.cat([k_b, k_a], dim=-1)
    return torch.cat([top, bot], dim=-2)


def eigen_split(tr: Transformed2N) -> tuple[torch.Tensor, torch.Tensor]:
    """Eqs. 17-19: the transformed spectrum splits into

    spec(K_A - K_B) = spec(A - K_s)   and
    spec(K_A + K_B) = spec(2D - |A| - K_s).

    Returns the eigenvalues (ascending, float64) of both blocks of the
    *circuit* operator M, i.e. with the supply conductance K_s on the
    diagonal, so the first block's spectrum is exactly spec(A).
    """
    k_ak = (tr.k_a + torch.diag_embed(tr.k_s)).to(torch.float64)
    k_b = tr.k_b.to(torch.float64)
    lam_minus = torch.linalg.eigvalsh(k_ak - k_b)   # = spec(A)
    lam_plus = torch.linalg.eigvalsh(k_ak + k_b)    # = spec(2D - |A|)
    return lam_minus, lam_plus


def stability_condition(a: torch.Tensor, k_s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Eq. 20 margin per node: D_ii - 0.5[(K_s)_ii + sum_j |A_ji|].

    >= 0 (with equality allowed when another column provides support)
    keeps (K_A + K_B) diagonally dominant hence PSD.
    """
    return d - 0.5 * (k_s + column_abs_sums(a))


def scale_system(tr: Transformed2N, alpha: float) -> Transformed2N:
    """Eq. 27: scale every conductance by alpha (solution unchanged)."""
    return Transformed2N(
        k_a=tr.k_a * alpha,
        k_b=tr.k_b * alpha,
        d=tr.d * alpha,
        k_s=tr.k_s * alpha,
        b_sign=tr.b_sign,
        supply_v=tr.supply_v,
    )
