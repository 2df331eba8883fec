"""Crosspoint-array layout of the proposed design (Sec. IV-A4, Fig. 11).

Counterpart of :mod:`repro.core.crosspoint`.  The 2n-design maps onto
the standard MVM crossbar:

* rows/columns = the 2n unknown nodes; row i is wired to column i;
* off-diagonals of K_A / K_B are halved and assigned symmetrically to
  (i, j) and (j, i) — two parallel resistors realizing the original one;
* the diagonal of the array is electrically irrelevant (both ends on the
  same node) and K_B's diagonal is deliberately zeroed in the array —
  those elements live in *external* element circuits so they can flip to
  negative resistance;
* two extra columns carry the supply conductances (Eq. 13), one extra
  row the ground conductances (column sums).

The array is the operand of K6 (:func:`repro_torch.kernels.ops.
crosspoint_mvm`, ``I = G V`` on the card).  The layout and its own
products run in float64 with ``torch.matmul``, as the reference leaves
``g @ v`` to XLA.  One system at a time, on the transform's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.transform import Transformed2N, assemble_2n


class CrosspointLayout(NamedTuple):
    g_array: torch.Tensor         # (2n, 2n) crossbar conductances, >= 0
    supply_cols: torch.Tensor     # (2n, 2) conductances to x_s+ / x_s-
    ground_row: torch.Tensor      # (2n,) conductances to ground
    external_cells: torch.Tensor  # (n,) diag(K_B): element circuits i <-> n+i
    supply_v: float

    def mvm_currents(self, v: torch.Tensor) -> torch.Tensor:
        """Array current drawn from each node at voltages ``v`` —
        the crossbar MVM the analog hardware performs for free."""
        # branch (i,j) of conductance g carries g (v_i - v_j) out of i
        g = self.g_array
        v = v.to(g.dtype)
        return v * g.sum(dim=1) - g @ v

    def dc_operator(self) -> torch.Tensor:
        """Reassemble the circuit's DC operator from the layout
        (the layout round-trip check)."""
        g = self.g_array
        n2 = g.shape[0]
        n = n2 // 2
        # halved symmetric entries: g holds K/2 both sides -> sum = K
        gs = g + g.T
        m = -gs
        diag = gs.sum(dim=1) + self.ground_row + self.supply_cols.sum(dim=1)
        ar2 = torch.arange(n2, device=g.device)
        m[ar2, ar2] = diag
        # external cells stamp the (i, n+i) pairs
        idx = torch.arange(n, device=g.device)
        w = self.external_cells
        m[idx, idx + n] += w
        m[idx + n, idx] += w
        m[idx, idx] -= w
        m[idx + n, idx + n] -= w
        return m


def crosspoint_layout(tr: Transformed2N) -> CrosspointLayout:
    """Map one transformed system onto the crossbar (Fig. 11), float64."""
    n = tr.n
    k_a = tr.k_a.to(torch.float64)
    k_b = tr.k_b.to(torch.float64)
    k_s = tr.k_s.to(torch.float64)
    dev = k_a.device
    k2n = assemble_2n(k_a, k_b)
    # off-diagonal conductances: g_ij = -K_ij (>= 0 off the K_B diagonal),
    # halved and mirrored; array diagonal and K_B diagonal zeroed.
    g = -k2n / 2.0
    ar2 = torch.arange(2 * n, device=dev)
    g[ar2, ar2] = 0.0
    idx = torch.arange(n, device=dev)
    external = torch.diagonal(k_b).clone()
    g[idx, idx + n] = 0.0
    g[idx + n, idx] = 0.0
    g = torch.clamp(g, min=0.0)   # numerical guard; entries are >= 0 by Eqs. 15-16

    pos = (tr.b_sign > 0).to(torch.float64)
    neg = (tr.b_sign < 0).to(torch.float64)
    # node i (first block) connects to +rail when b_i > 0; mirror node to -rail
    supply_cols = torch.stack(
        [torch.cat([k_s * pos, k_s * neg]), torch.cat([k_s * neg, k_s * pos])], dim=1,
    )

    # ground row: column sums of the full circuit operator (only nodes
    # 1 and n+1 are nonzero under the proposed D, Eq. 22)
    k_s2 = torch.cat([k_s, k_s])
    m_full = k2n + torch.diag(k_s2)
    gamma = m_full.sum(dim=0) - k_s2
    ground_row = torch.clamp(gamma, min=0.0)

    return CrosspointLayout(
        g_array=g,
        supply_cols=supply_cols,
        ground_row=ground_row,
        external_cells=external,
        supply_v=tr.supply_v,
    )
