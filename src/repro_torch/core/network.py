"""Netlist construction for both circuit designs.

Counterpart of :mod:`repro.core.network`.  A :class:`Netlist` is the
bridge between the linear-algebra view and the circuit view: the
physical component list (branch resistors, ground legs, supply
resistors, negative-resistance cells) as structure-of-arrays, host-side
numpy float64, because the number of cells is data dependent.

The Sec. IV transform runs in PyTorch float64 on ``device`` for the
whole batch at once (the reference's jit-vmapped ``transform_2n``); the
component extraction that follows stays host numpy, as in the
reference.  The single-system builders are batches of one.

Conventions (as in the reference): nodes ``0 .. n_nodes-1`` are the
unknown voltages (2n for the proposed design), ground is implicit; cell
arrays hold pair cells first (lexicographic ``(i, j)``) then ground
cells (``cell_j == -1``) in ascending node order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.runtime import sync_scope
from repro_torch.core import transform as T
from repro_torch.core.specs import CircuitParams, DEFAULT_PARAMS
from repro_torch.device import resolve_device, to_device

_EMPTY_I = np.zeros(0, dtype=np.int64)
_EMPTY_F = np.zeros(0, dtype=np.float64)


@dataclasses.dataclass
class NegCell:
    """One negative-resistance cell (Sec. II-B, Fig. 3).

    Pair cell (j >= 0): two op-amps + two buffers realize conductance
    ``-w`` between nodes i and j.  Ground cell (j == -1): a single
    op-amp realizes ``-w`` from node i to ground.
    """

    i: int
    j: int          # -1 for ground
    w: float        # magnitude of the (negative) conductance, > 0

    @property
    def n_amps(self) -> int:
        return 2 if self.j >= 0 else 1

    @property
    def n_buffers(self) -> int:
        return 2 if self.j >= 0 else 1


@dataclasses.dataclass
class Netlist:
    design: str                      # "preliminary" | "proposed" | "passive"
    n_unknowns: int                  # n of the original system
    n_nodes: int                     # n (preliminary) or 2n (proposed)
    # physical components (all conductances > 0):
    branch_i: np.ndarray             # (n_br,) int
    branch_j: np.ndarray             # (n_br,) int
    branch_g: np.ndarray             # (n_br,) float
    ground_g: np.ndarray             # (n_nodes,) float >= 0
    supply_g: np.ndarray             # (n_nodes,) float >= 0 (Eq. 13 stamps)
    supply_v: np.ndarray             # (n_nodes,) float (+/- rail or 0=NC)
    # negative-resistance cells, structure-of-arrays (j == -1: ground cell)
    cell_i: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I)
    cell_j: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I)
    cell_w: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_F)
    params: CircuitParams = DEFAULT_PARAMS
    # switch-bearing element circuits touching each node (Fig. 6)
    element_count: np.ndarray | None = None

    @property
    def cells(self) -> list[NegCell]:
        """Array-of-structures view of the cell arrays."""
        return [
            NegCell(i=int(i), j=int(j), w=float(w))
            for i, j, w in zip(self.cell_i, self.cell_j, self.cell_w)
        ]

    @property
    def n_cells(self) -> int:
        return int(self.cell_i.shape[0])

    @property
    def n_amps(self) -> int:
        # pair cells carry two amps, ground cells one
        return int(np.sum(np.where(self.cell_j >= 0, 2, 1))) if self.n_cells else 0

    @property
    def n_branches(self) -> int:
        return int(self.branch_g.shape[0])

    @property
    def is_passive(self) -> bool:
        return self.n_cells == 0

    @property
    def s(self) -> np.ndarray:
        """Norton supply current vector."""
        return self.supply_g * self.supply_v

    def assemble_passive(self) -> np.ndarray:
        """Dense passive operator (branches + ground legs + supplies)."""
        n = self.n_nodes
        m = np.zeros((n, n), dtype=np.float64)
        bi, bj, bg = self.branch_i, self.branch_j, self.branch_g
        np.add.at(m, (bi, bj), -bg)
        np.add.at(m, (bj, bi), -bg)
        diag = np.zeros(n, dtype=np.float64)
        np.add.at(diag, bi, bg)
        np.add.at(diag, bj, bg)
        diag += self.ground_g + self.supply_g
        m[np.arange(n), np.arange(n)] += diag
        return m

    def assemble_dc(self) -> np.ndarray:
        """Full DC operator including negative-resistance cell stamps.

        Solving ``M v = s`` gives the ideal operating point; for the
        proposed design ``v = [x; -x]``.
        """
        m = self.assemble_passive()
        pair = self.cell_j >= 0
        pi, pj, pw = self.cell_i[pair], self.cell_j[pair], self.cell_w[pair]
        np.add.at(m, (pi, pj), pw)
        np.add.at(m, (pj, pi), pw)
        np.add.at(m, (pi, pi), -pw)
        np.add.at(m, (pj, pj), -pw)
        gi, gw = self.cell_i[~pair], self.cell_w[~pair]
        np.add.at(m, (gi, gi), -gw)
        return m

    def recovered_solution(self, v: np.ndarray) -> np.ndarray:
        """Read the unknown vector off the node voltages."""
        return v[..., : self.n_unknowns]

    def max_conductance(self) -> float:
        """Largest branch/cell conductance (the Figs. 12-14 regressor)."""
        gmax = float(self.branch_g.max()) if self.n_branches else 0.0
        if self.n_cells:
            gmax = max(gmax, float(self.cell_w.max()))
        return gmax

    def perturbed(self, rng: np.random.Generator, rel: float) -> "Netlist":
        """Multiplicative conductance perturbation on every resistor."""
        def p(x):
            return x * (1.0 + rel * rng.uniform(-1.0, 1.0, size=np.shape(x)))

        return dataclasses.replace(
            self,
            branch_g=p(self.branch_g),
            ground_g=p(self.ground_g),
            supply_g=p(self.supply_g),
            cell_w=p(self.cell_w),
        )

    def with_wiper(self, r_wiper: float) -> "Netlist":
        """Pot wiper/series resistance: g -> g / (1 + g * R_w)."""
        def w(x):
            x = np.asarray(x, dtype=np.float64)
            return x / (1.0 + x * r_wiper)

        return dataclasses.replace(
            self,
            branch_g=w(self.branch_g),
            ground_g=w(self.ground_g),
            supply_g=w(self.supply_g),
            cell_w=w(self.cell_w),
        )

    def quantized(self, bits: int, g_full_scale: float | None = None) -> "Netlist":
        """Digital-potentiometer quantization (N-bit, resistance-domain).

        Codes ``g = code / (2^bits - 1) * g_fs``; each programmed
        conductance snaps to the nearest code (zero stays zero).  The
        supply pots are a separate bank with their own full scale.
        """
        if bits <= 0:
            return self
        levels = (1 << bits) - 1
        if g_full_scale is None:
            g_full_scale = max(self.max_conductance(), 1e-30)
        step = g_full_scale / levels
        sup_max = float(self.supply_g.max())
        sup_step = (sup_max / levels) if sup_max > 0 else step

        def q(x, st):
            x = np.asarray(x, dtype=np.float64)
            return np.where(x > 0, np.maximum(np.round(x / st), 1.0) * st, 0.0)

        return dataclasses.replace(
            self,
            branch_g=q(self.branch_g, step),
            ground_g=q(self.ground_g, step),
            supply_g=q(self.supply_g, sup_step),
            cell_w=q(self.cell_w, step),
        )


# ---------------------------------------------------------------------------
# Vectorized batched builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _BatchExtraction:
    """Batched component masks shared by both designs' builders."""

    iu: np.ndarray           # (P,) upper-triangle rows (shared)
    ju: np.ndarray           # (P,) upper-triangle cols (shared)
    vals: np.ndarray         # (B, P) off-diagonal values
    neg: np.ndarray          # (B, P) bool — branch resistors
    pos: np.ndarray          # (B, P) bool — pair cells
    gamma: np.ndarray        # (B, n_nodes) column sums minus supply
    gneg: np.ndarray         # (B, n_nodes) bool — ground cells
    ground_g: np.ndarray     # (B, n_nodes) physical ground legs


def _extract_components_batch(
    m_dc: np.ndarray,
    supply_g: np.ndarray,
    *,
    pair_mask: np.ndarray | None,
    tol: float,
) -> _BatchExtraction:
    """Decompose (B, n, n) DC operators into component masks.

    branch g_ij = -M_ij for M_ij < 0; cells for M_ij > 0; ground legs
    from the (symmetric) row sums minus supply stamps.
    """
    n = m_dc.shape[1]
    iu, ju = np.triu_indices(n, k=1)
    vals = m_dc[:, iu, ju]                                   # (B, P)
    scale = np.maximum(np.abs(m_dc).max(axis=(1, 2)), 1.0) * tol   # (B,)

    neg = vals < -scale[:, None]
    pos = vals > scale[:, None]
    if pair_mask is not None and np.any(pos & ~pair_mask[iu, ju][None, :]):
        raise ValueError(
            "positive off-diagonal outside allowed cell positions; "
            "transform violated its guarantee"
        )
    gamma = m_dc.sum(axis=1) - supply_g                      # (B, n)
    gneg = gamma < -scale[:, None]
    ground_g = np.where(gamma > scale[:, None], gamma, 0.0)
    return _BatchExtraction(
        iu=iu, ju=ju, vals=vals, neg=neg, pos=pos,
        gamma=gamma, gneg=gneg, ground_g=ground_g,
    )


def _netlists_from_extraction(
    ext: _BatchExtraction,
    *,
    design_of,
    n_unknowns: int,
    n_nodes: int,
    supply_g: np.ndarray,
    supply_v: np.ndarray,
    elem: np.ndarray,
    params: CircuitParams,
) -> list[Netlist]:
    """Slice the batched masks into per-system component arrays."""
    out = []
    for k in range(ext.vals.shape[0]):
        pk, nk = ext.pos[k], ext.neg[k]
        gi = np.nonzero(ext.gneg[k])[0]
        cell_i = np.concatenate([ext.iu[pk], gi]).astype(np.int64)
        cell_j = np.concatenate([ext.ju[pk], np.full(gi.shape, -1)]).astype(np.int64)
        cell_w = np.concatenate(
            [ext.vals[k][pk], -ext.gamma[k][ext.gneg[k]]]
        ).astype(np.float64)
        out.append(Netlist(
            design=design_of(cell_i),
            n_unknowns=n_unknowns,
            n_nodes=n_nodes,
            branch_i=ext.iu[nk],
            branch_j=ext.ju[nk],
            branch_g=-ext.vals[k][nk],
            ground_g=ext.ground_g[k],
            supply_g=supply_g[k],
            supply_v=supply_v[k],
            cell_i=cell_i,
            cell_j=cell_j,
            cell_w=cell_w,
            params=params,
            element_count=elem[k],
        ))
    return out


def _batch_elem_counts(
    ext: _BatchExtraction,
    n_nodes: int,
    *,
    count_branches: bool,
    count_ground_legs: bool,
    supply_g: np.ndarray,
) -> np.ndarray:
    """Batched per-node switch-bearing element counts (Fig. 6)."""
    b_count = ext.vals.shape[0]
    elem = np.zeros((b_count, n_nodes), dtype=np.float64)
    bidx = np.arange(b_count)[:, None]
    iu_b = np.broadcast_to(ext.iu[None, :], ext.pos.shape)
    ju_b = np.broadcast_to(ext.ju[None, :], ext.pos.shape)
    touch = ext.pos.astype(np.float64)
    if count_branches:
        touch = touch + ext.neg.astype(np.float64)
    np.add.at(elem, (bidx, iu_b), touch)
    np.add.at(elem, (bidx, ju_b), touch)
    elem += ext.gneg.astype(np.float64)          # ground cells touch one node
    if count_ground_legs:
        elem += (ext.ground_g > 0).astype(np.float64)
    elem += (supply_g > 0).astype(np.float64)
    return elem


def build_preliminary_batch(
    a: np.ndarray,
    b: np.ndarray,
    *,
    params: CircuitParams = DEFAULT_PARAMS,
    tol: float = 1e-14,
) -> list[Netlist]:
    """Sec. III: map ``(A - K_s) x = b - K_s x`` directly onto n nodes.

    The DC operator is A itself; every positive off-diagonal A_ij and
    every negative physical ground leg becomes a negative-resistance
    cell.  Host numpy only (no transform to run).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = a.shape[1]
    supply_g = np.abs(b) / params.supply_v                  # Eq. 13
    supply_v = params.supply_v * np.sign(b)

    ext = _extract_components_batch(a, supply_g, pair_mask=None, tol=tol)
    elem = _batch_elem_counts(
        ext, n, count_branches=True, count_ground_legs=True, supply_g=supply_g
    )
    return _netlists_from_extraction(
        ext,
        design_of=lambda cell_i: "preliminary",
        n_unknowns=n,
        n_nodes=n,
        supply_g=supply_g,
        supply_v=supply_v,
        elem=elem,
        params=params,
    )


def build_proposed_batch(
    a: np.ndarray,
    b: np.ndarray,
    *,
    d_policy: str = "proposed",
    beta: float = 0.5,
    alpha: float = 1.0,
    params: CircuitParams = DEFAULT_PARAMS,
    tol: float = 1e-14,
    device=None,
) -> list[Netlist]:
    """Sec. IV: the proposed 2n-design netlists of a (B, n, n) stack.

    The transform runs on ``device`` in float64, batched; the component
    extraction runs on the host.  Only the diagonal of K_B can be
    positive, so cells live strictly on (i, n+i) pairs.
    """
    dev = resolve_device(device)
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    b_count, n = b.shape
    tr = T.transform_2n(
        to_device(a, dev), to_device(b, dev),
        d_policy=d_policy, beta=beta, params=params,
    )
    if alpha != 1.0:
        tr = T.scale_system(tr, alpha)                      # Eq. 27
    # the extraction below is host numpy by design, so the transform's
    # outputs copy back here — labeled net_build so SyncWatch counts them
    # under the build, not under the caller's dispatch scope
    with sync_scope("net_build"):
        m_dc = tr.assembled().cpu().numpy()
        k_s = tr.k_s.cpu().numpy()
        sign = tr.b_sign.cpu().numpy()
    supply_g = np.concatenate([k_s, k_s], axis=1)
    supply_v = params.supply_v * np.concatenate([sign, -sign], axis=1)

    ar = np.arange(n)
    pair_mask = np.zeros((2 * n, 2 * n), dtype=bool)
    pair_mask[ar, ar + n] = True

    ext = _extract_components_batch(m_dc, supply_g, pair_mask=pair_mask, tol=tol)
    # crosspoint pots are switchless (Sec. IV-A4): only the external
    # K_B-diagonal element circuits and the supply switches load nodes.
    elem = _batch_elem_counts(
        ext, 2 * n, count_branches=False, count_ground_legs=False,
        supply_g=supply_g,
    )
    return _netlists_from_extraction(
        ext,
        design_of=lambda cell_i: "proposed" if cell_i.size else "passive",
        n_unknowns=n,
        n_nodes=2 * n,
        supply_g=supply_g,
        supply_v=supply_v,
        elem=elem,
        params=params,
    )


def build_preliminary(a, b, *, params: CircuitParams = DEFAULT_PARAMS,
                      tol: float = 1e-14) -> Netlist:
    """Single-system :func:`build_preliminary_batch`."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return build_preliminary_batch(a[None], b[None], params=params, tol=tol)[0]


def build_proposed(a, b, *, d_policy: str = "proposed", beta: float = 0.5,
                   alpha: float = 1.0, params: CircuitParams = DEFAULT_PARAMS,
                   tol: float = 1e-14, device=None) -> Netlist:
    """Single-system :func:`build_proposed_batch`."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return build_proposed_batch(
        a[None], b[None], d_policy=d_policy, beta=beta, alpha=alpha,
        params=params, tol=tol, device=device,
    )[0]
