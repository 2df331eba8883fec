"""Batched circuit physics engine — stamp patterns, batched assembly,
batched DC solves and batched transient settling, in PyTorch.

Counterpart of :mod:`repro.core.engine` (see there for the physics).

* **Stamp patterns** (:class:`StampPattern`, host numpy) — the static
  state layout of one ``(design, n)`` family, cached and shared by a
  batch.
* **Assembly** — the per-system component values are gathered on the
  host (O(B * components)), then scattered on the device in float64:
  :func:`assemble_batch` builds the dense ``(B, nz, nz)`` operators
  (DC solve, exact eig path, dense sweep) and :func:`assemble_batch_ell`
  the matrix-free ELL slot arrays with the reference's slot layout.
* **DC solve** — one batched ``torch.linalg.solve_ex`` in float64 with
  the reference's tiny-leakage repair for singular supports.  On CUDA it
  is asynchronous; :func:`dc_solve_batch_finalize` is where the host
  copy happens.
* **Transient** — exact modal settling by stacked eigendecomposition
  (host numpy, as in the reference) up to :data:`EIG_STATE_LIMIT`
  states, and :func:`euler_settle_batch`, the forward-Euler settle sweep
  through the Hopper kernels K1-K4 (:mod:`repro_torch.kernels.ops`),
  polled once per chunk.

Dtypes are explicit: assembly, DC and eig paths float64; only the sweep
runs float32 (or bf16 weights), which the 1 % settling band absorbs.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.analysis.runtime import sync_scope
from repro_torch.core import spectral
from repro_torch.core.network import Netlist
from repro_torch.core.specs import OpAmpSpec, AD712
from repro_torch.device import resolve_device, stage, to_device
from repro_torch.kernels import ops

F64 = torch.float64

# nz above which transient_batch(method="auto") switches from the exact
# eigendecomposition to the forward-Euler sweep.
EIG_STATE_LIMIT = 2048

# bf16 sweeps settle to the *rounded* operator's equilibrium; the bf16
# settle verdict certifies arrival within this per-system band
# (relative to max |x_ref|), as in the reference.
BF16_SETTLE_RTOL = 0.15


# ---------------------------------------------------------------------------
# Stamp patterns
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class StampPattern:
    """Static state-space structure for one ``(design, n)`` family.

    State layout: ``[nodes | per pair slot: buf1, buf2, a1_int,
    (a1_out), a2_int, (a2_out) | per ground slot: a_int, (a_out)]``.
    Identity (``__eq__``/``__hash__``) is defined by the primary fields
    only, so equal-but-distinct patterns are interchangeable cache keys.
    """

    design: str
    n_nodes: int
    n_unknowns: int
    pair_i: np.ndarray          # (P,) near node of each pair-cell slot
    pair_j: np.ndarray          # (P,) far node
    gcell_i: np.ndarray         # (G,) node of each ground-cell slot
    states_per_amp: int         # 2 with a second pole, else 1
    buffers: bool

    # derived state indices (filled by the factory)
    buf1_idx: np.ndarray = dataclasses.field(default=None, repr=False)
    buf2_idx: np.ndarray = dataclasses.field(default=None, repr=False)
    a1_int: np.ndarray = dataclasses.field(default=None, repr=False)
    a1_out: np.ndarray = dataclasses.field(default=None, repr=False)
    a2_int: np.ndarray = dataclasses.field(default=None, repr=False)
    a2_out: np.ndarray = dataclasses.field(default=None, repr=False)
    g_int: np.ndarray = dataclasses.field(default=None, repr=False)
    g_out: np.ndarray = dataclasses.field(default=None, repr=False)
    amp_int_index: np.ndarray = dataclasses.field(default=None, repr=False)
    amp_out_index: np.ndarray = dataclasses.field(default=None, repr=False)
    n_states: int = 0

    def _identity(self) -> tuple:
        return (
            self.design, self.n_nodes, self.n_unknowns,
            self.states_per_amp, self.buffers,
        )

    def __eq__(self, other) -> bool:
        if other is self:
            return True
        if not isinstance(other, StampPattern):
            return NotImplemented
        return (
            self._identity() == other._identity()
            and np.array_equal(self.pair_i, other.pair_i)
            and np.array_equal(self.pair_j, other.pair_j)
            and np.array_equal(self.gcell_i, other.gcell_i)
        )

    def __hash__(self) -> int:
        h = getattr(self, "_hash_cache", None)
        if h is None:
            h = hash(self._identity() + (
                self.pair_i.tobytes(), self.pair_j.tobytes(),
                self.gcell_i.tobytes(),
            ))
            object.__setattr__(self, "_hash_cache", h)
        return h

    @property
    def n_pair_slots(self) -> int:
        return int(self.pair_i.shape[0])

    @property
    def n_ground_slots(self) -> int:
        return int(self.gcell_i.shape[0])

    @property
    def n_amp_slots(self) -> int:
        return 2 * self.n_pair_slots + self.n_ground_slots

    def pair_keys(self) -> np.ndarray:
        """Sorted encoding of the pair slots, for slot lookup."""
        return self.pair_i * self.n_nodes + self.pair_j


def _build_pattern(design, n_nodes, n_unknowns, pair_i, pair_j, gcell_i,
                   states_per_amp, buffers) -> StampPattern:
    p = pair_i.shape[0]
    g = gcell_i.shape[0]
    spa = states_per_amp
    n_buf = 2 if buffers else 0
    per_pair = n_buf + 2 * spa

    pair_base = n_nodes + np.arange(p, dtype=np.int64) * per_pair
    if buffers:
        buf1 = pair_base
        buf2 = pair_base + 1
    else:
        # ideal buffers: the amp divider reads the far node directly
        buf1 = pair_j.astype(np.int64)
        buf2 = pair_i.astype(np.int64)
    a1_int = pair_base + n_buf
    a1_out = a1_int + 1 if spa == 2 else a1_int
    a2_int = pair_base + n_buf + spa
    a2_out = a2_int + 1 if spa == 2 else a2_int

    g_base = n_nodes + p * per_pair + np.arange(g, dtype=np.int64) * spa
    g_int = g_base
    g_out = g_base + 1 if spa == 2 else g_base
    n_states = n_nodes + p * per_pair + g * spa

    amp_int = np.concatenate([np.stack([a1_int, a2_int], axis=1).reshape(-1), g_int])
    amp_out = np.concatenate([np.stack([a1_out, a2_out], axis=1).reshape(-1), g_out])
    return StampPattern(
        design=design, n_nodes=n_nodes, n_unknowns=n_unknowns,
        pair_i=pair_i.astype(np.int64), pair_j=pair_j.astype(np.int64),
        gcell_i=gcell_i.astype(np.int64), states_per_amp=spa, buffers=buffers,
        buf1_idx=buf1, buf2_idx=buf2, a1_int=a1_int, a1_out=a1_out,
        a2_int=a2_int, a2_out=a2_out, g_int=g_int, g_out=g_out,
        amp_int_index=amp_int, amp_out_index=amp_out, n_states=int(n_states),
    )


_PATTERN_CACHE: dict[tuple, StampPattern] = {}
# preliminary-design patterns are keyed by data-dependent cell positions:
# bound the cache (FIFO eviction, LRU refresh on hits)
_PATTERN_CACHE_MAX = 512


def _cached_pattern(design, n_nodes, n_unknowns, pair_i, pair_j, gcell_i,
                    spa, buffers) -> StampPattern:
    pair_i = np.asarray(pair_i, dtype=np.int64)
    pair_j = np.asarray(pair_j, dtype=np.int64)
    gcell_i = np.asarray(gcell_i, dtype=np.int64)
    key = (design, n_nodes, n_unknowns, spa, buffers,
           pair_i.tobytes(), pair_j.tobytes(), gcell_i.tobytes())
    pat = _PATTERN_CACHE.pop(key, None)
    if pat is None:
        pat = _build_pattern(design, n_nodes, n_unknowns, pair_i, pair_j,
                             gcell_i, spa, buffers)
        while len(_PATTERN_CACHE) >= _PATTERN_CACHE_MAX:
            _PATTERN_CACHE.pop(next(iter(_PATTERN_CACHE)))
    _PATTERN_CACHE[key] = pat
    return pat


def pattern_of(net: Netlist, opamp: OpAmpSpec = AD712, *,
               buffers: bool = True) -> StampPattern:
    """Exact pattern of one netlist (its own cells as the slot set)."""
    pair = net.cell_j >= 0
    return _cached_pattern(
        net.design, net.n_nodes, net.n_unknowns, net.cell_i[pair],
        net.cell_j[pair], net.cell_i[~pair], 2 if opamp.p2_hz > 0 else 1,
        buffers,
    )


def pattern_union(nets: list[Netlist], opamp: OpAmpSpec = AD712, *,
                  buffers: bool = True) -> StampPattern:
    """Shared pattern covering every netlist in the batch.

    Proposed-design slots are normalized to all n ``(i, n+i)`` pairs, so
    the pattern depends only on ``(n, design)``; the preliminary design
    takes the union of the batch's cell positions.
    """
    first = nets[0]
    for net in nets[1:]:
        if (net.design in ("proposed", "passive")) != (
            first.design in ("proposed", "passive")
        ) or net.n_nodes != first.n_nodes or net.n_unknowns != first.n_unknowns:
            raise ValueError("batch mixes incompatible netlists")

    spa = 2 if opamp.p2_hz > 0 else 1
    n = first.n_unknowns
    gset = np.unique(np.concatenate(
        [net.cell_i[net.cell_j < 0] for net in nets]).astype(np.int64))
    if first.design in ("proposed", "passive"):
        idx = np.arange(n, dtype=np.int64)
        return _cached_pattern("proposed", first.n_nodes, n, idx, idx + n,
                               gset, spa, buffers)
    keys = np.unique(np.concatenate([
        net.cell_i[net.cell_j >= 0] * first.n_nodes + net.cell_j[net.cell_j >= 0]
        for net in nets
    ]).astype(np.int64))
    return _cached_pattern(first.design, first.n_nodes, n, keys // first.n_nodes,
                           keys % first.n_nodes, gset, spa, buffers)


def pattern_covers(pat: StampPattern, nets: list[Netlist]) -> bool:
    """Whether every cell of every netlist lands on a slot of ``pat``."""
    pair_keys = pat.pair_keys()
    for net in nets:
        if net.n_nodes != pat.n_nodes or net.n_unknowns != pat.n_unknowns:
            return False
        pair = net.cell_j >= 0
        keys = net.cell_i[pair] * pat.n_nodes + net.cell_j[pair]
        if not np.all(np.isin(keys, pair_keys)):
            return False
        if not np.all(np.isin(net.cell_i[~pair], pat.gcell_i)):
            return False
    return True


def pattern_merge(a: StampPattern, b: StampPattern) -> StampPattern:
    """Smallest cached pattern covering both ``a`` and ``b``."""
    if (
        a.design != b.design
        or a.n_nodes != b.n_nodes
        or a.n_unknowns != b.n_unknowns
        or a.states_per_amp != b.states_per_amp
        or a.buffers != b.buffers
    ):
        raise ValueError("cannot merge patterns from different families")
    keys = np.union1d(a.pair_keys(), b.pair_keys())
    return _cached_pattern(
        a.design, a.n_nodes, a.n_unknowns, keys // a.n_nodes, keys % a.n_nodes,
        np.union1d(a.gcell_i, b.gcell_i), a.states_per_amp, a.buffers,
    )


# ---------------------------------------------------------------------------
# Batched assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchedStateSpace:
    """``dz/dt = M_b z + c_b`` for a batch of B systems on one pattern."""

    m: torch.Tensor              # (B, nz, nz) float64, on the device
    c: torch.Tensor              # (B, nz) float64, on the device
    pattern: StampPattern
    amp_active: np.ndarray       # (B, n_amp_slots) bool — real amps only
    amp_rail: float
    slew: float

    @property
    def batch(self) -> int:
        return self.m.shape[0]

    @property
    def device(self) -> torch.device:
        return self.m.device

    @property
    def n_states(self) -> int:
        return self.pattern.n_states

    @property
    def n_nodes(self) -> int:
        return self.pattern.n_nodes

    @property
    def n_unknowns(self) -> int:
        return self.pattern.n_unknowns

    @property
    def amp_int_index(self) -> np.ndarray:
        return self.pattern.amp_int_index

    @property
    def amp_out_index(self) -> np.ndarray:
        return self.pattern.amp_out_index


def _slot_positions(pat: StampPattern, net: Netlist) -> tuple[np.ndarray, np.ndarray]:
    """Map a net's cells onto pattern slots (pair slots, ground slots)."""
    pair = net.cell_j >= 0
    keys = net.cell_i[pair] * pat.n_nodes + net.cell_j[pair]
    sp = np.searchsorted(pat.pair_keys(), keys)
    if sp.size and (
        np.any(sp >= pat.n_pair_slots) or np.any(pat.pair_keys()[sp] != keys)
    ):
        raise ValueError("netlist has a cell outside the pattern's slots")
    gi = net.cell_i[~pair]
    sg = np.searchsorted(pat.gcell_i, gi)
    if sg.size and (
        np.any(sg >= pat.n_ground_slots) or np.any(pat.gcell_i[sg] != gi)
    ):
        raise ValueError("netlist has a ground cell outside the pattern")
    return sp, sg


@dataclasses.dataclass
class _BatchValues:
    """Per-system component values gathered onto a shared pattern's slots
    (host side, O(B * components)); shared by the dense and ELL paths."""

    pair_w: np.ndarray       # (B, P)
    gcell_w: np.ndarray      # (B, G)
    pair_active: np.ndarray  # (B, P) bool
    g_active: np.ndarray     # (B, G) bool
    amp_active: np.ndarray   # (B, n_amp_slots) bool
    v_os_slots: np.ndarray   # (B, n_amp_slots)
    br_i: np.ndarray         # (B, n_br_max) int64
    br_j: np.ndarray         # (B, n_br_max) int64
    br_g: np.ndarray         # (B, n_br_max)
    n_br: np.ndarray         # (B,) int64 — valid branch count per system
    ground_g: np.ndarray     # (B, n)
    supply_g: np.ndarray     # (B, n)
    s_cur: np.ndarray        # (B, n)
    elem: np.ndarray         # (B, n)


def _gather_batch_values(nets, pat: StampPattern, v_os) -> _BatchValues:
    b_count = len(nets)
    n = pat.n_nodes
    p_slots = pat.n_pair_slots
    pair_w = np.zeros((b_count, p_slots))
    gcell_w = np.zeros((b_count, pat.n_ground_slots))
    pair_active = np.zeros((b_count, p_slots), dtype=bool)
    g_active = np.zeros((b_count, pat.n_ground_slots), dtype=bool)
    amp_active = np.zeros((b_count, pat.n_amp_slots), dtype=bool)
    v_os_slots = np.zeros((b_count, pat.n_amp_slots))

    n_br_max = max((net.n_branches for net in nets), default=0)
    br_i = np.zeros((b_count, n_br_max), dtype=np.int64)
    br_j = np.zeros((b_count, n_br_max), dtype=np.int64)
    br_g = np.zeros((b_count, n_br_max))
    n_br = np.zeros(b_count, dtype=np.int64)
    ground_g = np.zeros((b_count, n))
    supply_g = np.zeros((b_count, n))
    s_cur = np.zeros((b_count, n))
    elem = np.zeros((b_count, n))

    for b, net in enumerate(nets):
        sp, sg = _slot_positions(pat, net)
        pair = net.cell_j >= 0
        pair_w[b, sp] = net.cell_w[pair]
        gcell_w[b, sg] = net.cell_w[~pair]
        pair_active[b, sp] = True
        g_active[b, sg] = True
        amp_active[b, 2 * sp] = True
        amp_active[b, 2 * sp + 1] = True
        amp_active[b, 2 * p_slots + sg] = True

        n_amps_b = net.n_amps
        if v_os is not None and v_os[b] is not None and n_amps_b:
            offs = np.broadcast_to(np.asarray(v_os[b], dtype=np.float64), (n_amps_b,))
            amp_pos = np.concatenate(
                [np.stack([2 * sp, 2 * sp + 1], axis=1).reshape(-1), 2 * p_slots + sg])
            v_os_slots[b, amp_pos] = offs

        nb = net.n_branches
        br_i[b, :nb] = net.branch_i
        br_j[b, :nb] = net.branch_j
        br_g[b, :nb] = net.branch_g
        n_br[b] = nb
        ground_g[b] = net.ground_g
        supply_g[b] = net.supply_g
        s_cur[b] = net.s
        if net.element_count is not None:
            elem[b] = net.element_count

    return _BatchValues(
        pair_w=pair_w, gcell_w=gcell_w, pair_active=pair_active,
        g_active=g_active, amp_active=amp_active, v_os_slots=v_os_slots,
        br_i=br_i, br_j=br_j, br_g=br_g, n_br=n_br, ground_g=ground_g,
        supply_g=supply_g, s_cur=s_cur, elem=elem,
    )


def _check_batch_params(nets: list[Netlist]):
    params = nets[0].params
    for net in nets[1:]:
        if net.params != params:
            raise ValueError("batch mixes CircuitParams")
    return params


def _node_capacitance(pat, vals, params, opamp, dev) -> torch.Tensor:
    """Per-node capacitance: wiring + switches + active amp/buffer pins."""
    cap = torch.full((len(vals.elem), pat.n_nodes), params.c_node, dtype=F64,
                     device=dev)
    cap = cap + params.c_switch * to_device(vals.elem, dev)
    if pat.n_pair_slots:
        pin = 2.0 * opamp.c_in * to_device(vals.pair_active, dev, F64)
        cap.index_add_(1, to_device(pat.pair_i, dev), pin)
        cap.index_add_(1, to_device(pat.pair_j, dev), pin)
    if pat.n_ground_slots:
        cap.index_add_(1, to_device(pat.gcell_i, dev),
                       opamp.c_in * to_device(vals.g_active, dev, F64))
    return cap


def assemble_batch(
    nets: list[Netlist],
    opamp: OpAmpSpec = AD712,
    *,
    v_os=None,
    buffers: bool = True,
    pattern: StampPattern | None = None,
    device=None,
) -> BatchedStateSpace:
    """Dense state-space assembly for a batch of netlists, on ``device``.

    ``v_os[b]`` is the per-amp input offset of system ``b`` (scalar or
    one value per actual amp, in the net's amp order); ``None`` means
    zero offset.  Materializes the ``(B, nz, nz)`` float64 operator.
    """
    dev = resolve_device(device)
    b_count = len(nets)
    pat = pattern_union(nets, opamp, buffers=buffers) if pattern is None else pattern
    params = _check_batch_params(nets)
    n = pat.n_nodes
    nz = pat.n_states
    vals = _gather_batch_values(nets, pat, v_os)

    def t(x):
        return to_device(x, dev)

    bidx = torch.arange(b_count, device=dev)[:, None]
    inv_c = 1.0 / _node_capacitance(pat, vals, params, opamp, dev)

    # ---- passive stamps (branches + ground legs + supplies) ----
    br_i, br_j, br_g = t(vals.br_i), t(vals.br_j), t(vals.br_g)
    passive = torch.zeros((b_count, n, n), dtype=F64, device=dev)
    passive.index_put_((bidx, br_i, br_j), -br_g, accumulate=True)
    passive.index_put_((bidx, br_j, br_i), -br_g, accumulate=True)
    diag = torch.zeros((b_count, n), dtype=F64, device=dev)
    diag.index_put_((bidx, br_i), br_g, accumulate=True)
    diag.index_put_((bidx, br_j), br_g, accumulate=True)
    diag = diag + (t(vals.ground_g) + t(vals.supply_g))
    ar = torch.arange(n, device=dev)
    passive[:, ar, ar] += diag

    m = torch.zeros((b_count, nz, nz), dtype=F64, device=dev)
    c_vec = torch.zeros((b_count, nz), dtype=F64, device=dev)
    m[:, :n, :n] = -passive * inv_c[:, :, None]
    c_vec[:, :n] = t(vals.s_cur) * inv_c
    del passive

    # ---- amp/buffer dynamics (constant structure, shared by the batch) ----
    w_u = opamp.omega_u
    p2 = 2.0 * np.pi * opamp.p2_hz if opamp.p2_hz > 0 else 0.0
    inv_a0 = 1.0 / opamp.open_loop_gain
    spa = pat.states_per_amp

    if pat.n_pair_slots:
        pi, pj = t(pat.pair_i), t(pat.pair_j)
        buf1, buf2 = t(pat.buf1_idx), t(pat.buf2_idx)
        if buffers:
            m[:, buf1, pj] += w_u
            m[:, buf1, buf1] += -w_u
            m[:, buf2, pi] += w_u
            m[:, buf2, buf2] += -w_u
        for a_int, a_out, vplus, far in (
            (t(pat.a1_int), t(pat.a1_out), pi, buf1),
            (t(pat.a2_int), t(pat.a2_out), pj, buf2),
        ):
            m[:, a_int, vplus] += w_u
            m[:, a_int, a_out] += -0.5 * w_u
            m[:, a_int, far] += -0.5 * w_u
            m[:, a_int, a_int] += -w_u * inv_a0
            if spa == 2:
                m[:, a_out, a_int] += p2
                m[:, a_out, a_out] += -p2
        # cell currents into both nodes (w = 0 for inactive slots)
        pair_w = t(vals.pair_w)
        wi = pair_w * inv_c[:, pi]
        wj = pair_w * inv_c[:, pj]
        a1_out, a2_out = t(pat.a1_out), t(pat.a2_out)
        m.index_put_((bidx, pi[None, :], pi[None, :]), -wi, accumulate=True)
        m.index_put_((bidx, pi[None, :], a1_out[None, :]), wi, accumulate=True)
        m.index_put_((bidx, pj[None, :], pj[None, :]), -wj, accumulate=True)
        m.index_put_((bidx, pj[None, :], a2_out[None, :]), wj, accumulate=True)

    if pat.n_ground_slots:
        gi, g_int, g_out = t(pat.gcell_i), t(pat.g_int), t(pat.g_out)
        m[:, g_int, gi] += w_u
        m[:, g_int, g_out] += -0.5 * w_u
        m[:, g_int, g_int] += -w_u * inv_a0
        if spa == 2:
            m[:, g_out, g_int] += p2
            m[:, g_out, g_out] += -p2
        wg = t(vals.gcell_w) * inv_c[:, gi]
        m.index_put_((bidx, gi[None, :], gi[None, :]), -wg, accumulate=True)
        m.index_put_((bidx, gi[None, :], g_out[None, :]), wg, accumulate=True)

    if pat.n_amp_slots:
        c_vec[:, t(pat.amp_int_index)] += w_u * t(vals.v_os_slots)

    return BatchedStateSpace(
        m=m, c=c_vec, pattern=pat, amp_active=vals.amp_active,
        amp_rail=opamp.rail_v, slew=opamp.slew_v_per_s,
    )


# ---------------------------------------------------------------------------
# Matrix-free ELL assembly (on the device)
# ---------------------------------------------------------------------------
#
# ELL slot layout per node row, as in the reference:
#
#     [0] diagonal | [1 .. C] cell couplings | [1+C ..] branch stamps
#
# with the branch slots assigned by an in-row cumulative count (stable
# argsort + searchsorted per system).  Amp/buffer rows are static per
# pattern, built once on the host and broadcast.


@dataclasses.dataclass
class EllBatchedStateSpace:
    """``dz/dt = M z + c`` with ``M`` in batched ELL (padded sparse-row)
    form: ``(M z)[b, i] = sum_k weights[b, i, k] * z[b, indices[b, i, k]]``.

    Unused slots carry ``(index 0, weight 0)``.  The dense operator
    exists only if a caller asks (:meth:`to_dense`).
    """

    indices: torch.Tensor        # (B, nz, K) int32, on the device
    weights: torch.Tensor        # (B, nz, K) float64
    c: torch.Tensor              # (B, nz) float64
    pattern: StampPattern
    amp_active: np.ndarray       # (B, n_amp_slots) bool — real amps only
    amp_rail: float
    slew: float

    @property
    def batch(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def n_states(self) -> int:
        return self.pattern.n_states

    @property
    def n_nodes(self) -> int:
        return self.pattern.n_nodes

    @property
    def n_unknowns(self) -> int:
        return self.pattern.n_unknowns

    @property
    def amp_int_index(self) -> np.ndarray:
        return self.pattern.amp_int_index

    @property
    def amp_out_index(self) -> np.ndarray:
        return self.pattern.amp_out_index

    @property
    def ell_width(self) -> int:
        return self.indices.shape[2]

    @property
    def fill_ratio(self) -> float:
        """ELL row width over dense row length — the crossover metric."""
        return self.ell_width / max(self.n_states, 1)

    @functools.cached_property
    def gather_indices(self) -> torch.Tensor:
        """The int32 slot indices as the int64 that ``torch.gather`` takes,
        cast once per operator."""
        return self.indices.long()

    def matvec(self, z: torch.Tensor) -> torch.Tensor:
        """Batched ``M z`` (gathered row reduction, operand dtype)."""
        gathered = torch.gather(z, 1, self.gather_indices.reshape(self.batch, -1))
        return torch.sum(self.weights * gathered.reshape(self.indices.shape), dim=2)

    def matvec_block(self, z: torch.Tensor) -> torch.Tensor:
        """Block matvec ``(B, k, nz) -> (B, k, nz)``: one gathered row
        reduction over the whole block
        (:func:`repro_torch.core.spectral.ell_block_matvec`)."""
        return spectral.ell_block_matvec(self.gather_indices, self.weights, z)

    def matvec_t(self, z: torch.Tensor) -> torch.Tensor:
        """Batched ``M^T z`` (row-wise scatter-add).

        ``scatter_add_`` on a CUDA tensor adds with atomics, so on the
        card its float64 sums vary from run to run at the ulp level.
        Only the global symmetric-part bound of
        :func:`~repro_torch.core.spectral.spectral_bounds` uses it, and
        only with ``lanczos_iters > 0`` (the default is 0).
        """
        b, nz, k = self.indices.shape
        contrib = (self.weights * z[:, :, None]).reshape(b, nz * k)
        cols = self.gather_indices.reshape(b, nz * k)
        out = torch.zeros((b, nz), dtype=self.weights.dtype, device=self.device)
        return out.scatter_add_(1, cols, contrib)

    def diagonal(self) -> torch.Tensor:
        """Batched ``diag(M)`` — slots whose column equals their row."""
        rows = torch.arange(self.n_states, device=self.device,
                            dtype=self.indices.dtype)[None, :, None]
        return torch.where(self.indices == rows, self.weights, 0.0).sum(dim=2)

    def to_dense(self) -> torch.Tensor:
        """Materialize ``(B, nz, nz)`` float64 — reference/fallback only."""
        b, nz, k = self.indices.shape
        m = torch.zeros((b, nz, nz), dtype=F64, device=self.device)
        bb = torch.arange(b, device=self.device)[:, None, None].expand(b, nz, k)
        rr = torch.arange(nz, device=self.device)[None, :, None].expand(b, nz, k)
        m.index_put_((bb, rr, self.indices.long()), self.weights, accumulate=True)
        return m

    def to_dense_bss(self) -> BatchedStateSpace:
        """Dense-path view (the fill-ratio fallback of the sweep)."""
        return BatchedStateSpace(
            m=self.to_dense(), c=self.c, pattern=self.pattern,
            amp_active=self.amp_active, amp_rail=self.amp_rail, slew=self.slew,
        )


def _cumcount_np(r: np.ndarray) -> np.ndarray:
    """Per-element count of prior occurrences of the same value."""
    order = np.argsort(r, kind="stable")
    rs = r[order]
    pos = np.arange(r.size) - np.searchsorted(rs, rs, side="left")
    out = np.empty(r.size, dtype=np.int64)
    out[order] = pos
    return out


def _cumcount_rows(r: torch.Tensor) -> torch.Tensor:
    """:func:`_cumcount_np` per row of a (B, S) tensor."""
    order = torch.argsort(r, dim=1, stable=True)
    rs = torch.gather(r, 1, order)
    pos = torch.arange(r.shape[1], device=r.device)[None, :] - torch.searchsorted(
        rs, rs, side="left")
    return torch.empty_like(pos).scatter_(1, order, pos)


def _node_cell_layout(pat: StampPattern):
    """Static (row, col, slot) of every cell-output coupling stamp, in
    the value order ``[pair_w (near) | pair_w (far) | gcell_w]``."""
    rows = np.concatenate([pat.pair_i, pat.pair_j, pat.gcell_i])
    cols = np.concatenate([pat.a1_out, pat.a2_out, pat.g_out])
    slot = _cumcount_np(rows)
    c_max = int(slot.max()) + 1 if rows.size else 0
    return rows.astype(np.int64), cols.astype(np.int32), slot, c_max


def _amp_rows_static(pat: StampPattern, opamp: OpAmpSpec, buffers: bool, k: int):
    """The buffer/amp ELL rows — identical for every system in a batch."""
    n = pat.n_nodes
    nz = pat.n_states
    w_u = opamp.omega_u
    p2 = 2.0 * np.pi * opamp.p2_hz if opamp.p2_hz > 0 else 0.0
    inv_a0 = 1.0 / opamp.open_loop_gain
    spa = pat.states_per_amp
    rows: list[np.ndarray] = []
    cols: list[np.ndarray] = []
    vals: list[np.ndarray] = []

    def stamp(r, c, v):
        r = np.asarray(r, dtype=np.int64)
        rows.append(r)
        cols.append(np.broadcast_to(np.asarray(c, dtype=np.int64), r.shape))
        vals.append(np.broadcast_to(np.asarray(v, dtype=np.float64), r.shape))

    if pat.n_pair_slots:
        pi, pj = pat.pair_i, pat.pair_j
        if buffers:
            stamp(pat.buf1_idx, pj, w_u)
            stamp(pat.buf1_idx, pat.buf1_idx, -w_u)
            stamp(pat.buf2_idx, pi, w_u)
            stamp(pat.buf2_idx, pat.buf2_idx, -w_u)
        for a_int, a_out, vplus, far in (
            (pat.a1_int, pat.a1_out, pi, pat.buf1_idx),
            (pat.a2_int, pat.a2_out, pj, pat.buf2_idx),
        ):
            stamp(a_int, vplus, w_u)
            stamp(a_int, a_out, -0.5 * w_u)
            stamp(a_int, far, -0.5 * w_u)
            stamp(a_int, a_int, -w_u * inv_a0)
            if spa == 2:
                stamp(a_out, a_int, p2)
                stamp(a_out, a_out, -p2)
    if pat.n_ground_slots:
        stamp(pat.g_int, pat.gcell_i, w_u)
        stamp(pat.g_int, pat.g_out, -0.5 * w_u)
        stamp(pat.g_int, pat.g_int, -w_u * inv_a0)
        if spa == 2:
            stamp(pat.g_out, pat.g_int, p2)
            stamp(pat.g_out, pat.g_out, -p2)

    amp_idx = np.zeros((nz - n, k), dtype=np.int32)
    amp_w = np.zeros((nz - n, k), dtype=np.float64)
    if rows:
        r = np.concatenate(rows)
        slot = _cumcount_np(r)
        amp_idx[r - n, slot] = np.concatenate(cols).astype(np.int32)
        amp_w[r - n, slot] = np.concatenate(vals)
    return amp_idx, amp_w


# amp rows never exceed four stamps (v+, out, far, self)
_AMP_ROW_WIDTH = 4


def _ell_width(pat: StampPattern, vals: _BatchValues, c_max: int) -> int:
    """Bounded ELL row degree: 1 diag + C cell couplings + max branch
    degree across the batch, floored by the static amp-row width."""
    deg = np.zeros((vals.br_i.shape[0], pat.n_nodes), dtype=np.int64)
    valid = np.arange(vals.br_i.shape[1])[None, :] < vals.n_br[:, None]
    bidx = np.arange(vals.br_i.shape[0])[:, None]
    np.add.at(deg, (bidx, vals.br_i), valid.astype(np.int64))
    np.add.at(deg, (bidx, vals.br_j), valid.astype(np.int64))
    max_deg = int(deg.max()) if deg.size else 0
    return max(1 + c_max + max_deg, _AMP_ROW_WIDTH)


def assemble_batch_ell(
    nets: list[Netlist],
    opamp: OpAmpSpec = AD712,
    *,
    v_os=None,
    buffers: bool = True,
    pattern: StampPattern | None = None,
    device=None,
) -> EllBatchedStateSpace:
    """Matrix-free state-space assembly: ELL operators on ``device``.

    Same physics and arguments as :func:`assemble_batch`; the batch is
    scattered on the device directly in stamp-slot ELL form, with the
    reference's slot layout, and nothing of size ``(B, nz, nz)`` is built.
    """
    dev = resolve_device(device)
    pat = pattern_union(nets, opamp, buffers=buffers) if pattern is None else pattern
    params = _check_batch_params(nets)
    vals = _gather_batch_values(nets, pat, v_os)
    cell_rows, cell_cols, cell_slot, c_max = _node_cell_layout(pat)
    k = _ell_width(pat, vals, c_max)
    amp_idx, amp_w = _amp_rows_static(pat, opamp, buffers, k)

    def t(x, dtype=None):
        return to_device(x, dev, dtype)

    n = pat.n_nodes
    nz = pat.n_states
    b_count, nbr = vals.br_i.shape
    bidx = torch.arange(b_count, device=dev)[:, None]
    inv_c = 1.0 / _node_capacitance(pat, vals, params, opamp, dev)

    # ---- accumulated node diagonal ----
    br_i, br_j = t(vals.br_i), t(vals.br_j)
    valid = torch.arange(nbr, device=dev)[None, :] < t(vals.n_br)[:, None]
    bg = torch.where(valid, t(vals.br_g), 0.0)
    diag = -(t(vals.ground_g) + t(vals.supply_g))
    if nbr:
        diag.index_put_((bidx, br_i), -bg, accumulate=True)
        diag.index_put_((bidx, br_j), -bg, accumulate=True)
    pair_w, gcell_w = t(vals.pair_w), t(vals.gcell_w)
    if pat.n_pair_slots:
        diag.index_add_(1, t(pat.pair_i), -pair_w)
        diag.index_add_(1, t(pat.pair_j), -pair_w)
    if pat.n_ground_slots:
        diag.index_add_(1, t(pat.gcell_i), -gcell_w)

    # row nz is a write-off row for padded branch entries
    ell_w = torch.zeros((b_count, nz + 1, k), dtype=F64, device=dev)
    ell_i = torch.zeros((b_count, nz + 1, k), dtype=torch.int32, device=dev)
    ell_w[:, :n, 0] = diag * inv_c
    ell_i[:, :n, 0] = torch.arange(n, dtype=torch.int32, device=dev)[None, :]

    if cell_rows.size:
        rows_t, slot_t = t(cell_rows), t(1 + cell_slot)
        w_cell = torch.cat([pair_w, pair_w, gcell_w], dim=1) * inv_c[:, rows_t]
        ell_w[:, rows_t, slot_t] = w_cell
        ell_i[:, rows_t, slot_t] = t(cell_cols)[None, :].expand(b_count, -1)

    if nbr:
        r2 = torch.cat([br_i, br_j], dim=1)
        c2 = torch.cat([br_j, br_i], dim=1)
        # passive off-diag is -g; the operator is -passive/C -> +g/C
        v2 = torch.cat([bg * torch.gather(inv_c, 1, br_i),
                        bg * torch.gather(inv_c, 1, br_j)], dim=1)
        valid2 = torch.cat([valid, valid], dim=1)
        r2 = torch.where(valid2, r2, nz)
        slot2 = torch.clamp(1 + c_max + _cumcount_rows(r2), max=k - 1)
        ell_w.index_put_((bidx, r2, slot2), torch.where(valid2, v2, 0.0),
                         accumulate=True)
        ell_i.index_put_((bidx, r2, slot2),
                         torch.where(valid2, c2, 0).to(torch.int32), accumulate=True)

    if nz > n:
        ell_w[:, n:nz, :] = t(amp_w)[None]
        ell_i[:, n:nz, :] = t(amp_idx)[None]

    c_vec = torch.zeros((b_count, nz), dtype=F64, device=dev)
    c_vec[:, :n] = t(vals.s_cur) * inv_c
    if pat.n_amp_slots:
        c_vec[:, t(pat.amp_int_index)] += opamp.omega_u * t(vals.v_os_slots)

    return EllBatchedStateSpace(
        indices=ell_i[:, :nz].contiguous(),
        weights=ell_w[:, :nz].contiguous(),
        c=c_vec,
        pattern=pat,
        amp_active=vals.amp_active,
        amp_rail=opamp.rail_v,
        slew=opamp.slew_v_per_s,
    )


# ---------------------------------------------------------------------------
# Batched operating point
# ---------------------------------------------------------------------------


def _dc_solve(m: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    z, _info = torch.linalg.solve_ex(m, -c.unsqueeze(-1))
    return z[..., 0]


def dc_solve_batch_submit(bss: BatchedStateSpace, *, mesh=None, device=None) -> torch.Tensor:
    """Enqueue the batched float64 DC solve; returns the device result.

    On CUDA the call returns before the device finishes (the caller can
    build its next batch meanwhile); singular systems come back
    non-finite and are repaired by :func:`dc_solve_batch_finalize`.

    ``device`` solves the whole batch there; ``mesh`` (a
    :func:`repro_torch.distributed.sharding.solver_mesh`) splits the
    batch axis into contiguous parts, solves each on its mesh device and
    gathers the parts in order on ``bss.device``.  The two are mutually
    exclusive.  (The reference donates the operand buffers of a
    per-device solve to XLA; PyTorch's caching allocator has no
    counterpart, and none is needed.)
    """
    if device is not None and mesh is not None:
        raise ValueError("pass either device= (stream) or mesh= (shard)")
    if device is not None:
        dev = resolve_device(device)
        return _dc_solve(bss.m.to(dev), bss.c.to(dev))
    if mesh is not None:
        from repro_torch.distributed.sharding import shard_system_batch

        ms, cs = shard_system_batch(bss.m, bss.c, mesh=mesh)
        return torch.cat([_dc_solve(m, c).to(bss.device) for m, c in zip(ms, cs)])
    return _dc_solve(bss.m, bss.c)


def dc_solve_batch_finalize(z_dev: torch.Tensor, bss: BatchedStateSpace) -> np.ndarray:
    """Copy an in-flight DC solve to the host and apply the singular fallback.

    Systems whose operator is singular (degenerate supports) are
    re-solved with the tiny relative leakage ``1e-12 |M|`` to ground.
    """
    z = z_dev.cpu().numpy()
    bad = ~np.all(np.isfinite(z), axis=1)
    if np.any(bad):
        z = np.array(z, dtype=np.float64)
        eye = torch.eye(bss.n_states, dtype=F64, device=bss.device)
        for b in np.nonzero(bad)[0]:
            mb = bss.m[int(b)]
            eps = 1e-12 * mb.abs().max()
            zb = torch.linalg.solve(mb - eps * eye, -bss.c[int(b)])
            z[b] = zb.cpu().numpy()
    return z


def dc_solve_batch(bss: BatchedStateSpace) -> np.ndarray:
    """Steady states ``z_b = -M_b^{-1} c_b`` for the whole batch (host copy)."""
    return dc_solve_batch_finalize(dc_solve_batch_submit(bss), bss)


# ---------------------------------------------------------------------------
# Settling criterion
# ---------------------------------------------------------------------------


def settling_time(dev: np.ndarray, times: np.ndarray, target: np.ndarray, *,
                  rtol: float, atol: float) -> float:
    """Paper's criterion: first instant beyond which every node stays
    within 1% of its operating-point value."""
    tol = np.maximum(rtol * np.abs(target), atol)      # (nodes,)
    ok = np.all(np.abs(dev) <= tol[None, :], axis=1)   # (t,)
    if not ok[-1]:
        return float("inf")
    bad = np.nonzero(~ok)[0]
    if bad.size == 0:
        return float(times[0])
    last = bad[-1]
    return float(times[min(last + 1, len(times) - 1)])


# ---------------------------------------------------------------------------
# Batched transient analysis
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchTransientResult:
    stable: np.ndarray           # (B,) bool
    settle_time: np.ndarray      # (B,) seconds; inf if never
    x_converged: np.ndarray      # (B, n_unknowns)
    max_re_eig: np.ndarray       # (B,)
    dominant_tau: np.ndarray     # (B,)
    mirror_residual: np.ndarray  # (B,)
    method: str = "eig"
    # spectral path only: converged rightmost Ritz pair with a negative
    # restricted numerical abscissa (repro_torch.core.spectral); None on
    # the eig/euler/nonlinear paths
    certified: np.ndarray | None = None
    # euler path: per-system sweep steps actually taken (== max_steps if
    # never settled); spectral path: the predicted step count; None on
    # the eig/nonlinear paths
    settle_steps: np.ndarray | None = None

    def __len__(self) -> int:
        return self.stable.shape[0]


def _transient_batch_eig(bss: BatchedStateSpace, *, t_max: float, t_min: float,
                         n_times: int, stability_tol: float, settle_rtol: float,
                         settle_atol: float) -> BatchTransientResult:
    """Exact modal settling for every system (stacked eigendecomposition,
    host numpy float64 as in the reference)."""
    b_count = bss.batch
    nu = bss.n_unknowns
    nn = bss.n_nodes
    m = bss.m.cpu().numpy()
    c = bss.c.cpu().numpy()

    lam, vec = np.linalg.eig(m)                        # (B, nz), (B, nz, nz)
    max_re = np.max(lam.real, axis=1)
    rate_scale = np.max(np.abs(lam.real), axis=1)
    rate_scale = np.where(rate_scale == 0.0, 1.0, rate_scale)
    stable = max_re < stability_tol * rate_scale

    neg = lam.real < 0
    decays = np.where(neg, -lam.real, np.inf)
    min_decay = decays.min(axis=1)
    dominant_tau = np.where(min_decay < np.inf, 1.0 / min_decay, np.inf)

    settle = np.full(b_count, np.inf)
    x_conv = np.full((b_count, nu), np.nan)
    mirror = np.full(b_count, np.nan)

    if np.any(stable):
        times = np.logspace(np.log10(t_min), np.log10(t_max), n_times)
        idx = np.nonzero(stable)[0]
        z_star = np.linalg.solve(m[idx], -c[idx][..., None])[..., 0]
        coef = np.linalg.solve(vec[idx], (0.0 - z_star)[..., None])[..., 0]
        for k, b in enumerate(idx):
            rows = vec[b, :nu, :] * coef[k][None, :]   # (nu, modes)
            expo = np.exp(np.clip(lam[b][None, :] * times[:, None], -745.0, 60.0))
            dev = np.real(expo @ rows.T)               # (t, nu)
            v_star = np.real(z_star[k, :nn])
            settle[b] = settling_time(dev, times, v_star[:nu], rtol=settle_rtol,
                                      atol=settle_atol)
            x_conv[b] = v_star[:nu]
            mirror[b] = (
                float(np.max(np.abs(v_star[:nu] + v_star[nu: 2 * nu])))
                if nn == 2 * nu else 0.0
            )
    return BatchTransientResult(
        stable=stable, settle_time=settle, x_converged=x_conv,
        max_re_eig=max_re, dominant_tau=dominant_tau, mirror_residual=mirror,
        method="eig",
    )


def _settle_dt(bss, dt_safety: float, dt_policy: str) -> np.ndarray:
    """Per-system forward-Euler step size (host float64).

    ``"diag"`` — ``dt_safety / max_i |M_ii|``.  ``"spectral"`` — the
    abscissa-aware rule (:func:`repro_torch.core.spectral.mode_dt_limit`)
    in its dt-only configuration: power-iteration rate and Krylov Ritz
    modes, no slow-mode extraction and no certificate.
    """
    if dt_policy == "spectral":
        return spectral.spectral_bounds(
            bss, dt_safety=dt_safety, slow_iters=0, lanczos_iters=0).dt
    if dt_policy != "diag":
        raise ValueError(f"unknown dt_policy {dt_policy!r}")
    if isinstance(bss, EllBatchedStateSpace):
        diag = bss.diagonal().abs()
    else:
        diag = torch.diagonal(bss.m, dim1=1, dim2=2).abs()
    rate = diag.amax(dim=1).cpu().numpy()
    rate = np.where(rate == 0.0, 1.0, rate)
    return dt_safety / rate


def _settle_loop(step_chunk, z, dt, x_ref, *, rtol, atol, check_every,
                 max_steps, tol_floor=None, timings=None):
    """Shared chunked-sweep convergence loop (dense and ELL backends).

    ``step_chunk(z, n) -> (z', res)`` advances ``n`` steps with the
    dt-folded operator; ``res`` is the fused reduction
    ``dt * max|M z' + c|``.  The host polls once per chunk: one copy of
    the unknowns and the residual, then the settled check.  The final
    chunk is clamped so the sweep never passes ``max_steps``
    (``steps == max_steps`` means unsettled within budget).
    ``tol_floor`` (``(B,)``) widens the band per system (bf16 sweeps).
    ``timings`` accumulates ``sweep`` (launch + device work) and
    ``poll`` (host copy + check) wall seconds.
    """
    b_count, nu = x_ref.shape
    dev = z.device
    tol = np.maximum(rtol * np.abs(x_ref), atol)            # (B, nu)
    if tol_floor is not None:
        tol = np.maximum(tol, np.asarray(tol_floor)[:, None])
    steps = np.full(b_count, max_steps, dtype=np.int64)
    done = np.zeros(b_count, dtype=bool)
    res = np.zeros(b_count, dtype=np.float64)
    x_now = None
    taken = 0
    # the per-chunk poll is the sweep's sanctioned host copy: labeled so
    # SyncWatch counts it under settle_poll, not under the phase of
    # whichever service called us
    with sync_scope("settle_poll"):
        while taken < max_steps:
            chunk = min(check_every, max_steps - taken)
            with stage(timings, "sweep", dev):
                z, r = step_chunk(z, chunk)
            taken += chunk
            with stage(timings, "poll", dev):
                host = torch.cat([z[:, :nu], r[:, None]], dim=1).cpu().numpy()
                host = host.astype(np.float64)
                x_now = host[:, :nu]
                # dt was folded into the operator: undo it for the true residual
                res = host[:, nu] / dt
                ok = np.all(np.abs(x_now - x_ref) <= tol, axis=1)
                newly = ok & ~done
                steps[newly] = taken
                done |= newly
            if np.all(done):
                break
    if x_now is None:
        x_now = z[:, :nu].cpu().numpy().astype(np.float64)
    return steps, x_now, res


def euler_settle_batch(
    bss: BatchedStateSpace | EllBatchedStateSpace,
    x_ref: np.ndarray,
    *,
    rtol: float = 0.01,
    atol: float = 1e-4,
    dt_safety: float = 0.5,
    check_every: int | None = None,
    max_steps: int = 200_000,
    dt_policy: str = "diag",
    bounds=None,
    x0: np.ndarray | None = None,
    sweep_dtype: str = "float32",
    timings: dict | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Forward-Euler settling sweep through the Hopper kernels K1-K4.

    Integrates the batch from ``z = 0`` (or the warm start ``x0``) in
    float32, ``check_every`` fused steps per launch, until every unknown
    of every system stays within ``max(rtol |x_ref|, atol)`` of its
    reference, or ``max_steps``.  The per-system step
    (:func:`_settle_dt`) is folded into the operator in float64 before
    the cast to float32, so one kernel serves heterogeneous rates.

    ``bounds`` (a precomputed :class:`repro_torch.core.spectral.
    SpectralBounds`) replaces the ``dt_policy="spectral"`` estimate
    (``dt = dt_safety * bounds.dt_limit``) and, with ``check_every``
    left ``None``, sizes the chunks from the predicted settle steps
    (:func:`repro_torch.kernels.ops.sweep_chunk_schedule`); with its
    slow basis the prediction is amplitude-aware: the initial error
    state (the embedding of ``x0`` minus that of ``x_ref``) is projected
    onto the slow subspace.  Without a prediction ``check_every``
    defaults to 50.

    A dense :class:`BatchedStateSpace` runs the dense sweep (K3, or K4
    past the shared-memory limit).  An :class:`EllBatchedStateSpace`
    runs the matrix-free ELL sweep (K1, or K2) unless its fill ratio
    says the dense kernel moves fewer bytes, in which case it densifies.
    ``sweep_dtype="bfloat16"`` runs bf16 weights with f32 accumulation
    and widens the band by :data:`BF16_SETTLE_RTOL`.

    Returns ``(steps, x_final, residual, dt)``.
    """
    b_count = bss.batch
    nu = bss.n_unknowns
    nz = bss.n_states
    nn = bss.n_nodes
    x_ref = np.asarray(x_ref, dtype=np.float64).reshape(b_count, nu)

    if isinstance(bss, EllBatchedStateSpace):
        if ops.sweep_backend(nz, bss.ell_width).startswith("dense"):
            # fill-ratio fallback: the ELL form carries no traffic advantage
            bss = bss.to_dense_bss()
    dev = bss.c.device
    size = nz + (-nz) % ops.ROW_BLOCK

    def embed(x_nodes: np.ndarray) -> np.ndarray:
        """Node-block state embedding ``(B, nu) -> (B, nz)``: mirror nodes
        get ``-x`` on the 2n design, amp/buffer states 0 (an estimate,
        good enough for warm starts and amplitude projections)."""
        z_full = np.zeros((b_count, nz))
        z_full[:, :nu] = x_nodes
        if nn == 2 * nu:
            z_full[:, nu: 2 * nu] = -x_nodes
        return z_full

    z0_full = None
    z0 = torch.zeros((b_count, size), dtype=torch.float32, device=dev)
    if x0 is not None:
        z0_full = embed(np.asarray(x0, dtype=np.float64).reshape(b_count, nu))
        z0 = torch.as_tensor(np.pad(z0_full, ((0, 0), (0, size - nz))).astype(np.float32),
                             device=dev)

    tol_floor = (
        BF16_SETTLE_RTOL * np.max(np.abs(x_ref), axis=1)
        if sweep_dtype == "bfloat16" else None
    )
    if bounds is not None and dt_policy == "spectral":
        # the caller's safety factor on the (factor-free) stability limit
        dt = dt_safety * np.asarray(bounds.dt_limit)        # (B,)
    else:
        dt = _settle_dt(bss, dt_safety, dt_policy)          # (B,)
    if check_every is None:
        if bounds is not None:
            predicted = bounds.settle_steps
            if bounds.slow_basis is not None:
                z_err = (z0_full if z0_full is not None else 0.0) - embed(x_ref)
                predicted = spectral.amplitude_settle_steps(
                    bounds, z_err, rtol=rtol, x_scale=np.max(np.abs(x_ref), axis=1))
            check_every = ops.sweep_chunk_schedule(predicted, max_steps)
        else:
            check_every = 50
    dt_t = torch.as_tensor(dt, device=dev)

    def pad(x):
        return ops.pad_rows(x, tuple(range(1, x.ndim)))

    if isinstance(bss, EllBatchedStateSpace):
        w_dtype = torch.bfloat16 if sweep_dtype == "bfloat16" else torch.float32
        idx_t, w_t = ops.ell_prepare(
            bss.indices, (bss.weights * dt_t[:, None, None]).to(w_dtype), sweep_dtype)
        ct = pad((bss.c * dt_t[:, None]).to(torch.float32))

        def step_chunk(zz, n):
            return ops.ell_transient_sweep(idx_t, w_t, zz, ct, n_steps=n,
                                           padded=True, sweep_dtype=sweep_dtype)
    else:
        # rounded through the sweep dtype (bf16 storage semantics), padded
        # and laid out for its kernel once, outside the chunk loop
        route, mop = ops.dense_prepare((bss.m * dt_t[:, None, None]).to(torch.float32),
                                       sweep_dtype)
        ct = pad((bss.c * dt_t[:, None]).to(torch.float32))

        def step_chunk(zz, n):
            return ops.dense_sweep_prepared(route, mop, zz, ct, n_steps=n)

    steps, x_final, res = _settle_loop(
        step_chunk, z0, dt, x_ref, rtol=rtol, atol=atol,
        check_every=check_every, max_steps=max_steps, tol_floor=tol_floor,
        timings=timings,
    )
    return steps, x_final, res, dt


def transient_batch(
    nets: list[Netlist],
    opamp: OpAmpSpec = AD712,
    *,
    v_os=None,
    buffers: bool = True,
    t_max: float = 1.0,
    t_min: float = 1e-10,
    n_times: int = 3000,
    stability_tol: float = 1e-6,
    method: str = "auto",
    pattern: StampPattern | None = None,
    max_steps: int = 200_000,
    check_every: int | None = None,
    x_ref: np.ndarray | None = None,
    dt_policy: str = "diag",
    x0: np.ndarray | None = None,
    sweep_dtype: str = "float32",
    nl_t_end: float = 2e-4,
    nl_n_samples: int = 400,
    nl_safety: float = 0.4,
    device=None,
    timings: dict | None = None,
) -> BatchTransientResult:
    """Batched step-response settling analysis (supplies step at t=0).

    ``method``: ``"eig"`` — exact stacked eigendecomposition (host
    numpy); ``"euler"`` — forward-Euler sweep through the Hopper kernels
    (float32, settling time quantized to the check interval);
    ``"spectral"`` — the spectral estimator alone
    (:mod:`repro_torch.core.spectral`) on the ELL operators: the
    predicted settle time and steps, no integration, plus the
    ``certified`` flags; ``"nonlinear"`` — the slew-clipped,
    rail-clamped RK4 integration (:mod:`repro_torch.core.transient_nl`):
    ``stable`` is False when an active amp pins at a rail or the
    trajectory never enters the settle band around the DC point within
    ``nl_t_end`` (``nl_n_samples`` samples, RK4 margin ``nl_safety``);
    ``"auto"`` — eig up to :data:`EIG_STATE_LIMIT` states, euler beyond.

    On the euler path ``stable`` means *settled within ``max_steps``*.
    ``x_ref`` (``(B, nu)``) makes the euler path matrix-free: ELL
    assembly and sweep, settling against ``x_ref`` with no DC solve.
    Without it the euler path settles against the DC fixed point of the
    dense operator.  ``dt_policy="spectral"`` runs one full spectral
    pass first: its abscissa-aware dt drives the sweep and its predicted
    settle steps size the chunks.  ``timings`` accumulates stage wall
    seconds (``assembly``, ``dc_solve``, ``spectral``, ``sweep``,
    ``poll``, ``rk4``).
    """
    dev = resolve_device(device)
    params = nets[0].params
    if method == "auto":
        # the eig path runs per exact pattern: gate on the largest exact
        # state count, not the union pattern's
        probe = max(pattern_of(net, opamp, buffers=buffers).n_states for net in nets)
        method = "eig" if probe <= EIG_STATE_LIMIT else "euler"
    if method == "eig":
        # group systems by their *exact* pattern (inactive union slots
        # pollute the eigendecomposition with near-degenerate modes)
        groups: dict[int, list[int]] = {}
        pats: dict[int, StampPattern] = {}
        for k, net in enumerate(nets):
            pat_k = pattern_of(net, opamp, buffers=buffers)
            groups.setdefault(id(pat_k), []).append(k)
            pats[id(pat_k)] = pat_k
        b_count = len(nets)
        nu = nets[0].n_unknowns
        out = BatchTransientResult(
            stable=np.zeros(b_count, dtype=bool),
            settle_time=np.full(b_count, np.inf),
            x_converged=np.full((b_count, nu), np.nan),
            max_re_eig=np.full(b_count, np.nan),
            dominant_tau=np.full(b_count, np.nan),
            mirror_residual=np.full(b_count, np.nan),
            method="eig",
        )
        for gid, idx in groups.items():
            sub = [nets[k] for k in idx]
            sub_os = None if v_os is None else [v_os[k] for k in idx]
            with stage(timings, "assembly", dev):
                bss = assemble_batch(sub, opamp, v_os=sub_os, buffers=buffers,
                                     pattern=pats[gid], device=dev)
            res = _transient_batch_eig(
                bss, t_max=t_max, t_min=t_min, n_times=n_times,
                stability_tol=stability_tol, settle_rtol=params.settle_rtol,
                settle_atol=params.settle_atol,
            )
            ii = np.asarray(idx)
            out.stable[ii] = res.stable
            out.settle_time[ii] = res.settle_time
            out.x_converged[ii] = res.x_converged
            out.max_re_eig[ii] = res.max_re_eig
            out.dominant_tau[ii] = res.dominant_tau
            out.mirror_residual[ii] = res.mirror_residual
        return out
    if method == "nonlinear":
        return _transient_batch_nonlinear(
            nets, opamp, v_os=v_os, buffers=buffers, pattern=pattern, t_end=nl_t_end,
            n_samples=nl_n_samples, safety=nl_safety, device=dev, timings=timings)
    if method == "spectral":
        # estimator only, on the ELL operators: no dense build, no integration
        with stage(timings, "assembly", dev):
            bss = assemble_batch_ell(nets, opamp, v_os=v_os, buffers=buffers,
                                     pattern=pattern, device=dev)
        with stage(timings, "spectral", dev):
            sb = spectral.spectral_bounds(bss, rtol=params.settle_rtol)
        b_count = len(nets)
        nu = bss.n_unknowns
        if x_ref is not None:
            x_conv = np.where(
                sb.stable[:, None],
                np.asarray(x_ref, dtype=np.float64).reshape(b_count, nu), np.nan)
        else:
            x_conv = np.full((b_count, nu), np.nan)
        with np.errstate(divide="ignore"):
            tau = np.where(sb.stable, 1.0 / np.maximum(-sb.slow_re, 1e-300), np.inf)
        return BatchTransientResult(
            stable=sb.stable, settle_time=sb.settle_time, x_converged=x_conv,
            max_re_eig=sb.slow_re, dominant_tau=tau,
            mirror_residual=np.full(b_count, np.nan), method="spectral",
            certified=sb.certified, settle_steps=sb.settle_steps,
        )
    if method != "euler":
        raise ValueError(f"unknown transient method {method!r}")
    if dt_policy not in ("diag", "spectral"):
        raise ValueError(f"unknown dt_policy {dt_policy!r}")

    if x_ref is not None:
        # matrix-free path: ELL assembly, settle against the caller's
        # reference — nothing (B, nz, nz) is built
        with stage(timings, "assembly", dev):
            bss = assemble_batch_ell(nets, opamp, v_os=v_os, buffers=buffers,
                                     pattern=pattern, device=dev)
        nu = bss.n_unknowns
        x_star = np.asarray(x_ref, dtype=np.float64).reshape(len(nets), nu)
        z_star = None
    else:
        with stage(timings, "assembly", dev):
            bss = assemble_batch(nets, opamp, v_os=v_os, buffers=buffers,
                                 pattern=pattern, device=dev)
        # settle against the DC operating point
        with stage(timings, "dc_solve", dev):
            z_star = dc_solve_batch(bss)
        nu = bss.n_unknowns
        x_star = z_star[:, :nu]
    bounds = None
    if dt_policy == "spectral":
        # one full spectral pass: its abscissa-aware dt drives the sweep
        # and its predicted settle steps size the chunks
        with stage(timings, "spectral", dev):
            bounds = spectral.spectral_bounds(bss, rtol=params.settle_rtol)
    steps, x_final, _res, dt = euler_settle_batch(
        bss, x_star, rtol=params.settle_rtol, atol=params.settle_atol,
        max_steps=max_steps, check_every=check_every, dt_policy=dt_policy,
        bounds=bounds, x0=x0, sweep_dtype=sweep_dtype, timings=timings,
    )
    tol = np.maximum(params.settle_rtol * np.abs(x_star), params.settle_atol)
    if sweep_dtype == "bfloat16":
        tol = np.maximum(
            tol, BF16_SETTLE_RTOL * np.max(np.abs(x_star), axis=1, keepdims=True))
    settled = np.all(np.abs(x_final - x_star) <= tol, axis=1)
    settle_time = np.where(settled, steps * dt, np.inf)
    nn = bss.n_nodes
    if nn != 2 * nu:
        mirror = np.zeros(len(nets))
    elif z_star is not None:
        mirror = np.max(np.abs(z_star[:, :nu] + z_star[:, nu: 2 * nu]), axis=1)
    else:
        # matrix-free path: no DC state to read the mirror nodes from
        mirror = np.full(len(nets), np.nan)
    return BatchTransientResult(
        stable=settled,
        settle_time=settle_time,
        x_converged=np.where(settled[:, None], x_final, np.nan),
        max_re_eig=np.full(len(nets), np.nan),
        dominant_tau=np.full(len(nets), np.nan),
        mirror_residual=mirror,
        method="euler",
        settle_steps=steps,
    )


def _transient_batch_nonlinear(nets, opamp, *, v_os, buffers, pattern, t_end, n_samples,
                               safety, device, timings) -> BatchTransientResult:
    """``transient_batch(method="nonlinear")``: the RK4 integration of
    :mod:`repro_torch.core.transient_nl`, with settling read on its sample
    grid against the DC fixed point, as the linear paths read it."""
    from repro_torch.core import transient_nl

    params = nets[0].params
    with stage(timings, "assembly", device):
        bss = assemble_batch(nets, opamp, v_os=v_os, buffers=buffers, pattern=pattern,
                             device=device)
    with stage(timings, "rk4", device):
        tr = transient_nl.nonlinear_transient_batch(
            nets, opamp, t_end=t_end, n_samples=n_samples, v_os=v_os, safety=safety,
            bss=bss)
    b_count = len(nets)
    nu = bss.n_unknowns
    with stage(timings, "dc_solve", device):
        z_star = dc_solve_batch(bss)
    x_star = z_star[:, :nu]
    tol = np.maximum(params.settle_rtol * np.abs(x_star)[:, None, :], params.settle_atol)
    ok = np.all(np.abs(tr.x - x_star[:, None, :]) <= tol, axis=2)
    # first sample index from which the trajectory stays in-band
    viol = ~ok[:, ::-1]
    last_bad = np.where(viol.any(axis=1), ok.shape[1] - 1 - np.argmax(viol, axis=1), -1)
    settled = ok[:, -1] & ~tr.saturated
    idx = np.clip(last_bad + 1, 0, ok.shape[1] - 1)
    settle_time = np.where(settled, tr.times[idx], np.inf)
    if bss.n_nodes == 2 * nu:
        mirror = np.max(np.abs(z_star[:, :nu] + z_star[:, nu: 2 * nu]), axis=1)
    else:
        mirror = np.zeros(b_count)
    return BatchTransientResult(
        stable=settled,
        settle_time=settle_time,
        x_converged=np.where(settled[:, None], tr.x_final, np.nan),
        max_re_eig=np.full(b_count, np.nan),
        dominant_tau=np.full(b_count, np.nan),
        mirror_residual=mirror,
        method="nonlinear",
    )
