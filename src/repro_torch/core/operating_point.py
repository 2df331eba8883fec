"""Operating-point (DC) analysis with component non-idealities.

Counterpart of :mod:`repro.core.operating_point`: solve the steady
state of the full state space (finite open-loop gain and input offset on
the amp rows; digital-pot quantization, tolerance and wiper resistance
applied to the netlist), of one circuit or of a batch, and compare the
recovered unknowns with the mathematical solution.  The error-model draws are
host numpy with the reference's seeds, so both packages perturb the
same circuits identically.

Error metric: ``err_fullscale = max_i |x_hat_i - x_i| / max_i |x_i|``
(``max_rel_error``, per entry with an absolute floor, is reported too).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.network import Netlist
from repro_torch.core.specs import OpAmpSpec, AD712
from repro_torch.core.transient import assemble_state_space
from repro_torch.device import resolve_device, stage


@dataclasses.dataclass(frozen=True)
class NonIdealities:
    """Component error model.

    * ``pot_bits``: digital-potentiometer resolution (0 = ideal).
    * ``pot_tol``: relative conductance tolerance, uniform per resistor.
    * ``wiper_ohm``: pot wiper/series resistance (g -> g/(1 + g R_w)).
    * ``offset_mode``: "none" | "random" (U(-V_os, V_os) per amp) |
      "alternating" (+/-V_os per amp, the worst differential drive).
    * ``use_finite_gain``: apply the finite open-loop gain.
    * ``seed``: RNG seed for tolerance/offset draws.
    """

    pot_bits: int = 0
    pot_tol: float = 0.0
    wiper_ohm: float = 0.0
    offset_mode: str = "random"
    use_finite_gain: bool = True
    seed: int = 0


IDEAL = NonIdealities(
    pot_bits=0, pot_tol=0.0, wiper_ohm=0.0, offset_mode="none", use_finite_gain=False
)
DEFAULT_NONIDEAL = NonIdealities()
# full hardware model: 10-bit pots with 1% tolerance and 50-ohm wipers
HARDWARE = NonIdealities(pot_bits=10, pot_tol=0.01, wiper_ohm=50.0)


def draw_offsets(spec: OpAmpSpec, n_amps: int, mode: str, seed: int) -> np.ndarray:
    if mode == "none" or n_amps == 0:
        return np.zeros(n_amps)
    if mode == "alternating":
        return spec.v_os * np.where(np.arange(n_amps) % 2 == 0, 1.0, -1.0)
    if mode == "random":
        rng = np.random.default_rng(seed + 7919)
        return rng.uniform(-spec.v_os, spec.v_os, size=n_amps)
    raise ValueError(f"unknown offset_mode {mode!r}")


def apply_nonidealities(net: Netlist, ni: NonIdealities) -> Netlist:
    out = net
    if ni.pot_bits > 0:
        out = out.quantized(ni.pot_bits)
    if ni.pot_tol > 0.0:
        out = out.perturbed(np.random.default_rng(ni.seed), ni.pot_tol)
    if ni.wiper_ohm > 0.0:
        out = out.with_wiper(ni.wiper_ohm)
    return out


@dataclasses.dataclass
class OperatingPoint:
    x: np.ndarray                 # recovered unknowns
    v: np.ndarray                 # all node voltages
    amp_outputs: np.ndarray       # op-amp output voltages
    amp_saturated: bool           # any |a| beyond the rail -> invalid OP
    max_rel_error: float | None   # per-entry, floored, vs reference
    max_abs_error: float | None   # volts
    err_fullscale: float | None   # max abs error / max |x_ref| (paper metric)


def operating_point(
    net: Netlist,
    opamp: OpAmpSpec = AD712,
    *,
    nonideal: NonIdealities = DEFAULT_NONIDEAL,
    x_ref: np.ndarray | None = None,
    device=None,
) -> OperatingPoint:
    """DC solve of one (non-ideal) circuit, float64 on ``device``.

    A singular operator (with b_i = 0 on the support node, Eq. 22 puts
    the only ground leg at k_s1 = |b_1| / 4, so disconnected node pairs
    float) is solved with a tiny leakage to ground on every state,
    ``1e-12 max|M|`` — far below the component error floor — as the
    reference does.
    """
    net_ni = apply_nonidealities(net, nonideal)
    spec = opamp
    if not nonideal.use_finite_gain:
        spec = dataclasses.replace(spec, open_loop_gain=1e15)
    v_os = draw_offsets(spec, net_ni.n_amps, nonideal.offset_mode, nonideal.seed)
    ss = assemble_state_space(net_ni, spec, v_os=v_os, device=device)
    z, info = torch.linalg.solve_ex(ss.m, -ss.c)
    if int(info) != 0 or not bool(torch.isfinite(z).all()):
        eps = 1e-12 * ss.m.abs().max()
        eye = torch.eye(ss.n_states, dtype=ss.m.dtype, device=ss.m.device)
        z = torch.linalg.solve(ss.m - eps * eye, -ss.c)
    z = z.cpu().numpy()
    v = z[: ss.n_nodes]
    a = z[ss.amp_out_index] if ss.amp_out_index.size else np.zeros(0)
    sat = bool(np.any(np.abs(a) > ss.amp_rail)) if a.size else False
    x = net.recovered_solution(v)

    max_rel = max_abs = err_fs = None
    if x_ref is not None:
        x_ref = np.asarray(x_ref, dtype=np.float64)
        err = np.abs(x - x_ref)
        max_abs = float(err.max())
        scale = np.maximum(np.abs(x_ref), 1e-3)
        max_rel = float((err / scale).max())
        err_fs = float(max_abs / max(np.abs(x_ref).max(), 1e-12))
    return OperatingPoint(
        x=x, v=v, amp_outputs=a, amp_saturated=sat, max_rel_error=max_rel,
        max_abs_error=max_abs, err_fullscale=err_fs,
    )


@dataclasses.dataclass
class BatchOperatingPoint:
    """Batched DC analysis: per-system arrays over a shared stamp pattern."""

    x: np.ndarray                 # (B, n_unknowns)
    v: np.ndarray                 # (B, n_nodes)
    amp_outputs: np.ndarray       # (B, n_amp_slots); inactive slots = 0
    amp_saturated: np.ndarray     # (B,) bool
    max_rel_error: np.ndarray | None    # (B,)
    max_abs_error: np.ndarray | None    # (B,)
    err_fullscale: np.ndarray | None    # (B,)
    # which amp slots system b actually populates (B, n_amp_slots)
    amp_active: np.ndarray | None = None

    def __len__(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass
class PendingBatchOperatingPoint:
    """An in-flight batched DC solve: host metadata + the device result.

    :meth:`wait` copies the solution to the host (the only sync) and
    unpacks it; ``operating_point_batch`` is exactly submit + wait.
    """

    _bss: engine.BatchedStateSpace
    _z_dev: torch.Tensor
    _x_ref: np.ndarray | None
    _batch: int
    _timings: dict | None = None

    def wait(self) -> BatchOperatingPoint:
        bss = self._bss
        with stage(self._timings, "dc_solve", bss.device):
            z = engine.dc_solve_batch_finalize(self._z_dev, bss)
        nn = bss.n_nodes
        nu = bss.n_unknowns
        v = z[:, :nn]
        x = v[:, :nu]
        if bss.amp_out_index.size:
            a = z[:, bss.amp_out_index] * bss.amp_active
            sat = np.any(
                (np.abs(z[:, bss.amp_out_index]) > bss.amp_rail) & bss.amp_active,
                axis=1,
            )
        else:
            a = np.zeros((self._batch, 0))
            sat = np.zeros(self._batch, dtype=bool)

        max_rel = max_abs = err_fs = None
        if self._x_ref is not None:
            x_ref = np.asarray(self._x_ref, dtype=np.float64).reshape(self._batch, nu)
            err = np.abs(x - x_ref)
            max_abs = err.max(axis=1)
            scale = np.maximum(np.abs(x_ref), 1e-3)
            max_rel = (err / scale).max(axis=1)
            err_fs = max_abs / np.maximum(np.abs(x_ref).max(axis=1), 1e-12)
        return BatchOperatingPoint(
            x=x, v=v, amp_outputs=a, amp_saturated=sat, max_rel_error=max_rel,
            max_abs_error=max_abs, err_fullscale=err_fs, amp_active=bss.amp_active,
        )


def operating_point_batch_submit(
    nets: list[Netlist],
    opamp: OpAmpSpec = AD712,
    *,
    nonideal: NonIdealities = DEFAULT_NONIDEAL,
    x_ref: np.ndarray | None = None,
    pattern: engine.StampPattern | None = None,
    mesh=None,
    device=None,
    timings: dict | None = None,
) -> PendingBatchOperatingPoint:
    """Host phase of the batched DC analysis + asynchronous device solve.

    Applies the per-system error model (host), assembles the batch on
    the shared stamp pattern on ``device``, enqueues the float64 solve
    and returns without waiting for it.  ``mesh`` splits the DC solve's
    batch axis over a 1-d solver mesh
    (:func:`repro_torch.distributed.sharding.solver_mesh`).
    """
    dev = resolve_device(device)
    spec = opamp
    if not nonideal.use_finite_gain:
        spec = dataclasses.replace(spec, open_loop_gain=1e15)
    nets_ni = [apply_nonidealities(net, nonideal) for net in nets]
    v_os = [
        draw_offsets(spec, net.n_amps, nonideal.offset_mode, nonideal.seed)
        for net in nets_ni
    ]
    with stage(timings, "assembly", dev):
        bss = engine.assemble_batch(nets_ni, spec, v_os=v_os, pattern=pattern,
                                    device=dev)
    with stage(timings, "dc_solve", dev):
        z_dev = engine.dc_solve_batch_submit(bss, mesh=mesh)
    return PendingBatchOperatingPoint(
        _bss=bss, _z_dev=z_dev, _x_ref=x_ref, _batch=len(nets), _timings=timings,
    )


def operating_point_batch(
    nets: list[Netlist],
    opamp: OpAmpSpec = AD712,
    *,
    nonideal: NonIdealities = DEFAULT_NONIDEAL,
    x_ref: np.ndarray | None = None,
    pattern: engine.StampPattern | None = None,
    mesh=None,
    device=None,
) -> BatchOperatingPoint:
    """Batched DC solve of the (non-ideal) circuits: submit + wait.

    ``mesh`` splits the DC solve's batch axis over a solver mesh; the
    assembly runs on ``device``.
    """
    return operating_point_batch_submit(
        nets, opamp, nonideal=nonideal, x_ref=x_ref, pattern=pattern, mesh=mesh,
        device=device,
    ).wait()
