"""Nonlinear transient integration (slew-rate + rail saturation).

Counterpart of :mod:`repro.core.transient_nl`.  Integrates

    dz/dt = f(z),   f = M z + c  with per-amp slew clipping and
                    output-rail clamping

by fixed-step RK4 in float64 — the instability signature of Sec.
III-C.2 (an op-amp output pinned at a rail), used by the Fig. 8
stability check and ``engine.transient_batch(method="nonlinear")``.

:func:`nonlinear_transient_batch` assembles the batch on one shared
stamp pattern and advances all B systems together, one batched torch
step at a time on the operator's device (the reference's vmapped
``lax.scan``); :func:`nonlinear_transient` is its B = 1 wrapper.  All
systems share one ``dt`` (the stiffest system's RK4 bound, a Gershgorin
row-sum estimate) unless ``dt=`` pins it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.network import Netlist
from repro_torch.core.specs import OpAmpSpec, AD712


@dataclasses.dataclass
class NLTrace:
    times: np.ndarray            # (n_samples,)
    x: np.ndarray                # (n_samples, n_unknowns) node voltages
    amp_out: np.ndarray          # (n_samples, n_amps)
    saturated: bool              # any amp pinned at a rail at the end
    x_final: np.ndarray


@dataclasses.dataclass
class BatchNLTrace:
    """Batched :class:`NLTrace` on a shared sample grid."""

    times: np.ndarray            # (n_samples,) shared across the batch
    x: np.ndarray                # (B, n_samples, n_unknowns)
    amp_out: np.ndarray          # (B, n_samples, n_amp_slots)
    saturated: np.ndarray        # (B,) bool — active amps only
    x_final: np.ndarray          # (B, n_unknowns)
    z_final: np.ndarray          # (B, n_states) full final state
    dt: float                    # shared RK4 step

    def __len__(self) -> int:
        return self.x.shape[0]


def _integrate(m, c, int_mask, out_mask, slew, rail, z0, dt, n_steps: int,
               store_every: int):
    """``n_steps`` RK4 steps of the batch ``(B, nz)``, the state stored
    every ``store_every`` steps: ``(z_final, zs)`` with ``zs`` of shape
    ``(B, n_steps // store_every, nz)``.  The order of operations is the
    reference's: ``m @ z + c``, the slew clip on integrator rows, the
    pinned masks, ``z + (dt / 6) (k1 + 2 k2 + 2 k3 + k4)``, the rail clamp.
    """
    sat_mask = int_mask | out_mask

    def f(z):
        dz = torch.bmm(m, z[:, :, None])[:, :, 0] + c
        # slew-rate limit on the integrator rows
        dz = torch.where(int_mask, torch.clamp(dz, -slew, slew), dz)
        # saturation: no outward drive when pinned at a rail
        pinned_hi = sat_mask & (z >= rail) & (dz > 0)
        pinned_lo = sat_mask & (z <= -rail) & (dz < 0)
        return torch.where(pinned_hi | pinned_lo, 0.0, dz)

    n_samples = n_steps // store_every
    zs = torch.empty((z0.shape[0], n_samples, z0.shape[1]), dtype=z0.dtype,
                     device=z0.device)
    z = z0
    for s in range(n_samples):
        for _ in range(store_every):
            k1 = f(z)
            k2 = f(z + 0.5 * dt * k1)
            k3 = f(z + 0.5 * dt * k2)
            k4 = f(z + dt * k3)
            z = z + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            # hard clamp amp states at the rails
            z = torch.where(sat_mask, torch.clamp(z, -rail, rail), z)
        zs[:, s] = z
    return z, zs


def nonlinear_transient_batch(
    nets: list[Netlist],
    opamp: OpAmpSpec = AD712,
    *,
    t_end: float = 2e-4,
    n_samples: int = 400,
    v_os=None,
    safety: float = 0.4,
    dt: float | None = None,
    pattern: engine.StampPattern | None = None,
    buffers: bool = True,
    bss: engine.BatchedStateSpace | None = None,
    device=None,
) -> BatchNLTrace:
    """Integrate the step response of B circuits from z(0) = 0 on a
    shared stamp pattern, on ``device`` (default ``"cuda"``).

    ``dt`` defaults to the batch's stiffest RK4 stability bound
    (``safety * 2.78 / max_k max_rate_k``).  ``saturated[k]`` consults
    only system k's *active* amps.  ``bss`` hands over an already
    assembled batch (``assemble_batch`` output for exactly these nets);
    the integration then runs on its device.
    """
    if bss is None:
        bss = engine.assemble_batch(nets, opamp, v_os=v_os, buffers=buffers,
                                    pattern=pattern, device=device)
    dev = bss.device
    nz = bss.n_states
    b_count = bss.batch

    # RK4 stability: dt < ~2.78/|lambda_max|; bound |lambda_max| by the
    # max absolute row sum (Gershgorin) and add a safety margin.
    if dt is None:
        max_rate = float(torch.max(torch.sum(torch.abs(bss.m), dim=2)))
        dt = safety * 2.78 / max_rate
    n_steps = max(int(np.ceil(t_end / dt)), n_samples)
    store_every = max(n_steps // n_samples, 1)
    n_steps = store_every * n_samples

    int_mask = torch.zeros(nz, dtype=torch.bool, device=dev)
    int_mask[torch.as_tensor(bss.amp_int_index, device=dev)] = True
    out_mask = torch.zeros(nz, dtype=torch.bool, device=dev)
    out_mask[torch.as_tensor(bss.amp_out_index, device=dev)] = True

    z_final, zs = _integrate(
        bss.m, bss.c, int_mask, out_mask, bss.slew, bss.amp_rail,
        torch.zeros((b_count, nz), dtype=torch.float64, device=dev), dt, n_steps,
        store_every,
    )
    zs = zs.cpu().numpy()                    # (B, n_samples, nz)
    z_final = z_final.cpu().numpy()          # (B, nz)
    times = dt * store_every * (1 + np.arange(zs.shape[1]))
    n_amp_slots = bss.amp_out_index.shape[0]
    if n_amp_slots:
        amp_final = z_final[:, bss.amp_out_index]          # (B, n_amp_slots)
        saturated = np.any(
            bss.amp_active & (np.abs(amp_final) >= 0.999 * bss.amp_rail), axis=1)
        amp_out = zs[:, :, bss.amp_out_index]
    else:
        saturated = np.zeros(b_count, dtype=bool)
        amp_out = np.zeros((b_count, zs.shape[1], 0))
    return BatchNLTrace(
        times=times,
        x=zs[:, :, : bss.n_unknowns],
        amp_out=amp_out,
        saturated=saturated,
        x_final=z_final[:, : bss.n_unknowns],
        z_final=z_final,
        dt=float(dt),
    )


def nonlinear_transient(
    net: Netlist,
    opamp: OpAmpSpec = AD712,
    *,
    t_end: float = 2e-4,
    n_samples: int = 400,
    v_os: np.ndarray | float | None = None,
    safety: float = 0.4,
    device=None,
) -> NLTrace:
    """Integrate the circuit step response from z(0) = 0: the B = 1
    wrapper over :func:`nonlinear_transient_batch`."""
    tr = nonlinear_transient_batch(
        [net], opamp, t_end=t_end, n_samples=n_samples,
        v_os=None if v_os is None else [v_os], safety=safety, device=device,
    )
    return NLTrace(
        times=tr.times,
        x=tr.x[0],
        amp_out=tr.amp_out[0],
        saturated=bool(tr.saturated[0]),
        x_final=tr.x_final[0],
    )
