"""Circuit transient analysis of one system — the single-system facade.

Counterpart of :mod:`repro.core.transient` (see there for the op-amp
model).  The netlist's parasitic node capacitances and behavioral
op-amp models form an LTI system

    dz/dt = M z + c,   z = [v (node voltages); amp/buffer states]

The stamping and the solve paths live in the batched engine
(:mod:`repro_torch.core.engine`); :func:`assemble_state_space` and
:func:`lti_transient` here are thin B = 1 wrappers over
``engine.assemble_batch`` and ``engine.transient_batch(method="eig")``,
so the single and batched paths are the same physics by construction.
The operator ``M`` of a :class:`StateSpace` is the operand of K5
(:func:`repro_torch.kernels.ops.transient_step`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import settling_time  # noqa: F401  (re-export)
from repro_torch.core.network import Netlist
from repro_torch.core.specs import OpAmpSpec, AD712
from repro_torch.device import resolve_device


@dataclasses.dataclass
class StateSpace:
    """dz/dt = M z + c with bookkeeping to read solutions back out."""

    m: torch.Tensor              # (nz, nz) float64, on the device
    c: torch.Tensor              # (nz,) float64, on the device
    n_nodes: int                 # voltage states are z[:n_nodes]
    n_unknowns: int
    amp_out_index: np.ndarray    # (n_amps,) output states (rail clamp)
    amp_int_index: np.ndarray    # (n_amps,) integrator states (slew clip)
    amp_rail: float
    slew: float

    @property
    def n_states(self) -> int:
        return self.m.shape[0]


def assemble_state_space(
    net: Netlist,
    opamp: OpAmpSpec = AD712,
    *,
    v_os: np.ndarray | float | None = None,
    buffers: bool = True,
    device=None,
) -> StateSpace:
    """Build the LTI operator from a netlist (B = 1 engine assembly) on
    ``device``.

    ``v_os`` sets the per-amp input offset voltage (scalar or one value
    per amp); ``None`` means zero offset.
    """
    pattern = engine.pattern_of(net, opamp, buffers=buffers)
    bss = engine.assemble_batch(
        [net], opamp, v_os=None if v_os is None else [v_os],
        buffers=buffers, pattern=pattern, device=resolve_device(device),
    )
    return StateSpace(
        m=bss.m[0],
        c=bss.c[0],
        n_nodes=net.n_nodes,
        n_unknowns=net.n_unknowns,
        amp_out_index=pattern.amp_out_index,
        amp_int_index=pattern.amp_int_index,
        amp_rail=bss.amp_rail,
        slew=bss.slew,
    )


@dataclasses.dataclass
class TransientResult:
    stable: bool
    settle_time: float           # seconds to stay within tolerance; inf if never
    x_converged: np.ndarray      # recovered unknowns at the operating point
    max_re_eig: float            # stability margin (< 0 for stable)
    dominant_tau: float          # slowest mode time constant [s]
    mirror_residual: float       # proposed design: max |x + x_mirror| (sanity)


def lti_transient(
    net: Netlist,
    opamp: OpAmpSpec = AD712,
    *,
    v_os: np.ndarray | float | None = None,
    buffers: bool = True,
    t_max: float = 1.0,
    t_min: float = 1e-10,
    n_times: int = 3000,
    stability_tol: float = 1e-6,
    device=None,
) -> TransientResult:
    """Step-response settling analysis (supply steps 0 -> x_s at t=0),
    by the exact modal solution."""
    batch = engine.transient_batch(
        [net], opamp, v_os=None if v_os is None else [v_os], buffers=buffers,
        t_max=t_max, t_min=t_min, n_times=n_times, stability_tol=stability_tol,
        method="eig", device=device,
    )
    return TransientResult(
        stable=bool(batch.stable[0]),
        settle_time=float(batch.settle_time[0]),
        x_converged=batch.x_converged[0],
        max_re_eig=float(batch.max_re_eig[0]),
        dominant_tau=float(batch.dominant_tau[0]),
        mirror_residual=float(batch.mirror_residual[0]),
    )
