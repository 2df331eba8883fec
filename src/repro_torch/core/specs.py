"""Component specifications (paper Table I) and circuit parameters.

A plain copy of :mod:`repro.core.specs` (no JAX there either), kept so
that the port imports nothing of the reference package.

All quantities are SI: conductance in siemens, voltage in volts,
capacitance in farads, time in seconds.  The paper works in micro-siemens
(eigenvalues 10 uS .. 1000 uS) and +/-4 V rails; we keep the same numeric
ranges.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OpAmpSpec:
    """Behavioral op-amp model parameters.

    The transient engine linearizes each op-amp as a one-pole integrator

        da/dt = min(2*pi*gbw_hz * (v_plus - v_minus - a/open_loop_gain),
                    slew rate limit)

    with output saturation at ``+/- rail_v``.  The input offset voltage
    ``v_os`` shifts ``v_plus``.  This is the standard first-order macro
    model of the devices the paper simulates in LTspice (Table I).
    """

    name: str
    gbw_hz: float            # gain-bandwidth product [Hz]
    slew_v_per_s: float      # slew rate [V/s]
    v_os: float              # input offset voltage [V]
    open_loop_gain: float    # DC open-loop gain [V/V]
    rail_v: float            # output saturation [V]
    p2_hz: float = 0.0       # second pole [Hz]; 0 = single-pole model
    c_in: float = 0.0        # input capacitance per pin [F] — loads the
                             # node it reads; the dominant reason the
                             # preliminary design (O(n) pins per node)
                             # settles slower than the proposed design
                             # (<= 2 pins per node)

    @property
    def omega_u(self) -> float:
        """Unity-gain angular frequency [rad/s]."""
        import math

        return 2.0 * math.pi * self.gbw_hz


# Paper Table I.  Open-loop gains and rails from the datasheets of the
# simulated parts (AD712: ~106 dB, +/-13 V swing on +/-15 V supplies;
# LTC2050: ~160 dB zero-drift; LTC6268: ~110 dB, lower supply).  Second
# poles are placed for the datasheet phase margins (~60-70 deg at unity
# gain): f_p2 ~ f_u / tan(90 - PM).
AD712 = OpAmpSpec(
    name="AD712",
    gbw_hz=4e6,
    slew_v_per_s=20e6,
    v_os=1e-3,
    open_loop_gain=2.0e5,
    rail_v=13.0,
    p2_hz=7e6,
    c_in=5.5e-12,
)

LTC2050 = OpAmpSpec(
    name="LTC2050",
    gbw_hz=3e6,
    slew_v_per_s=2e6,
    v_os=3e-6,
    open_loop_gain=1.0e8,
    rail_v=4.7,
    p2_hz=8e6,
    c_in=4.0e-12,
)

LTC6268 = OpAmpSpec(
    name="LTC6268",
    gbw_hz=500e6,
    slew_v_per_s=400e6,
    v_os=2.5e-3,
    open_loop_gain=3.0e5,
    rail_v=4.7,
    p2_hz=1.4e9,
    c_in=0.5e-12,
)

OPAMPS: dict[str, OpAmpSpec] = {s.name: s for s in (AD712, LTC2050, LTC6268)}


@dataclasses.dataclass(frozen=True)
class CircuitParams:
    """Global circuit parameters shared by both designs."""

    supply_v: float = 4.0          # |x_s| supply rails (paper Sec. III-A)
    c_node: float = 10e-12         # parasitic node capacitance [F]
    c_switch: float = 15e-12       # analog-switch terminal capacitance [F]
                                   # per element circuit touching a node;
                                   # the preliminary design has O(n) element
                                   # circuits per node (Table II), the
                                   # proposed crosspoint only the K_B-diag
                                   # cells + supply switches
    k_gain: float = 1e-4           # gain-network resistors R1=R2=10 kOhm (Table II)
    settle_rtol: float = 0.01      # paper: converged when within 1% of OP
    settle_atol: float = 1e-4      # floor for near-zero unknowns [V]
    pot_bits: int = 0              # digital-pot resolution; 0 = ideal
    pot_tol: float = 0.0           # relative resistor tolerance; 0 = ideal

    def with_(self, **kw) -> "CircuitParams":
        return dataclasses.replace(self, **kw)


DEFAULT_PARAMS = CircuitParams()
