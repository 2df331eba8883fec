"""Power-consumption model of the proposed design (Sec. IV-B4).

Counterpart of :mod:`repro.core.power`.  Eq. 31:

    P_sys = P_amp + P_sw + 4 k_R x^T x + 6 x^T (K_B + |K_B|) x + 2 x^T A x

* ``2 x^T A x``            — passive network + supply resistors (Eq. 28
                             simplified through Eqs. 14/18).
* ``6 x^T (K_B+|K_B|) x``  — correction for the negative-resistance
                             cells (Eq. 29): only positive diag(K_B)
                             entries contribute; the voltage across each
                             cell resistor is 2 x_i and there are two
                             pots (R_pot1, R_pot2) per cell.
* ``4 k_R x^T x``          — the gain-network resistors (R1 = R2 =
                             1/k_R = 10 kOhm), amp outputs at +/-3 x_i
                             (Eq. 30).
* ``P_amp``, ``P_sw``      — quiescent device power.
"""

from __future__ import annotations

from repro_torch.core.specs import CircuitParams, DEFAULT_PARAMS
from repro_torch.device import as_float64

# Quiescent power per device [W] (datasheet supply currents x typical rails).
AMP_QUIESCENT_W = {
    "AD712": 5.0e-3 * 30.0,      # 5 mA max per amp on +/-15 V
    "LTC2050": 0.75e-3 * 10.0,   # 750 uA on +/-5 V
    "LTC6268": 16.5e-3 * 10.0,   # 16.5 mA on +/-5 V
    "ideal": 0.0,
}
SWITCH_QUIESCENT_W = 1e-6        # CMOS analog switch leakage-level


def system_power(
    a,
    k_b,
    x,
    *,
    n_amps: int = 0,
    n_switches: int = 0,
    opamp_name: str = "AD712",
    params: CircuitParams = DEFAULT_PARAMS,
    device=None,
) -> dict:
    """Evaluate Eq. 31 term by term (watts), in float64.

    A tensor ``a`` is used where it lies, an array goes to ``device``
    (default ``"cuda"``); ``k_b`` and ``x`` follow ``a``.
    """
    a = as_float64(a, device)
    k_b = as_float64(k_b, a.device)
    x = as_float64(x, a.device)

    p_network = float(2.0 * x @ (a @ x))
    kb_pos = k_b + k_b.abs()
    p_cells = float(6.0 * x @ (kb_pos @ x))
    # Eq. 30 counts the gain network per active cell; with no cells the
    # term vanishes.
    p_gain = float(4.0 * params.k_gain * (x @ x)) if n_amps > 0 else 0.0
    p_amp = AMP_QUIESCENT_W.get(opamp_name, 0.0) * n_amps
    p_sw = SWITCH_QUIESCENT_W * n_switches
    return {
        "network_w": p_network,
        "cells_w": p_cells,
        "gain_resistors_w": p_gain,
        "amps_w": p_amp,
        "switches_w": p_sw,
        "total_w": p_network + p_cells + p_gain + p_amp + p_sw,
    }
