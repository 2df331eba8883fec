"""Component-count model (Table II) plus exact counts from a netlist.

Counterpart of :mod:`repro.core.components`.  Table II (worst case,
full matrix):

    |                      | preliminary   | proposed  |
    | unknowns             | n             | 2n        |
    | variable resistors   | n^2 + 2n      | 2n^2 + 1  |
    | 10k resistors        | 2(n^2 + n)    | 4n        |
    | analog switches      | 1.5n^2 + 2.5n | 3n        |
    | op-amps              | 2(n^2 + n)    | 4n        |

Host Python: counts, no tensors.
"""

from __future__ import annotations

from repro_torch.core.network import Netlist


def component_counts(design: str, n: int) -> dict:
    """Paper Table II formulas (worst-case full matrix)."""
    if design == "preliminary":
        return {
            "unknowns": n,
            "variable_resistors": n * n + 2 * n,
            "resistors_10k": 2 * (n * n + n),
            "analog_switches": int(1.5 * n * n + 2.5 * n),
            "opamps": 2 * (n * n + n),
        }
    if design == "proposed":
        return {
            "unknowns": 2 * n,
            "variable_resistors": 2 * n * n + 1,
            "resistors_10k": 4 * n,
            "analog_switches": 3 * n,
            "opamps": 4 * n,
        }
    raise ValueError(f"unknown design {design!r}")


def netlist_counts(net: Netlist) -> dict:
    """Exact counts for a concrete system (sparse matrices use fewer)."""
    cells = net.cells
    n_pots = (
        net.n_branches
        + int((net.ground_g > 0).sum())
        + int((net.supply_g > 0).sum())
        + 2 * len(cells)               # R_pot1, R_pot2 per element circuit
    )
    n_amps = sum(c.n_amps + c.n_buffers for c in cells)
    n_10k = 2 * sum(c.n_amps for c in cells)      # R1, R2 per gain amp
    n_sw = 3 * len(cells) + int((net.supply_g > 0).sum())
    return {
        "unknowns": net.n_nodes,
        "variable_resistors": n_pots,
        "resistors_10k": n_10k,
        "analog_switches": n_sw,
        "opamps": n_amps,
    }


def component_reduction(n: int) -> float:
    """Fractional total-component reduction of the proposed design
    (the paper reports ~70% for full matrices)."""
    pre = component_counts("preliminary", n)
    pro = component_counts("proposed", n)
    tot_pre = sum(v for k, v in pre.items() if k != "unknowns")
    tot_pro = sum(v for k, v in pro.items() if k != "unknowns")
    return 1.0 - tot_pro / tot_pre
