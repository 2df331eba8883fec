"""The settling-accuracy guard: spectral slow mode against exact eig.

    PYTHONPATH=src python -m repro_torch.settling_guard [--device cpu]

The port's copy of the reference's guard
(``benchmarks/tpu_complexity.py:settling_accuracy``).  Over the small
reference set — both circuit designs, non-diagonally-dominant SPD and
SDD systems and one batch with an unstable system — it runs
:func:`repro_torch.core.spectral.spectral_bounds` on the ELL operators
and the exact eigenvalues of the dense operators (``np.linalg.eigvals``
on the host), and fails a case whose slow-mode estimate ``Re
lambda_slow`` leaves ``[0.5, 2.0]`` times the exact rightmost stable
eigenvalue, or whose unstable system is not flagged.  Exits 1 on a
failure.
"""

from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np

from repro_torch.core import engine, spectral
from repro_torch.core.network import build_preliminary_batch, build_proposed_batch
from repro_torch.data.spd import random_rhs_from_solution, random_sdd, random_spd
from repro_torch.device import resolve_device

# (label, builder, n, count, options): the reference guard's five cases
CASES = (
    ("proposed", "proposed", 14, 4, {}),
    ("proposed_sparse", "proposed", 20, 3, {"density": 0.4}),
    ("preliminary", "preliminary", 12, 3, {}),
    ("sdd", "proposed", 12, 3, {"sdd": True}),
    ("non_pd", "proposed", 10, 3, {"non_pd": True}),
)


def case_systems(label: str, n: int, count: int, opts: dict):
    """The case's ``(A, b)`` batch, from the seed ``zlib.crc32(label)``
    and the reference guard's draw order."""
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    a_l, b_l = [], []
    for k in range(count):
        a = random_spd(rng, n, density=opts.get("density", 1.0))
        if opts.get("non_pd") and k == count - 1:
            a = -a
        if opts.get("sdd") and k == count - 1:
            a = random_sdd(rng, n)
        _x, b = random_rhs_from_solution(rng, a)
        a_l.append(a), b_l.append(b)
    return np.stack(a_l), np.stack(b_l)


def settling_accuracy(*, device=None, ratio_lo: float = 0.5,
                      ratio_hi: float = 2.0) -> tuple[list[str], list[dict]]:
    """Run the five cases on ``device`` (default ``"cuda"``).

    Returns ``(failures, rows)``: failure strings (empty when the
    contract holds) and one row per system with its estimate, the exact
    abscissa and slow eigenvalue, the ratio and the certificate.
    """
    dev = resolve_device(device)
    failures: list[str] = []
    rows: list[dict] = []
    for label, builder, n, count, opts in CASES:
        a, b = case_systems(label, n, count, opts)
        if builder == "proposed":
            nets = build_proposed_batch(a, b, device=dev)
        else:
            nets = build_preliminary_batch(a, b)
        dense = engine.assemble_batch(nets, device=dev)
        ell = engine.assemble_batch_ell(nets, device=dev)
        sb = spectral.spectral_bounds(ell)
        lam = np.linalg.eigvals(dense.m.cpu().numpy())
        abscissa = lam.real.max(axis=1)
        for k in range(count):
            row = dict(case=label, system=k, slow_re=float(sb.slow_re[k]),
                       slow_residual=float(sb.slow_residual[k]),
                       certified=bool(sb.certified[k]), abscissa=float(abscissa[k]))
            rows.append(row)
            if abscissa[k] >= 0:
                if sb.slow_re[k] < 0:
                    failures.append(f"{label}[{k}]: unstable system (abscissa "
                                    f"{abscissa[k]:.3e}) not flagged")
                continue
            true_slow = lam[k].real[lam[k].real < 0].max()
            ratio = sb.slow_re[k] / true_slow
            row.update(exact_slow=float(true_slow), ratio=float(ratio))
            if not (ratio_lo <= ratio <= ratio_hi):
                failures.append(
                    f"{label}[{k}]: slow-mode ratio {ratio:.3f} outside "
                    f"[{ratio_lo}, {ratio_hi}] (est {sb.slow_re[k]:.4e} "
                    f"vs exact {true_slow:.4e})")
    return failures, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    failures, rows = settling_accuracy(device=args.device)
    for row in rows:
        print(row)
    for f in failures:
        print(f"SETTLING GUARD: {f}", file=sys.stderr)
    print(f"settling_accuracy,failures,{len(failures)}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
