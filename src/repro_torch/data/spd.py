"""Random SPD/SDD system generators mirroring the paper's test protocol.

The paper (Sec. III-C) generates symmetric matrices with MATLAB's
``sprandsym(n, density, rc)`` — random symmetric matrices with a
prescribed eigenvalue range — then draws the solution x ~ U[-0.5, 0.5] V
and computes b = A x.  We reproduce the same semantics:

* density = 1: A = Q diag(lam) Q^T with Q a random orthogonal basis and
  lam ~ U[lam_min, lam_max] (units: siemens; paper uses 10 uS..1000 uS).
* density < 1: a random sparse symmetric pattern is drawn, then the
  spectrum is shifted/scaled into the target range by a diagonal shift
  (preserves sparsity exactly, like sprandsym's kind=1 behaviour it
  only approximates the spectrum — we then *verify* the actual range).

Host-side numpy float64 (generation is not a training-path operation).
A copy of :mod:`repro.data.spd`: the same generators draw the same
numbers from the same seed, so the port and the reference get identical
inputs.
"""

from __future__ import annotations

import numpy as np

US = 1e-6  # microsiemens


def _random_orthogonal(rng: np.random.Generator, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diagonal(r))[None, :]


def random_spd(
    rng: np.random.Generator,
    n: int,
    *,
    density: float = 1.0,
    lam_min: float = 10 * US,
    lam_max: float = 1000 * US,
) -> np.ndarray:
    """Random SPD matrix with eigenvalues in [lam_min, lam_max]."""
    if density >= 1.0:
        lam = rng.uniform(lam_min, lam_max, size=n)
        # pin the extremes so the range is exact, like sprandsym(rc)
        if n >= 2:
            lam[0], lam[1] = lam_min, lam_max
        q = _random_orthogonal(rng, n)
        return (q * lam[None, :]) @ q.T

    # sparse pattern: symmetric Erdos-Renyi off-diagonals
    mask = rng.uniform(size=(n, n)) < density
    mask = np.triu(mask, k=1)
    s = np.zeros((n, n))
    vals = rng.standard_normal(int(mask.sum()))
    s[mask] = vals
    s = s + s.T
    s[np.arange(n), np.arange(n)] = rng.standard_normal(n)
    # shift+scale spectrum into [lam_min, lam_max] (diagonal shift keeps
    # the off-diagonal sparsity pattern intact)
    ev = np.linalg.eigvalsh(s)
    span = ev[-1] - ev[0]
    if span <= 0:
        span = 1.0
    scale = (lam_max - lam_min) / span
    a = s * scale
    a[np.arange(n), np.arange(n)] += lam_min - ev[0] * scale
    return a


def random_sdd(
    rng: np.random.Generator,
    n: int,
    *,
    density: float = 1.0,
    g_scale: float = 100 * US,
    margin: float = 0.1,
    v_range: float = 0.5,
    supply_v: float = 4.0,
) -> np.ndarray:
    """Random symmetric diagonally dominant matrix (Laplacian + diag).

    Off-diagonals are <= 0 (a positive weighted graph).  Eq. 25 requires
    dominance *including* the supply conductance K_s = |b|/supply_v, and
    with x ~ U[-v, v]:  k_s <= (A_ii + offsum) * v / supply_v.  Solving
    for the diagonal, ``diag >= offsum * (1 + r) / (1 - r)`` with
    r = v/supply_v guarantees the passive path for any such rhs; we add
    a strictly positive margin on top.
    """
    w = rng.uniform(0.0, g_scale, size=(n, n))
    keep = rng.uniform(size=(n, n)) < density
    w = np.triu(w * keep, k=1)
    w = w + w.T
    a = -w
    colsum = w.sum(axis=0)
    r = v_range / supply_v
    factor = (1.0 + r) / (1.0 - r)
    a[np.arange(n), np.arange(n)] = colsum * factor + rng.uniform(
        margin * g_scale, (1 + margin) * g_scale, size=n
    ) * factor
    return a


def random_rhs_from_solution(
    rng: np.random.Generator, a: np.ndarray, v_range: float = 0.5
) -> tuple[np.ndarray, np.ndarray]:
    """Paper protocol: x ~ U[-0.5, 0.5] V, b = A x. Returns (x, b)."""
    n = a.shape[0]
    x = rng.uniform(-v_range, v_range, size=n)
    return x, a @ x


def random_spd_fixed_conductance(
    rng: np.random.Generator,
    n: int,
    *,
    g_target: float = 800 * US,
    g_tol: float = 0.10,
    density: float = 1.0,
    lam_min: float = 10 * US,
    lam_max: float = 1000 * US,
    max_tries: int = 400,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Generate systems whose *transformed* max conductance lands within
    ``g_tol`` of ``g_target`` (the Figs. 13-14 protocol).

    The transformed max conductance is dominated by the K_B diagonal
    ~ 0.5 * max column |A| sum, which grows ~sqrt(n) at a fixed
    spectrum.  We calibrate the eigenvalue *upper bound* per n so the
    expected max conductance lands on target, then rejection-sample on
    both criteria (g within tolerance AND spectrum inside
    [lam_min, lam_max]).  Exactly like the paper, the joint criterion
    is infeasible outside a size window (no systems below ~15 unknowns
    at density 1); we return None in that case.  ``device`` is where
    the probe netlists' transform runs.
    """
    from repro_torch.core.network import build_proposed  # local: avoids cycle

    # --- calibrate: E[g_max] is ~linear in the eigenvalue upper bound
    def probe(hi: float, trials: int = 3) -> float:
        gs = []
        for _ in range(trials):
            a = random_spd(rng, n, density=density, lam_min=lam_min, lam_max=hi)
            _, b = random_rhs_from_solution(rng, a)
            gs.append(build_proposed(a, b, device=device).max_conductance())
        return float(np.median(gs))

    hi = 0.5 * (lam_min + lam_max)
    g_probe = probe(hi)
    if g_probe > 0:
        hi = hi * g_target / g_probe
    hi = float(np.clip(hi, lam_min * 2, lam_max))

    for _ in range(max_tries):
        a = random_spd(rng, n, density=density, lam_min=lam_min, lam_max=hi)
        x, b = random_rhs_from_solution(rng, a)
        g = build_proposed(a, b, device=device).max_conductance()
        if abs(g - g_target) <= g_tol * g_target:
            ev = np.linalg.eigvalsh(a)
            if ev[0] >= lam_min * 0.99 and ev[-1] <= lam_max * 1.01:
                return a, x, b
        # slow adaptive nudge toward the target
        hi = float(np.clip(hi * (1.0 + 0.2 * (g_target / max(g, 1e-12) - 1.0)),
                           lam_min * 2, lam_max))
    return None
