"""Batched spectral bounds — the settling estimator that integrates nothing.

Counterpart of :mod:`repro.core.spectral` (see there for the method and
its accuracy contract).  From matrix-free products with the state
operator ``M`` it estimates, per system of a batch:

* ``|lambda|_max`` by power iteration (:func:`power_rate`);
* the exterior Ritz modes of an m-step Krylov space
  (:func:`krylov_ritz`), which give the abscissa-aware Euler step
  (:func:`mode_dt_limit`) that stays valid for underdamped operators;
* the slow (rightmost) mode by propagator-filtered deflated subspace
  iteration (:func:`slow_mode_ritz`), with the restricted numerical
  abscissa of the slow subspace as the stability certificate;
* the predicted settle steps, blind (:func:`spectral_bounds`) or from
  the initial error's slow-mode amplitude (:func:`amplitude_settle_steps`).

The split between device and host is the reference's: block products,
QR and norms run in float64 on the operator's device; only the small
``(B, k, k)`` projected matrices cross to the host, where
``np.linalg.eig`` / ``eigvalsh`` solve them with the reference's LAPACK.
:class:`SpectralBounds` holds numpy arrays.  The start vectors are built
in float64 numpy on the host and moved, so both packages start from the
same bits (up to the rounding of the reference's compiled ramp, see
:func:`_init_vec`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import as_float64

F64 = torch.float64

# power-iteration estimates converge from below; inflate the rate by
# this margin before using it in a stability-critical step bound
RATE_MARGIN = 1.10
# margin on the per-mode abscissa rule (Ritz values of exterior modes
# converge fast but carry a few-percent error before the residual dies)
MODE_MARGIN = 1.25
# the mode rule never tightens dt below this fraction of the modulus
# rule — a guard against an unconverged near-imaginary Ritz value
# collapsing the step (supports damped resonances up to Q ~ 5e5)
MODE_DT_FLOOR = 1e-6
_TINY = 1e-300


@dataclasses.dataclass
class SpectralBounds:
    """Batched spectral estimates of ``dz/dt = M z + c`` (numpy arrays).

    ``dt`` is the abscissa-aware forward-Euler step ``dt_safety *
    dt_limit``; ``slow_re`` the rightmost-eigenvalue estimate with its
    Ritz residual ``slow_residual`` (relative to ``|slow_re|``);
    ``fov_slow`` the restricted numerical abscissa of the slow subspace
    (the certificate); ``sym_max`` the global symmetric-part bound
    (``None`` unless requested).
    """

    rate_max: np.ndarray        # (B,) |lambda|_max estimate (>= 0)
    slow_re: np.ndarray         # (B,) Re of the rightmost mode (< 0: stable)
    slow_residual: np.ndarray   # (B,) Ritz residual of that pair / |slow_re|
    fov_slow: np.ndarray | None  # (B,) restricted numerical abscissa
    sym_max: np.ndarray | None  # (B,) lambda_max of (M+M^T)/2; None if skipped
    dt_limit: np.ndarray        # (B,) Euler stability limit (no safety factor)
    dt: np.ndarray              # (B,) dt_safety * dt_limit
    settle_time: np.ndarray     # (B,) ln(1/rtol)/|Re slow|; inf if unstable
    settle_steps: np.ndarray    # (B,) ceil(settle_time / dt)
    certified: np.ndarray       # (B,) converged + contracting slow subspace
    slow_basis: np.ndarray | None = None  # (B, k, nz) orthonormal slow block

    @property
    def stable(self) -> np.ndarray:
        return self.slow_re < 0.0


# ---------------------------------------------------------------------------
# Operator adapters
# ---------------------------------------------------------------------------


def ell_block_matvec(indices: torch.Tensor, weights: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """Block ELL-SpMV ``(B, k, nz) -> (B, k, nz)``: one gathered row
    reduction over the whole block, summed over the K slots as the
    reference sums them.  Materializes the ``(B, k, nz, K)`` gather."""
    b, nz, k_slots = indices.shape
    cols = indices.long().reshape(b, 1, nz * k_slots).expand(b, z.shape[1], nz * k_slots)
    gathered = torch.gather(z, 2, cols).reshape(b, z.shape[1], nz, k_slots)
    return torch.sum(weights[:, None] * gathered, dim=3)


def _matvec_pair(bss, device=None):
    """``(matvec, matvec_t, matvec_block, batch, n_states, device)`` for a
    dense ``(B, nz, nz)`` array or tensor, a
    :class:`~repro_torch.core.engine.BatchedStateSpace` or an
    :class:`~repro_torch.core.engine.EllBatchedStateSpace`.

    ``matvec_block`` maps ``(B, k, nz) -> (B, k, nz)``.  A tensor stays on
    its device; an array goes to ``device`` (default ``"cuda"``).
    """
    if hasattr(bss, "matvec"):
        mvb = getattr(bss, "matvec_block", None)
        if mvb is None:
            # generic operator: the per-vector matvec, column by column
            mv_one = bss.matvec

            def mvb(z):
                return torch.stack([mv_one(z[:, j]) for j in range(z.shape[1])], dim=1)
        return (bss.matvec, getattr(bss, "matvec_t", None), mvb, bss.batch,
                bss.n_states, bss.device)
    m = as_float64(bss.m if hasattr(bss, "m") else bss, device)

    def mv(z):
        return torch.einsum("bij,bj->bi", m, z)

    def mvt(z):
        return torch.einsum("bij,bi->bj", m, z)

    def mvb(z):
        return torch.einsum("bij,bkj->bki", m, z)

    return mv, mvt, mvb, m.shape[0], m.shape[1], m.device


def _ramp(nz: int) -> np.ndarray:
    """The reference's ``jnp.linspace(0.3, 1.0, nz)`` in its own form,
    ``start * (1 - s) + stop * s`` with ``s = i / (nz - 1)``.  XLA's
    compiled arithmetic rounds some entries one ulp away from this."""
    if nz == 1:
        return np.array([0.3])
    div = nz - 1
    s = np.arange(div, dtype=np.float64) / div
    return np.concatenate([0.3 * (1.0 - s) + 1.0 * s, [1.0]])


def _init_vec(b: int, nz: int, device) -> torch.Tensor:
    """Deterministic, fully-supported start vector (no RNG), built in
    float64 numpy on the host and moved to ``device``."""
    flip = np.where(np.arange(nz) % 2 == 0, 1.0, -1.0)
    v = torch.as_tensor(_ramp(nz) * flip, device=device)
    return v.expand(b, nz)


def _probe_np(nz: int, j: int) -> np.ndarray:
    """Cosine probe ``j`` of the start block, ``(nz,)`` float64."""
    i = np.arange(nz, dtype=np.float64)
    return np.cos((j + 1) * (i + 0.5) * (np.pi / nz)) + 0.01 * (j + 1)


def _init_block(b: int, nz: int, k: int, device) -> torch.Tensor:
    """Deterministic full-support block ``(B, k, nz)``: k cosine probes
    with distinct frequencies (host numpy, moved)."""
    block = np.stack([_probe_np(nz, j) for j in range(k)], axis=0)
    return torch.as_tensor(block, device=device).expand(b, k, nz)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=1))


def _orthonormalize_rows(v: torch.Tensor) -> torch.Tensor:
    """Batched thin-QR orthonormalization of the (B, k, nz) block rows.
    Q's column signs may differ from LAPACK's on another library; only
    the spanned subspace is used."""
    q, _ = torch.linalg.qr(v.transpose(1, 2))
    return q.transpose(1, 2)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


def power_rate(matvec, b: int, nz: int, iters: int = 32, *, device=None):
    """Dominant ``(|lambda|, Rayleigh)`` of a batched linear operator,
    as numpy arrays."""
    v = _init_vec(b, nz, device)
    v = v / torch.clamp(_norm(v), min=_TINY)[:, None]
    w = matvec(v)
    for _ in range(max(iters - 1, 0)):
        v = w / torch.clamp(_norm(w), min=_TINY)[:, None]
        w = matvec(v)
    rate = _norm(w) / torch.clamp(_norm(v), min=_TINY)
    rayleigh = torch.sum(v * w, dim=1) / torch.clamp(torch.sum(v * v, dim=1), min=_TINY)
    return _host(rate), _host(rayleigh)


def _rayleigh_ritz(qs: torch.Tensor, ws: torch.Tensor):
    """Ritz values and per-pair residual norms of a projected operator.

    ``qs`` is an orthonormal basis block ``(B, k, nz)``, ``ws = M qs``.
    Returns ``(b_proj, theta, res)``: the ``(B, k, k)`` projection, its
    complex eigenvalues ``(B, k)`` and the residual norms ``||M y -
    theta y||`` of each Ritz pair.  Only the two ``(k, k)`` matrices
    cross to the host; the eigenproblem is the reference's LAPACK.
    """
    b_proj_dev = torch.einsum("bin,bjn->bij", qs, ws)
    r = ws - torch.einsum("bij,bin->bjn", b_proj_dev, qs)
    gram = _host(torch.einsum("bjn,bkn->bjk", r, r))
    b_proj = _host(b_proj_dev)
    theta, u = np.linalg.eig(b_proj)
    quad = np.einsum("bjk,bkm->bjm", gram, u)
    res = np.sqrt(np.maximum(np.einsum("bjm,bjm->bm", np.conj(u), quad).real, 0.0))
    return b_proj, theta, res


def krylov_ritz(matvec, b: int, nz: int, m: int = 24, *, device=None):
    """Rayleigh-Ritz over an m-step Krylov space of ``M``: the complex
    Ritz values ``(B, m)`` and their residual norms (numpy)."""
    m = min(m, nz)
    v = _init_vec(b, nz, device)
    v = v / torch.clamp(_norm(v), min=_TINY)[:, None]
    q = [v]
    w_list = []
    scale = None
    for j in range(m - 1):
        w = matvec(q[-1])
        w_list.append(w)
        if scale is None:
            scale = _norm(w)
        qs = torch.stack(q, dim=1)
        for _ in range(2):                       # MGS x2 (reorthogonalized)
            coeff = torch.einsum("bjn,bn->bj", qs, w)
            w = w - torch.einsum("bjn,bj->bn", qs, coeff)
        nw = _norm(w)
        # breakdown (invariant subspace hit): continue from a fresh
        # deterministic probe orthogonalized against the basis
        fresh = torch.as_tensor(_probe_np(nz, j % 7 + 1), device=device).expand(b, nz)
        for _ in range(2):
            coeff = torch.einsum("bjn,bn->bj", qs, fresh)
            fresh = fresh - torch.einsum("bjn,bj->bn", qs, coeff)
        fresh = fresh / torch.clamp(_norm(fresh), min=_TINY)[:, None]
        ok = nw > 1e-10 * torch.clamp(scale, min=_TINY)
        q.append(torch.where(ok[:, None], w / torch.clamp(nw, min=_TINY)[:, None], fresh))
    w_list.append(matvec(q[-1]))
    _b_proj, theta, res = _rayleigh_ritz(torch.stack(q, dim=1), torch.stack(w_list, dim=1))
    return theta, res


def mode_dt_limit(theta: np.ndarray, res: np.ndarray, rate: np.ndarray) -> np.ndarray:
    """Abscissa-aware forward-Euler stability limit from Ritz modes.

    ``min(2 / (RATE_MARGIN |lambda|_max), min over trusted stable modes of
    2 |Re| / |lambda|^2 / MODE_MARGIN)``, floored at ``MODE_DT_FLOOR``
    times the modulus rule; a mode is trusted when its residual is below
    ``0.1 |theta|``.  Host numpy, the reference's arithmetic.
    """
    rate = np.maximum(np.asarray(rate, dtype=np.float64), _TINY)
    modulus = 2.0 / (rate * RATE_MARGIN)
    absq = np.abs(theta) ** 2
    trusted = (
        (theta.real < 0.0)
        & (res < 0.1 * np.maximum(np.abs(theta), _TINY))
        & (absq > _TINY)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        per_mode = np.where(
            trusted, 2.0 * np.abs(theta.real) / np.maximum(absq, _TINY), np.inf
        )
    mode_rule = per_mode.min(axis=1) / MODE_MARGIN
    return np.maximum(np.minimum(modulus, mode_rule), MODE_DT_FLOOR * modulus)


def _propagator_filter(matvec_block, tau: torch.Tensor, v0: torch.Tensor, *,
                       steps: int) -> torch.Tensor:
    """``steps`` renormalized Euler-propagator applications of a block."""
    vv = v0
    for _ in range(steps):
        vv = vv + tau * matvec_block(vv)
        nrm = torch.sqrt(torch.sum(vv * vv, dim=2, keepdim=True))
        vv = vv / torch.clamp(nrm, min=_TINY)
    return vv


def slow_mode_ritz(
    matvec_block,
    rate: np.ndarray,
    b: int,
    nz: int,
    *,
    tau_limit: np.ndarray | None = None,
    block: int = 12,
    filter_steps: int = 64,
    max_cycles: int = 6,
    res_rtol: float = 1e-8,
    device=None,
):
    """Rightmost modes of ``M`` by propagator-filtered deflated subspace
    iteration (see the reference for the method).

    Returns ``(theta, res, fov_slow, cycles, basis)``: the final Ritz
    values ``(B, k)`` and residual norms, the restricted numerical
    abscissa of the slow subspace, the cycle count and the orthonormal
    block ``(B, k, nz)`` (numpy) spanning the slow subspace.
    """
    k = min(block, nz)
    rate = np.maximum(np.asarray(rate, dtype=np.float64), _TINY)
    tau_np = 0.9 / rate
    if tau_limit is not None:
        tau_np = np.minimum(tau_np, 0.9 * np.asarray(tau_limit))
    tau = torch.as_tensor(tau_np, device=device)[:, None, None]
    v = _orthonormalize_rows(_init_block(b, nz, k, device))

    theta = res = b_proj = None
    cycles = 0
    for cycles in range(1, max(max_cycles, 1) + 1):
        v = _orthonormalize_rows(_propagator_filter(matvec_block, tau, v, steps=filter_steps))
        w = matvec_block(v)
        b_proj, theta, res = _rayleigh_ritz(v, w)
        i_right = np.argmax(theta.real, axis=1)
        r_right = res[np.arange(b), i_right] / rate
        if np.all(r_right < res_rtol):
            break
    fov_slow = np.linalg.eigvalsh(0.5 * (b_proj + b_proj.transpose(0, 2, 1)))[:, -1]
    return theta, res, fov_slow, cycles, _host(v)


def lanczos_sym_extreme(matvec_sym, b: int, nz: int, iters: int = 24, *, device=None):
    """Extreme eigenvalue estimates ``(theta_min, theta_max)`` of a batched
    *symmetric* operator: plain Lanczos, then the ``(iters, iters)``
    tridiagonal eigenproblem per system on the host."""
    m = min(iters, nz)
    q = _init_vec(b, nz, device)
    q = q / torch.clamp(_norm(q), min=_TINY)[:, None]
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(b, dtype=F64, device=q.device)
    alphas, betas = [], []
    for _ in range(m):
        w = matvec_sym(q) - beta_prev[:, None] * q_prev
        alpha = torch.sum(q * w, dim=1)
        w = w - alpha[:, None] * q
        beta = _norm(w)
        alphas.append(alpha)
        betas.append(beta)
        q_prev = q
        q = w / torch.clamp(beta, min=_TINY)[:, None]
        beta_prev = beta
    a = _host(torch.stack(alphas, dim=1))                      # (B, m)
    beta = _host(torch.stack(betas, dim=1))[:, : m - 1]
    t = np.zeros((b, m, m))
    ar = np.arange(m)
    t[:, ar, ar] = a
    if m > 1:
        t[:, ar[:-1], ar[1:]] = beta
        t[:, ar[1:], ar[:-1]] = beta
    theta = np.linalg.eigvalsh(t)
    return theta[:, 0], theta[:, -1]


# ---------------------------------------------------------------------------
# The combined estimate
# ---------------------------------------------------------------------------


def spectral_bounds(
    bss,
    *,
    iters: int = 32,
    krylov_m: int = 24,
    slow_iters: int = 6,
    slow_block: int = 12,
    filter_steps: int = 64,
    lanczos_iters: int = 0,
    dt_safety: float = 0.5,
    rtol: float = 0.01,
    res_rtol: float = 1e-8,
    cert_rtol: float = 0.5,
    device=None,
) -> SpectralBounds:
    """Spectral settling/stability estimates for a batch of LTI systems.

    ``bss`` is a dense ``(B, nz, nz)`` array or tensor, a
    :class:`~repro_torch.core.engine.BatchedStateSpace` or an
    :class:`~repro_torch.core.engine.EllBatchedStateSpace`; the products
    run on its device (an array goes to ``device``, default ``"cuda"``).
    ``slow_iters=0`` skips the slow-mode extraction (``slow_re`` NaN,
    ``stable``/``certified`` all False): the dt-only configuration.
    ``lanczos_iters > 0`` adds the global symmetric-part bound
    ``sym_max``.  ``certified[b]``: the rightmost Ritz pair converged
    (residual below ``cert_rtol |slow_re|``), ``slow_re < 0`` and
    ``fov_slow < 0``.
    """
    mv, mvt, mvb, b, nz, dev = _matvec_pair(bss, device)

    rate, _ray = power_rate(mv, b, nz, iters=iters, device=dev)
    rate = np.maximum(rate, _TINY)

    theta_k, res_k = krylov_ritz(mv, b, nz, m=krylov_m, device=dev)
    dt_limit = mode_dt_limit(theta_k, res_k, rate)
    dt = dt_safety * dt_limit

    slow = np.full(b, np.nan)
    slow_res = np.full(b, np.inf)
    fov_slow = None
    basis = None
    certified = np.zeros(b, dtype=bool)
    if slow_iters:
        theta_s, res_s, fov_slow, _cycles, basis = slow_mode_ritz(
            mvb, rate, b, nz, tau_limit=dt_limit, block=slow_block,
            filter_steps=filter_steps, max_cycles=slow_iters, res_rtol=res_rtol,
            device=dev,
        )
        ar = np.arange(b)
        i_right = np.argmax(theta_s.real, axis=1)
        slow = theta_s.real[ar, i_right]
        slow_res = res_s[ar, i_right] / np.maximum(np.abs(slow), _TINY)
        certified = (slow < 0.0) & (slow_res < cert_rtol) & (fov_slow < 0.0)

    sym_max = None
    if lanczos_iters and mvt is not None:

        def mv_sym(z):
            return 0.5 * (mv(z) + mvt(z))

        _lo, sym_max = lanczos_sym_extreme(mv_sym, b, nz, iters=lanczos_iters, device=dev)

    stable = slow < 0.0
    with np.errstate(divide="ignore", over="ignore"):
        settle = np.where(stable, np.log(1.0 / rtol) / np.maximum(-slow, _TINY), np.inf)
        steps = np.where(np.isfinite(settle), np.ceil(settle / dt), np.inf)
    return SpectralBounds(
        rate_max=rate, slow_re=slow, slow_residual=slow_res, fov_slow=fov_slow,
        sym_max=sym_max, dt_limit=dt_limit, dt=dt, settle_time=settle,
        settle_steps=steps, certified=certified, slow_basis=basis,
    )


# ---------------------------------------------------------------------------
# Amplitude-aware settling correction
# ---------------------------------------------------------------------------


def amplitude_settle_steps(
    bounds: SpectralBounds,
    z_err: np.ndarray,
    *,
    rtol: float = 0.01,
    x_scale: np.ndarray | None = None,
) -> np.ndarray:
    """Amplitude-corrected settle-step prediction ``(B,)`` (host numpy).

    Projects the initial error state ``z_err = z0 - z*`` ``(B, nz)`` onto
    the slow subspace and predicts ``ceil(ln(amp / (rtol x_scale)) /
    (|Re lambda_slow| dt))`` steps (at least one e-fold) instead of the
    blind ``ln(1/rtol)`` horizon.  ``x_scale`` defaults to ``max |z_err|``
    per system; unstable systems keep the blind ``settle_steps``.
    """
    z = np.asarray(z_err, dtype=np.float64)
    if bounds.slow_basis is None:
        return np.asarray(bounds.settle_steps, dtype=np.float64)
    coeff = np.einsum("bkn,bn->bk", bounds.slow_basis, z)
    amp = np.linalg.norm(coeff, axis=1)
    if x_scale is None:
        x_scale = np.max(np.abs(z), axis=1)
    tol_abs = np.maximum(np.asarray(rtol, dtype=np.float64) * x_scale, _TINY)
    decay = np.maximum(-bounds.slow_re, _TINY) * np.asarray(bounds.dt)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        efolds = np.log(np.maximum(amp / tol_abs, np.e))
        steps = np.ceil(efolds / np.maximum(decay, _TINY))
    blind = np.asarray(bounds.settle_steps, dtype=np.float64)
    ok = bounds.stable & np.isfinite(steps)
    return np.where(ok, steps, blind)
