"""AnalogNewton — the paper's RNM solver as an optimizer substrate
(counterpart of :mod:`repro.optim.analog_newton`).

Layerwise block-Jacobi natural-gradient preconditioning:

* Every step: for each 2D parameter, maintain an EMA of the
  per-block input-side gradient covariance ``C = E[G_b G_b^T]``
  (blocks of size ``block`` along the input dim — the *fixed crossbar
  array size* of a deployed analog accelerator), and precondition the
  gradient with the current block inverses: ``P_b @ G_b`` — on real
  hardware this MVM is the crossbar's free operation (Sec. IV-A4).

* Every ``refresh_every`` steps, outside the step:
  ``refresh_preconditioner`` re-solves ``(C_b + lambda I) X = e_i``
  **through the simulated RNM circuit** (2n transform -> netlist ->
  non-ideal operating point).  Every block inverse column of every
  leaf is one unit-vector-RHS system; they all share one sparsity
  class (dense ``block x block``), so the whole refresh is issued as
  ONE ``solve_batch`` call of ``total_blocks * block`` systems on a
  shared :class:`~repro_torch.core.engine.StampPattern` that is derived once
  and reused across refreshes (``REFRESH_STATS`` counts the
  ``solve_batch`` calls, systems, and pattern derivations — the
  pre-batched path issued ``n_blocks * block`` sequential single-RHS
  solves per refresh).  Backends: "analog_2n" (paper), "analog_n"
  (preliminary), "cholesky"/"cg" (digital baselines) — flipping the
  backend gives the paper-vs-digital comparison inside a real training
  run (see examples/train_lm_torch.py).

SPD guarantee: C is PSD by construction; +lambda I makes it SPD — the
transform's stable domain (Sec. IV-A1).

Which leaves get a preconditioner is decided by the *reference's* leaf
shape.  The reference stacks every layer's weights on a leading layer
axis (``blocks``, ``enc_blocks``, ``dec_blocks``), so a layer weight
there is 3-D or more and never qualifies; only unstacked 2-D leaves do
(``lm_head``, ``embed`` when it fits ``max_blocks``, the MLP weights of a
hybrid's ``shared_attn``).  The port holds each layer as its own module,
where the same weights are 2-D; :func:`preconditioned` decides on the
reference's shape (:func:`reference_shapes`), so the port runs the
reference's optimizer.  The refresh copies the covariance blocks to the
host (float64, as the reference's host callback does), builds the
netlists there, and solves on the covariance's device through
:func:`repro_torch.core.solver.solve_batch`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models.model import STACKED
from repro_torch.optim.adamw import Optimizer, clip_by_global_norm, learning_rate


@dataclasses.dataclass(frozen=True)
class AnalogNewtonConfig:
    block: int = 64              # crossbar array size (n unknowns per solve)
    ema: float = 0.95
    damping: float = 1e-4        # lambda (relative to mean diag)
    min_dim: int = 64            # 2D params smaller than this use plain Adam
    max_blocks: int = 16         # skip leaves needing more block solves
                                 # than this per refresh (host-sim budget;
                                 # real hardware solves are O(1) each)
    refresh_every: int = 20
    backend: str = "analog_2n"   # analog_2n | analog_n | cholesky | cg
    opamp: str = "AD712"
    nonideal: Any = None         # repro_torch.core.operating_point.NonIdealities


def _n_blocks(m: int, block: int) -> int:
    return (m + block - 1) // block


def reference_shapes(params: dict[str, torch.Tensor]) -> dict[str, tuple]:
    """The shape of the reference's leaf for each of the port's parameters:
    under a layer-stacked subtree (``blocks.3.ln1``) the layer axis leads,
    its length the subtree's depth; elsewhere the port's own shape."""
    depth: dict[str, int] = {}
    for name in params:
        parts = name.split(".")
        if parts[0] in STACKED:
            depth[parts[0]] = max(depth.get(parts[0], 0), int(parts[1]) + 1)
    out = {}
    for name, p in params.items():
        top = name.split(".")[0]
        out[name] = ((depth[top],) if top in STACKED else ()) + tuple(p.shape)
    return out


def is_preconditioned(shape: tuple, cfg: AnalogNewtonConfig) -> bool:
    """The reference's ``_is_precond`` on the reference's leaf ``shape``:
    2-D, both sides at least ``min_dim``, at most ``max_blocks`` blocks of
    rows."""
    if len(shape) != 2 or min(shape) < cfg.min_dim:
        return False
    return _n_blocks(shape[0], cfg.block) <= cfg.max_blocks


def preconditioned(params: dict[str, torch.Tensor], cfg: AnalogNewtonConfig) -> list[str]:
    """The names of the leaves that get a preconditioner.  A stacked 1-D
    leaf the reference would precondition (a (layers, d) matrix with at
    least ``min_dim`` layers, whose blocks mix layers) raises
    ``NotImplementedError`` rather than being run differently."""
    out = []
    for name, shape in reference_shapes(params).items():
        if not is_preconditioned(shape, cfg):
            continue
        if name.split(".")[0] in STACKED:
            raise NotImplementedError(
                f"the reference preconditions the layer-stacked leaf of {name} "
                f"(shape {shape}); the port does not precondition across layers")
        out.append(name)
    return out


def analog_newton(lr, cfg: AnalogNewtonConfig = AnalogNewtonConfig(), *, b1: float = 0.9,
                  weight_decay: float = 0.0, grad_clip: float = 1.0) -> Optimizer:
    """The state is ``{"mu": {name: float32}, "cov": {name: (nb, r, r)},
    "pinv": {name: (nb, r, r)}, "step": int}``, ``cov`` and ``pinv`` only
    for the preconditioned leaves (:func:`preconditioned`); ``update``
    replaces its tensors as it goes and returns it with the updates, each
    in its parameter's dtype.  ``pinv`` changes only at
    :func:`refresh_preconditioner`."""

    def init(params: dict[str, torch.Tensor]) -> dict:
        cov, pinv = {}, {}
        for n in preconditioned(params, cfg):
            p = params[n]
            nb = _n_blocks(p.shape[0], cfg.block)
            cov[n] = torch.zeros((nb, cfg.block, cfg.block), dtype=torch.float32,
                                 device=p.device)
            eye = torch.eye(cfg.block, dtype=torch.float32, device=p.device)
            pinv[n] = eye.expand(nb, cfg.block, cfg.block).clone()
        return {
            "mu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in params.items()},
            "cov": cov,
            "pinv": pinv,
            "step": 0,
        }

    def _blocked(g32: torch.Tensor) -> torch.Tensor:
        m, n = g32.shape
        nb = _n_blocks(m, cfg.block)
        gb = torch.nn.functional.pad(g32, (0, 0, 0, nb * cfg.block - m))
        return gb.reshape(nb, cfg.block, n)

    def update(grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        step = state["step"] + 1
        g32 = clip_by_global_norm(grads, grad_clip)
        lr_t = learning_rate(lr, step)
        mu, cov, pinv = state["mu"], state["cov"], state["pinv"]
        updates = {}
        for n, p in params.items():
            g = g32.pop(n)
            if n in cov:
                gb = _blocked(g)                                  # (nb, r, n)
                cb = torch.einsum("brn,bsn->brs", gb, gb) / g.shape[1]
                cov[n] = cfg.ema * cov[n] + (1 - cfg.ema) * cb
                pg = torch.einsum("brs,bsn->brn", pinv[n], gb).reshape(-1, g.shape[1])
                g = pg[: g.shape[0]]
            mu[n] = b1 * mu[n] + (1 - b1) * g
            del g
            # LAMB-style trust ratio: the preconditioner sets the
            # direction; the step scales with the parameter's own norm
            # so small-norm tensors (norm scales, biases) don't overshoot
            m = mu[n]
            mn = torch.sqrt(torch.mean(m * m)) + 1e-12
            p32 = p.detach().float()
            wn = torch.sqrt(torch.mean(torch.square(p32)))
            trust = torch.clamp(wn, 1e-2, 10.0)
            u = (m / mn) * trust + weight_decay * p32
            updates[n] = (-lr_t * u).to(p.dtype)
        state["step"] = step
        return updates, state

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# preconditioner refresh through the simulated analog circuit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefreshStats:
    """Counters over every :func:`refresh_preconditioner` call in the
    process — the acceptance probes for the batched refresh path:
    ``solve_batch_calls`` must equal ``refreshes`` (one batched solve
    per refresh) and ``pattern_derivations`` stays at one per
    ``(block, backend)`` class across arbitrarily many refreshes."""

    refreshes: int = 0
    solve_batch_calls: int = 0
    systems_solved: int = 0
    pattern_derivations: int = 0


REFRESH_STATS = RefreshStats()
# (block, backend) -> StampPattern shared by every refresh batch of the
# class: the block size is iteration-invariant, so the sparsity pattern
# is derived exactly once per process
_REFRESH_PATTERNS: dict = {}


def reset_refresh_stats() -> None:
    global REFRESH_STATS
    REFRESH_STATS = RefreshStats()
    _REFRESH_PATTERNS.clear()


def _refresh_pattern(nets, opamp, key):
    """The shared refresh stamp pattern, derived once per class."""
    from repro_torch.core import engine
    from repro_torch.core.specs import OPAMPS

    pattern = _REFRESH_PATTERNS.get(key)
    if pattern is None:
        spec = OPAMPS[opamp] if isinstance(opamp, str) else opamp
        pattern = engine.pattern_union(nets, spec)
        _REFRESH_PATTERNS[key] = pattern
        REFRESH_STATS.pattern_derivations += 1
    return pattern


def _solve_blocks(cb: np.ndarray, cfg: AnalogNewtonConfig, device=None) -> np.ndarray:
    """Invert a stack of damped covariance blocks ``(T, r, r)`` with ONE
    batched solve over all ``T * r`` unit-vector-RHS systems, on
    ``device`` (default ``"cuda"``).

    Conductance scaling: each block is normalized to the paper's uS
    range before mapping (Eq. 27 — solutions are scale-invariant), with
    the per-block scale folded back out of the recovered columns.
    """
    from repro_torch.core.network import build_preliminary_batch, build_proposed_batch
    from repro_torch.core.solver import solve_batch

    t, r, _ = cb.shape
    # damping floor keeps zero-covariance blocks (cold start, padded
    # tails) well-conditioned: pinv ~ I/damp there
    damp = cfg.damping * np.maximum(np.trace(cb, axis1=1, axis2=2) / r, 1e-12)
    a = cb + damp[:, None, None] * np.eye(r)
    if cfg.backend == "cholesky":
        return np.linalg.inv(a)

    # map into the paper's ranges: conductances ~ 500 uS peak, currents
    # sized so node voltages land in ~[-0.5, 0.5] V
    s = 500e-6 / np.maximum(np.abs(a).max(axis=(1, 2)), 1e-300)
    a_s = a * s[:, None, None]
    beta = 0.25 * 500e-6               # ~0.25 V solution scale
    a_batch = np.repeat(a_s, r, axis=0)               # (t*r, r, r)
    b_batch = np.tile(beta * np.eye(r), (t, 1))       # (t*r, r)

    kwargs: dict = {}
    if cfg.backend in ("analog_2n", "analog_n"):
        if cfg.backend == "analog_2n":
            nets = build_proposed_batch(a_batch, b_batch, device=device)
        else:
            nets = build_preliminary_batch(a_batch, b_batch)
        kwargs["nets"] = nets
        kwargs["pattern"] = _refresh_pattern(nets, cfg.opamp, (r, cfg.backend))
    res = solve_batch(a_batch, b_batch, method=cfg.backend, opamp=cfg.opamp,
                      nonideal=cfg.nonideal, device=device, **kwargs)
    REFRESH_STATS.solve_batch_calls += 1
    REFRESH_STATS.systems_solved += t * r
    y = np.asarray(res.x, dtype=np.float64).reshape(t, r, r)
    # y[k, j] = (s_k A_k)^-1 beta e_j, i.e. column j of inv(A_k) up to
    # the scale s_k / beta; transpose the column axis back into place
    return np.transpose(y, (0, 2, 1)) * (s[:, None, None] / beta)


def refresh_preconditioner(state: dict, cfg: AnalogNewtonConfig) -> dict:
    """Rebuild every block inverse through the solver.

    Each block inverse column is one RNM circuit solve (unit-vector
    RHS), i.e. the analog accelerator's workload.  All blocks of all
    leaves share the ``block x block`` sparsity class, so the entire
    refresh issues exactly ONE :func:`repro_torch.core.solver.solve_batch`
    call on the cached refresh :class:`~repro_torch.core.engine.StampPattern`
    (see :data:`REFRESH_STATS`), on the device the covariance lies on.
    Returns the state with a new ``pinv``.
    """
    names = list(state["cov"])
    REFRESH_STATS.refreshes += 1
    if not names:
        return {**state, "pinv": state["pinv"]}
    device = state["cov"][names[0]].device
    # the host copy of the covariance blocks, float64 (the reference's
    # host callback takes them the same way)
    blocks = [state["cov"][n].double().cpu().numpy() for n in names]
    spans = np.cumsum([0] + [len(c) for c in blocks])
    inv = _solve_blocks(np.concatenate(blocks), cfg, device=device)
    pinv = {n: torch.as_tensor(inv[spans[i]: spans[i + 1]], dtype=torch.float32,
                               device=device)
            for i, n in enumerate(names)}
    return {**state, "pinv": pinv}
