"""Public wrappers around the Hopper kernels: the kernel API and the
settle sweeps.

Counterpart of :mod:`repro.kernels.ops`.

* The kernel API — :func:`crosspoint_mvm` (K6), :func:`transient_step`
  (K5), :func:`transient_step_batched` (K4), :func:`transient_sweep` (K3
  or K4), :func:`spd_transform_arrays` (K7a + K7b) and
  :func:`flash_attention` (K8), with the
  reference's contracts: 1-D or 2-D inputs, the output dtype, and
  ``(K_A, K_B, D, K_s)`` in that order.  Unlike the reference the K5-K8
  wrappers pad nothing (the kernels mask ragged edges; the dense settle
  steps pad to the 128-row block as the reference does) and none takes
  ``block=`` or ``interpret=``: tile shapes are the kernels' own, and a
  CPU tensor runs the plain version.
* The settle sweeps: pad inputs to the 128-row block (zero padding is
  exact: padded rows carry ``w = 0`` slots pointing at column 0, and zero
  operator rows and columns are neutral); lay the ELL slots out
  slot-major; route between the persistent sweeps (K1, K3) and the
  row-tiled per-step kernels (K2, K4).

The kernels run for CUDA tensors and their plain versions for CPU
tensors; the routing here is the same for both.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import crosspoint_mvm as _mvm
from repro_torch.kernels import ell_transient as _ell
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import spd_transform as _tr
from repro_torch.kernels import transient_step as _st

ROW_BLOCK = _ell.ROW_BLOCK        # the row-tiled kernels' block height


# ---------------------------------------------------------------------------
# The kernel API
# ---------------------------------------------------------------------------


def crosspoint_mvm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Crossbar currents ``I = G @ V`` (K6).  ``v`` may be (k,) or (k, batch);
    the result has ``v``'s dtype and rank."""
    if v.ndim == 1:
        return _mvm.crosspoint_mvm(g, v[:, None])[:, 0]
    return _mvm.crosspoint_mvm(g, v)


def transient_step(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """One fused Euler step ``z + dt (M z + c)`` (K5); z and c may be (n,)
    or (n, b); the result has ``z``'s dtype and rank."""
    if z.ndim == 1:
        return _st.transient_step(m, z[:, None], c[:, None], dt)[:, 0]
    return _st.transient_step(m, z, c, dt)


def transient_step_batched(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
                           dt: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched fused Euler step (K4); m (B, n, n), z/c (B, n), any n.

    Pads M, z and c once to the 128-row block (zero rows and columns are
    neutral), runs the step in float32 and returns ``(z'[:, :n], res)``
    with ``res`` the per-system ``max_i |M z + c|_i`` at the input state,
    as the reference's ``transient_step_batched``.
    """
    n = m.shape[1]
    m = pad_rows(m.to(torch.float32), (1, 2)).contiguous()
    z = pad_rows(z.to(torch.float32), (1,)).contiguous()
    c = pad_rows(c.to(torch.float32), (1,)).contiguous()
    out, res = _st.transient_step_batched(m, z, c, dt)
    return out[:, :n], res.amax(dim=1)


def spd_transform_arrays(
    a: torch.Tensor, b: torch.Tensor, *, supply_v: float = 4.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel-fused proposed transform: returns ``(K_A, K_B, D, K_s)``.

    The semantics of :func:`repro_torch.core.transform.transform_2n` with
    ``d_policy="proposed"``: the column sums of |A| (K7a), then D of
    Eq. 22 and K_s of Eq. 13 in float32, then K_A and K_B of Eqs. 15-16
    (K7b) in ``a``'s dtype.  D and K_s are float32; as in the reference,
    the assembly reads them rounded to ``a``'s dtype.
    """
    n = a.shape[0]
    if a.shape != (n, n) or b.shape != (n,):
        raise ValueError(f"need a (n, n) and b (n,), got {tuple(a.shape)}, {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    colsum = _tr.colabs(a)                                          # K7a
    k_s = b.to(torch.float32).abs() / supply_v                      # Eq. 13
    d = 0.5 * k_s + 0.5 * colsum                                    # Eq. 22
    d[0] += 0.5 * k_s[0]
    ka, kb = _tr.assemble(a, d.to(a.dtype).float(), k_s.to(a.dtype).float())  # K7b
    return ka, kb, d, k_s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA flash attention (K8) with the contract of the reference's
    ``flash_attention_pallas``: q (B, S, H, D), k/v (B, T, KV, D), the
    probability tile rounded to ``v``'s dtype before the PV product.  The
    model's attention (:mod:`repro_torch.models.attention`) calls K8 with
    its own ``p_dtype`` instead.  ``q_block``/``kv_block``/``interpret``
    are dropped: the tiles are the kernel's own, and a CPU tensor runs
    the plain version."""
    p_dtype = torch.bfloat16 if v.dtype == torch.bfloat16 else None
    return _fa.flash_attention(q, k, v, causal=causal, window=window, p_dtype=p_dtype)

# ---------------------------------------------------------------------------
# Routing limits, re-derived for the Hopper designs
# ---------------------------------------------------------------------------
#
# The reference sizes its limits to TPU VMEM: SWEEP_STATE_LIMIT = 1792
# (the whole (n^2 + 3n)-f32 dense operator resident) and ELL_VMEM_BUDGET =
# 12 MiB with ell_sweep_fits_vmem (the whole ELL operator resident).  On
# an H100 a thread block may use 227 KB (232,448 bytes) of shared memory.
# The persistent sweeps K1 and K3 run each system on the R <= 16 blocks of
# a thread-block cluster: every rank keeps the whole state (two f32 copies
# of the padded state, ping-pong), computes its nz / R rows and sends them
# to its peers through distributed shared memory, and holds its rows of
# the operator in its shared memory where they fit beside the state
# (ell_sweep_variant, dense_sweep_variant), else streams them from L2/HBM.
# That gives two limits:
#
# * a hard one: the state must fit one block's shared memory
#   (sweep_state_fits_smem), the same for the dense and the ELL sweep;
# * a rate one, per pair: the row-tiled kernels K2/K4 spread the batch
#   over all 132 SMs but pay a launch and its host call per step (20-40 us
#   a launch from Python on an H100), while a persistent sweep pays one
#   launch per 50-step chunk.  chip_smoke.py times both routes of each
#   pair on each side of its limit (its route_times line; PERF.md):
#   - ELL_PERSISTENT_BYTES = 4 MiB was set when K1 ran a system through
#     one SM (20 us a step at 2.1 MB, 42 at 4.3 MB, a tie with the K2
#     loop).  Over a cluster K1 takes 3.1 us a step at 2.1 MB (resident)
#     and 7.3 at 4.3 MB (streamed), against 18-43 us a K2 launch in the
#     loop and 4.8-6.7 on the device;
#   - DENSE_PERSISTENT_BYTES = 1 MiB was set when K3 walked a system's
#     columns on one SM (34 us a step at 1 MiB, K4 42; 43 at 1.6 MiB, K4
#     24).  Over a cluster K3 takes 2.9-4.0 us a step up to 1.6 MiB
#     (resident) and 27 at 4 MiB (streamed), against 17-42 us a K4 launch
#     in the loop and 4.4-6.9 on the device.
#   So in the Python loop the persistent sweeps now win on both sides of
#   both limits, while the row-tiled kernels' device times are close to
#   theirs.  The limits stay until the row-tiled chunk runs as a CUDA
#   graph (ROADMAP, "Beside the kernels"), which moves the other side of
#   the same comparison; moving them now would change which kernel, and
#   so which order of summation, decides the settle steps of the main
#   path.
SMEM_PER_BLOCK = build.SMEM_PER_BLOCK
ELL_PERSISTENT_BYTES = 4 << 20
DENSE_PERSISTENT_BYTES = 1 << 20


def sweep_state_fits_smem(nz: int) -> bool:
    """Whether K1/K3 hold one system's padded state in a block's shared memory.

    Replaces the reference's ``nz <= SWEEP_STATE_LIMIT`` (1792, sized to
    TPU VMEM); here it holds up to nz = 28,928 states.
    """
    nz_p = nz + (-nz) % ROW_BLOCK
    return 2 * nz_p * 4 + 32 * 4 <= SMEM_PER_BLOCK


def ell_sweep_persistent(nz: int, k: int) -> bool:
    """K1 (persistent) rather than K2 (row-tiled) for an ELL operator of
    width ``k``; replaces the reference's ``ell_sweep_fits_vmem``."""
    nz_p = nz + (-nz) % ROW_BLOCK
    return sweep_state_fits_smem(nz) and nz_p * k * 8 <= ELL_PERSISTENT_BYTES


def dense_sweep_persistent(nz: int) -> bool:
    """K3 (persistent) rather than K4 (row-tiled) for a dense operator."""
    nz_p = nz + (-nz) % ROW_BLOCK
    return sweep_state_fits_smem(nz) and nz_p * nz_p * 4 <= DENSE_PERSISTENT_BYTES


# Dense <-> ELL crossover: per step the dense sweep reads nz^2 f32
# weights and the ELL sweep nz*K (weight, index) pairs, twice the bytes
# per slot, so ELL moves fewer bytes while K < nz / 2 — as in the reference.
ELL_FILL_CUTOFF = 0.5


def pad_rows(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """Zero-pad the given dims up to the next multiple of ROW_BLOCK."""
    pad = [0] * (2 * x.ndim)
    for d in dims:
        pad[2 * (x.ndim - 1 - d) + 1] = (-x.shape[d]) % ROW_BLOCK
    if not any(pad):
        return x
    return torch.nn.functional.pad(x, pad)


def sweep_chunk_schedule(
    predicted_steps,
    max_steps: int,
    *,
    floor: int = 50,
    ceil: int = 4096,
    splits: int = 8,
) -> int:
    """Fused-sweep chunk length from a spectral settling prediction.

    Every chunk boundary costs a launch (K1, K3) or a dt = 0 launch (K2,
    K4) and a host poll, so a sweep predicted to run N steps is cut into
    chunks of ``median(N) / splits``, clipped to ``[floor, min(ceil,
    max_steps)]``: the settle step stays resolved to about 1/``splits``
    of the horizon.  Non-finite predictions (unstable systems) are
    ignored; with none finite the chunk is ``floor``.  Host numpy, the
    reference's arithmetic.
    """
    p = np.asarray(predicted_steps, dtype=np.float64).reshape(-1)
    p = p[np.isfinite(p)]
    if p.size == 0:
        return floor
    target = int(np.median(p) / max(splits, 1))
    return int(np.clip(target, floor, max(min(ceil, max_steps), floor)))


def sweep_backend(nz: int, k: int | None) -> str:
    """Pick the transient-sweep backend for an operator family.

    ``k`` is the ELL slot width (None for a dense-only caller).
    Returns ``"ell"`` (K1), ``"ell-step"`` (K2), ``"dense"`` (K3) or
    ``"dense-step"`` (K4); see the routing limits above.
    """
    if k is not None and k < ELL_FILL_CUTOFF * nz:
        return "ell" if ell_sweep_persistent(nz, k) else "ell-step"
    return "dense" if dense_sweep_persistent(nz) else "dense-step"


def ell_prepare(idx: torch.Tensor, w: torch.Tensor, sweep_dtype: str = "float32"):
    """Row-major ELL slots (B, nz, K) -> padded slot-major (B, K, nz_p).

    ``w`` is cast to the sweep dtype (bf16 storage halves the weight
    traffic).  The settle loop calls this once per operator batch.
    """
    if sweep_dtype not in _ell.SWEEP_DTYPES:
        raise ValueError(f"unknown sweep_dtype {sweep_dtype!r}")
    w_dtype = torch.bfloat16 if sweep_dtype == "bfloat16" else torch.float32
    idx_t = pad_rows(idx.to(torch.int32), (1,)).transpose(1, 2).contiguous()
    w_t = pad_rows(w.to(w_dtype), (1,)).transpose(1, 2).contiguous()
    return idx_t, w_t


def ell_transient_sweep(
    idx: torch.Tensor,
    w: torch.Tensor,
    z: torch.Tensor,
    c: torch.Tensor,
    *,
    n_steps: int,
    dt: float = 1.0,
    padded: bool = False,
    sweep_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` fused ELL Euler steps; idx/w (B, nz, K), z/c (B, nz).

    Pads ``nz`` to the row block and routes between the persistent
    sweep K1 and ``n_steps`` launches of the row-tiled step K2 (plus one
    ``dt=0`` launch for the residual at the final state) by
    :func:`ell_sweep_persistent`.  Returns ``(z', res)`` with the
    per-system residual ``max_i |M z' + c|_i`` at the final state.

    ``padded=True`` says the caller already did the per-operator prep:
    idx/w are the slot-major ``(B, K, nz_p)`` arrays of
    :func:`ell_prepare` and z/c are padded to ``nz_p`` — the
    loop-hoisted path of settle sweeps that launch many chunks over one
    operator batch.

    ``sweep_dtype="bfloat16"`` runs the bf16-weight / fp32-accumulate
    variant; state, slot sum and residual stay float32.
    """
    if padded:
        idx_t, w_t = idx, w
        nz = idx_t.shape[2]
    else:
        nz = idx.shape[1]
        idx_t, w_t = ell_prepare(idx, w, sweep_dtype)
        z = pad_rows(z.to(torch.float32), (1,))
        c = pad_rows(c.to(torch.float32), (1,))
    if ell_sweep_persistent(idx_t.shape[2], idx_t.shape[1]):
        out, res = _ell.ell_sweep(idx_t, w_t, z, c, n_steps=n_steps, dt=dt)
        return out[:, :nz], res[:, 0]
    for _ in range(n_steps):
        z, _ = _ell.ell_step(idx_t, w_t, z, c, dt)
    # dt=0 step: state unchanged, residual evaluated at the *final*
    # state — matching the fused kernel's contract
    _zf, res = _ell.ell_step(idx_t, w_t, z, c, 0.0)
    return z[:, :nz], res.amax(dim=1)


def dense_prepare(m: torch.Tensor, sweep_dtype: str = "float32") -> tuple[str, torch.Tensor]:
    """The dense operators M (B, n, n) -> ``(route, operand)`` for
    :func:`dense_sweep_prepared`: rounded through ``sweep_dtype`` (bf16
    storage), cast to float32, padded to the row block and laid out as
    the route's kernel reads it — ``M^T`` for the persistent sweep K3
    (``route == "dense"``), ``M`` for the row-tiled step K4
    (``"dense-step"``).  A settle loop calls this once per operator batch
    and runs every chunk on the prepared operand.
    """
    if sweep_dtype not in _ell.SWEEP_DTYPES:
        raise ValueError(f"unknown sweep_dtype {sweep_dtype!r}")
    route = "dense" if dense_sweep_persistent(m.shape[1]) else "dense-step"
    if sweep_dtype == "bfloat16":
        m = m.to(torch.bfloat16)
    m = pad_rows(m.to(torch.float32), (1, 2))
    if route == "dense":
        m = m.transpose(1, 2)
    return route, m.contiguous()


def dense_sweep_prepared(route: str, operand: torch.Tensor, z: torch.Tensor,
                         c: torch.Tensor, *, n_steps: int,
                         dt: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` Euler steps on an operand of :func:`dense_prepare`;
    z/c (B, n_p) float32, padded to the row block.  ``"dense"`` runs the
    persistent sweep K3; ``"dense-step"`` ``n_steps`` launches of K4 and
    one ``dt=0`` launch for the residual at the final state.  Returns the
    padded ``(z', res)``, ``res`` the per-system ``max_i |M z' + c|_i``.
    """
    if route == "dense":
        out, res = _st.transient_sweep(operand, z, c, n_steps=n_steps, dt=dt)
        return out, res[:, 0]
    if route != "dense-step":
        raise ValueError(f"unknown dense route {route!r}")
    for _ in range(n_steps):
        z, _ = _st.transient_step_batched(operand, z, c, dt)
    # dt=0 step: state unchanged, residual evaluated at the *final*
    # state — matching the fused kernel's contract
    _zf, res = _st.transient_step_batched(operand, z, c, 0.0)
    return z, res.amax(dim=1)


def transient_sweep(
    m: torch.Tensor,
    z: torch.Tensor,
    c: torch.Tensor,
    *,
    n_steps: int,
    dt: float = 1.0,
    m_transposed: bool = False,
    sweep_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` fused batched Euler steps; m (B, n, n), z/c (B, n).

    Runs the persistent sweep K3 where :func:`dense_sweep_persistent`
    says so, else ``n_steps`` launches of the row-tiled step K4 (plus a
    ``dt=0`` launch for the final residual).  Returns
    ``(z', res)`` with ``res`` the per-system ``max_i |M z' + c|_i`` at
    the final state.

    ``m_transposed=True`` says, as in the reference, that the caller
    already padded every operand to the row block, applied the
    ``sweep_dtype`` rounding and passed ``m[b] = M_b.T``, whichever
    route runs.  K3 reads that operand as it is; where K4 applies, this
    call transposes it back once: one read and one write of the operator
    per call, against a 50-step chunk's 51 reads.  A settle loop that runs
    many chunks on one operator batch hoists that with
    :func:`dense_prepare` and :func:`dense_sweep_prepared` instead.

    ``sweep_dtype="bfloat16"`` rounds the dense operator through bf16
    once before the f32 sweep; the kernels themselves are unchanged.
    """
    if sweep_dtype not in _ell.SWEEP_DTYPES:
        raise ValueError(f"unknown sweep_dtype {sweep_dtype!r}")
    n = m.shape[1]
    if m_transposed:
        if dense_sweep_persistent(n):
            route, operand = "dense", m
        else:
            route, operand = "dense-step", m.transpose(1, 2).contiguous()
    else:
        route, operand = dense_prepare(m, sweep_dtype)
        z = pad_rows(z.to(torch.float32), (1,))
        c = pad_rows(c.to(torch.float32), (1,))
    out, res = dense_sweep_prepared(route, operand, z, c, n_steps=n_steps, dt=dt)
    return out[:, :n], res


_KERNELS = (_ell.ell_sweep, _ell.ell_step, _st.transient_sweep,
            _st.transient_step_batched, _st.transient_step, _mvm.crosspoint_mvm,
            _tr.colabs, _tr.assemble, _fa.flash_attention)


# the kernels with more than one route, and their launch counts by route
_ROUTED = (_st.transient_step, _mvm.crosspoint_mvm, _tr.colabs, _fa.flash_attention)
# the persistent sweeps, and their launch counts by variant
_SWEEPS = (_ell.ell_sweep, _st.transient_sweep)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel (K1-K8) since the last reset."""
    return {fn.__name__: fn.launches for fn in _KERNELS}


def launch_counts_by_route() -> dict[str, dict[str, int]]:
    """Launches of K5, K6, K7a and K8 by route since the last reset: K5's
    ``transient_step_route`` ("narrow_async", "narrow_scalar", "column",
    "wide"), K6's ``crosspoint_mvm_route`` ("mma_async", "mma_scalar",
    "f32_async", "f32_scalar", "fma"), K7a's ``colabs_route`` ("vec16",
    "scalar") and K8's ``flash_attention_route`` ("mma", "fma")."""
    return {fn.__name__: dict(fn.launches_by_route) for fn in _ROUTED}


def launch_counts_by_variant() -> dict[str, dict[str, int]]:
    """Launches of the persistent sweeps K1 and K3 by variant since the last
    reset: "resident" (the rank's share of the operator in shared memory,
    ``ell_sweep_variant`` / ``dense_sweep_variant``) or "streamed"."""
    return {fn.__name__: dict(fn.launches_by_variant) for fn in _SWEEPS}


def launch_counts_by_dtype() -> dict[str, dict[str, int]]:
    """K5's launches by operand dtype ("float32", "bfloat16") and route
    since the last reset: its narrow kernel serves both dtypes on one
    route name."""
    return {dt: dict(by_route) for dt, by_route in _st.transient_step.launches_by_dtype.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS:
        fn.launches = 0
    for fn in _ROUTED:
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    for fn in _SWEEPS:
        fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)
    _st.transient_step.launches_by_dtype = {
        dt: dict.fromkeys(by_route, 0)
        for dt, by_route in _st.transient_step.launches_by_dtype.items()}
