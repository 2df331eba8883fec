"""Mamba2 / SSD (state-space duality) block, chunked scan.

Counterpart of :mod:`repro.models.ssm`, the minimal SSD formulation
(Dao & Gu, arXiv:2405.21060):

    in-proj -> [z | x | B | C | dt],  causal conv1d over (x, B, C),
    y = SSD(x, dt, A, B, C) + D*x,  y = RMSNorm(y * silu(z)),  out-proj

Within a chunk of Q tokens the recurrence is an attention-like
lower-triangular product; across chunks a Python loop carries the
(H, P, N) state (the reference's ``lax.scan``).  Decode is the O(1)
recurrent update of the carried state.  All of it is plain PyTorch, as
the reference's is plain jnp: no Pallas kernel is on this path.

The dtype steps are the reference's.  Where it asks for
``preferred_element_type=float32`` on a product of bf16 operands, the
operands are taken to float32 first (their products are exact there)
and the product runs in float32, so the result is the float32 sum the
reference keeps instead of a bf16-rounded one.

The sequence length of a full-sequence call must be a multiple of the
chunk ``min(ssm_chunk, L)``, as the reference asserts; here it raises
:class:`ValueError`.  Padding would change the final state, so nothing
is padded.

Under tensor parallelism ``tp`` (a
:class:`~repro_torch.distributed.sharding.ModelSplit` whose Mamba block
is split, ``tp.ssm_partial``) a rank computes its share, as GSPMD splits
the reference's block under its rules (``inner`` and ``ssm_heads`` on
``"model"``): ``w_z``, ``w_x`` and the x conv give its ``inner``
columns, the SSD runs on its SSM heads (its slices of ``w_dt``,
``dt_bias``, ``a_log``, ``d_skip`` and of the state), and ``w_out`` is
row-parallel, its partial sums all-reduced (g).  B and C are computed
whole on every rank (every head of a group reads them).  One f sits on
the block's normed input, which all four in-projections read, and f on
``w_bc`` and the B/C conv's leaves: a rank's gradient of B and C is its
heads' share, summed over ``"model"`` once on each path it takes (to
the input and to those leaves), which costs the leaves' d x 2GN where a
sum of B and C themselves would cost an activation of B x L x 2GN.  The
gated RMSNorm's mean square over ``d_inner`` is summed over ``"model"``
forward and backward (:meth:`ModelSplit.mean_over`).  Decode gathers
the rank's columns of the new ``x`` over ``"model"``: the conv window is
replicated there, as the reference's cache is.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise segment sums.

    x: (..., Q) per-step log-decay; returns (..., Q, Q) where
    out[..., t, s] = sum_{s < r <= t} x[..., r]  (-inf above the diagonal).
    """
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def check_chunk(length: int, chunk: int) -> None:
    """The reference's contract: a full-sequence call takes a length that
    is a multiple of its chunk."""
    if length % chunk:
        raise ValueError(f"sequence length {length} is not a multiple of the SSD chunk {chunk}: "
                         "a prompt longer than ssm_chunk must be a multiple of it (the "
                         "reference asserts this; padding would change the final state)")


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, *, chunk: int,
                init_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P), dt (B, L, H) after softplus, a (H,) negative,
    b_mat/c_mat (B, L, G, N), init_state (B, H, P, N) or None.

    Returns (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) float32).
    """
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    check_chunk(l, chunk)
    nc = l // chunk
    rep = h // g
    f32 = torch.float32

    # fold dt into x (the SSD trick): x_bar = x * dt
    xb = x * dt[..., None].to(x.dtype)
    da = dt * a[None, None, :]                                       # (B, L, H) log-decay

    xc = xb.reshape(bsz, nc, chunk, g, rep, p)
    dac = da.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, g, n)
    cc = c_mat.reshape(bsz, nc, chunk, g, n)

    # intra-chunk (attention-like)
    lmat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))               # (B, nc, H, Q, Q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", cc.to(f32), bc.to(f32))
    scores = scores.reshape(bsz, nc, g, 1, chunk, chunk)
    lm = lmat.reshape(bsz, nc, g, rep, chunk, chunk)
    att = (scores * lm).to(x.dtype)                                  # (B, nc, G, rep, Q, Q)
    y_intra = torch.einsum("bcgrqk,bckgrp->bcqgrp", att.to(f32), xc.to(f32))

    # chunk states
    cum = torch.cumsum(dac, dim=2)                                   # (B, nc, Q, H)
    total = cum[:, :, -1:, :]
    decay_to_end = torch.exp(total - cum)
    s_chunk = torch.einsum("bcqgn,bcqgrp,bcqgr->bcgrpn", bc.to(f32), xc.to(f32),
                           decay_to_end.reshape(bsz, nc, chunk, g, rep))

    # inter-chunk recurrence: state_c = state_{c-1} * decay_c + s_c
    chunk_decay = torch.exp(total[:, :, 0, :]).reshape(bsz, nc, g, rep, 1, 1)
    if init_state is None:
        state = torch.zeros((bsz, g, rep, p, n), dtype=f32, device=x.device)
    else:
        state = init_state.reshape(bsz, g, rep, p, n).to(f32)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c] + s_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)                           # (B, nc, G, rep, P, N)

    # inter-chunk contribution
    in_decay = torch.exp(cum).reshape(bsz, nc, chunk, g, rep)
    y_inter = torch.einsum("bcqgn,bcgrpn,bcqgr->bcqgrp", cc.to(f32), prev_states, in_decay)

    y = (y_intra + y_inter).reshape(bsz, l, h, p).to(x.dtype)
    return y, state.reshape(bsz, h, p, n)


def _causal_conv(seg: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of kernel size K by shifted adds, then SiLU.

    seg (B, L, C); w (K, C); bias (C,).  Sums in float32, the result in
    seg's dtype.
    """
    k = w.shape[0]
    length = seg.shape[1]
    out = torch.zeros(seg.shape, dtype=torch.float32, device=seg.device)
    for i in range(k):
        shift = k - 1 - i
        shifted = F.pad(seg, (0, 0, shift, 0))[:, :length, :]
        out = out + shifted.float() * w[i].float()
    out = out + bias.float()
    return F.silu(out).to(seg.dtype)


# the Mamba block's leaves that a rank of a split block uses in part
_B_C_LEAVES = ("w_bc", "conv_bc_w", "conv_bc_b")
_HEAD_LEAVES = ("dt_bias", "a_log", "d_skip")


def _split(tp) -> bool:
    """Whether a Mamba block computes a rank's share under tensor
    parallelism ``tp`` (None on one device)."""
    return tp is not None and tp.ssm_partial


def rank_leaves(p, tp):
    """The Mamba block's leaves as a rank uses them under tensor
    parallelism ``tp``: its own shards of the ``inner`` leaves; ``w_bc``
    and the B/C conv whole, their gradients summed over ``"model"``; its
    SSM heads' slices of ``w_dt``, ``dt_bias``, ``a_log`` and ``d_skip``
    (views), their gradients summed too.  ``p`` itself where the block
    is not split."""
    if not _split(tp):
        return p
    leaves = {n: getattr(p, n) for n in ("ln", "w_z", "w_x", "conv_x_w", "conv_x_b",
                                         "norm_scale", "w_out")}
    leaves.update({n: tp.enter(getattr(p, n)) for n in _B_C_LEAVES})
    leaves["w_dt"] = tp.enter(p.w_dt).narrow(1, tp.ssm_first, tp.ssm_heads)
    leaves.update({n: tp.enter(getattr(p, n)).narrow(0, tp.ssm_first, tp.ssm_heads)
                   for n in _HEAD_LEAVES})
    return types.SimpleNamespace(**leaves)


def _heads_and_groups(cfg: ModelConfig, tp) -> tuple[int, int, int]:
    """(SSM heads, first group, groups) of what the rank computes: its
    heads and the groups of B and C they read (whole groups, or the one
    group its heads lie in; ``_model_split`` refuses anything else)."""
    if not _split(tp):
        return cfg.ssm_heads, 0, cfg.ssm_groups
    rep = cfg.ssm_heads // cfg.ssm_groups
    return tp.ssm_heads, tp.ssm_first // rep, max(1, tp.ssm_heads // rep)


def in_proj(x: torch.Tensor, p):
    """Split in-projection: returns (z, x_seg, bc_seg, dt_raw)."""
    return x @ p.w_z, x @ p.w_x, x @ p.w_bc, x @ p.w_dt


def _dt_and_a(dt: torch.Tensor, p) -> tuple[torch.Tensor, torch.Tensor]:
    dt = F.softplus(dt.float() + p.dt_bias.float())
    return dt, -torch.exp(p.a_log.float())


def _gate_out(y: torch.Tensor, z: torch.Tensor, x_dtype: torch.dtype, p,
              cfg: ModelConfig, tp=None) -> torch.Tensor:
    """RMSNorm(y * silu(z)) and the out-projection; under tensor
    parallelism the rank's columns, the mean square summed over
    ``"model"`` both ways, and ``w_out``'s partial sums all-reduced."""
    mean_over = tp.mean_over if _split(tp) else None
    y = rms_norm(y * F.silu(z.float()).to(x_dtype), p.norm_scale, cfg.norm_eps,
                 mean_over=mean_over)
    out = y @ p.w_out
    return out if mean_over is None else tp.exit(out)


def mamba2_forward(x: torch.Tensor, p, cfg: ModelConfig, *,
                   init_state: torch.Tensor | None = None,
                   tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block.  x: (B, L, d_model).

    Returns (out (B, L, d_model), final ssm state (B, H, P, N) float32);
    under tensor parallelism ``tp`` the state of the rank's H heads.
    """
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    h, g_first, g = _heads_and_groups(cfg, tp)
    bsz, l, _ = x.shape
    if _split(tp):
        x = tp.enter(x)
        p = rank_leaves(p, tp)

    z, xs, bc, dt = in_proj(x, p)
    xs = _causal_conv(xs, p.conv_x_w, p.conv_x_b)
    bc = _causal_conv(bc, p.conv_bc_w, p.conv_bc_b)

    xs = xs.reshape(bsz, l, h, pdim)
    b_mat, c_mat = bc.chunk(2, dim=-1)
    b_mat = b_mat.reshape(bsz, l, cfg.ssm_groups, n)
    c_mat = c_mat.reshape(bsz, l, cfg.ssm_groups, n)
    if g < cfg.ssm_groups:
        b_mat, c_mat = b_mat.narrow(2, g_first, g), c_mat.narrow(2, g_first, g)
    dt, a = _dt_and_a(dt, p)

    y, state = ssd_chunked(xs, dt, a, b_mat, c_mat, chunk=min(cfg.ssm_chunk, l),
                           init_state=init_state)
    y = y + xs * p.d_skip.to(x.dtype)[None, None, :, None]
    return _gate_out(y.reshape(bsz, l, h * pdim), z, x.dtype, p, cfg, tp), state


def mamba2_decode(x: torch.Tensor, p, cfg: ModelConfig, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor, *,
                  tp=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  x: (B, 1, d_model); conv_state
    (B, K-1, d_in + 2GN) ``[x-seg | bc-seg]``; ssm_state (B, H, P, N).

    Returns (out (B, 1, d_model), new conv_state, new ssm_state in
    ssm_state's dtype).  Under tensor parallelism ``tp`` the rank steps
    its H heads' state and gathers its columns of the new x-seg, so that
    the conv window stays whole on every rank.
    """
    d_in = cfg.d_inner
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    h, g_first, g = _heads_and_groups(cfg, tp)
    bsz = x.shape[0]
    f32 = torch.float32
    p = rank_leaves(p, tp)

    z, xs_new, bc_new, dt = in_proj(x[:, 0, :], p)
    if _split(tp):
        xs_new = tp.gather_columns(xs_new)
    xbc_new = torch.cat([xs_new, bc_new], dim=-1)                     # (B, d_in + 2GN)

    window = torch.cat([conv_state, xbc_new[:, None, :]], dim=1)      # (B, K, C)
    new_conv_state = window[:, 1:, :]
    w_full = torch.cat([p.conv_x_w, p.conv_bc_w], dim=1)              # (K, C)
    b_full = torch.cat([p.conv_x_b, p.conv_bc_b], dim=0)
    if _split(tp):
        # the rank's columns of the x-seg, and the bc-seg whole
        first = tp.ssm_first * pdim
        window = torch.cat([window[..., first:first + h * pdim], window[..., d_in:]], dim=-1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32), w_full.to(f32)) + b_full.to(f32)
    xbc_c = F.silu(conv_out).to(x.dtype)

    xs, bc = xbc_c.split([h * pdim, xbc_c.shape[-1] - h * pdim], dim=-1)
    b_mat, c_mat = bc.chunk(2, dim=-1)
    xs = xs.reshape(bsz, h, pdim)
    b_mat = b_mat.reshape(bsz, cfg.ssm_groups, n)
    c_mat = c_mat.reshape(bsz, cfg.ssm_groups, n)
    if g < cfg.ssm_groups:
        b_mat, c_mat = b_mat.narrow(1, g_first, g), c_mat.narrow(1, g_first, g)
    dt, a = _dt_and_a(dt, p)

    rep = h // g
    decay = torch.exp(dt * a[None, :])                                # (B, H)
    bx = torch.einsum("bgn,bgrp,bgr->bgrpn", b_mat.to(f32), xs.reshape(bsz, g, rep, pdim).to(f32),
                      dt.reshape(bsz, g, rep)).reshape(bsz, h, pdim, n)
    state = ssm_state.to(f32) * decay[..., None, None] + bx
    y = torch.einsum("bgn,bgrpn->bgrp", c_mat.to(f32),
                     state.reshape(bsz, g, rep, pdim, n)).reshape(bsz, h, pdim)
    y = y + xs.to(f32) * p.d_skip.to(f32)[None, :, None]
    y = y.reshape(bsz, h * pdim).to(x.dtype)
    out = _gate_out(y, z, x.dtype, p, cfg, tp)[:, None, :]
    return out, new_conv_state, state.to(ssm_state.dtype)
