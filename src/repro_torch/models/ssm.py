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
"""

from __future__ import annotations

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


def in_proj(x: torch.Tensor, p):
    """Split in-projection: returns (z, x_seg, bc_seg, dt_raw)."""
    return x @ p.w_z, x @ p.w_x, x @ p.w_bc, x @ p.w_dt


def _dt_and_a(dt: torch.Tensor, p) -> tuple[torch.Tensor, torch.Tensor]:
    dt = F.softplus(dt.float() + p.dt_bias.float())
    return dt, -torch.exp(p.a_log.float())


def _gate_out(y: torch.Tensor, z: torch.Tensor, x_dtype: torch.dtype, p,
              cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm(y * silu(z)) and the out-projection."""
    y = rms_norm(y * F.silu(z.float()).to(x_dtype), p.norm_scale, cfg.norm_eps)
    return y @ p.w_out


def mamba2_forward(x: torch.Tensor, p, cfg: ModelConfig, *,
                   init_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block.  x: (B, L, d_model).

    Returns (out (B, L, d_model), final ssm state (B, H, P, N) float32).
    """
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    bsz, l, _ = x.shape

    z, xs, bc, dt = in_proj(x, p)
    xs = _causal_conv(xs, p.conv_x_w, p.conv_x_b)
    bc = _causal_conv(bc, p.conv_bc_w, p.conv_bc_b)

    xs = xs.reshape(bsz, l, h, pdim)
    b_mat, c_mat = bc.chunk(2, dim=-1)
    b_mat = b_mat.reshape(bsz, l, g, n)
    c_mat = c_mat.reshape(bsz, l, g, n)
    dt, a = _dt_and_a(dt, p)

    y, state = ssd_chunked(xs, dt, a, b_mat, c_mat, chunk=min(cfg.ssm_chunk, l),
                           init_state=init_state)
    y = y + xs * p.d_skip.to(x.dtype)[None, None, :, None]
    return _gate_out(y.reshape(bsz, l, cfg.d_inner), z, x.dtype, p, cfg), state


def mamba2_decode(x: torch.Tensor, p, cfg: ModelConfig, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  x: (B, 1, d_model); conv_state
    (B, K-1, d_in + 2GN) ``[x-seg | bc-seg]``; ssm_state (B, H, P, N).

    Returns (out (B, 1, d_model), new conv_state, new ssm_state in
    ssm_state's dtype).
    """
    d_in = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    bsz = x.shape[0]
    f32 = torch.float32

    z, xs_new, bc_new, dt = in_proj(x[:, 0, :], p)
    xbc_new = torch.cat([xs_new, bc_new], dim=-1)                     # (B, d_in + 2GN)

    window = torch.cat([conv_state, xbc_new[:, None, :]], dim=1)      # (B, K, C)
    new_conv_state = window[:, 1:, :]
    w_full = torch.cat([p.conv_x_w, p.conv_bc_w], dim=1)              # (K, C)
    b_full = torch.cat([p.conv_x_b, p.conv_bc_b], dim=0)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32), w_full.to(f32)) + b_full.to(f32)
    xbc_c = F.silu(conv_out).to(x.dtype)

    xs, bc = xbc_c.split([d_in, xbc_c.shape[-1] - d_in], dim=-1)
    b_mat, c_mat = bc.chunk(2, dim=-1)
    xs = xs.reshape(bsz, h, pdim)
    b_mat = b_mat.reshape(bsz, g, n)
    c_mat = c_mat.reshape(bsz, g, n)
    dt, a = _dt_and_a(dt, p)

    rep = h // g
    decay = torch.exp(dt * a[None, :])                                # (B, H)
    bx = torch.einsum("bgn,bgrp,bgr->bgrpn", b_mat.to(f32), xs.reshape(bsz, g, rep, pdim).to(f32),
                      dt.reshape(bsz, g, rep)).reshape(bsz, h, pdim, n)
    state = ssm_state.to(f32) * decay[..., None, None] + bx
    y = torch.einsum("bgn,bgrpn->bgrp", c_mat.to(f32),
                     state.reshape(bsz, g, rep, pdim, n)).reshape(bsz, h, pdim)
    y = y + xs.to(f32) * p.d_skip.to(f32)[None, :, None]
    y = y.reshape(bsz, d_in).to(x.dtype)
    out = _gate_out(y, z, x.dtype, p, cfg)[:, None, :]
    return out, new_conv_state, state.to(ssm_state.dtype)
