"""Flash attention kernel K8: GQA attention with an online softmax.

Counterpart of :mod:`repro.kernels.flash_attention` (the Hopper source is
``csrc/flash_attention.cu``).  For ``q (B, S, H, D)`` and
``k, v (B, T, KV, D)`` with ``H = KV * G``, query head ``h`` attends to
KV head ``h // G`` and the result is ``softmax(q k^T / sqrt(D) + mask) v``
as ``(B, S, H, D)`` in ``q``'s dtype.  The mask is causal
(``kpos <= qpos``), an optional sliding window (``kpos > qpos - window``)
and the keys that exist (``kpos < T``).  Scores, the running max and
denominator and the accumulator are float32; masked scores are the
finite ``NEG_INF = -1e30``, not ``-inf``, so a row that is fully masked
in its first key tile takes ``p = 1`` there and the next tile's
``alpha = exp(-1e30 - m) = 0`` wipes it, where ``-inf`` would give NaN.

``p_dtype`` says whether the probability tile is rounded before the PV
product: ``None`` keeps it float32, as the model's attention does unless
``ModelConfig.attn_p_bf16``; ``torch.bfloat16`` rounds it, the float32
row sum staying exact.  The reference's Pallas kernel rounds to ``v``'s
dtype, which :func:`repro_torch.kernels.ops.flash_attention` passes on.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
its plain PyTorch version, :func:`flash_attention_plain`, for CPU
tensors.  D must be 16, 32, 64, 112 or 128; q, k and v share one dtype,
float32 or bfloat16.  The route it launches is
:func:`flash_attention_route`'s: bf16 on the tensor cores, float32 on
float32 FMA.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 112, 128)   # 112: Zamba2-7B's shared attention
KV_TILE = 64          # keys per tile, in the kernel and in the plain version
P_DTYPES = (None, torch.bfloat16)
# "mma": bf16 tensor cores with float32 accumulators; "fma": float32 FMA
ROUTES = ("mma", "fma")


def flash_attention_route(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The route of a K8 call, a pure function of its dtype, head size and
    alignment (``aligned``: q, k and v start on 16-byte boundaries).

    bf16 at every head size of :data:`HEAD_DIMS` takes ``"mma"`` when
    aligned (any fresh tensor is); float32 takes ``"fma"``, because TF32
    would break its 1e-6 + 1e-5 |want| bar, and so does a bf16 view whose
    base is off the 16-byte grid, which the FMA kernel reads element by
    element.
    """
    if dtype == torch.bfloat16 and d in HEAD_DIMS and aligned:
        return "mma"
    return "fma"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p_dtype,
           window: int) -> torch.device:
    dev = build.check_tensors(build.FLOAT_DTYPES, q=q, k=k, v=v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, S, H, D) and k, v (B, T, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _s, h, d = q.shape
    kb, _t, kv, kd = k.shape
    if kb != b or kd != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not fit: "
                         "batch and head size must match and KV divide H")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not supported; the kernel takes {HEAD_DIMS}")
    if p_dtype not in P_DTYPES:
        raise ValueError(f"p_dtype must be one of {P_DTYPES}, got {p_dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return dev


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          p_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`.

    The online softmax over key tiles of :data:`KV_TILE`, all queries at
    once, in float32 (products of bf16 inputs are exact in float32), with
    the kernel's mask, ``NEG_INF`` and ``max(l, 1e-30)`` floor.  The tile
    edges are the kernel's, so ``p`` is rounded against the same running
    max.  Tiles that the kernel skips are fully masked for every row
    that reaches them, and their contribution is wiped, as in the kernel.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kv, g, d).float()
    kf, vf = k.float(), v.float()
    qpos = torch.arange(s, device=q.device)[:, None]
    acc = torch.zeros((b, kv, g, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, kv, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g, s), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, KV_TILE):
        k1 = min(k0 + KV_TILE, t)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, k0:k1]) * scale
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        ok = torch.ones((s, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vf[:, k0:k1])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]                   # (b, kv, g, s, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    p_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K8: GQA attention, ``q (B, S, H, D)``, ``k, v (B, T, KV, D)`` ->
    ``(B, S, H, D)`` in q's dtype.

    Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas``
    (which rounds ``p`` to ``v.dtype``: ``ops.flash_attention``).  Any
    S and T: the kernel masks ragged edges, so nothing is padded.  Bound
    by operations at the main path's shape (``csrc/flash_attention.cu``);
    the route is :func:`flash_attention_route`'s.
    """
    dev = _check(q, k, v, p_dtype, window)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, p_dtype=p_dtype)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    route = flash_attention_route(q.dtype, d, build.aligned16(q, k, v))
    lib = build.load_library()
    out = torch.empty_like(q)
    scale, p_bf16 = 1.0 / math.sqrt(d), int(p_dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = build.current_stream(dev)
        if route == "mma":
            lib.call("repro_flash_attention_mma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, t, h, kv, d, int(causal), int(window), scale,
                     p_bf16, stream)
        else:
            lib.call("repro_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     int(q.dtype == torch.bfloat16), out.data_ptr(), b, s, t, h, kv, d,
                     int(causal), int(window), scale, p_bf16, stream)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


# launch counts of the CUDA kernel, in all and by route (plain-version
# calls do not count)
flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
