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

Training (ROADMAP Queue 1 item 12.6).  Under grad mode, with an input that
requires grad, :func:`flash_attention` runs through
:class:`FlashAttention`, whose forward also writes each row's
log-sum-exp (:func:`flash_attention_lse`) and whose backward is
:func:`flash_attention_bwd`: three hand-written kernels on the card
(``csrc/flash_attention.cu``: Delta, then dK/dV, then dQ, on the route
:func:`flash_attention_bwd_route` names: bf16 on the tensor cores,
float32 on float32 FMA) and :func:`flash_attention_bwd_plain` on the
CPU.  The reference has no
backward kernel: it differentiates the pure-JAX attention
(``repro/models/attention.py:42``) with ``jax.grad``, which these
replace.  The gradient is FlashAttention-2's: ``P = exp(S scale - lse)``
under the forward's mask, ``dV = P~^T dO`` with ``P~`` the forward's PV
operand (``P`` rounded to bf16 when ``p_dtype`` is bf16), ``dS = P (dP -
Delta)`` with the float32 ``P`` (``jax.grad`` passes a cast's cotangent
straight through), ``dQ = scale dS K``, ``dK = scale dS^T Q``; the GQA
sum over a group's query heads is in a fixed order, without atomics.

Counting.  Under a counting dispatch mode (:class:`build.KernelCounter`,
the roofline's ``CostCounter``) the forward and each of the backward's
three kernels report one operation (:func:`build.record_operation`) by
formula (:func:`forward_cost`, :func:`backward_costs`: the work the mask
leaves, :func:`attn_pairs`, each operand read once and each result
written once) on every device; the plain version that stands in on the
CPU runs uncounted.  With no such mode active the formulas are not
evaluated.  On
``meta`` tensors (a dry run) the wrappers return empty results of the
right shapes and dtypes, launch nothing and run no plain version.
"""

from __future__ import annotations

import ctypes
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


def flash_attention_bwd_route(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The route of K8's dK/dV and dQ kernels: :func:`flash_attention_route`'s
    rule, with dO among the inputs that ``aligned`` covers."""
    return flash_attention_route(dtype, d, aligned)


# The "fma" forward's layout and plan (csrc/flash_attention.cu: FfLayout,
# ff_plan, FF_*): the largest row tile from FMA_FWD_MIN_ROWS up whose grid
# keeps FMA_FWD_FILL_BLOCKS blocks; an H100 SM's shared memory, threads
# and blocks for the one-wave estimate (registers are the card's to
# report: fma_forward_plan_on_device).
FMA_FWD_MIN_ROWS, FMA_FWD_FILL_BLOCKS = 16, 192
FMA_FWD_ROWS_PER_THREAD, FMA_FWD_MAX_THREADS = 4, 256
H100_SMS, SM_SMEM, SM_BLOCK_RESERVED, SM_THREADS, SM_BLOCKS = 132, 233_472, 1024, 2048, 32


def fma_forward_layout(d: int) -> dict:
    """The "fma" forward's register tiles at head size ``d``: ``kg`` lanes
    share a row group of 4 rows (16 at D = 32 and 64, else 8), each forms
    ``ak`` = 64 / kg keys of S and ``cpt`` = d / kg output columns in
    chunks of ``vec``; ``ts`` and ``ps`` are the padded row strides of the
    Q/K/V tiles and of P (floats); ``max_rows`` the largest row tile (256
    threads) and ``row_step`` the rows of a warp (row tiles are multiples of
    it); ``nb`` the 64-key buffers of the K/V ring (4: a key tile's K and V
    a tile ahead; 3 at D >= 112, where a fourth does not fit beside 128
    rows)."""
    kg = 16 if d in (32, 64) else 8
    cpt = d // kg
    return dict(kg=kg, ak=KV_TILE // kg, cpt=cpt, vec=4 if cpt % 4 == 0 else 2, ts=d + 4,
                ps=KV_TILE + kg, max_rows=FMA_FWD_MAX_THREADS // kg * FMA_FWD_ROWS_PER_THREAD,
                row_step=FMA_FWD_ROWS_PER_THREAD * 32 // kg, nb=3 if d >= 112 else 4)


def fma_forward_key_tiles(r0: int, rows: int, n_rows: int, g: int, t: int, causal: bool,
                          window: int) -> tuple[int, int]:
    """``(kt0, n_kt)``: the key tiles of 64 keys that hold an unmasked key
    for some row of rows ``[r0, r0 + rows)`` of the (q position, group
    member) index (``csrc/flash_attention.cu:ff_key_tiles``)."""
    q_lo, q_hi = r0 // g, (min(r0 + rows, n_rows) - 1) // g
    k_hi = min(t - 1, q_hi) if causal else t - 1
    k_lo = max(0, q_lo - window + 1) if window > 0 else 0
    kt0 = k_lo // KV_TILE
    return kt0, (k_hi // KV_TILE - kt0 + 1 if k_lo <= k_hi else 0)


def fma_forward_plan(batch: int, s: int, t: int, h: int, kv: int, d: int, causal: bool,
                     window: int) -> dict:
    """The "fma" forward's launch at a shape, a pure function of it (the
    same function as ``csrc/flash_attention.cu:ff_plan``, which
    :func:`fma_forward_plan_on_device` reads): ``rows`` per block, the
    largest multiple of the layout's ``row_step`` up to its ``max_rows``
    whose grid keeps FMA_FWD_FILL_BLOCKS blocks, else FMA_FWD_MIN_ROWS
    (train_lm's attention: 48 rows, 192 blocks); ``threads`` (a
    thread per 4 rows x kg lanes); ``smem_bytes``; ``blocks`` (row tiles x
    batch x kv, one per (row tile, batch * KV head), block i taking row
    tile ``row_tiles - 1 - i // (batch kv)``: the longest first);
    ``tiles``, per row tile in that issue order, ``(r0, r1, kt0, n_kt)``:
    its rows and the key tiles the mask lets it reach; ``blocks_per_sm``,
    an H100 SM's room by shared memory and threads, and ``waves``."""
    lay = fma_forward_layout(d)
    g = h // kv
    n_rows, n_bkv = s * g, batch * kv
    rows = lay["max_rows"]
    while rows > FMA_FWD_MIN_ROWS and -(-n_rows // rows) * n_bkv < FMA_FWD_FILL_BLOCKS:
        rows -= lay["row_step"]
    n_tiles = -(-n_rows // rows)
    smem = (rows * lay["ts"] + lay["nb"] * KV_TILE * lay["ts"] + rows * lay["ps"]) * 4
    threads = rows // FMA_FWD_ROWS_PER_THREAD * lay["kg"]
    per_sm = min(SM_SMEM // (smem + SM_BLOCK_RESERVED), SM_THREADS // threads, SM_BLOCKS)
    tiles = []
    for tile in reversed(range(n_tiles)):
        r0 = tile * rows
        tiles.append((r0, min(r0 + rows, n_rows),
                      *fma_forward_key_tiles(r0, rows, n_rows, g, t, causal, window)))
    blocks = n_tiles * n_bkv
    return dict(rows=rows, threads=threads, smem_bytes=smem, blocks=blocks, row_tiles=n_tiles,
                tiles=tiles, blocks_per_sm=per_sm, waves=blocks / (H100_SMS * per_sm))


def fma_forward_plan_on_device(batch: int, s: int, t: int, h: int, kv: int, d: int,
                               causal: bool, window: int) -> dict:
    """The plan the C launcher computes for the same shape
    (``repro_flash_attention_fma_plan``): ``rows``, ``threads``,
    ``smem_bytes``, ``blocks``, ``row_tiles`` and per row tile in issue
    order ``(kt0, n_kt)`` under ``key_tiles``, plus ``blocks_per_sm``:
    how many of its blocks the current CUDA device holds on one SM."""
    n_rows = s * (h // kv)
    buf = (ctypes.c_int * (6 + 2 * -(-n_rows // FMA_FWD_MIN_ROWS)))()
    build.load_library().call("repro_flash_attention_fma_plan", batch, s, t, h, kv, d,
                              int(causal), int(window), ctypes.addressof(buf), len(buf))
    out = dict(zip(("rows", "threads", "smem_bytes", "blocks", "row_tiles", "blocks_per_sm"),
                   buf[:6]))
    out["key_tiles"] = [(buf[6 + 2 * i], buf[7 + 2 * i]) for i in range(out["row_tiles"])]
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p_dtype,
           window: int) -> torch.device:
    dev = build.check_tensors(build.FLOAT_DTYPES, allow_meta=True, q=q, k=k, v=v)
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


def _keep(s: int, k0: int, k1: int, causal: bool, window: int, device) -> torch.Tensor:
    """The forward's mask of query rows [0, s) against keys [k0, k1)."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    ok = torch.ones((s, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return ok


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
    return flash_attention_plain_lse(q, k, v, causal=causal, window=window, p_dtype=p_dtype)[0]


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              p_dtype: torch.dtype | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_plain` and each row's log-sum-exp ``m +
    log(max(l, 1e-30))`` of the scaled scores, float32 (B, H, S): the
    plain version of :func:`flash_attention_lse`."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kv, g, d).float()
    kf, vf = k.float(), v.float()
    acc = torch.zeros((b, kv, g, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, kv, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g, s), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, KV_TILE):
        k1 = min(k0 + KV_TILE, t)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, k0:k1]) * scale
        sc = torch.where(_keep(s, k0, k1, causal, window, q.device), sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vf[:, k0:k1])
        m = m_new
    l = l.clamp_min(1e-30)
    out = acc / l[..., None]                                    # (b, kv, g, s, d)
    lse = (m + torch.log(l)).reshape(b, h, s)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype), lse


def _pairs_at(q: int, t: int, causal: bool, window: int) -> int:
    hi = min(q, t - 1) if causal else t - 1
    lo = max(0, q - window + 1) if window > 0 else 0
    return max(0, hi - lo + 1)


def attn_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the mask leaves for ``s`` queries at
    positions 0..s-1 against ``t`` keys at 0..t-1: ``kpos <= qpos`` when
    causal, ``kpos > qpos - window`` when ``window > 0``.  The work this
    input needs, in closed form: a query's count is linear in its
    position between the kinks at t (the causal edge reaches the last
    key), window (the window starts to cut) and t + window - 1 (nothing
    left), so each stretch is an arithmetic series."""
    if s <= 0 or t <= 0:
        return 0
    cuts = {0, s}
    for c in (t, window, t + window - 1) if window > 0 else (t,):
        if 0 < c < s:
            cuts.add(c)
    cuts = sorted(cuts)
    total = 0
    for a, b in zip(cuts, cuts[1:]):
        total += (_pairs_at(a, t, causal, window) + _pairs_at(b - 1, t, causal, window)) \
            * (b - a) // 2
    return total


def forward_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 window: int, lse: bool) -> tuple[int, int]:
    """(flops, bytes) of one forward: 4 D flops a (query head, key) pair
    the mask leaves (S and PV); q, k and v read once, the output (and the
    row lse) written once."""
    b, s, h, d = q.shape
    flops = 4 * b * h * d * attn_pairs(s, k.shape[1], causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return flops, nbytes + (b * h * s * 4 if lse else 0)


def backward_costs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                   window: int) -> dict[str, tuple[int, int]]:
    """(flops, bytes) of each backward kernel by name: Delta (2 flops and
    two elements of O and dO read a product, the float32 row written);
    dK/dV (8 D flops a pair: S, dP, dV and dK) and dQ (6 D: S, dP, dQ),
    each reading q, k, v, dO, lse and Delta once and writing its results
    once."""
    b, s, h, d = q.shape
    pairs = attn_pairs(s, k.shape[1], causal, window)
    esize = q.element_size()
    qkvo = (2 * q.numel() + k.numel() + v.numel()) * esize
    stats = 2 * b * h * s * 4
    return {
        "flash_attention_bwd_delta": (2 * q.numel(), 2 * q.numel() * esize + b * h * s * 4),
        "flash_attention_bwd_dkdv": (8 * d * pairs * b * h,
                                     qkvo + stats + (k.numel() + v.numel()) * esize),
        "flash_attention_bwd_dq": (6 * d * pairs * b * h, qkvo + stats + q.numel() * esize),
    }


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    p_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K8: GQA attention, ``q (B, S, H, D)``, ``k, v (B, T, KV, D)`` ->
    ``(B, S, H, D)`` in q's dtype.

    Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas``
    (which rounds ``p`` to ``v.dtype``: ``ops.flash_attention``).  Any
    S and T: the kernel masks ragged edges, so nothing is padded.  Bound
    by operations at the main path's shape (``csrc/flash_attention.cu``);
    the route is :func:`flash_attention_route`'s.  Under grad mode with an
    input that requires grad the call goes through :class:`FlashAttention`,
    so the result has a ``grad_fn`` whose backward is
    :func:`flash_attention_bwd`.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, p_dtype)
    return flash_attention_lse(q, k, v, causal=causal, window=window, p_dtype=p_dtype,
                               lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        p_dtype: torch.dtype | None = None, lse: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K8's forward and, when ``lse``, each row's log-sum-exp (float32
    (B, H, S)) from the same launch; ``(out, None)`` without it, the
    kernel then writing exactly what it wrote before that output existed.
    Launches for CUDA tensors (counted as :func:`flash_attention`'s), runs
    :func:`flash_attention_plain_lse` for CPU tensors and returns empty
    results for ``meta`` tensors.  No autograd."""
    dev = _check(q, k, v, p_dtype, window)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    build.record_operation("flash_attention",
                           lambda: forward_cost(q, k, v, causal, window, lse))
    if dev.type == "meta":
        return torch.empty_like(q), (torch.empty((b, h, s), dtype=torch.float32, device=dev)
                                     if lse else None)
    if dev.type == "cpu":
        with build.uncounted():
            out, row_lse = flash_attention_plain_lse(q, k, v, causal=causal, window=window,
                                                     p_dtype=p_dtype)
        return out, (row_lse if lse else None)
    route = flash_attention_route(q.dtype, d, build.aligned16(q, k, v))
    lib = build.load_library()
    out = torch.empty_like(q)
    row_lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) if lse else None
    lse_ptr = row_lse.data_ptr() if lse else None
    scale, p_bf16 = 1.0 / math.sqrt(d), int(p_dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = build.current_stream(dev)
        if route == "mma":
            lib.call("repro_flash_attention_mma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse_ptr, b, s, t, h, kv, d, int(causal), int(window),
                     scale, p_bf16, stream)
        else:
            lib.call("repro_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     int(q.dtype == torch.bfloat16), out.data_ptr(), lse_ptr, b, s, t, h, kv,
                     d, int(causal), int(window), scale, p_bf16, stream)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out, row_lse


# launch counts of the CUDA kernel, in all and by route (plain-version
# calls do not count)
flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              p_dtype: torch.dtype | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_attention_bwd`: the kernels'
    formulas over the same key tiles of :data:`KV_TILE`, in float32.

    ``o`` and ``lse`` are the forward's output and row log-sum-exp, ``do``
    the output's gradient.  ``Delta = rowsum(dO * O)``; per key tile ``P =
    exp(S scale - lse)`` (0 where masked), ``dV = P~^T dO`` (``P~`` rounded
    to bf16 when ``p_dtype`` is), ``dS = P (dP - Delta)``, ``dK = scale
    dS^T Q`` (the group's query heads summed), ``dQ += scale dS K``.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kv, g, d).float()
    dog = do.reshape(b, s, kv, g, d).float()
    kf, vf = k.float(), v.float()
    delta = (dog * o.reshape(b, s, kv, g, d).float()).sum(-1).permute(0, 2, 3, 1)
    lse_g = lse.float().reshape(b, kv, g, s)
    dq = torch.zeros((b, s, kv, g, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, t, kv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, t, kv, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, KV_TILE):
        k1 = min(k0 + KV_TILE, t)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, k0:k1]) * scale
        p = torch.exp(sc - lse_g[..., None])
        p = torch.where(_keep(s, k0, k1, causal, window, q.device), p, 0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf[:, k0:k1])
        ds = p * (dp - delta[..., None])
        p_mm = p.to(p_dtype).float() if p_dtype is not None else p
        dv[:, k0:k1] = torch.einsum("bhgqk,bqhgd->bkhd", p_mm, dog)
        dk[:, k0:k1] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kf[:, k0:k1]) * scale
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The "fma" route's tiles (csrc/flash_attention.cu, FB_*): a dK/dV block
# owns FMA_BWD_KEYS keys and walks items of FMA_BWD_QUERIES queries of one
# query head; its walk is split over a thread-block cluster of at most
# FMA_BWD_MAX_RANKS blocks.  A dQ block owns FMA_BWD_QUERIES queries.
FMA_BWD_KEYS, FMA_BWD_QUERIES, FMA_BWD_MAX_RANKS = 64, 32, 8


def fma_dkdv_query_tiles(kt: int, s: int, t: int, causal: bool, window: int
                         ) -> tuple[int, int]:
    """``(qt0, n_qt)``: the query tiles ``[qt0, qt0 + n_qt)`` of
    FMA_BWD_QUERIES rows whose rows keep a key of key tile ``kt`` (causal:
    from its first key on; a window: up to its last key + window - 1).
    The tile's items are (head gi, query tile qt0 + j) in the order ``gi *
    n_qt + j``, gi over the G query heads of the KV head."""
    k0 = kt * FMA_BWD_KEYS
    k_last = min(k0 + FMA_BWD_KEYS, t) - 1
    q_lo = k0 if causal else 0
    q_hi = min(s - 1, k_last + window - 1) if window > 0 else s - 1
    qt0 = q_lo // FMA_BWD_QUERIES
    return qt0, (q_hi // FMA_BWD_QUERIES - qt0 + 1 if q_lo <= q_hi else 0)


def fma_dkdv_ranks(batch: int, s: int, t: int, h: int, kv: int, d: int, causal: bool,
                   window: int) -> int:
    """The cluster size R of the "fma" dK/dV launch, a pure function of the
    shape (``csrc/flash_attention.cu:fb_dkdv_ranks``): the largest power of
    two up to FMA_BWD_MAX_RANKS that keeps the grid (batch * kv * key tiles
    * R blocks) within one wave (build.split_ranks; at D >= 112 a block
    fills an SM's shared memory, so half of ONE_WAVE_BLOCKS) and gives
    every rank of the busiest key tile an item.  train_lm's attention (B =
    4, S = T = 192, 12 heads over 4, D = 64, causal): 48 key tiles, the
    busiest with 18 items, R = 4."""
    n_kt = -(-t // FMA_BWD_KEYS)
    most = max((h // kv * fma_dkdv_query_tiles(kt, s, t, causal, window)[1]
                for kt in range(n_kt)), default=0)
    wave = build.ONE_WAVE_BLOCKS // 2 if d >= 112 else build.ONE_WAVE_BLOCKS
    return build.split_ranks(batch * kv * n_kt, FMA_BWD_MAX_RANKS, most, wave=wave)


def fma_dkdv_plan(batch: int, s: int, t: int, h: int, kv: int, d: int, causal: bool,
                  window: int) -> dict:
    """The "fma" dK/dV launch's plan: ``ranks`` and, per key tile,
    ``(qt0, n_qt, bounds)`` with ``bounds`` the R + 1 item indices that cut
    the tile's items into the ranks' contiguous shares (rank r walks
    ``[bounds[r], bounds[r + 1])``), as the kernel cuts them."""
    ranks = fma_dkdv_ranks(batch, s, t, h, kv, d, causal, window)
    tiles = []
    for kt in range(-(-t // FMA_BWD_KEYS)):
        qt0, n_qt = fma_dkdv_query_tiles(kt, s, t, causal, window)
        n = h // kv * n_qt
        tiles.append((qt0, n_qt, [n * r // ranks for r in range(ranks + 1)]))
    return dict(ranks=ranks, tiles=tiles)


def fma_dkdv_plan_on_device(batch: int, s: int, t: int, h: int, kv: int, d: int,
                            causal: bool, window: int) -> dict:
    """The plan the C launcher computes for the same shape
    (``repro_flash_attention_bwd_dkdv_clusters``), in
    :func:`fma_dkdv_plan`'s form, plus ``clusters_per_wave``: how many
    clusters of R blocks the current CUDA device runs at once."""
    n_kt = -(-t // FMA_BWD_KEYS)
    buf = (ctypes.c_int * (3 + n_kt * (FMA_BWD_MAX_RANKS + 3)))()
    build.load_library().call("repro_flash_attention_bwd_dkdv_clusters", batch, s, t, h, kv,
                              d, int(causal), int(window), ctypes.addressof(buf), len(buf))
    ranks, clusters = buf[0], buf[1]
    tiles = []
    for kt in range(buf[2]):
        p = buf[3 + kt * (ranks + 3):3 + (kt + 1) * (ranks + 3)]
        tiles.append((p[0], p[1], list(p[2:])))
    return dict(ranks=ranks, tiles=tiles, clusters_per_wave=clusters)


def _count_bwd(fn, dtype: torch.dtype, route: str | None = None) -> None:
    fn.launches += 1
    fn.launches_by_dtype[str(dtype).removeprefix("torch.")] += 1
    if route is not None:
        fn.launches_by_route[route] += 1


# Delta's kernel (csrc/flash_attention.cu, FD_*): each warp loads
# DELTA_GROUPS groups of rows before it adds any; the passes spread over
# about one block an SM of an H100 (DELTA_SMS), up to DELTA_MAX_WARPS warps
# a block, 64 resident warps an SM, one wave at most
DELTA_GROUPS, DELTA_SMS, DELTA_MAX_WARPS, DELTA_SM_WARPS = 2, 132, 32, 64
DELTA_VARIANTS = ("vec16", "scalar")


def delta_variant(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """Delta's variant, a pure function of dtype, head size and alignment
    (``aligned``: o's and dO's bases on 16-byte boundaries): ``"vec16"``
    (16-byte loads) where every row is a whole number of 16-byte chunks
    and the bases are aligned, else ``"scalar"`` (masked element loads of
    the same chunks, the same sums)."""
    return "vec16" if d % (16 // dtype.itemsize) == 0 and aligned else "scalar"


def delta_plan(dtype: torch.dtype, d: int, n_rows: int) -> dict:
    """Delta's launch for ``n_rows`` rows of head size ``d``
    (``csrc/flash_attention.cu:fd_plan``): ``lanes`` a row (its 16-byte
    chunks rounded up to a power of two), ``rows_per_warp`` at a time;
    ``passes`` of DELTA_GROUPS such groups; ``warps`` a block, about the
    passes over DELTA_SMS (at most DELTA_MAX_WARPS); ``blocks``, within one
    wave (warps walk their passes by grid stride)."""
    chunks = d // (16 // dtype.itemsize)
    lanes = 1 << max(chunks - 1, 0).bit_length()
    passes = -(-n_rows // (32 // lanes * DELTA_GROUPS))
    warps = min(max(-(-passes // DELTA_SMS), 1), DELTA_MAX_WARPS)
    return dict(lanes=lanes, rows_per_warp=32 // lanes, passes=passes, warps=warps,
                blocks=min(-(-passes // warps), DELTA_SMS * (DELTA_SM_WARPS // warps)))


def delta_plan_on_device(dtype: torch.dtype, batch: int, s: int, h: int, d: int) -> dict:
    """The launch the C entry point makes for Delta at (batch, s, h, d)
    (``repro_flash_attention_bwd_delta_plan``): ``lanes``, ``warps`` and
    ``blocks``, to hold :func:`delta_plan` against."""
    buf = (ctypes.c_int * 3)()
    build.load_library().call("repro_flash_attention_bwd_delta_plan",
                              int(dtype == torch.bfloat16), batch, s, h, d,
                              ctypes.addressof(buf), len(buf))
    return dict(zip(("lanes", "warps", "blocks"), buf[:3]))


def delta_in_kernel_order(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``Delta = rowsum(dO * O)`` (float32 (B, H, S)) as Delta's kernel
    adds it, in plain PyTorch: the same bits on any device.

    Each row's 16-byte chunks (4 float32 or 8 bf16 elements) go one to a
    lane; a lane rounds its E products in float32 (no FMA) and adds them
    pairwise, ``(p0 + p1) + (p2 + p3)``; lanes past the row's chunks add
    0; then the lanes by a shuffle tree, lane l + o into lane l for o =
    lanes / 2, ..., 1 (:func:`delta_plan`'s ``lanes``).  Every step is one
    elementwise float32 operation, which rounds the same on every device.
    """
    b, s, h, d = o.shape
    e = 16 // o.element_size()
    lanes = delta_plan(o.dtype, d, 1)["lanes"]
    acc = (do.float() * o.float()).reshape(b * s * h, d // e, e)
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    acc = torch.nn.functional.pad(acc[..., 0], (0, lanes - d // e))
    width = lanes // 2
    while width:
        acc = acc[:, :width] + acc[:, width:2 * width]
        width //= 2
    return acc[:, 0].reshape(b, s, h).permute(0, 2, 1).contiguous()


def flash_attention_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``Delta = rowsum(dO * O)``, float32 (B, H, S), for ``o`` and ``do``
    (B, S, H, D) of one dtype: one CUDA launch (counted, by dtype, and by
    dtype and :func:`delta_variant`), bit for bit
    :func:`delta_in_kernel_order`; plain on the CPU."""
    dev = build.check_tensors(build.FLOAT_DTYPES, o=o, do=do)
    if o.shape != do.shape or o.dtype != do.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         "must share shape and dtype")
    b, s, h, d = o.shape
    if dev.type == "cpu":
        return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not supported; the kernel takes {HEAD_DIMS}")
    variant = delta_variant(o.dtype, d, build.aligned16(o, do))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        build.load_library().call(
            "repro_flash_attention_bwd_delta", o.data_ptr(), do.data_ptr(),
            int(o.dtype == torch.bfloat16), delta.data_ptr(), b, s, h, d,
            int(variant == "vec16"), build.current_stream(dev))
    _count_bwd(flash_attention_bwd_delta, o.dtype)
    by_variant = flash_attention_bwd_delta.launches_by_variant
    by_variant[str(o.dtype).removeprefix("torch.")][variant] += 1
    return delta


def _bwd_operands(q, k, v, do, lse, delta) -> tuple[str, tuple, tuple]:
    """The route (:func:`flash_attention_bwd_route`) and the pointers and
    sizes the dK/dV and dQ entry points share (the FMA ones also take
    ``is_bf16`` after dO)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    route = flash_attention_bwd_route(q.dtype, d, build.aligned16(q, k, v, do))
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr()]
    if route == "fma":
        ptrs.insert(4, int(q.dtype == torch.bfloat16))
    return route, tuple(ptrs), (b, s, t, h, kv, d)


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True, window: int = 0,
                             p_dtype: torch.dtype | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """dK and dV (B, T, KV, D) in k's dtype: one CUDA launch (counted, by
    dtype and by route) per (batch, KV head, 64-key tile), on the tensor
    cores (``"mma"``: a block of 8 warps) or on float32 FMA (``"fma"``: a
    cluster of :func:`fma_dkdv_ranks` blocks that split the tile's (head,
    32-query tile) items and add their sums in rank order).  No fallback:
    a failed launch raises.  CUDA tensors only, checked by
    :func:`flash_attention_bwd`."""
    route, ptrs, dims = _bwd_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    scale, p_bf16 = 1.0 / math.sqrt(dims[-1]), int(p_dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = build.current_stream(q.device)
        if route == "mma":
            build.load_library().call(
                "repro_flash_attention_bwd_dkdv_mma", *ptrs, dk.data_ptr(), dv.data_ptr(),
                *dims, int(causal), int(window), scale, p_bf16, stream)
        else:
            build.load_library().call(
                "repro_flash_attention_bwd_dkdv", *ptrs, dk.data_ptr(), dv.data_ptr(), *dims,
                int(causal), int(window), scale, p_bf16, stream)
    _count_bwd(flash_attention_bwd_dkdv, q.dtype, route)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """dQ (B, S, H, D) in q's dtype: one CUDA launch (counted, by dtype and
    by route), on the tensor cores (``"mma"``: a block of 8 warps per 128
    rows of the (q position, group member) index, as the forward) or on
    float32 FMA (``"fma"``: a block per (batch, head, 32 queries)).  No
    fallback.  CUDA tensors only, checked by :func:`flash_attention_bwd`."""
    route, ptrs, dims = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    entry = "repro_flash_attention_bwd_dq_mma" if route == "mma" else \
        "repro_flash_attention_bwd_dq"
    with torch.cuda.device(q.device):
        build.load_library().call(entry, *ptrs, dq.data_ptr(), *dims, int(causal),
                                  int(window), 1.0 / math.sqrt(dims[-1]),
                                  build.current_stream(q.device))
    _count_bwd(flash_attention_bwd_dq, q.dtype, route)
    return dq


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, p_dtype: torch.dtype | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's backward: ``(dq, dk, dv)`` in the inputs' dtypes from the
    forward's operands, its output ``o`` and row log-sum-exp ``lse``
    (float32 (B, H, S)) and the output's gradient ``do`` (taken in q's
    dtype).  For CUDA tensors three launches (Delta, dK/dV, dQ; the last two
    on :func:`flash_attention_bwd_route`'s route); for CPU tensors
    :func:`flash_attention_bwd_plain`; for ``meta`` tensors empty
    gradients.  Each of the three kernels records its operation under a
    counter (:func:`backward_costs`), on every device."""
    dev = _check(q, k, v, p_dtype, window)
    do = do.to(q.dtype).contiguous()
    build.check_tensors(build.FLOAT_DTYPES, allow_meta=True, q=q, o=o, do=do)
    b, s, h, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"need o and do {tuple(q.shape)} and lse {(b, h, s)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    for fn in BWD_KERNELS:
        build.record_operation(fn.__name__, lambda name=fn.__name__: backward_costs(
            q, k, v, causal, window)[name])
    if dev.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dev.type == "cpu":
        with build.uncounted():
            return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                             window=window, p_dtype=p_dtype)
    lse = lse.float().contiguous()
    delta = flash_attention_bwd_delta(o.to(q.dtype), do)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=causal, window=window,
                                      p_dtype=p_dtype)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal, window=window)
    return dq, dk, dv


# the backward's CUDA kernels; each counts its launches, in all and by the
# inputs' dtype, dK/dV and dQ also by route and Delta by variant
# (plain-version calls do not count)
BWD_KERNELS = (flash_attention_bwd_delta, flash_attention_bwd_dkdv, flash_attention_bwd_dq)
BWD_ROUTED = (flash_attention_bwd_dkdv, flash_attention_bwd_dq)
BWD_DTYPES = ("float32", "bfloat16")
for _fn in BWD_KERNELS:
    _fn.launches = 0
    _fn.launches_by_dtype = dict.fromkeys(BWD_DTYPES, 0)
for _fn in BWD_ROUTED:
    _fn.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_bwd_delta.launches_by_variant = {dt: dict.fromkeys(DELTA_VARIANTS, 0)
                                                  for dt in BWD_DTYPES}


class FlashAttention(torch.autograd.Function):
    """K8 with its hand-written backward: the forward (one K8 launch on
    the card, with the row log-sum-exp) saves q, k, v, the output and
    ``lse``; the backward is :func:`flash_attention_bwd`.  Called as
    ``FlashAttention.apply(q, k, v, causal, window, p_dtype)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, p_dtype):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window, p_dtype=p_dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, p_dtype=p_dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None
