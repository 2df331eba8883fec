"""Port parity: the gradient of attention — K8's hand-written backward
(``FlashAttention``, its plain version ``flash_attention_bwd_plain`` on
the CPU) against ``jax.vjp`` of the reference's pure-JAX attention
(``repro.models.attention.flash_attention``, which the reference's
training differentiates; it has no backward kernel).

Float32 inputs drawn with numpy.  With p kept float32 the gradients are
held within 1e-5 of each array's largest element and the forward's row
log-sum-exp within 1e-6 of its largest (against a float64 log-sum-exp of
the masked scores).  With p rounded to bf16 both packages round p on
their own tile edges (the port against the running max of its 64-key
tiles, the reference against its 512-key tiles) and the reference also
rounds dP through its cast's transpose, so the two differ by bf16
roundings: 1e-2 of the largest element, the bar of the forward's test
with p rounded (tests/test_torch_attention.py).  ``tests/test_torch_cuda.py``
holds the CUDA kernels against the plain backward on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402

from repro_torch.kernels import flash_attention as k8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL, TOL_LSE, TOL_P_BF16 = 1e-5, 1e-6, 1e-2

# (b, s, t, h, kv, d, causal, window): G = 1, 2 and 4; causal, a window,
# non-causal with S != T (cross attention); D = 16, 64 and 112; ragged
# lengths past one 64-key tile
CASES = [
    (2, 70, 70, 4, 4, 16, True, 0),
    (1, 130, 130, 4, 2, 64, True, 0),
    (2, 100, 100, 8, 2, 16, True, 24),
    (1, 40, 150, 4, 1, 64, False, 0),
    (1, 96, 96, 4, 2, 112, True, 0),
    (2, 77, 33, 8, 4, 112, False, 0),
    (1, 150, 150, 4, 1, 16, True, 70),
]


def _ids(case):
    b, s, t, h, kv, d, causal, window = case
    return f"s{s}_t{t}_g{h // kv}_d{d}_{'causal' if causal else 'full'}_w{window}"


def _operands(seed, b, s, t, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d))]


def _close(got, want, tol, label):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{label}: {err} vs {np.abs(want).max()}"


def _reference(q, k, v, do, causal, window, p_dtype):
    out, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal=causal, window=window, p_dtype=p_dtype), q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _lse64(q, k, causal, window):
    """Each row's log-sum-exp of the masked scaled scores, float64, (B, H, S)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    sc = np.einsum("bqhgd,bkhd->bhgqk", q.reshape(b, s, kv, h // kv, d).astype(np.float64),
                   k.astype(np.float64)) / math.sqrt(d)
    qpos, kpos = np.arange(s)[:, None], np.arange(t)[None, :]
    ok = np.ones((s, t), bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    sc = np.where(ok, sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(sc - m).sum(-1))).reshape(b, h, s)


@pytest.mark.parametrize("p_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_attention_grad_matches_jax_vjp(case, p_dtype):
    """The port's flash_attention under grad mode (the FlashAttention
    Function: the forward with lse, then flash_attention_bwd on the CPU)
    against jax.vjp of the reference's attention."""
    b, s, t, h, kv, d, causal, window = case
    q, k, v, do = _operands(17, b, s, t, h, kv, d)
    want = _reference(q, k, v, do, causal, window,
                      None if p_dtype is None else jnp.bfloat16)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(qt, kt, vt, causal=causal, window=window,
                                p_dtype=None if p_dtype is None else torch.bfloat16)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    tol = TOL if p_dtype is None else TOL_P_BF16
    for label, got, w in zip(("out", "dq", "dk", "dv"), (out, qt.grad, kt.grad, vt.grad), want):
        _close(got, w, tol, f"{label} {case} p={p_dtype}")


@pytest.mark.parametrize("case", CASES[:4], ids=_ids)
def test_forward_lse_matches_float64(case):
    """flash_attention_lse (the plain version on the CPU) gives the output
    of flash_attention and each row's log-sum-exp within 1e-6 of max|lse|."""
    b, s, t, h, kv, d, causal, window = case
    q, k, v, _ = _operands(23, b, s, t, h, kv, d)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out, lse = k8.flash_attention_lse(qt, kt, vt, causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert torch.equal(out, k8.flash_attention(qt, kt, vt, causal=causal, window=window))
    _close(lse, _lse64(q, k, causal, window), TOL_LSE, f"lse {case}")
    none_out, none_lse = k8.flash_attention_lse(qt, kt, vt, causal=causal, window=window,
                                                lse=False)
    assert none_lse is None and torch.equal(none_out, out)


@pytest.mark.parametrize("case", CASES[2:5], ids=_ids)
def test_function_backward_is_the_plain_backward(case):
    """On the CPU the Function's backward is flash_attention_bwd_plain on the
    saved operands, output and lse, bit for bit; Delta is rowsum(dO * O)."""
    b, s, t, h, kv, d, causal, window = case
    q, k, v, do = map(torch.from_numpy, _operands(29, b, s, t, h, kv, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = k8.FlashAttention.apply(*leaves, causal, window, None)
    out.backward(do)
    o, lse = k8.flash_attention_plain_lse(q, k, v, causal=causal, window=window)
    want = k8.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window)
    for got, w in zip((x.grad for x in leaves), want):
        assert torch.equal(got, w)
    assert torch.equal(k8.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                              window=window)[0], want[0])
    delta = k8.flash_attention_bwd_delta(o, do)
    assert delta.shape == (b, h, s)
    torch.testing.assert_close(delta, (do * o).sum(-1).transpose(1, 2), rtol=1e-6, atol=1e-6)


def test_grad_mode_routes_and_cpu_counts_no_launch():
    """Without grad mode, or with no input that requires grad, the call
    stays on the forward alone (no grad_fn); under grad mode it goes
    through FlashAttention.  CPU calls count no launch of any K8 kernel."""
    q, k, v, do = map(torch.from_numpy, _operands(31, 1, 65, 65, 4, 2, 16))
    names = ("flash_attention", "flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dq")
    before = {n: ops.launch_counts()[n] for n in names}
    assert k8.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert k8.flash_attention(qg, k, v).grad_fn is None
    out = k8.flash_attention(qg, k, v)
    assert out.grad_fn is not None
    out.backward(do)
    assert qg.grad is not None and qg.grad.shape == q.shape
    assert {n: ops.launch_counts()[n] for n in names} == before
    with pytest.raises(ValueError, match="lse"):
        k8.flash_attention_bwd(q, k, v, out.detach(), torch.zeros(1, 4, 64), do)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", k8.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_route(dtype, d, aligned):
    """The backward's dK/dV and dQ route, a pure function of dtype, head
    size and alignment: bf16 with q, k, v and dO on the 16-byte grid takes
    the tensor cores ("mma") at every head size; float32, or a bf16 view
    off the grid, takes float32 FMA ("fma")."""
    want = "mma" if dtype == torch.bfloat16 and aligned else "fma"
    assert k8.flash_attention_bwd_route(dtype, d, aligned) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_backward_counts_no_launch_on_either_route(dtype):
    """A backward of CPU tensors (the plain version) counts no launch of the
    dK/dV or dQ kernels on either route, in bf16 as in float32, and gives
    the plain backward's gradients."""
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _operands(37, 1, 70, 70, 4, 2, 32))
    before = ops.launch_counts_bwd_by_route()
    assert set(before) == {"flash_attention_bwd_dkdv", "flash_attention_bwd_dq"}
    assert all(set(r) == {"mma", "fma"} for r in before.values())
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = k8.flash_attention(*leaves)
    out.backward(do)
    assert ops.launch_counts_bwd_by_route() == before
    o, lse = k8.flash_attention_plain_lse(q, k, v)
    want = k8.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for got, w in zip((x.grad for x in leaves), want):
        assert got.dtype == dtype and torch.equal(got, w)
