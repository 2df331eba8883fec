"""Port parity: attention — K8's plain version against the reference's
Pallas kernel in interpret mode, the model's flash attention against
the reference's pure-JAX one, and cached decode attention.

On the CPU the port's attention runs K8's plain PyTorch version;
``tests/test_torch_cuda.py`` holds the Hopper kernel against it on a
CUDA device.  Inputs are drawn with numpy and rounded to the working
dtype once, so both packages see identical operands.  Every case with
G = H / KV > 1 checks the GQA head order (query head h reads KV head
h // G), and KV = 1 is MQA.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402

from repro_torch.kernels import flash_attention as k8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dt: str):
    xj = jnp.asarray(x, JNP[dt])
    return xj, torch.from_numpy(np.array(xj, np.float32)).to(TORCH[dt])


def _qkv(seed, b, s, t, h, kv, d, dt):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(shape).astype(np.float32), dt)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the grid of tests/test_kernels.py:138-175: MHA, GQA, a window, MQA with a
# ragged S, each in float32 and bfloat16, with that test's bars (3e-5 f32;
# 3e-2 bf16, a few bf16 ulps of outputs of order 1)
PALLAS_GRID = [
    (128, 4, 2, 32, True, 0),
    (128, 4, 4, 32, False, 0),
    (192, 8, 2, 16, True, 64),
    (100, 4, 1, 32, True, 0),       # ragged, MQA
    (100, 2, 2, 112, True, 0),      # Zamba2's head size, ragged
    (64, 14, 2, 16, False, 0),      # G = 7, non-causal
    (130, 12, 4, 64, True, 0),      # train_lm's heads (G = 3, D = 64), ragged S
]


@pytest.mark.parametrize("s,h,kv,d,causal,window", PALLAS_GRID)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_k8_plain_matches_pallas_interpret(s, h, kv, d, causal, window, dt):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(s + h, 2, s, s, h, kv, d, dt)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, window=window, q_block=64,
                                  kv_block=64, interpret=True)
    # the port of flash_attention_pallas: p rounded to v's dtype
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 3e-2 if dt == "bfloat16" else 3e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", [
    # (b, s, t, h, kv, d, causal, window)
    (2, 96, 96, 6, 3, 32, True, 0),         # the reference's production pair test
    (1, 130, 130, 8, 2, 64, True, 48),      # window; ragged against the 64-key tile
    (2, 70, 70, 4, 1, 16, False, 0),        # MQA, non-causal, ragged
    (1, 33, 200, 4, 4, 128, False, 0),      # S != T, D = 128
    (1, 90, 90, 14, 2, 64, True, 0),        # InternVL2's G = 7
    (1, 70, 70, 4, 4, 112, True, 0),        # Zamba2's D = 112, G = 1
    (2, 20, 75, 4, 4, 112, False, 0),       # D = 112, cross-attention shape
    (1, 150, 150, 12, 2, 32, True, 64),     # Mixtral's G = 6 with a window
])
@pytest.mark.parametrize("p_dtype", [None, "bfloat16"])
def test_flash_attention_matches_reference(case, p_dtype):
    """The model's flash attention (K8's plain version on the CPU) against
    the reference's pure-JAX blocked attention, float32 inputs.  Bars:
    2e-5 as the reference's own pair test (tests/test_kernels.py:178-192);
    with p rounded to bf16 the two round p against running maxima of
    other key blocks (512 there, 64 here), so 1e-2 — a bf16 ulp of p."""
    b, s, t, h, kv, d, causal, window = case
    (qj, qt), (kj, kt), (vj, vt) = _qkv(sum(case[:6]), b, s, t, h, kv, d, "float32")
    jp = None if p_dtype is None else jnp.bfloat16
    tp = None if p_dtype is None else torch.bfloat16
    want = jattn.flash_attention(qj, kj, vj, causal=causal, window=window, p_dtype=jp)
    got = tattn.flash_attention(qt, kt, vt, causal=causal, window=window, p_dtype=tp)
    tol = 2e-5 if p_dtype is None else 1e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_attention_bf16_matches_reference():
    """bf16 inputs, p kept float32 (Qwen3's setting): the reference's bf16
    bar (3e-2)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, 1, 80, 80, 8, 2, 32, "bfloat16")
    want = jattn.flash_attention(qj, kj, vj, causal=True, q_block=32, kv_block=32)
    got = tattn.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)


def test_window_row_fully_masked_in_first_tile_is_wiped():
    """With a window, rows late in a 64-key tile see no key in the first
    reachable tile; the finite NEG_INF gives p = 1 there and the next
    tile's alpha = 0 wipes it (with -inf it would be NaN).  Held against
    a dense masked softmax in float64."""
    b, s, h, kv, d, window = 1, 160, 2, 1, 16, 40
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    got = k8.flash_attention(q, k, v, causal=True, window=window)
    assert torch.isfinite(got).all()
    sc = torch.einsum("bqhd,bkd->bhqk", q.double(), k[:, :, 0].double()) / np.sqrt(d)
    qpos, kpos = torch.arange(s)[:, None], torch.arange(s)[None, :]
    ok = (kpos <= qpos) & (kpos > qpos - window)
    p = torch.softmax(sc.masked_fill(~ok, -np.inf), dim=-1)
    want = torch.einsum("bhqk,bkd->bqhd", p, v[:, :, 0].double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_k8_wrapper_checks_and_counts_only_cuda_launches():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    before = ops.launch_counts()["flash_attention"]
    k8.flash_attention(q, k, k)                     # CPU: the plain version
    assert ops.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="head size"):
        k8.flash_attention(torch.zeros(1, 8, 4, 24), torch.zeros(1, 8, 2, 24),
                           torch.zeros(1, 8, 2, 24))
    with pytest.raises(ValueError, match="KV divide H"):
        k8.flash_attention(torch.zeros(1, 8, 3, 16), k, k)
    with pytest.raises(TypeError, match="one dtype"):
        k8.flash_attention(q, k.bfloat16(), k)
    for p_dtype in (torch.float16, torch.float32):      # float32 is spelled None
        with pytest.raises(ValueError, match="p_dtype"):
            k8.flash_attention(q, k, k, p_dtype=p_dtype)


@pytest.mark.parametrize("kv", [2, 1])
def test_decode_attention_per_slot_positions(kv):
    """One query per sequence against a cache, at a per-slot (B,) position
    vector (and a scalar), against the reference; float32 and bf16
    caches."""
    b, s, h, d = 3, 24, 4, 16
    rng = np.random.default_rng(kv)
    pos = np.array([5, 23, 0], np.int32)
    for dt, tol in (("float32", 1e-5), ("bfloat16", 3e-2)):
        (qj, qt), (kj, kt), (vj, vt) = [
            _pair(rng.standard_normal(sh).astype(np.float32), dt)
            for sh in ((b, 1, h, d), (b, s, kv, d), (b, s, kv, d))]
        for p in (pos, np.int32(11)):
            want = jattn.decode_attention(qj, kj, vj, jnp.asarray(p))
            got = tattn.decode_attention(qt, kt, vt, torch.as_tensor(p, dtype=torch.int64))
            assert got.dtype == qt.dtype
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
