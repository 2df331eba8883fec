"""Port parity: the Mamba2 / SSD block (``repro_torch.models.ssm``) against
the reference's ``repro.models.ssm`` on the same inputs.

Inputs come from numpy seeds.  ``ssd_chunked`` runs at the reference's
own grid (tests/test_ssm_moe.py:30-52), the init-state continuation
included; float32 results are held within 1e-5 of their largest element
(the chunked products add in other orders), and the port's SSD is also
held against the naive recurrence with the reference test's 2e-3 bar.
The block's bf16 path (Mamba2-370M's dtype, float32 conv and SSD state)
is held within 2e-2 of max|y|: the two packages round the same bf16
intermediates from float32 sums taken in other orders.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import FLOAT32_LEAVES  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), err


def _ssd_inputs(seed, bsz, l, h, p, n, g):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, l, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (bsz, l, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, h).astype(np.float32),
            rng.standard_normal((bsz, l, g, n)).astype(np.float32),
            rng.standard_normal((bsz, l, g, n)).astype(np.float32))


def _naive_ssd(x, dt, a, b_mat, c_mat):
    """h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t, in float64."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[3]
    rep = h // b_mat.shape[2]
    y = np.zeros((bsz, l, h, p))
    state = np.zeros((bsz, h, p, n))
    for t in range(l):
        for head in range(h):
            grp = head // rep
            decay = np.exp(dt[:, t, head] * a[head])
            outer = dt[:, t, head, None, None] * x[:, t, head, :, None] * b_mat[:, t, grp, None, :]
            state[:, head] = decay[:, None, None] * state[:, head] + outer
            y[:, t, head] = np.einsum("bn,bpn->bp", c_mat[:, t, grp], state[:, head])
    return y, state


@pytest.mark.parametrize("l,chunk,h,p,n,g", [
    (32, 8, 2, 4, 8, 1),
    (64, 16, 4, 8, 16, 2),
    (48, 48, 2, 4, 8, 1),   # single chunk
])
def test_ssd_chunked_matches_reference(l, chunk, h, p, n, g):
    x, dt, a, b_mat, c_mat = _ssd_inputs(l + h, 2, l, h, p, n, g)
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b_mat, c_mat)), chunk=chunk)
    ty, ts = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b_mat, c_mat)), chunk=chunk)
    _close(ty, jy)
    _close(ts, js)
    y_want, s_want = _naive_ssd(x, dt, a, b_mat, c_mat)
    np.testing.assert_allclose(ty.numpy(), y_want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), s_want, rtol=2e-3, atol=2e-3)


def test_ssd_init_state_continuation():
    """The second half with the first half's state carried in equals the
    whole sequence, and the reference's continuation."""
    x, dt, a, b_mat, c_mat = _ssd_inputs(5, 1, 32, 2, 4, 8, 1)
    args = [torch.from_numpy(v) for v in (x, dt, a, b_mat, c_mat)]
    y_full, s_full = tssm.ssd_chunked(*args, chunk=8)
    first = [v[:, :16] if v.ndim > 1 else v for v in args]
    second = [v[:, 16:] if v.ndim > 1 else v for v in args]
    _, s1 = tssm.ssd_chunked(*first, chunk=8)
    y2, s2 = tssm.ssd_chunked(*second, chunk=8, init_state=s1)
    _close(y2, y_full[:, 16:])
    _close(s2, s_full)
    jargs = [jnp.asarray(v.numpy()) for v in second]
    jy2, js2 = jssm.ssd_chunked(*jargs, chunk=8, init_state=jnp.asarray(s1.numpy()))
    _close(y2, jy2)
    _close(s2, js2)


def test_ssd_length_must_be_a_multiple_of_the_chunk():
    """The reference asserts l % chunk == 0; the port raises and pads nothing."""
    args = [torch.from_numpy(v) for v in _ssd_inputs(1, 1, 24, 2, 4, 8, 1)]
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.ssd_chunked(*args, chunk=16)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(9)
    seg = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    _close(tssm._causal_conv(*map(torch.from_numpy, (seg, w, bias))),
           jssm._causal_conv(*map(jnp.asarray, (seg, w, bias))))
    # causal: output t sees inputs <= t only
    moved = seg.copy()
    moved[:, 6:] += 1.0
    a = tssm._causal_conv(*map(torch.from_numpy, (seg, w, bias)))
    b = tssm._causal_conv(*map(torch.from_numpy, (moved, w, bias)))
    assert torch.equal(a[:, :6], b[:, :6]) and not torch.equal(a[:, 6:], b[:, 6:])


def _mamba_pair(dtype: str):
    """The SMOKE Mamba2 config in ``dtype``, one reference block and the
    port's copy (float32 leaves float32)."""
    jcfg = dataclasses.replace(jget_smoke("mamba2_370m"), dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config("mamba2_370m"), dtype=dtype, param_dtype=dtype)
    jp = jblocks.init_mamba_block(jax.random.PRNGKey(4), jcfg)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tp = tblocks.MambaBlock(**{
        k: torch.from_numpy(np.array(v, np.float32)).to(torch.float32 if k in FLOAT32_LEAVES
                                                        else tdt)
        for k, v in jp.items()})
    for k, v in jp.items():
        assert str(getattr(tp, k).dtype).removeprefix("torch.") == str(v.dtype), k
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
def test_mamba2_forward_and_decode_match_reference(dtype, tol):
    """mamba2_forward (two chunks) and its final state, then three
    mamba2_decode steps from that state and a random conv window."""
    jcfg, jp, cfg, tp = _mamba_pair(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(11)
    bsz, l = 2, 2 * cfg.ssm_chunk
    xj = jnp.asarray(rng.standard_normal((bsz, l, cfg.d_model)), jdt)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(tdt)
    jy, js = jssm.mamba2_forward(xj, jp, jcfg)
    with torch.inference_mode():
        ty, ts = tssm.mamba2_forward(xt, tp, cfg)
    assert ty.dtype == tdt and ts.dtype == torch.float32
    _close(ty, jy, tol)
    _close(ts, js, tol)

    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv_j = jnp.asarray(rng.standard_normal((bsz, cfg.ssm_conv - 1, conv_dim)), jdt)
    conv_t = torch.from_numpy(np.array(conv_j, np.float32)).to(tdt)
    state_j, state_t = js, ts
    for step in range(3):
        x1j = jnp.asarray(rng.standard_normal((bsz, 1, cfg.d_model)), jdt)
        x1t = torch.from_numpy(np.array(x1j, np.float32)).to(tdt)
        jo, conv_j, state_j = jssm.mamba2_decode(x1j, jp, jcfg, conv_j, state_j)
        with torch.inference_mode():
            to, conv_t, state_t = tssm.mamba2_decode(x1t, tp, cfg, conv_t, state_t)
        _close(to, jo, tol)
        _close(conv_t, conv_j, tol)
        _close(state_t, state_j, tol)


def test_mamba2_forward_rejects_a_ragged_prompt():
    _, _, cfg, tp = _mamba_pair("float32")
    x = torch.zeros(1, cfg.ssm_chunk + 4, cfg.d_model)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.mamba2_forward(x, tp, cfg)
    y, _ = tssm.mamba2_forward(x[:, :cfg.ssm_chunk - 4], tp, cfg)   # one short chunk
    assert y.shape == (1, cfg.ssm_chunk - 4, cfg.d_model)
