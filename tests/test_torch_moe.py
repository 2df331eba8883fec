"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the same inputs.

Inputs come from numpy seeds.  Float32 outputs are held within 1e-5 of
max|y| (the experts' products and the combine add in other orders) and
the aux loss within 1e-6 relative; the kept (token, choice) pairs are
held exactly against the capacity rule the reference implements (within
an expert, pairs in flat order ``token * k + j``, the first ``cap``
kept), with ties between router probabilities broken to the lower
expert index as ``lax.top_k`` does.  bf16 activations with the float32
router take the reference's type promotion: bf16 bar 2e-2 of max|y|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402

from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-5


def _params(seed, e, d, f, router_scale=0.1):
    rng = np.random.default_rng(seed)
    return {
        "w_router": (rng.standard_normal((d, e)) * router_scale).astype(np.float32),
        "w_gate": (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32),
        "w_up": (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32),
        "w_down": (rng.standard_normal((e, f, d)) * 0.05).astype(np.float32),
    }


def _pair(p: dict, dtype=jnp.float32):
    """The reference's dict and the port's module; non-router leaves in
    ``dtype``, the router float32 (as both packages keep it)."""
    jp = {k: jnp.asarray(v, jnp.float32 if k == "w_router" else dtype) for k, v in p.items()}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = tblocks.MoE(*(torch.from_numpy(np.array(jp[k], np.float32)).to(
        torch.float32 if k == "w_router" else tdt)
        for k in ("w_router", "w_gate", "w_up", "w_down")))
    return jp, tp


def _close(got, want, tol=TOL):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), err


def _kept_by_rule(top_i: np.ndarray, cap: int, n_experts: int) -> np.ndarray:
    """(n, k) bool: within each expert, the first ``cap`` pairs in flat
    order are kept."""
    flat = top_i.reshape(-1)
    kept = np.zeros(flat.shape, bool)
    for e in range(n_experts):
        kept[np.flatnonzero(flat == e)[:cap]] = True
    return kept.reshape(top_i.shape)


@pytest.mark.parametrize("n,n_experts,top_k,factor", [
    (64, 4, 2, 8.0),        # nothing dropped
    (64, 8, 4, 1.25),       # the default factor
    (128, 4, 2, 0.5),       # tight: half the pairs dropped
    (40, 8, 2, 2.0),        # the decode factor
])
def test_moe_ffn_matches_reference_with_drops(n, n_experts, top_k, factor):
    rng = np.random.default_rng(n + n_experts)
    d, f = 16, 32
    x = rng.standard_normal((n, d)).astype(np.float32)
    jp, tp = _pair(_params(n, n_experts, d, f), jnp.float32)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, n_experts=n_experts, top_k=top_k,
                            capacity_factor=factor)
    ty, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, n_experts=n_experts, top_k=top_k,
                            capacity_factor=factor)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    # the kept pairs: the capacity rule on the reference's own top-k
    cap = jmoe.moe_capacity(n, n_experts, top_k, factor)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["w_router"], axis=-1)
    _, jtop = jax.lax.top_k(probs, top_k)
    route = tmoe.moe_route(torch.from_numpy(x)[None], tp.w_router, n_experts=n_experts,
                           top_k=top_k, capacity_factor=factor)
    np.testing.assert_array_equal(route["top_i"][0].numpy(), np.asarray(jtop))
    kept = (route["pair_slot"][0] < route["src_for_slot"].numel()).numpy()
    np.testing.assert_array_equal(kept, _kept_by_rule(np.asarray(jtop), cap, n_experts))
    assert int(route["used"].sum()) == int(kept.sum())
    if factor < 1:
        assert not kept.all()


def test_router_ties_go_to_the_lower_expert():
    """A zero router makes every probability equal: lax.top_k picks experts
    0..k-1 for every token, capacity drops the late tokens, and the port
    picks and drops the same."""
    n, e, k, d, f = 48, 4, 2, 8, 16
    x = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    p = _params(1, e, d, f)
    p["w_router"][:] = 0.0
    jp, tp = _pair(p)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, n_experts=e, top_k=k)
    ty, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, n_experts=e, top_k=k)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    route = tmoe.moe_route(torch.from_numpy(x)[None], tp.w_router, n_experts=e, top_k=k)
    assert (route["top_i"][0] == torch.arange(k)).all()
    cap = tmoe.moe_capacity(n, e, k)
    kept = route["pair_slot"][0] < route["src_for_slot"].numel()
    assert kept[:cap].all() and not kept[cap:].any()


@pytest.mark.parametrize("n,groups", [(64, 4), (60, 8)])   # 60 % 8 != 0: flat
def test_moe_ffn_grouped_matches_reference(n, groups):
    rng = np.random.default_rng(n)
    d, f, e, k = 16, 32, 8, 2
    x = rng.standard_normal((n, d)).astype(np.float32)
    jp, tp = _pair(_params(2, e, d, f))
    jy, jaux = jmoe.moe_ffn_grouped(jnp.asarray(x), jp, n_experts=e, top_k=k, groups=groups)
    ty, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, n_experts=e, top_k=k, groups=groups)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if n % groups == 0:
        # group-local capacity: each group fills its own
        route = tmoe.moe_route(torch.from_numpy(x).reshape(groups, n // groups, d),
                               tp.w_router, n_experts=e, top_k=k)
        assert route["cap"] == jmoe.moe_capacity(n // groups, e, k)


def test_moe_ffn_bf16_takes_the_reference_promotion():
    """bf16 activations and experts, float32 router: the router product is
    float32 in both packages; the outputs agree within bf16 rounding."""
    n, d, f, e, k = 64, 32, 64, 8, 2
    x = np.random.default_rng(7).standard_normal((n, d)).astype(np.float32)
    jp, tp = _pair(_params(3, e, d, f), jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).bfloat16()
    jy, jaux = jmoe.moe_ffn(xj, jp, n_experts=e, top_k=k)
    ty, taux = tmoe.moe_ffn(xt, tp, n_experts=e, top_k=k)
    assert ty.dtype == torch.bfloat16 and tp.w_router.dtype == torch.float32
    _close(ty, jy, 2e-2)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_capacity_matches_reference():
    for n in (1, 4, 40, 375, 2000, 6000):
        for e, k in ((8, 2), (32, 8), (4, 2)):
            for factor in (0.5, 1.25, 2.0):
                assert tmoe.moe_capacity(n, e, k, factor) == jmoe.moe_capacity(n, e, k, factor)
