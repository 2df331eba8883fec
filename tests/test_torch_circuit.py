"""Port parity: the single-circuit modules of repro_torch — the rest of the
Sec. IV transform, the Eq. 25 passivity test, the netlist views, the
crossbar layout, one circuit's state space and transient, its operating
point, component counts and power — against the JAX reference on the CPU,
and the quickstart flow end to end.

Bars (ROADMAP parity contract): float64 arrays within 1e-12 relative,
solutions within 1e-10, counts and flags exactly equal.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro.core import components as jcomp  # noqa: E402
from repro.core import crosspoint as jcross  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import power as jpower  # noqa: E402
from repro.core import sdd as jsdd  # noqa: E402
from repro.core import solve as jsolve  # noqa: E402
from repro.core import transform as jtr  # noqa: E402
from repro.core import transient as jtransient  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_sdd, random_spd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import components as tcomp  # noqa: E402
from repro_torch.core import crosspoint as tcross  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import power as tpower  # noqa: E402
from repro_torch.core import sdd as tsdd  # noqa: E402
from repro_torch.core import transform as ttr  # noqa: E402
from repro_torch.core import transient as ttransient  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# both core packages export a function named like this submodule
jop = importlib.import_module("repro.core.operating_point")
top = importlib.import_module("repro_torch.core.operating_point")

CPU = "cpu"


def _sys(seed, n, *, sdd=False, density=1.0):
    rng = np.random.default_rng(seed)
    a = random_sdd(rng, n) if sdd else random_spd(rng, n, density=density)
    x, b = random_rhs_from_solution(rng, a)
    return a, x, b


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel=1e-12):
    """Within ``rel`` of the largest magnitude of the reference array."""
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rel * scale)


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _nets(a, b, design):
    if design == "proposed":
        return jnet.build_proposed(a, b), tnet.build_proposed(a, b, device=CPU)
    return jnet.build_preliminary(a, b), tnet.build_preliminary(a, b)


# ---------------------------------------------------------------------------
# Transform: eigen split, Eq. 20 margin, cell conductances
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 5), (1, 12), (2, 24)])
def test_transform_extras_match_reference(seed, n):
    a, _x, b = _sys(seed, n)
    jt = jtr.transform_2n(a, b)
    tt = ttr.transform_2n(_t(a), _t(b))
    assert tt.n == jt.n == n
    _close(tt.negative_cell_conductances(), jt.negative_cell_conductances())
    _close(tt.max_conductance(), jt.max_conductance())
    for got, want in zip(ttr.eigen_split(tt), jtr.eigen_split(jt)):
        _close(got, want)
    _close(ttr.stability_condition(_t(a), tt.k_s, tt.d),
           jtr.stability_condition(a, jt.k_s, jt.d))
    # Eq. 18: the minus block's spectrum is spec(A)
    _close(ttr.eigen_split(tt)[0], np.linalg.eigvalsh(a), rel=1e-10)


def test_transform_extras_batched_equal_single():
    """The port's transform takes a leading batch axis; its extras too."""
    sys3 = [_sys(s, 9) for s in (3, 4, 5)]
    a = np.stack([s[0] for s in sys3])
    b = np.stack([s[2] for s in sys3])
    batch = ttr.transform_2n(_t(a), _t(b))
    lam_m, lam_p = ttr.eigen_split(batch)
    for k in range(3):
        one = ttr.transform_2n(_t(a[k]), _t(b[k]))
        _close(batch.negative_cell_conductances()[k], one.negative_cell_conductances())
        _close(batch.max_conductance()[k], one.max_conductance())
        _close(lam_m[k], ttr.eigen_split(one)[0])
        _close(lam_p[k], ttr.eigen_split(one)[1])


# ---------------------------------------------------------------------------
# Eq. 25: the passive path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,sdd", [(6, 10, False), (7, 10, True), (8, 17, True)])
def test_sdd_margin_matches_reference(seed, n, sdd):
    a, _x, b = _sys(seed, n, sdd=sdd)
    got = tsdd.sdd_margin(_t(a), _t(b))
    _close(got, jsdd.sdd_margin(a, b))
    assert bool(tsdd.is_diagonally_dominant(_t(a), _t(b))) == \
        bool(jsdd.is_diagonally_dominant(a, b))
    assert bool(tsdd.is_diagonally_dominant(a, b, device=CPU)) == \
        bool(jsdd.is_diagonally_dominant(a, b))


# Fixed draws of random_sdd.  (1085, 8), (16, 20), (48, 20) and (52, 8) are
# draws on which the reference's random property test
# (tests/test_transform.py::test_sdd_gives_nonpositive_kb_diag) fails:
# their Eq. 25 margin is >= 0 everywhere, yet diag(K_B) is positive at the
# support node 0.
SDD_DRAWS = [(0, 3), (1, 8), (2, 20), (3, 12), (16, 20), (48, 20), (52, 8), (1085, 8)]


@pytest.mark.parametrize("seed,n", SDD_DRAWS)
def test_sdd_margin_bounds_kb_diagonal(seed, n):
    """What Eqs. 22 and 26 do say.  With m = sdd_margin:

    * K_Bii = -m_i / 2 for every node i >= 1, so m_i >= 0 there gives
      diag(K_B)_i <= 0: no negative-resistance cell;
    * at the support node, Eq. 22 puts the whole k_s1 into D, so
      K_B00 = (k_s1 - m_0) / 2: node 0 needs m_0 >= k_s1, not m_0 >= 0.
    """
    a, _x, b = _sys(seed, n, sdd=True)
    tt = ttr.transform_2n(_t(a), _t(b))
    kb = _np(tt.negative_cell_conductances())
    m = _np(tsdd.sdd_margin(_t(a), _t(b)))
    k_s = _np(tt.k_s)
    tol = 1e-12 * np.abs(a).max()
    np.testing.assert_allclose(kb[1:], -0.5 * m[1:], rtol=0.0, atol=tol)
    np.testing.assert_allclose(kb[0], 0.5 * (k_s[0] - m[0]), rtol=0.0, atol=tol)
    assert np.all(kb[1:][m[1:] >= 0] <= tol)
    if m[0] >= k_s[0]:
        assert kb[0] <= tol
    if (seed, n) == (1085, 8):
        # the reference's counterexample: dominant by Eq. 25, a cell at node 0
        assert m.min() >= 0 and bool(tsdd.is_diagonally_dominant(_t(a), _t(b)))
        assert m[0] < k_s[0] and kb[0] > 1e-6
    _close(kb, jtr.transform_2n(a, b).negative_cell_conductances())


# ---------------------------------------------------------------------------
# Netlist views
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", ["proposed", "preliminary"])
def test_netlist_views_match_reference(design):
    a, x, b = _sys(11, 9, density=0.6)
    jn, tn = _nets(a, b, design)
    assert [(c.i, c.j, c.n_amps, c.n_buffers) for c in tn.cells] == \
        [(c.i, c.j, c.n_amps, c.n_buffers) for c in jn.cells]
    _close([c.w for c in tn.cells], [c.w for c in jn.cells])
    _close(tn.assemble_passive(), jn.assemble_passive())
    _close(tn.assemble_dc(), jn.assemble_dc())
    v = np.linalg.solve(tn.assemble_dc(), tn.s)
    np.testing.assert_allclose(tn.recovered_solution(v), x, rtol=0.0, atol=1e-10)
    np.testing.assert_array_equal(tn.recovered_solution(v), jn.recovered_solution(v))


def test_netlist_perturbed_and_wiper_match_reference():
    a, _x, b = _sys(12, 8)
    jn, tn = _nets(a, b, "proposed")
    for jm, tm in ((jn.perturbed(np.random.default_rng(3), 0.01),
                    tn.perturbed(np.random.default_rng(3), 0.01)),
                   (jn.with_wiper(50.0), tn.with_wiper(50.0))):
        for f in ("branch_g", "ground_g", "supply_g", "cell_w"):
            _close(getattr(tm, f), getattr(jm, f))


# ---------------------------------------------------------------------------
# Crosspoint layout (Sec. IV-A4) and K6 on it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(13, 6), (14, 16)])
def test_crosspoint_layout_matches_reference(seed, n):
    a, x, b = _sys(seed, n)
    jt = jtr.transform_2n(a, b)
    tt = ttr.transform_2n(_t(a), _t(b))
    jl = jcross.crosspoint_layout(jt)
    tl = tcross.crosspoint_layout(tt)
    for f in ("g_array", "supply_cols", "ground_row", "external_cells"):
        _close(getattr(tl, f), getattr(jl, f))
    assert tl.supply_v == jl.supply_v
    _close(tl.dc_operator(), jl.dc_operator())
    _close(tl.dc_operator(), tt.assembled())           # the layout round trip
    y = np.concatenate([x, -x])
    _close(tl.mvm_currents(_t(y)), jl.mvm_currents(y))


def test_crossbar_product_through_k6_plain_version():
    """K6's operand is the layout's G: the float32 kernel path (its plain
    version here) against the float64 product, 5e-5 relative (the
    reference's float32 bar)."""
    a, x, b = _sys(15, 20)
    tl = tcross.crosspoint_layout(ttr.transform_2n(_t(a), _t(b)))
    g = tl.g_array
    y = _t(np.concatenate([x, -x]))
    want = g @ y
    got = ops.crosspoint_mvm(g.float(), y.float())
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, rel=5e-5)
    v = _t(np.random.default_rng(0).uniform(-0.5, 0.5, (g.shape[0], 4)))
    _close(ops.crosspoint_mvm(g.float(), v.float()), g @ v, rel=5e-5)


# ---------------------------------------------------------------------------
# One circuit's state space and transient; K5 on its operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", ["proposed", "preliminary"])
def test_state_space_matches_reference(design):
    a, _x, b = _sys(16, 7)
    jn, tn = _nets(a, b, design)
    v_os = np.random.default_rng(1).uniform(-1e-3, 1e-3, jn.n_amps)
    js = jtransient.assemble_state_space(jn, v_os=v_os)
    ts = ttransient.assemble_state_space(tn, v_os=v_os, device=CPU)
    assert ts.n_states == js.n_states
    _close(ts.m, js.m)
    _close(ts.c, js.c)
    for f in ("n_nodes", "n_unknowns", "amp_rail", "slew"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.amp_out_index, js.amp_out_index)
    np.testing.assert_array_equal(ts.amp_int_index, js.amp_int_index)


@pytest.mark.parametrize("design", ["proposed", "preliminary"])
def test_lti_transient_matches_reference(design):
    a, _x, b = _sys(17, 6)
    jn, tn = _nets(a, b, design)
    want = jtransient.lti_transient(jn)
    got = ttransient.lti_transient(tn, device=CPU)
    assert got.stable == want.stable
    np.testing.assert_allclose(got.settle_time, want.settle_time, rtol=1e-6)
    np.testing.assert_allclose(got.x_converged, want.x_converged, rtol=0.0, atol=1e-10)
    np.testing.assert_allclose(got.max_re_eig, want.max_re_eig, rtol=1e-8)
    np.testing.assert_allclose(got.dominant_tau, want.dominant_tau, rtol=1e-8)
    np.testing.assert_allclose(got.mirror_residual, want.mirror_residual, rtol=0.0,
                               atol=1e-10)
    assert ttransient.settling_time is tcore.engine.settling_time


def test_transient_step_on_circuit_operator():
    """K5's operand is one circuit's M: the dt-folded float32 operator
    carried across from the reference, 16 state columns (the zero state
    and 15 random starts), 50 steps of the port's K5 path (plain version
    here) against 50 of the reference's wrapper, 1e-5 of max|z|."""
    a, _x, b = _sys(18, 10)
    js = jtransient.assemble_state_space(jnet.build_proposed(a, b))
    ts = convert.single_state_space_from_arrays(
        js.m, js.c, n_nodes=js.n_nodes, n_unknowns=js.n_unknowns,
        amp_out_index=js.amp_out_index, amp_int_index=js.amp_int_index,
        amp_rail=js.amp_rail, slew=js.slew, device=CPU)
    _close(ts.m, js.m, rel=0.0)
    dt = 0.5 / np.abs(np.diag(js.m)).max()
    m32 = (js.m * dt).astype(np.float32)
    c32 = np.repeat((js.c * dt).astype(np.float32)[:, None], 16, axis=1)
    z0 = np.random.default_rng(2).uniform(-0.5, 0.5, c32.shape).astype(np.float32)
    z0[:, 0] = 0.0
    zt, zj = torch.from_numpy(z0), z0
    mt, ct = torch.from_numpy(m32), torch.from_numpy(c32)
    for _ in range(50):
        zt = ops.transient_step(mt, zt, ct, 1.0)
        zj = jops.transient_step(m32, zj, c32, 1.0, interpret=True)
    zj = np.asarray(zj)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0.0, atol=1e-5 * np.abs(zj).max())


# ---------------------------------------------------------------------------
# Operating point of one circuit
# ---------------------------------------------------------------------------

NONIDEAL = {
    "ideal": (jop.IDEAL, top.IDEAL),
    "default": (jop.DEFAULT_NONIDEAL, top.DEFAULT_NONIDEAL),
    "hardware": (jop.HARDWARE, top.HARDWARE),
}


@pytest.mark.parametrize("model", list(NONIDEAL))
@pytest.mark.parametrize("design", ["proposed", "preliminary"])
def test_operating_point_matches_reference(model, design):
    a, x, b = _sys(19, 8)
    jn, tn = _nets(a, b, design)
    jni, tni = NONIDEAL[model]
    want = jop.operating_point(jn, nonideal=jni, x_ref=x)
    got = top.operating_point(tn, nonideal=tni, x_ref=x, device=CPU)
    for f in ("x", "v", "amp_outputs"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0.0,
                                   atol=1e-10, err_msg=f)
    assert got.amp_saturated == want.amp_saturated
    for f in ("max_rel_error", "max_abs_error", "err_fullscale"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6,
                                   atol=1e-10, err_msg=f)


def test_operating_point_repairs_a_singular_support():
    """b_1 = 0 takes the support node's ground leg (Eq. 22); with a
    diagonal A the node pair (1, n+1) floats, the DC operator is singular,
    and both packages solve it with the 1e-12 max|M| leakage."""
    a = np.eye(2) * 1e-4
    b = np.array([0.0, 1e-4])
    jn, tn = _nets(a, b, "proposed")
    ss = ttransient.assemble_state_space(tn, device=CPU)
    assert int(torch.linalg.solve_ex(ss.m, -ss.c)[1]) != 0
    want = jop.operating_point(jn, nonideal=jop.IDEAL)
    got = top.operating_point(tn, nonideal=top.IDEAL, device=CPU)
    assert np.all(np.isfinite(got.x))
    np.testing.assert_allclose(got.x, want.x, rtol=0.0, atol=1e-10)
    np.testing.assert_allclose(got.x, [0.0, 1.0], rtol=0.0, atol=1e-10)


# ---------------------------------------------------------------------------
# Component counts (Table II) and power (Eq. 31)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", ["proposed", "preliminary"])
def test_component_counts_match_reference(design):
    for n in (1, 2, 7, 24, 100):
        assert tcomp.component_counts(design, n) == jcomp.component_counts(design, n)
        assert tcomp.component_reduction(n) == jcomp.component_reduction(n)
    with pytest.raises(ValueError):
        tcomp.component_counts("passive", 3)
    a, _x, b = _sys(20, 9)
    jn, tn = _nets(a, b, design)
    assert tcomp.netlist_counts(tn) == jcomp.netlist_counts(jn)


def test_system_power_matches_reference():
    a, x, b = _sys(21, 12)
    kb = np.asarray(jtr.transform_2n(a, b).k_b)
    jn = jnet.build_proposed(a, b)
    kw = dict(n_amps=jn.n_amps, n_switches=jcomp.netlist_counts(jn)["analog_switches"])
    want = jpower.system_power(a, kb, x, **kw)
    for got in (tpower.system_power(_t(a), _t(kb), _t(x), **kw),
                tpower.system_power(a, kb, x, device=CPU, **kw),
                tpower.system_power(_t(a), _t(kb), x, device=CPU, **kw)):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=key)
    no_cells = tpower.system_power(_t(a), _t(kb), _t(x), n_amps=0, opamp_name="ideal")
    assert no_cells["gain_resistors_w"] == 0.0 and no_cells["amps_w"] == 0.0


# ---------------------------------------------------------------------------
# Converters, exports, the device rule
# ---------------------------------------------------------------------------


def test_transformed_converter_and_core_exports():
    a, _x, b = _sys(22, 7)
    jt = jtr.transform_2n(a, b)
    tt = convert.transformed_from_arrays(jt.k_a, jt.k_b, jt.d, jt.k_s, jt.b_sign,
                                         supply_v=jt.supply_v, device=CPU)
    _close(tcross.crosspoint_layout(tt).g_array, jcross.crosspoint_layout(jt).g_array)
    _close(tt.assembled(), jt.assembled(), rel=0.0)
    jcore = importlib.import_module("repro.core")
    assert set(jcore.__all__) <= set(tcore.__all__)
    assert all(hasattr(tcore, name) for name in tcore.__all__)


def test_array_inputs_default_to_the_card(monkeypatch):
    """Arrays given without ``device=`` go to CUDA, and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, x, b = _sys(23, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsdd.sdd_margin(a, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpower.system_power(a, a, x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttransient.assemble_state_space(tnet.build_proposed(a, b, device=CPU))


# ---------------------------------------------------------------------------
# The quickstart flow (examples/quickstart.py) at n = 24
# ---------------------------------------------------------------------------


def test_quickstart_flow_matches_reference():
    rng = np.random.default_rng(0)
    n = 24
    a = random_spd(rng, n)
    x_true, b = random_rhs_from_solution(rng, a)

    def flow(solve, nonideal_cls, build_proposed, netlist_counts, transform_2n,
             system_power, **dev):
        out = {}
        res = solve(a, b, method="analog_2n", x_ref=x_true, compute_settling=True, **dev)
        out["2n"] = (res.x, res.settle_time, res.info["max_abs_error"],
                     int(res.info["n_amps"]), bool(res.info["is_passive"]))
        hw = nonideal_cls(offset_mode="none", pot_bits=10, wiper_ohm=50.0)
        res_hw = solve(a, b, method="analog_2n", nonideal=hw, x_ref=x_true, **dev)
        out["hw"] = (res_hw.x, res_hw.info["err_fullscale"])
        res_pre = solve(a, b, method="analog_n", x_ref=x_true, compute_settling=True, **dev)
        out["n"] = (res_pre.x, res_pre.settle_time, int(res_pre.info["n_amps"]))
        for m in ("cholesky", "cg"):
            r = solve(a, b, method=m, **dev)
            out[m] = (r.x, int(r.info["iterations"]) if m == "cg" else 0)
        net = build_proposed(a, b, **dev)
        counts = netlist_counts(net)
        k_b = transform_2n(a, b).k_b
        out["counts"] = counts
        out["power"] = system_power(a, np.asarray(k_b), x_true, n_amps=net.n_amps,
                                    n_switches=counts["analog_switches"], **dev)
        return out

    want = flow(jsolve, jop.NonIdealities, jnet.build_proposed, jcomp.netlist_counts,
                jtr.transform_2n, jpower.system_power)
    got = flow(tcore.solve, top.NonIdealities, tnet.build_proposed, tcomp.netlist_counts,
               lambda a_, b_: ttr.transform_2n(_t(a_), _t(b_)), tpower.system_power,
               device=CPU)
    np.testing.assert_allclose(got["2n"][0], want["2n"][0], rtol=0.0, atol=1e-10)
    np.testing.assert_allclose(got["2n"][1], want["2n"][1], rtol=1e-6)
    np.testing.assert_allclose(got["2n"][2], want["2n"][2], rtol=1e-6, atol=1e-12)
    assert got["2n"][3:] == want["2n"][3:]
    np.testing.assert_allclose(got["hw"][0], want["hw"][0], rtol=0.0, atol=1e-10)
    np.testing.assert_allclose(got["hw"][1], want["hw"][1], rtol=1e-6)
    np.testing.assert_allclose(got["n"][0], want["n"][0], rtol=0.0, atol=1e-10)
    np.testing.assert_allclose(got["n"][1], want["n"][1], rtol=1e-6)
    assert got["n"][2] == want["n"][2]
    for m in ("cholesky", "cg"):
        np.testing.assert_allclose(got[m][0], want[m][0], rtol=0.0, atol=1e-10)
        assert got[m][1] == want[m][1]
    assert got["counts"] == want["counts"]
    for key, val in want["power"].items():
        np.testing.assert_allclose(got["power"][key], val, rtol=1e-12, err_msg=key)
