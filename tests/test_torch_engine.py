"""Port parity: repro_torch's transform, netlists, stamp patterns,
assembly (dense and ELL), DC solve, operating point, settle sweep and
digital baselines against the JAX reference, on the CPU.

Bars (ROADMAP parity contract): float64 arrays within 1e-12 relative,
ELL indices exactly equal, solutions within 1e-10, float32 sweep states
within 1e-5 of max|x|, step counts and flags equal.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import network as jnet  # noqa: E402

# repro.core re-exports a function named operating_point over the submodule
jop = importlib.import_module("repro.core.operating_point")
from repro.core import transform as jtr  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_sdd, random_spd  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import transform as ttr  # noqa: E402
from repro_torch.core.specs import AD712 as TAD712  # noqa: E402
from repro_torch.data import spd as tspd  # noqa: E402

# repro_torch.core, like repro.core, exports a function named operating_point
top = importlib.import_module("repro_torch.core.operating_point")

CPU = "cpu"


def _systems(seed, n, count, *, with_non_pd=False, with_sdd=False):
    rng = np.random.default_rng(seed)
    a_l, x_l, b_l = [], [], []
    for k in range(count):
        a = random_spd(rng, n)
        if with_non_pd and k == 1:
            a = -a
        if with_sdd and k == count - 1:
            a = random_sdd(rng, n)
        x, b = random_rhs_from_solution(rng, a)
        a_l.append(a), x_l.append(x), b_l.append(b)
    return np.stack(a_l), np.stack(x_l), np.stack(b_l)


def _rel(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0.0, atol=tol * scale)


def _nets(design, a, b, **kw):
    if design == "proposed":
        return (jnet.build_proposed_batch(a, b, **kw),
                tnet.build_proposed_batch(a, b, device=CPU, **kw))
    return jnet.build_preliminary_batch(a, b), tnet.build_preliminary_batch(a, b)


def _port_pattern(jp):
    return convert.pattern_from_arrays(
        design=jp.design, n_nodes=jp.n_nodes, n_unknowns=jp.n_unknowns,
        pair_i=jp.pair_i, pair_j=jp.pair_j, gcell_i=jp.gcell_i,
        states_per_amp=jp.states_per_amp, buffers=jp.buffers)


# ------------------------------------------------------------ transform
def test_spd_generators_are_the_reference_generators():
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    assert np.array_equal(tspd.random_spd(r1, 9, density=0.4), random_spd(r2, 9, density=0.4))
    assert np.array_equal(tspd.random_sdd(r1, 9), random_sdd(r2, 9))
    assert np.array_equal(tspd.random_rhs_from_solution(r1, np.eye(3))[1],
                          random_rhs_from_solution(r2, np.eye(3))[1])


@pytest.mark.parametrize("d_policy", ["proposed", "scaled", "gremban"])
def test_transform_matches_reference(d_policy):
    a, _x, b = _systems(1, 9, 3)
    got = ttr.transform_2n(torch.as_tensor(a), torch.as_tensor(b), d_policy=d_policy,
                           beta=0.7)
    got = ttr.scale_system(got, 0.5)
    for k in range(3):
        want = jtr.scale_system(
            jtr.transform_2n(jnp.asarray(a[k]), jnp.asarray(b[k]), d_policy=d_policy,
                             beta=0.7), 0.5)
        for field in ("k_a", "k_b", "d", "k_s", "b_sign"):
            _rel(getattr(got, field)[k], getattr(want, field), 1e-12)
        _rel(got.assembled()[k], want.assembled(), 1e-12)
        _rel(got.rhs()[k], want.rhs(), 1e-12)


# ------------------------------------------------------------- netlists
@pytest.mark.parametrize("design,kw", [
    ("proposed", {}), ("proposed", {"d_policy": "scaled", "beta": 0.6}),
    ("proposed", {"alpha": 0.25}), ("preliminary", {}),
])
def test_netlists_match_reference(design, kw):
    a, _x, b = _systems(2, 10, 4, with_non_pd=True, with_sdd=True)
    jn, tn = _nets(design, a, b, **kw)
    for j, t in zip(jn, tn):
        assert (t.design, t.n_unknowns, t.n_nodes) == (j.design, j.n_unknowns, j.n_nodes)
        for name in ("branch_i", "branch_j", "cell_i", "cell_j"):
            assert np.array_equal(getattr(t, name), getattr(j, name)), name
        for name in ("branch_g", "ground_g", "supply_g", "supply_v", "cell_w",
                     "element_count"):
            _rel(getattr(t, name), getattr(j, name), 1e-12)
        assert t.n_amps == j.n_amps and t.max_conductance() == pytest.approx(
            j.max_conductance(), rel=1e-12)
    single = tnet.build_proposed(a[0], b[0], device=CPU, **kw) if design == "proposed" \
        else tnet.build_preliminary(a[0], b[0])
    assert np.array_equal(single.cell_i, tn[0].cell_i)


def test_netlist_error_model_matches_reference():
    a, _x, b = _systems(3, 8, 2)
    jn, tn = _nets("proposed", a, b)
    for ni in (jop.HARDWARE, jop.DEFAULT_NONIDEAL):
        tni = top.NonIdealities(**dataclasses.asdict(ni))
        for j, t in zip(jn, tn):
            jj, tt = jop.apply_nonidealities(j, ni), top.apply_nonidealities(t, tni)
            for name in ("branch_g", "ground_g", "supply_g", "cell_w"):
                _rel(getattr(tt, name), getattr(jj, name), 1e-12)
            assert np.array_equal(
                top.draw_offsets(TAD712, tt.n_amps, ni.offset_mode, ni.seed),
                jop.draw_offsets(jengine.AD712, jj.n_amps, ni.offset_mode, ni.seed))


# -------------------------------------------------------------- patterns
def test_stamp_patterns_match_reference():
    a, _x, b = _systems(4, 8, 3)
    for design in ("proposed", "preliminary"):
        jn, tn = _nets(design, a, b)
        jp, tp = jengine.pattern_union(jn), tengine.pattern_union(tn)
        for name in ("pair_i", "pair_j", "gcell_i", "buf1_idx", "buf2_idx", "a1_int",
                     "a1_out", "a2_int", "a2_out", "g_int", "g_out", "amp_int_index",
                     "amp_out_index"):
            assert np.array_equal(getattr(tp, name), getattr(jp, name)), name
        assert tp.n_states == jp.n_states
        # content-based identity: an equal pattern from fields is == and hashes equal
        tp2 = tengine._build_pattern(tp.design, tp.n_nodes, tp.n_unknowns, tp.pair_i,
                                     tp.pair_j, tp.gcell_i, tp.states_per_amp, tp.buffers)
        assert tp2 is not tp and tp2 == tp and hash(tp2) == hash(tp)
        assert _port_pattern(jp) == tp
        assert tengine.pattern_covers(tp, tn)
        assert tengine.pattern_merge(tp, tengine.pattern_of(tn[0])) == tp
    single = tengine.pattern_of(tn[0])
    assert not tengine.pattern_covers(single, tn[1:]) or single == tp
    with pytest.raises(ValueError):
        tengine.pattern_merge(tp, tengine.pattern_union(_nets("proposed", a, b)[1]))


# -------------------------------------------------------------- assembly
@pytest.mark.parametrize("design", ["proposed", "preliminary"])
def test_dense_and_ell_assembly_match_reference(design):
    """Dense m/c within 1e-12; ELL indices exactly, weights within 1e-12;
    non-PD and SDD systems included, nz off the 128 multiple."""
    a, _x, b = _systems(5, 11, 4, with_non_pd=True, with_sdd=True)
    jn, tn = _nets(design, a, b)
    jd, td = jengine.assemble_batch(jn), tengine.assemble_batch(tn, device=CPU)
    assert td.n_states % 128 != 0
    _rel(td.m, jd.m, 1e-12)
    _rel(td.c, jd.c, 1e-12)
    assert np.array_equal(td.amp_active, jd.amp_active)
    je, te = jengine.assemble_batch_ell(jn), tengine.assemble_batch_ell(tn, device=CPU)
    assert te.indices.dtype == torch.int32 and te.ell_width == je.ell_width
    assert np.array_equal(te.indices.numpy(), np.asarray(je.indices))
    _rel(te.weights, np.asarray(je.weights), 1e-12)
    _rel(te.c, np.asarray(je.c), 1e-12)
    _rel(te.diagonal(), np.asarray(je.diagonal()), 1e-12)
    _rel(te.to_dense(), jd.m, 1e-12)
    assert te.fill_ratio == pytest.approx(je.fill_ratio)


def test_assembly_with_offsets_and_ideal_buffers():
    a, _x, b = _systems(6, 8, 3)
    jn, tn = _nets("proposed", a, b)
    rng = np.random.default_rng(1)
    v_os = [rng.normal(0.0, 1e-3, size=net.n_amps) for net in jn]
    for kw in ({"v_os": v_os}, {"buffers": False}):
        jd, td = jengine.assemble_batch(jn, **kw), tengine.assemble_batch(tn, device=CPU,
                                                                          **kw)
        _rel(td.m, jd.m, 1e-12)
        _rel(td.c, jd.c, 1e-12)
        je = jengine.assemble_batch_ell(jn, **kw)
        te = tengine.assemble_batch_ell(tn, device=CPU, **kw)
        assert np.array_equal(te.indices.numpy(), np.asarray(je.indices))
        _rel(te.weights, np.asarray(je.weights), 1e-12)
        _rel(te.c, np.asarray(je.c), 1e-12)


# ------------------------------------------------------------- DC solve
def test_dc_solve_matches_reference_and_repairs_singular():
    a, _x, b = _systems(7, 9, 3)
    jn, tn = _nets("proposed", a, b)
    jd, td = jengine.assemble_batch(jn), tengine.assemble_batch(tn, device=CPU)
    _rel(tengine.dc_solve_batch(td), jengine.dc_solve_batch(jd), 1e-10)
    # a singular operator (one state decoupled) takes the leakage repair
    m = np.array(jd.m)
    m[1, 3, :] = 0.0
    m[1, :, 3] = 0.0
    jd_s = dataclasses.replace(jd, m=m)
    td_s = convert.state_space_from_arrays(
        m, jd.c, pattern=_port_pattern(jd.pattern), amp_active=jd.amp_active,
        amp_rail=jd.amp_rail, slew=jd.slew, device=CPU)
    want = jengine.dc_solve_batch(jd_s)
    got = tengine.dc_solve_batch(td_s)
    assert np.all(np.isfinite(got))
    _rel(got, want, 1e-10)


def test_operating_point_matches_reference():
    a, x, b = _systems(8, 10, 4, with_sdd=True)
    jn, tn = _nets("proposed", a, b)
    for ni in (jop.HARDWARE, jop.IDEAL):
        tni = top.NonIdealities(**dataclasses.asdict(ni))
        want = jop.operating_point_batch(jn, nonideal=ni, x_ref=x)
        got = top.operating_point_batch(tn, nonideal=tni, x_ref=x, device=CPU)
        _rel(got.x, want.x, 1e-10)
        _rel(got.amp_outputs, want.amp_outputs, 1e-10)
        assert np.array_equal(got.amp_saturated, want.amp_saturated)
        # solutions agree to 1e-10, so the error metrics do too
        np.testing.assert_allclose(got.err_fullscale, want.err_fullscale, rtol=1e-6,
                                   atol=1e-10)


# ----------------------------------------------------------- settle sweep
def test_euler_settle_on_identical_operators():
    """The reference's ELL and dense operators, carried across with
    convert, settle in the same number of steps in both packages."""
    a, x, b = _systems(9, 12, 3)
    jn = jnet.build_proposed_batch(a, b)
    je, jd = jengine.assemble_batch_ell(jn), jengine.assemble_batch(jn)
    pat = _port_pattern(je.pattern)
    te = convert.ell_state_space_from_arrays(
        np.array(je.indices), np.array(je.weights), np.array(je.c), pattern=pat,
        amp_active=je.amp_active, amp_rail=je.amp_rail, slew=je.slew, device=CPU)
    td = convert.state_space_from_arrays(
        jd.m, jd.c, pattern=pat, amp_active=jd.amp_active, amp_rail=jd.amp_rail,
        slew=jd.slew, device=CPU)
    for jss, tss in ((je, te), (jd, td)):
        ws, wx, wr, wdt = jengine.euler_settle_batch(jss, x, max_steps=20_000,
                                                     interpret=True)
        gs, gx, gr, gdt = tengine.euler_settle_batch(tss, x, max_steps=20_000)
        assert np.array_equal(gs, ws)
        assert np.all(gs < 20_000)
        _rel(gdt, wdt, 1e-12)
        _rel(gx, wx, 1e-5)
        # (the final residual max|Mz + c| near equilibrium is a cancellation
        # of O(|M||z|) terms, so its f32 value is compared only by the
        # <= 200-step kernel tests, not after a whole settle)


def test_euler_settle_warm_start_and_bf16_dense():
    a, x, b = _systems(10, 8, 2)
    jn, tn = _nets("proposed", a, b)
    jd, td = jengine.assemble_batch(jn), tengine.assemble_batch(tn, device=CPU)
    x0 = x * 0.9
    for kw in ({"x0": x0}, {"sweep_dtype": "bfloat16"}):
        ws, wx, _wr, _ = jengine.euler_settle_batch(jd, x, max_steps=20_000,
                                                    interpret=True, **kw)
        gs, gx, _gr, _ = tengine.euler_settle_batch(td, x, max_steps=20_000, **kw)
        assert np.array_equal(gs, ws), kw
        _rel(gx, wx, 1e-5)


def test_transient_batch_eig_matches_reference():
    a, _x, b = _systems(11, 6, 3, with_non_pd=True)
    jn, tn = _nets("proposed", a, b)
    want = jengine.transient_batch(jn, method="eig")
    got = tengine.transient_batch(tn, method="eig", device=CPU)
    assert np.array_equal(got.stable, want.stable)
    np.testing.assert_allclose(got.settle_time, want.settle_time, rtol=1e-6)
    _rel(np.nan_to_num(got.x_converged), np.nan_to_num(want.x_converged), 1e-10)
    _rel(got.max_re_eig, want.max_re_eig, 1e-8)


def test_transient_batch_rejects_unported_methods():
    a, _x, b = _systems(12, 5, 1)
    tn = tnet.build_proposed_batch(a, b, device=CPU)
    for kw in ({"method": "spectral"}, {"method": "nonlinear"},
               {"method": "euler", "dt_policy": "spectral"}):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            tengine.transient_batch(tn, device=CPU, **kw)


# -------------------------------------------------------------- baselines
def test_digital_baselines_match_reference():
    a, _x, b = _systems(13, 12, 4)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    _rel(tbase.cholesky_solve_batch(at, bt),
         jbase.cholesky_solve_batch(jnp.asarray(a), jnp.asarray(b)), 1e-10)
    for tfn, jfn, kw in ((tbase.cg_solve_batch, jbase.cg_solve_batch, {"max_iter": 500}),
                         (tbase.jacobi_solve_batch, jbase.jacobi_solve_batch,
                          {"max_iter": 40})):
        got = tfn(at, bt, tol=1e-10, **kw)
        want = jfn(jnp.asarray(a), jnp.asarray(b), tol=1e-10, **kw)
        assert np.array_equal(got.iterations.numpy(), np.asarray(want.iterations))
        _rel(got.x, want.x, 1e-10)


# ---------------------------------------------------------------- convert
def test_netlists_from_arrays_round_trip():
    a, _x, b = _systems(14, 7, 2)
    jn = jnet.build_proposed_batch(a, b)
    fields = [
        {**{k: getattr(n, k) for k in convert.NETLIST_ARRAYS},
         "design": n.design, "n_unknowns": n.n_unknowns, "n_nodes": n.n_nodes,
         "element_count": n.element_count, "params": dataclasses.asdict(n.params)}
        for n in jn
    ]
    tn = convert.netlists_from_arrays(fields)
    _rel(tengine.assemble_batch(tn, device=CPU).m, jengine.assemble_batch(jn).m, 1e-12)
