"""Port parity: repro_torch.core.spectral, the spectral wiring of the
engine and the solver, and the port's settling-accuracy guard against
the JAX reference, on the CPU.

Bars:
* start vectors: the cosine block bit for bit; the ramp within 1 ulp
  (XLA's compiled ``jnp.linspace`` rounds some entries one ulp away from
  its own ``start (1 - s) + stop s`` form, which the port computes in
  numpy);
* ``mode_dt_limit``, ``sweep_chunk_schedule``, ``amplitude_settle_steps``
  on the same numpy inputs: bit for bit;
* ``spectral_bounds`` on the same operators: ``rate_max``, ``dt_limit``,
  ``dt`` within 1e-9 relative; ``slow_re`` within 1e-6 relative;
  ``certified``, ``stable`` and ``settle_steps`` equal; the exact slow
  eigenvector inside both slow bases (projectors ``V^T V``) within 1e-6;
  ``fov_slow`` within 1e-6 relative on a system whose whole 12-vector
  slow block agrees between the packages (projectors within 1e-6), and
  of equal sign elsewhere.  Where the block does not agree, its trailing
  directions are set by rounding (the filter lets all 12 vectors fall
  toward the slowest mode before the QR): there the reference's own ELL
  and dense forms of one operator give ``fov_slow`` up to 59 % apart,
  and the port's up to 148 % from the reference's (the guard's ``non_pd``
  case, system 0, dense), with the sign, and so ``certified``, equal;
* the engine and solver paths: chunk, ``settle_steps`` and flags equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro.core import engine as jengine  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import spectral as jspec  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_sdd, random_spd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch import convert, settling_guard  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402
from repro_torch.core import spectral as tspec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

CPU = "cpu"
TOL_DT, TOL_SLOW = 1e-9, 1e-6


def _systems(seed, n, count, *, with_non_pd=False, with_sdd=False, density=1.0):
    """The draw order of tests/test_spectral_settling.py's ``_batch``."""
    rng = np.random.default_rng(seed)
    a_l, x_l, b_l = [], [], []
    for k in range(count):
        a = random_spd(rng, n, density=density)
        if with_non_pd and k == 1:
            a = -a
        if with_sdd and k == count - 1:
            a = random_sdd(rng, n, density=density)
        x, b = random_rhs_from_solution(rng, a)
        a_l.append(a), x_l.append(x), b_l.append(b)
    return np.stack(a_l), np.stack(x_l), np.stack(b_l)


def _jnets(design, a, b):
    build = jnet.build_proposed if design == "proposed" else jnet.build_preliminary
    return [build(a[k], b[k]) for k in range(a.shape[0])]


def _tnets(design, a, b):
    if design == "proposed":
        return tnet.build_proposed_batch(a, b, device=CPU)
    return tnet.build_preliminary_batch(a, b)


def _carried(jss):
    """The reference's operator carried across bit for bit."""
    pat = convert.pattern_from_arrays(
        design=jss.pattern.design, n_nodes=jss.pattern.n_nodes,
        n_unknowns=jss.pattern.n_unknowns, pair_i=jss.pattern.pair_i,
        pair_j=jss.pattern.pair_j, gcell_i=jss.pattern.gcell_i,
        states_per_amp=jss.pattern.states_per_amp, buffers=jss.pattern.buffers)
    kw = dict(pattern=pat, amp_active=jss.amp_active, amp_rail=jss.amp_rail,
              slew=jss.slew, device=CPU)
    if hasattr(jss, "indices"):
        return convert.ell_state_space_from_arrays(
            np.array(jss.indices), np.array(jss.weights), np.array(jss.c), **kw)
    return convert.state_space_from_arrays(jss.m, jss.c, **kw)


def _rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=0.0, err_msg=what)


def _assert_bounds(got, want, m=None):
    """``m``: the dense operators ``(B, nz, nz)``, for the slow-eigenvector
    check (skipped without it)."""
    _rel(got.rate_max, want.rate_max, TOL_DT, "rate_max")
    _rel(got.dt_limit, want.dt_limit, TOL_DT, "dt_limit")
    _rel(got.dt, want.dt, TOL_DT, "dt")
    assert np.array_equal(got.stable, want.stable)
    assert np.array_equal(got.certified, want.certified)
    assert np.array_equal(got.settle_steps, want.settle_steps)
    if want.sym_max is not None:
        _rel(got.sym_max, want.sym_max, TOL_SLOW, "sym_max")
    if want.fov_slow is None:
        return
    _rel(got.slow_re, want.slow_re, TOL_SLOW, "slow_re")
    # QR signs may differ between libraries: compare bases as projectors
    pg = np.einsum("bkn,bkm->bnm", got.slow_basis, got.slow_basis)
    pw = np.einsum("bkn,bkm->bnm", want.slow_basis, want.slow_basis)
    same_block = np.abs(pg - pw).max(axis=(1, 2)) <= TOL_SLOW
    _rel(got.fov_slow[same_block], want.fov_slow[same_block], TOL_SLOW, "fov_slow")
    assert np.array_equal(got.fov_slow < 0, want.fov_slow < 0)
    if m is None:
        return
    lam, vec = np.linalg.eig(m)
    for k in range(m.shape[0]):
        v = vec[k][:, np.argmax(lam[k].real)]
        for part in (v.real, v.imag):
            if np.linalg.norm(part) > 1e-3:
                part = part / np.linalg.norm(part)
                for p in (pg[k], pw[k]):
                    assert np.linalg.norm(p @ part - part) <= TOL_SLOW


# ----------------------------------------------------------- host pieces
@pytest.mark.parametrize("nz", [1, 2, 7, 96, 1000, 16384])
def test_start_vectors_match_reference(nz):
    want = np.asarray(jspec._init_vec(2, nz))
    got = tspec._init_vec(2, nz, CPU).numpy()
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 1.0, ulps.max()
    k = min(12, nz)
    assert np.array_equal(tspec._init_block(2, nz, k, CPU).numpy(),
                          np.asarray(jspec._init_block(2, nz, k)))


def test_host_rules_match_reference_bit_for_bit():
    """mode_dt_limit, sweep_chunk_schedule and amplitude_settle_steps are
    host numpy in both packages: equal outputs on equal inputs."""
    rng = np.random.default_rng(5)
    b, m = 6, 24
    theta = rng.uniform(-1e7, 1e5, (b, m)) + 1j * rng.uniform(-1e7, 1e7, (b, m))
    res = np.abs(theta) * rng.uniform(0.0, 0.2, (b, m))
    rate = np.abs(theta).max(axis=1) * rng.uniform(0.9, 1.1, b)
    assert np.array_equal(tspec.mode_dt_limit(theta, res, rate),
                          jspec.mode_dt_limit(theta, res, rate))
    for pred, max_steps in (([np.inf, np.inf], 10_000), ([8000.0, 8000.0], 200_000),
                            ([100.0], 200_000), ([1e9], 200_000), ([1e9], 2000),
                            (rng.uniform(1e2, 1e5, 9), 30_000),
                            ([3600.0, np.inf, 3871.0, 3249.0], 30_000)):
        assert tops.sweep_chunk_schedule(pred, max_steps) == jops.sweep_chunk_schedule(
            pred, max_steps)
    nz, k = 40, 5
    basis = np.linalg.qr(rng.standard_normal((b, nz, k)))[0].transpose(0, 2, 1)
    fields = dict(
        rate_max=np.full(b, 1e6), slow_re=np.array([-1e4, -2e4, 3.0, -5e3, -1e5, -7e4]),
        slow_residual=np.zeros(b), fov_slow=None, sym_max=None,
        dt_limit=np.full(b, 1e-6), dt=np.full(b, 5e-7),
        settle_time=np.full(b, 1e-3), settle_steps=np.full(b, 2000.0),
        certified=np.ones(b, bool), slow_basis=basis)
    z_err = rng.standard_normal((b, nz)) * np.array([1, 1e-3, 1, 1e-6, 10, 0])[:, None]
    for x_scale in (None, np.ones(b)):
        got = tspec.amplitude_settle_steps(tspec.SpectralBounds(**fields), z_err,
                                           x_scale=x_scale)
        want = jspec.amplitude_settle_steps(jspec.SpectralBounds(**fields), z_err,
                                            x_scale=x_scale)
        assert np.array_equal(got, want)


def test_ell_matvecs_match_dense_and_reference():
    """EllBatchedStateSpace.matvec / matvec_block / matvec_t against the
    dense operator and the reference's ELL products (the CPU scatter-add
    of matvec_t is deterministic; on the card it adds with atomics)."""
    a, _x, b = _systems(61, 10, 3)
    jell = jengine.assemble_batch_ell(_jnets("proposed", a, b))
    tell = _carried(jell)
    m = tell.to_dense()
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.standard_normal((3, tell.n_states)))
    zb = torch.as_tensor(rng.standard_normal((3, 5, tell.n_states)))
    scale = float(m.abs().max() * zb.abs().max())
    for got, want_dense, want_ref in (
            (tell.matvec(z), torch.einsum("bij,bj->bi", m, z),
             jell.matvec(z.numpy())),
            (tell.matvec_t(z), torch.einsum("bij,bi->bj", m, z),
             jell.matvec_t(z.numpy())),
            (tell.matvec_block(zb), torch.einsum("bij,bkj->bki", m, zb),
             jell.matvec_block(zb.numpy()))):
        np.testing.assert_allclose(got.numpy(), want_dense.numpy(), rtol=0, atol=1e-13 * scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=0,
                                   atol=1e-13 * scale)
    assert tell.gather_indices.dtype == torch.int64


# ----------------------------------------------------- spectral_bounds
def _underdamped(re, im, extra_real):
    blocks = [np.array([[re, im], [-im, re]])] + [np.array([[r]]) for r in extra_real]
    n = sum(blk.shape[0] for blk in blocks)
    m = np.zeros((n, n))
    i = 0
    for blk in blocks:
        k = blk.shape[0]
        m[i:i + k, i:i + k] = blk
        i += k
    return m


SETTLING_CASES = {
    # tests/test_spectral_settling.py's inputs
    "proposed_47": dict(seed=47, n=12, count=4, design="proposed"),
    "preliminary_47": dict(seed=47, n=12, count=4, design="preliminary"),
    "sdd_31": dict(seed=31, n=14, count=4, design="proposed", with_sdd=True),
    "unstable_53": dict(seed=53, n=10, count=4, design="proposed", with_non_pd=True),
    "lanczos_47": dict(seed=47, n=12, count=4, design="proposed", lanczos_iters=24),
}


@pytest.mark.parametrize("form", ["ell", "dense"])
@pytest.mark.parametrize("case", sorted(SETTLING_CASES))
def test_spectral_bounds_matches_reference(case, form):
    spec = dict(SETTLING_CASES[case])
    kw = {"lanczos_iters": spec.pop("lanczos_iters")} if "lanczos_iters" in spec else {}
    design = spec.pop("design")
    a, _x, b = _systems(spec.pop("seed"), spec.pop("n"), spec.pop("count"), **spec)
    nets = _jnets(design, a, b)
    jss = (jengine.assemble_batch_ell if form == "ell" else jengine.assemble_batch)(nets)
    want = jspec.spectral_bounds(jss, **kw)
    got = tspec.spectral_bounds(_carried(jss), **kw)
    _assert_bounds(got, want, np.asarray(jengine.assemble_batch(nets).m))
    assert isinstance(got.rate_max, np.ndarray) and isinstance(got.slow_basis, np.ndarray)


def test_spectral_bounds_underdamped_and_dt_only():
    """The underdamped operator of test_abscissa_aware_dt_underdamped (a
    numpy array goes to ``device``), and the dt-only configuration."""
    batch = np.stack([
        _underdamped(-1e3, 1e7, [-2e6, -5e5, -1e4]),
        _underdamped(-5e4, 4e6, [-3e6, -1e5, -2e4]),
    ])
    _assert_bounds(tspec.spectral_bounds(batch, device=CPU), jspec.spectral_bounds(batch),
                   batch)
    a, _x, b = _systems(61, 10, 3)
    jell = jengine.assemble_batch_ell(_jnets("proposed", a, b))
    got = tspec.spectral_bounds(_carried(jell), slow_iters=0)
    want = jspec.spectral_bounds(jell, slow_iters=0)
    _assert_bounds(got, want)
    assert np.all(np.isnan(got.slow_re)) and not got.certified.any()


@pytest.mark.parametrize("form", ["ell", "dense"])
@pytest.mark.parametrize("label", [c[0] for c in settling_guard.CASES])
def test_spectral_bounds_on_guard_cases(label, form):
    """The settling guard's five cases: the port's case builder draws the
    reference guard's systems, and the estimates agree."""
    _, builder, n, count, opts = next(c for c in settling_guard.CASES if c[0] == label)
    a, b = settling_guard.case_systems(label, n, count, opts)
    nets = _jnets(builder, a, b)
    jss = (jengine.assemble_batch_ell if form == "ell" else jengine.assemble_batch)(nets)
    _assert_bounds(tspec.spectral_bounds(_carried(jss)), jspec.spectral_bounds(jss),
                   np.asarray(jengine.assemble_batch(nets).m))


def test_settling_guard_passes():
    """The port's guard holds on the CPU (the reference's guard passes on
    the same systems: benchmarks/tpu_complexity.py --settling), and it
    fails a ratio band that no estimate can meet."""
    failures, rows = settling_guard.settling_accuracy(device=CPU)
    assert failures == []
    tight, _ = settling_guard.settling_accuracy(device=CPU, ratio_lo=2.0, ratio_hi=3.0)
    assert len(tight) == sum(1 for row in rows if "ratio" in row)
    assert len(rows) == sum(c[3] for c in settling_guard.CASES)
    for row in rows:
        if "ratio" in row:
            assert 0.5 <= row["ratio"] <= 2.0
        else:
            assert row["slow_re"] >= 0 and not row["certified"]


# ------------------------------------------------------ engine + solver
def _record_chunks(monkeypatch):
    """Record the chunk each package's sweep_chunk_schedule returns."""
    chunks = {"jax": [], "torch": []}

    def wrap(fn, key):
        def recorded(*args, **kw):
            out = fn(*args, **kw)
            chunks[key].append(out)
            return out
        return recorded

    monkeypatch.setattr(jops, "sweep_chunk_schedule",
                        wrap(jops.sweep_chunk_schedule, "jax"))
    monkeypatch.setattr(tops, "sweep_chunk_schedule",
                        wrap(tops.sweep_chunk_schedule, "torch"))
    return chunks


def test_transient_batch_spectral_matches_reference():
    a, x, b = _systems(59, 12, 4, with_non_pd=True)
    want = jengine.transient_batch(_jnets("proposed", a, b), method="spectral", x_ref=x)
    timings = {}
    got = tengine.transient_batch(_tnets("proposed", a, b), method="spectral", x_ref=x,
                                  device=CPU, timings=timings)
    assert got.method == "spectral" and set(timings) == {"assembly", "spectral"}
    for key in ("stable", "certified", "settle_steps"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert not got.certified[1] and got.certified[[0, 2, 3]].all()
    _rel(got.max_re_eig, want.max_re_eig, TOL_SLOW, "max_re_eig")
    _rel(got.settle_time, want.settle_time, TOL_SLOW, "settle_time")
    np.testing.assert_array_equal(np.isnan(got.x_converged), np.isnan(want.x_converged))


@pytest.mark.parametrize("form", ["ell", "dense"])
def test_euler_spectral_policy_matches_reference(form, monkeypatch):
    """transient_batch(method="euler", dt_policy="spectral"): the spectral
    pass's dt and chunk, then the sweep; chunk, settle_steps and flags
    equal.  The ELL form settles against x_ref, the dense one against the
    DC point."""
    chunks = _record_chunks(monkeypatch)
    a, x, b = _systems(83, 12, 3)
    kw = {"x_ref": x} if form == "ell" else {}
    want = jengine.transient_batch(_jnets("proposed", a, b), method="euler", interpret=True,
                                   max_steps=120_000, dt_policy="spectral", **kw)
    timings = {}
    got = tengine.transient_batch(_tnets("proposed", a, b), method="euler",
                                  max_steps=120_000, dt_policy="spectral", device=CPU,
                                  timings=timings, **kw)
    assert chunks["torch"] == chunks["jax"] and len(chunks["jax"]) == 1
    assert chunks["jax"][0] > 50
    assert "spectral" in timings
    assert np.array_equal(got.settle_steps, want.settle_steps)
    assert np.all(got.settle_steps % chunks["jax"][0] == 0)
    assert np.array_equal(got.stable, want.stable) and got.stable.all()
    np.testing.assert_allclose(got.settle_time, want.settle_time, rtol=1e-9)
    np.testing.assert_allclose(got.x_converged, want.x_converged, rtol=0,
                               atol=1e-5 * np.abs(want.x_converged).max())


def test_euler_settle_batch_bounds_warm_start_chunk(monkeypatch):
    """euler_settle_batch(bounds=) with a warm start: the amplitude-aware
    prediction sizes the chunk; the same chunk and steps as the
    reference."""
    chunks = _record_chunks(monkeypatch)
    a, x, b = _systems(84, 10, 3)
    jell = jengine.assemble_batch_ell(_jnets("proposed", a, b))
    tell = _carried(jell)
    jb, tb = jspec.spectral_bounds(jell), tspec.spectral_bounds(tell)
    for x0 in (None, x * 0.97):
        ws, _wx, _wr, wdt = jengine.euler_settle_batch(
            jell, x, dt_policy="spectral", bounds=jb, x0=x0, max_steps=60_000,
            interpret=True)
        gs, _gx, _gr, gdt = tengine.euler_settle_batch(
            tell, x, dt_policy="spectral", bounds=tb, x0=x0, max_steps=60_000)
        assert np.array_equal(gs, ws)
        _rel(gdt, wdt, TOL_DT, "dt")
    assert chunks["torch"] == chunks["jax"] and chunks["jax"][1] < chunks["jax"][0]


@pytest.mark.parametrize("kw", [
    dict(settle_method="spectral"),
    dict(settle_method="euler", settle_dt_policy="spectral", settle_max_steps=120_000),
], ids=["spectral", "euler_spectral_dt"])
def test_solve_batch_spectral_options_match_reference(kw):
    """solve_batch / solve with the spectral options: settle_certified,
    settle_steps, stable and x as in the reference (B = 3, n = 8)."""
    a, x, b = _systems(71, 8, 3)
    want = jsolver.solve_batch(a, b, compute_settling=True, x_ref=x, **kw)
    got = tsolver.solve_batch(a, b, compute_settling=True, x_ref=x, device=CPU, **kw)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-10)
    assert np.array_equal(got.stable, want.stable)
    assert got.info["settle_method"] == want.info["settle_method"]
    assert np.array_equal(got.info["settle_steps"], want.info["settle_steps"])
    if kw["settle_method"] == "spectral":
        assert np.array_equal(got.info["settle_certified"], want.info["settle_certified"])
        one = got[2]
        assert isinstance(one.info["settle_certified"], bool)
    # solve() is a B = 1 solve_batch (its own chunk: the median is that
    # of one prediction), against the reference's solve()
    single = tsolver.solve(a[0], b[0], compute_settling=True, x_ref=x[0], device=CPU, **kw)
    ref = jsolver.solve(a[0], b[0], compute_settling=True, x_ref=x[0], **kw)
    assert single.stable == ref.stable
    assert single.info["settle_steps"] == ref.info["settle_steps"]
    np.testing.assert_allclose(single.x, ref.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(single.settle_time, ref.settle_time, rtol=1e-9)
