"""Port parity: repro_torch's solve_batch / solve end to end against the
JAX reference on the CPU, and the port's package contract (no JAX
inside, the CUDA default, ``mesh=``).

``settle_steps`` and ``stable`` must be equal; solutions within 1e-10.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro.core import solver as jsolver  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_sdd, random_spd  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402

CPU = "cpu"


def _systems(seed, n, count, *, with_non_pd=False, sdd=False):
    rng = np.random.default_rng(seed)
    a_l, x_l, b_l = [], [], []
    for k in range(count):
        a = random_sdd(rng, n) if sdd else random_spd(rng, n)
        if with_non_pd and k == 1:
            a = -a
        x, b = random_rhs_from_solution(rng, a)
        a_l.append(a), x_l.append(x), b_l.append(b)
    return np.stack(a_l), np.stack(x_l), np.stack(b_l)


def _assert_same(got, want):
    np.testing.assert_allclose(got.x, want.x, rtol=0.0, atol=1e-10)
    assert np.array_equal(got.stable, want.stable)
    for key in ("settle_steps", "iterations", "n_amps", "n_branches", "is_passive",
                "design"):
        if key in want.info:
            assert np.array_equal(got.info[key], want.info[key]), key
    if want.settle_time is not None:
        np.testing.assert_allclose(got.settle_time, want.settle_time, rtol=1e-6)
    if want.info.get("err_fullscale") is not None:
        np.testing.assert_allclose(got.info["err_fullscale"], want.info["err_fullscale"],
                                   rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("case", ["euler_ell", "euler_dense", "auto", "eig"])
def test_solve_batch_analog_2n_settling_matches_reference(case):
    """The slice end to end: analog_2n with compute_settling, B = 3, n = 12
    (nz = 96, off the 128 multiple); the eig case salts in a non-PD system."""
    a, x, b = _systems(31, 12, 3, with_non_pd=(case == "eig"))
    kw = {
        "euler_ell": dict(settle_method="euler", settle_matrix_free=True, x_ref=x),
        "euler_dense": dict(settle_method="euler", x_ref=x),
        "auto": dict(settle_method="auto"),
        "eig": dict(settle_method="eig", x_ref=x),
    }[case]
    want = jsolver.solve_batch(a, b, method="analog_2n", compute_settling=True, **kw)
    got = tsolver.solve_batch(a, b, method="analog_2n", compute_settling=True,
                              device=CPU, **kw)
    assert got.info["settle_method"] == want.info["settle_method"]
    _assert_same(got, want)
    if case.startswith("euler"):
        assert np.all(got.info["settle_steps"] < 200_000)


def test_solve_batch_nonideal_and_analog_n_match_reference():
    from repro.core.operating_point import HARDWARE
    from repro_torch.core.operating_point import NonIdealities

    a, x, b = _systems(32, 10, 3)
    tni = NonIdealities(pot_bits=HARDWARE.pot_bits, pot_tol=HARDWARE.pot_tol,
                        wiper_ohm=HARDWARE.wiper_ohm)
    _assert_same(tsolver.solve_batch(a, b, nonideal=tni, x_ref=x, device=CPU),
                 jsolver.solve_batch(a, b, nonideal=HARDWARE, x_ref=x))
    _assert_same(tsolver.solve_batch(a, b, method="analog_n", x_ref=x, device=CPU),
                 jsolver.solve_batch(a, b, method="analog_n", x_ref=x))


@pytest.mark.parametrize("method", ["cholesky", "cg", "jacobi"])
def test_digital_methods_match_reference(method):
    """Batched baselines (SDD systems, on which Jacobi converges): equal
    per-system iteration counts, solutions within 1e-10."""
    a, _x, b = _systems(33, 10, 3, sdd=True)
    got = tsolver.solve_batch(a, b, method=method, max_iter=300, device=CPU)
    want = jsolver.solve_batch(a, b, method=method, max_iter=300)
    _assert_same(got, want)
    single = tsolver.solve(a[0], b[0], method=method, max_iter=300, device=CPU)
    ref = jsolver.solve(a[0], b[0], method=method, max_iter=300)
    np.testing.assert_allclose(single.x, ref.x, rtol=0.0, atol=1e-10)
    if method != "cholesky":
        for res in (got, single):
            assert np.array_equal(np.asarray(res.info["iterations"]).reshape(-1)[:1],
                                  np.asarray(want.info["iterations"])[:1])
        assert single.info["iterations"] == ref.info["iterations"]
        np.testing.assert_allclose(single.info["residual_norm"],
                                   ref.info["residual_norm"], rtol=0.0,
                                   atol=1e-12 * np.linalg.norm(b[0]))


def test_solve_single_system_and_two_phase_handle():
    a, x, b = _systems(34, 8, 2)
    got = tsolver.solve(a[0], b[0], x_ref=x[0], compute_settling=True,
                        settle_method="euler", device=CPU)
    want = jsolver.solve(a[0], b[0], x_ref=x[0], compute_settling=True,
                         settle_method="euler")
    np.testing.assert_allclose(got.x, want.x, rtol=0.0, atol=1e-10)
    assert got.stable == want.stable and got.info["settle_steps"] == want.info["settle_steps"]
    pending = tsolver.solve_batch_submit(a, b, compute_settling=True,
                                         settle_method="euler", device=CPU)
    assert pending.split
    dc = pending.wait_dc()
    assert dc.settle_time is None and pending.wait_dc() is dc
    done = pending.wait()
    assert pending.wait() is done and np.all(np.isfinite(done.settle_time))
    direct = tsolver.solve_batch(a, b, compute_settling=True, settle_method="euler",
                                 device=CPU)
    np.testing.assert_array_equal(done.x, direct.x)
    assert np.array_equal(done.info["settle_steps"], direct.info["settle_steps"])


def test_fallback_resolves_nonfinite_rows():
    a, _x, b = _systems(35, 6, 3)
    res = tsolver.BatchSolveResult(
        x=np.array([[np.nan] * 6, *np.linalg.solve(a[1:], b[1:][..., None])[..., 0]]),
        method="analog_2n", stable=np.ones(3, dtype=bool), settle_time=None, info={})
    assert tsolver.fallback_mask(res.x, a, b).tolist() == [True, False, False]
    out = tsolver._apply_digital_fallback(res, a, b, method="cholesky", tol=1e-10,
                                          max_iter=100, residual_tol=1e-6,
                                          device=torch.device(CPU))
    np.testing.assert_allclose(out.x[0], np.linalg.solve(a[0], b[0]), atol=1e-10)
    assert out.info["fallback"].tolist() == ["cholesky", "", ""]


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, _x, b = _systems(36, 5, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.solve_batch(a, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.solve(a[0], b[0], method="cg")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_mesh_alone_raises_not_implemented(monkeypatch):
    """mesh= runs (it no longer raises): a batch split over a mesh of two
    CPU devices gives the unsharded batch's bytes, an indivisible batch
    raises the reference's ValueError, and mesh= with device= raises.  The
    options of items 6-8 run on the CPU when asked and, like every entry
    point, raise without a card when not."""
    from types import SimpleNamespace

    import jax
    from repro.distributed import sharding as jsharding
    from repro_torch.distributed.sharding import shard_system_batch, solver_mesh

    a, x, b = _systems(37, 5, 2)
    mesh = solver_mesh(devices=[CPU] * 2)
    for kw in (dict(), dict(refine=True), dict(method="analog_n"), dict(method="cholesky"),
               dict(method="cg"), dict(compute_settling=True, settle_method="euler")):
        whole = tsolver.solve_batch(a, b, device=CPU, **kw)
        split = tsolver.solve_batch(a, b, mesh=mesh, **kw)
        assert np.array_equal(split.x, whole.x), kw
        assert np.array_equal(split.stable, whole.stable), kw
        for key in ("iterations", "settle_steps", "precision_path"):
            if key in whole.info:
                assert np.array_equal(split.info[key], whole.info[key]), (kw, key)
    a3, _x3, b3 = _systems(38, 5, 3)
    with pytest.raises(ValueError) as ported:
        tsolver.solve_batch(a3, b3, mesh=mesh)
    with pytest.raises(ValueError) as reference:
        jsharding.shard_system_batch(a3, mesh=SimpleNamespace(devices=np.empty(2, object)))
    assert str(ported.value) == str(reference.value)
    assert "does not divide over 2 devices" in str(ported.value)
    with pytest.raises(ValueError, match="divide"):
        shard_system_batch(a3, b3, mesh=mesh)
    with pytest.raises(ValueError, match="either mesh= or device="):
        tsolver.solve_batch(a, b, mesh=mesh, device=CPU)
    with pytest.raises(ValueError, match="either mesh= or device="):
        jsolver.solve_batch(a, b, mesh=jsharding.solver_mesh(), device=jax.devices()[0])
    options = (dict(refine=True), dict(refine="fcg"),
               dict(compute_settling=True, settle_method="spectral", x_ref=x),
               dict(compute_settling=True, settle_method="nonlinear"),
               dict(compute_settling=True, settle_method="euler",
                    settle_dt_policy="spectral"))
    for kw in options:
        res = tsolver.solve_batch(a, b, device=CPU, **kw)
        assert np.all(np.isfinite(res.x)), kw
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in options + (dict(mesh=mesh),):
        if "mesh" in kw:
            # a mesh of CPU devices asks for the CPU
            assert np.all(np.isfinite(tsolver.solve_batch(a, b, **kw).x))
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsolver.solve_batch(a, b, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver_mesh()


def test_port_imports_no_jax_and_nothing_of_the_reference():
    """Every module of repro_torch imports without jax or repro.*."""
    code = r"""
import pkgutil, importlib, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
