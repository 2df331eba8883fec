"""Port parity: the settle-sweep kernels K1-K4 of repro_torch against the
reference's Pallas kernels (interpret mode) on identical operators.

On the CPU each port wrapper runs its kernel's plain PyTorch version;
``tests/test_torch_cuda.py`` holds the Hopper kernels against those
plain versions on a CUDA device.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.network import build_proposed as jbuild  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_spd  # noqa: E402
from repro.kernels import ell_transient as jell  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

# repro.kernels re-exports a function named transient_step over the submodule
jst = importlib.import_module("repro.kernels.transient_step")

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ell_transient as ell  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
st = importlib.import_module("repro_torch.kernels.transient_step")

# f32 state within 1e-5 of max|z| after <= 200 steps; residual within
# 1e-4 relative (ROADMAP parity contract for float32 sweeps)
Z_TOL, RES_TOL = 1e-5, 1e-4


def _operators(seed: int, n: int, count: int):
    """Dt-folded f32 ELL and dense operators of one reference batch."""
    rng = np.random.default_rng(seed)
    nets = []
    for _ in range(count):
        a = random_spd(rng, n)
        _x, b = random_rhs_from_solution(rng, a)
        nets.append(jbuild(a, b))
    ell_ss = jengine.assemble_batch_ell(nets)
    dense = jengine.assemble_batch(nets)
    dt = jengine._settle_dt(dense, 0.5, "diag")
    idx = np.array(ell_ss.indices)
    w = (np.asarray(ell_ss.weights) * dt[:, None, None]).astype(np.float32)
    m = (dense.m * dt[:, None, None]).astype(np.float32)
    c = (dense.c * dt[:, None]).astype(np.float32)
    z0 = np.random.default_rng(seed + 1).uniform(-0.5, 0.5, c.shape).astype(np.float32)
    return idx, w, m, c, z0


def _pad(x, axes):
    pads = [(0, 0)] * x.ndim
    for ax in axes:
        pads[ax] = (0, (-x.shape[ax]) % 128)
    return np.pad(x, pads)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=tol * np.abs(want).max())


# The reference's bf16 contract (repro/kernels/ell_transient.py:66-67)
# rounds the gathered state to bf16 and the bf16 product once to bf16
# before the f32 slot sum.  XLA:CPU's default excess precision skips the
# product rounding inside the interpreted kernel, so the bf16 reference
# runs in a subprocess with --xla_allow_excess_precision=false, which
# executes the contract as written (ROADMAP Queue 3).
_BF16_REFERENCE = """
import sys
import numpy as np, jax.numpy as jnp
from repro.kernels import ell_transient as jell, ops as jops
d = np.load(sys.argv[1])
z, r = jops.ell_transient_sweep(*(jnp.asarray(d[k]) for k in ("idx", "w", "z0", "c")),
                                n_steps=int(d["steps"]), interpret=True,
                                sweep_dtype="bfloat16")
zs, rs = jell.ell_step_pallas(jnp.asarray(d["idx_p"]),
                              jnp.asarray(d["w_p"]).astype(jnp.bfloat16),
                              jnp.asarray(d["z_p"]),
                              jnp.asarray(d["c_p"]), 1.0, interpret=True,
                              sweep_dtype="bfloat16")
np.savez(sys.argv[2], z=np.asarray(z), r=np.asarray(r), zs=np.asarray(zs),
         rs=np.asarray(rs))
"""


def _bf16_reference(tmp_path, idx, w, z0, c, steps):
    """The reference's bf16 sweep (K1 route) and step (K2), product rounding on."""
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, idx=idx, w=w, z0=z0, c=c, steps=steps,
             idx_p=_pad(idx, (1,)), w_p=_pad(w, (1,)),
             z_p=_pad(z0, (1,)), c_p=_pad(c, (1,)))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _BF16_REFERENCE, str(src), str(dst)],
                   env=env, check=True, timeout=300)
    return np.load(dst)


@pytest.mark.parametrize("n", [12, 7])        # nz = 96 and 58: off the 128 multiple
def test_ell_sweep_matches_pallas(n):
    """K1 route of ops.ell_transient_sweep vs the reference's, same operator."""
    idx, w, _m, c, z0 = _operators(3, n, 3)
    want_z, want_r = jops.ell_transient_sweep(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(z0), jnp.asarray(c),
        n_steps=200, interpret=True)
    got_z, got_r = ops.ell_transient_sweep(
        *(torch.as_tensor(v) for v in (idx, w, z0, c)), n_steps=200)
    assert ops.sweep_backend(idx.shape[1], idx.shape[2]) == "ell"
    _close(got_z, want_z, Z_TOL)
    _close(got_r, want_r, RES_TOL)


def test_ell_step_matches_pallas():
    """K2: one row-tiled step, block-max residual at the input state."""
    idx, w, _m, c, z0 = _operators(5, 16, 2)
    idx_p, w_p = _pad(idx, (1,)), _pad(w, (1,))
    c_p, z_p = _pad(c, (1,)), _pad(z0, (1,))
    want_z, want_r = jell.ell_step_pallas(
        jnp.asarray(idx_p), jnp.asarray(w_p), jnp.asarray(z_p), jnp.asarray(c_p), 1.0,
        interpret=True)
    idx_t, w_t = ops.ell_prepare(torch.as_tensor(idx), torch.as_tensor(w))
    got_z, got_r = ell.ell_step(idx_t, w_t, torch.as_tensor(z_p), torch.as_tensor(c_p))
    assert got_r.shape == (2, z_p.shape[1] // 128)
    _close(got_z, want_z, Z_TOL)
    _close(got_r, want_r, RES_TOL)


def test_ell_bf16_matches_pallas_bf16(tmp_path):
    """bf16 weights: K1 route and K2 against the reference's
    sweep_dtype="bfloat16" kernels, same operator (nz = 58, off 128)."""
    idx, w, _m, c, z0 = _operators(21, 7, 3)
    want = _bf16_reference(tmp_path, idx, w, z0, c, 200)
    got_z, got_r = ops.ell_transient_sweep(
        *(torch.as_tensor(v) for v in (idx, w, z0, c)), n_steps=200,
        sweep_dtype="bfloat16")
    _close(got_z, want["z"], Z_TOL)
    _close(got_r, want["r"], RES_TOL)
    idx_t, w_t = ops.ell_prepare(torch.as_tensor(idx), torch.as_tensor(w), "bfloat16")
    got_zs, got_rs = ell.ell_step(idx_t, w_t, torch.as_tensor(_pad(z0, (1,))),
                                  torch.as_tensor(_pad(c, (1,))))
    _close(got_zs, want["zs"], Z_TOL)
    _close(got_rs, want["rs"], RES_TOL)


def test_ell_row_tiled_route_matches_persistent(monkeypatch):
    """ops.ell_transient_sweep through K2 (n_steps launches + the dt=0
    residual launch) equals the K1 route and the reference."""
    idx, w, _m, c, z0 = _operators(7, 12, 2)
    args = [torch.as_tensor(v) for v in (idx, w, z0, c)]
    z_k1, r_k1 = ops.ell_transient_sweep(*args, n_steps=40)
    monkeypatch.setattr(ops, "ELL_PERSISTENT_BYTES", 0)
    assert ops.sweep_backend(idx.shape[1], idx.shape[2]) == "ell-step"
    z_k2, r_k2 = ops.ell_transient_sweep(*args, n_steps=40)
    _close(z_k2, z_k1, Z_TOL)
    _close(r_k2, r_k1, RES_TOL)
    want_z, want_r = jref.ell_sweep_ref(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(z0), jnp.asarray(c), n_steps=40)
    _close(z_k2, want_z, Z_TOL)
    _close(r_k2, want_r, RES_TOL)


@pytest.mark.parametrize("n", [12, 7])
def test_dense_sweep_matches_pallas(n):
    """K3: fused dense sweep on the pre-transposed operator."""
    _idx, _w, m, c, z0 = _operators(9, n, 3)
    mp, cp, zp = _pad(m, (1, 2)), _pad(c, (1,)), _pad(z0, (1,))
    want_z, want_r = jst.transient_sweep_pallas(
        jnp.asarray(mp.transpose(0, 2, 1)), jnp.asarray(zp), jnp.asarray(cp),
        n_steps=200, interpret=True)
    got_z, got_r = st.transient_sweep(
        torch.as_tensor(mp.transpose(0, 2, 1).copy()), torch.as_tensor(zp),
        torch.as_tensor(cp), n_steps=200)
    _close(got_z, want_z, Z_TOL)
    _close(got_r, want_r, RES_TOL)
    assert ops.sweep_backend(m.shape[1], None) == "dense"


def test_dense_step_matches_pallas():
    """K4: one row-tiled dense step, block-max residual."""
    _idx, _w, m, c, z0 = _operators(11, 16, 2)
    mp, cp, zp = _pad(m, (1, 2)), _pad(c, (1,)), _pad(z0, (1,))
    want_z, want_r = jst.transient_step_batched_pallas(
        jnp.asarray(mp), jnp.asarray(zp), jnp.asarray(cp), 1.0, interpret=True)
    got_z, got_r = st.transient_step_batched(
        torch.as_tensor(mp), torch.as_tensor(zp), torch.as_tensor(cp), 1.0)
    _close(got_z, want_z, Z_TOL)
    _close(got_r, want_r, RES_TOL)


def test_dense_row_tiled_route_matches_persistent(monkeypatch):
    """ops.transient_sweep through K4 (+ dt=0 launch) equals the K3 route,
    including the bf16 rounding of the operator."""
    _idx, _w, m, c, z0 = _operators(13, 12, 2)
    args = [torch.as_tensor(v) for v in (m, z0, c)]
    for sweep_dtype in ("float32", "bfloat16"):
        z3, r3 = ops.transient_sweep(*args, n_steps=30, sweep_dtype=sweep_dtype)
        with monkeypatch.context() as mp:
            mp.setattr(ops, "DENSE_PERSISTENT_BYTES", 0)
            assert ops.sweep_backend(m.shape[1], None) == "dense-step"
            z4, r4 = ops.transient_sweep(*args, n_steps=30, sweep_dtype=sweep_dtype)
        want_z, want_r = jops.transient_sweep(
            *(jnp.asarray(v) for v in (m, z0, c)), n_steps=30, interpret=True,
            sweep_dtype=sweep_dtype)
        _close(z4, z3, Z_TOL)
        _close(r4, r3, RES_TOL)
        _close(z3, want_z, Z_TOL)
        _close(r3, want_r, RES_TOL)


def test_oracles_match_reference_oracles():
    """kernels/ref.py against repro.kernels.ref, float32."""
    idx, w, m, c, z0 = _operators(17, 8, 2)
    tz = [torch.as_tensor(v) for v in (idx, w, z0)]
    _close(ref.ell_spmv_ref(*tz), jref.ell_spmv_ref(*(jnp.asarray(v) for v in (idx, w, z0))),
           Z_TOL)
    got = ref.ell_sweep_ref(*tz, torch.as_tensor(c), n_steps=25)
    want = jref.ell_sweep_ref(*(jnp.asarray(v) for v in (idx, w, z0, c)), n_steps=25)
    _close(got[0], want[0], Z_TOL)
    _close(got[1], want[1], RES_TOL)
    td = [torch.as_tensor(v) for v in (m, z0, c)]
    jd = [jnp.asarray(v) for v in (m, z0, c)]
    for g, wnt in zip(ref.transient_step_batched_ref(*td, 0.5),
                      jref.transient_step_batched_ref(*jd, 0.5)):
        _close(g, wnt, Z_TOL)
    for g, wnt in zip(ref.transient_sweep_ref(*td, n_steps=25),
                      jref.transient_sweep_ref(*jd, n_steps=25)):
        _close(g, wnt, RES_TOL)


def test_wrappers_validate_operands():
    z = torch.zeros((1, 128))
    with pytest.raises(ValueError):
        ell.ell_sweep(torch.zeros((1, 3, 100), dtype=torch.int32), torch.zeros((1, 3, 100)),
                      torch.zeros((1, 100)), torch.zeros((1, 100)), n_steps=1)
    with pytest.raises(TypeError):
        ell.ell_step(torch.zeros((1, 3, 128), dtype=torch.int64), torch.zeros((1, 3, 128)),
                     z, z)
    with pytest.raises(TypeError):
        st.transient_sweep(torch.zeros((1, 128, 128), dtype=torch.float64), z, z, n_steps=1)
    with pytest.raises(ValueError):
        st.transient_step_batched(torch.zeros((1, 128, 64)), z, z)


def test_routing_limits():
    """The re-derived Hopper limits: the state must fit one block's 227 KB;
    the persistent sweeps take only small per-system operator streams."""
    assert ops.sweep_state_fits_smem(28_928)               # 2 x 113 KiB of state
    assert not ops.sweep_state_fits_smem(28_928 + 128)
    assert ops.sweep_backend(8192, 32) == "ell"           # 2.1 MB of slots
    assert ops.sweep_backend(16384, 34) == "ell-step"     # 4.5 MB of slots
    assert ops.sweep_backend(512, None) == "dense"        # 1 MiB operator
    assert ops.sweep_backend(640, None) == "dense-step"   # 1.6 MiB operator
    assert ops.sweep_backend(2048, None) == "dense-step"  # 16 MiB operator
    assert ops.sweep_backend(40_000, 8) == "ell-step"     # state past 227 KB
    assert ops.sweep_backend(2048, 1500) == "dense-step"  # fill ratio >= 0.5


def test_import_builds_nothing():
    """Importing the kernel modules compiles nothing and needs no nvcc."""
    code = (
        "import repro_torch.kernels.ops, repro_torch.kernels.build as b; "
        "assert b._LIB is None; print(b.BUILD_DIR)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().endswith("build/repro_torch_kernels")
    assert build.SOURCES == ("ell_transient.cu", "transient_step.cu", "crosspoint_mvm.cu",
                             "spd_transform.cu", "flash_attention.cu")


def test_a_reused_library_keeps_its_build_log(tmp_path, monkeypatch):
    """The nvcc/ptxas log of a build is kept beside the library, so a later
    process that loads the library from disk reports the same registers
    and spills; its build time reads 0."""
    def fake_run(cmds):
        for cmd in cmds:
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return "".join("ptxas info    : Used 255 registers\n" for cmd in cmds if "-c" in cmd)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_run", fake_run)
    monkeypatch.setattr(build, "KernelLibrary",
                        lambda path, seconds, log: (path, seconds, log))
    path, _seconds, log = build.load_library()
    assert path.exists() and log.count("Used 255 registers") == len(build.SOURCES)
    monkeypatch.setattr(build, "_LIB", None)
    assert build.load_library() == (path, 0.0, log)
