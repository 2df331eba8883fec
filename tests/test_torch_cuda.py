"""On a CUDA device: each Hopper kernel of repro_torch (K1-K8) against
its plain PyTorch version, and the main paths through the kernels.

Imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import solve_batch  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.network import build_proposed_batch  # noqa: E402
from repro_torch.data.spd import random_rhs_from_solution, random_spd  # noqa: E402
from repro_torch.kernels import ell_transient as ell  # noqa: E402
from repro_torch.kernels import flash_attention as k8  # noqa: E402
from repro_torch.kernels import build, gemv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spd_transform as tr  # noqa: E402

# repro_torch.kernels re-exports functions named like these submodules
mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
st = importlib.import_module("repro_torch.kernels.transient_step")

# f32 reassociation between the kernels' sequential sums and torch's
# reductions: 1e-5 of max|z| after 100 steps (as the CPU parity bar)
Z_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


def _systems(seed, n, count):
    rng = np.random.default_rng(seed)
    a, x, b = [], [], []
    for _ in range(count):
        ak = random_spd(rng, n)
        xk, bk = random_rhs_from_solution(rng, ak)
        a.append(ak), x.append(xk), b.append(bk)
    return np.stack(a), np.stack(x), np.stack(b)


def _close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert float((got - want).abs().max()) <= Z_TOL * float(want.abs().max())


@pytest.mark.cuda
def test_kernels_match_plain_versions(cuda):
    a, _x, b = _systems(19, 16, 3)
    nets = build_proposed_batch(a, b, device=cuda)
    ell_ss = engine.assemble_batch_ell(nets, device=cuda)
    dense = engine.assemble_batch(nets, device=cuda)
    dt = torch.as_tensor(engine._settle_dt(dense, 0.5, "diag"), device=cuda)
    c = ops.pad_rows((dense.c * dt[:, None]).float(), (1,))
    z0 = torch.rand(c.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    before = ops.launch_counts()
    for sweep_dtype in ("float32", "bfloat16"):
        idx_t, w_t = ops.ell_prepare(ell_ss.indices, ell_ss.weights * dt[:, None, None],
                                     sweep_dtype)
        _close(ell.ell_sweep(idx_t, w_t, z0, c, n_steps=100)[0],
               ell.ell_sweep_plain(idx_t, w_t, z0, c, n_steps=100)[0])
        _close(ell.ell_step(idx_t, w_t, z0, c)[0], ell.ell_step_plain(idx_t, w_t, z0, c)[0])
    m = ops.pad_rows((dense.m * dt[:, None, None]).float(), (1, 2)).contiguous()
    m_t = m.transpose(1, 2).contiguous()
    _close(st.transient_sweep(m_t, z0, c, n_steps=100)[0],
           st.transient_sweep_plain(m_t, z0, c, n_steps=100)[0])
    _close(st.transient_step_batched(m, z0, c)[0],
           st.transient_step_batched_plain(m, z0, c)[0])
    after = ops.launch_counts()
    assert after["ell_sweep"] - before["ell_sweep"] == 2
    assert after["ell_step"] - before["ell_step"] == 2
    assert after["transient_sweep"] - before["transient_sweep"] == 1
    assert after["transient_step_batched"] - before["transient_step_batched"] == 1


@pytest.mark.cuda
def test_main_path_on_the_card_matches_cpu(cuda):
    """solve_batch on the card and on the CPU: same settle steps (the
    kernels and the plain versions sum in other orders, so a crossing
    may move by one 50-step chunk), DC solutions within 1e-10."""
    a, x, b = _systems(23, 12, 3)
    for kw in (dict(settle_matrix_free=True, x_ref=x), {}):
        got = solve_batch(a, b, compute_settling=True, settle_method="euler",
                          device=cuda, **kw)
        want = solve_batch(a, b, compute_settling=True, settle_method="euler",
                           device="cpu", **kw)
        np.testing.assert_allclose(got.x, want.x, rtol=0.0, atol=1e-10)
        assert np.all(np.abs(got.info["settle_steps"] - want.info["settle_steps"]) <= 50)
        assert np.array_equal(got.stable, want.stable)


def _kernel_api_tol(dtype):
    # the reference's kernel-test tolerances (tests/test_kernels.py:19-23)
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=5e-5,
                                                                          atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_api_matches_plain_versions(cuda, dtype):
    """K5, K6, K7a and K7b against their plain versions on the card, at
    ragged shapes that take every tile configuration (nb = 1, <= 16, > 16)."""
    rng = np.random.default_rng(29)

    def t(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, device=cuda).to(dtype)

    def close(got, want):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), **_kernel_api_tol(dtype))

    before = ops.launch_counts()
    for m, k, nb in ((300, 513, 1), (300, 513, 5), (257, 130, 64), (64, 64, 17)):
        g, v = t((m, k)), t((k, nb))
        close(mvm.crosspoint_mvm(g, v), mvm.crosspoint_mvm_plain(g, v))
    for n, nb in ((137, 1), (137, 17), (200, 3)):
        m, z, c = t((n, n), 0.1), t((n, nb)), t((n, nb))
        close(st.transient_step(m, z, c, 1e-2), st.transient_step_plain(m, z, c, 1e-2))
    a = t((301, 301))
    d = torch.as_tensor(rng.uniform(1.0, 2.0, 301), dtype=torch.float32, device=cuda)
    k_s = torch.as_tensor(rng.uniform(0.0, 0.5, 301), dtype=torch.float32, device=cuda)
    torch.testing.assert_close(tr.colabs(a), tr.colabs_plain(a), rtol=1e-5, atol=1e-5)
    for got, want in zip(tr.assemble(a, d, k_s), tr.assemble_plain(a, d, k_s)):
        # elementwise, rounded step by step as the plain version: bit for bit
        assert torch.equal(got, want)
    after = ops.launch_counts()
    assert after["crosspoint_mvm"] - before["crosspoint_mvm"] == 4
    assert after["transient_step"] - before["transient_step"] == 3
    assert after["colabs"] - before["colabs"] == 1
    assert after["assemble"] - before["assemble"] == 1


@pytest.mark.cuda
def test_kernel_api_on_the_card_matches_cpu(cuda):
    """The public kernel API on a circuit's own operands: the transform of
    an SPD system (K7a + K7b) and the crossbar product (K6) on the card
    against the CPU path; 1-D inputs keep their rank."""
    a, x, b = _systems(31, 40, 1)
    a32, b32 = torch.as_tensor(a[0], dtype=torch.float32), torch.as_tensor(b[0],
                                                                           dtype=torch.float32)
    got = ops.spd_transform_arrays(a32.to(cuda), b32.to(cuda))
    want = ops.spd_transform_arrays(a32, b32)
    scale = float(want[0].abs().max())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0.0, atol=1e-6 * scale)
    y = torch.as_tensor(np.concatenate([x[0], -x[0]]), dtype=torch.float32)
    g = torch.as_tensor(np.random.default_rng(1).uniform(0, 1e-4, (80, 80)),
                        dtype=torch.float32)
    out = ops.crosspoint_mvm(g.to(cuda), y.to(cuda))
    assert out.shape == (80,)
    torch.testing.assert_close(out.cpu(), ops.crosspoint_mvm(g, y), rtol=5e-5, atol=1e-12)
    z = ops.transient_step(g.to(cuda), y.to(cuda), y.to(cuda), 0.5)
    assert z.shape == (80,)
    torch.testing.assert_close(z.cpu(), ops.transient_step(g, y, y, 0.5), rtol=5e-5,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda, dtype):
    """K8 against its plain version on the card: GQA, MQA, a window, a
    non-causal case, ragged S and T, every head size, p rounded or not;
    element by element within atol + rtol |want| (the form of the
    reference kernel test, tests/test_kernels.py:171): a sound pair of
    bf16 outputs lies at most one bf16 ulp (2^-7 |want|) apart."""
    rtol, atol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-6)
    rounded = torch.bfloat16 if dtype == torch.bfloat16 else None
    gen = torch.Generator(device=cuda).manual_seed(41)
    before = ops.launch_counts()["flash_attention"]
    route = "mma" if dtype == torch.bfloat16 else "fma"
    before_route = ops.launch_counts_by_route()["flash_attention"][route]
    cases = [  # b, s, t, h, kv, d, causal, window, p_dtype
        (2, 128, 128, 4, 2, 32, True, 0, None),
        (1, 100, 100, 4, 1, 16, True, 0, rounded),
        (1, 192, 192, 8, 2, 64, True, 64, None),
        (2, 77, 130, 6, 3, 128, False, 0, None),
        (1, 300, 300, 32, 8, 128, True, 0, rounded),
        # p kept float32 (the p_hi + p_lo split in bf16) at every head size
        (2, 131, 131, 4, 2, 16, True, 0, None),
        (1, 131, 131, 4, 2, 64, True, 0, None),
        # Granite-20B's MQA: 48 query heads over one KV head (64 % 48 != 0)
        (1, 200, 200, 48, 1, 128, True, 0, None),
    ]
    for b, s, t, h, kv, d, causal, window, p_dtype in cases:
        q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
        k = torch.randn((b, t, kv, d), generator=gen, device=cuda).to(dtype)
        v = torch.randn((b, t, kv, d), generator=gen, device=cuda).to(dtype)
        got = k8.flash_attention(q, k, v, causal=causal, window=window, p_dtype=p_dtype)
        want = k8.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        p_dtype=p_dtype)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{(b, s, t, h, kv, d)}: {m}")
    assert ops.launch_counts()["flash_attention"] - before == len(cases)
    assert ops.launch_counts_by_route()["flash_attention"][route] - before_route == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_family_shapes(cuda, dtype):
    """K8 against its plain version at the shapes the other model families
    give it: Zamba2's D = 112 (seven 16-column groups of V on the tensor
    cores, four then three), InternVL2's G = 7, Mixtral's G = 6 with a
    window that masks, Whisper's non-causal encoder (S = T = 1500) and
    cross attention (S != T = 1500), G = 1; the bars of
    test_flash_attention_matches_plain_version."""
    rtol, atol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-6)
    gen = torch.Generator(device=cuda).manual_seed(47)
    route = "mma" if dtype == torch.bfloat16 else "fma"
    before = ops.launch_counts_by_route()["flash_attention"][route]
    cases = [  # b, s, t, h, kv, d, causal, window
        (1, 300, 300, 32, 32, 112, True, 0),
        (2, 131, 131, 4, 4, 112, True, 0),
        (1, 77, 200, 8, 8, 112, False, 0),
        (1, 400, 400, 14, 2, 64, True, 0),
        (1, 700, 700, 12, 2, 128, True, 256),
        (1, 1500, 1500, 8, 8, 64, False, 0),
        (2, 40, 1500, 8, 8, 64, False, 0),
    ]
    for b, s, t, h, kv, d, causal, window in cases:
        q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
        k = torch.randn((b, t, kv, d), generator=gen, device=cuda).to(dtype)
        v = torch.randn((b, t, kv, d), generator=gen, device=cuda).to(dtype)
        got = k8.flash_attention(q, k, v, causal=causal, window=window)
        want = k8.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{(b, s, t, h, kv, d)}: {m}")
    assert ops.launch_counts_by_route()["flash_attention"][route] - before == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2_1b", "granite_moe_1b_a400m", "mixtral_8x22b",
                                  "mamba2_370m", "zamba2_7b", "whisper_base"])
def test_family_smoke_configs_on_the_card_match_cpu(cuda, arch):
    """Each family's SMOKE config (float32) on the card against the CPU with
    one set of weights: prefill logits and two decode steps within 1e-4 of
    max|logit| (chip_smoke.py's TOL_SMOKE_LOGITS), equal greedy tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import decode_step, init_params, prefill

    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    gpu = init_params(cfg, torch.Generator().manual_seed(5), device="cpu").to(cuda)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 32))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(np.float32)
    lg_g, c_g = prefill(gpu, batch, cfg, 64)
    lg_c, c_c = prefill(cpu, batch, cfg, 64)
    pos = np.array([32, 29]) + (cfg.n_patches if cfg.family == "vlm" else 0)
    for _ in range(3):
        scale = float(lg_c.abs().max())
        assert float((lg_g.cpu() - lg_c).abs().max()) <= 1e-4 * scale
        nxt = lg_c.argmax(dim=-1, keepdim=True).numpy()
        assert (lg_g.argmax(dim=-1, keepdim=True).cpu().numpy() == nxt).all()
        lg_g, c_g = decode_step(gpu, nxt, pos, c_g, cfg)
        lg_c, c_c = decode_step(cpu, nxt, pos, c_c, cfg)
        pos = pos + 1


@pytest.mark.cuda
def test_flash_attention_unaligned_bf16_takes_the_fma_route(cuda):
    """A bf16 view off the 16-byte grid goes to the FMA kernel, which reads
    element by element, and agrees with the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    shape = (1, 70, 4, 32)
    n = 70 * 4 * 32
    q, k, v = (torch.randn(n + 1, generator=gen, device=cuda).bfloat16()[1:].view(shape)
               for _ in range(3))
    assert k8.flash_attention_route(torch.bfloat16, 32, False) == "fma"
    before = ops.launch_counts_by_route()["flash_attention"]["fma"]
    got = k8.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), k8.flash_attention_plain(q, k, v).float(),
                               rtol=1e-2, atol=1e-3)
    assert ops.launch_counts_by_route()["flash_attention"]["fma"] == before + 1


def _mvm_bf16_share(got, want):
    """The largest |got - want| over its element's bar 1e-2 |want| +
    1e-3 max|want| (chip_smoke.py's MVM_BF16 bar: a sound bf16 pair lies at
    most one bf16 ulp, 2^-7 |want|, apart; above 1 fails)."""
    got, want = got.double(), want.double()
    bar = 1e-2 * want.abs() + 1e-3 * float(want.abs().max())
    return float(((got - want).abs() / bar).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [
    ((300, 513, 1), "fma"),
    ((300, 513, 5), "mma_scalar"),
    ((257, 130, 64), "mma_scalar"),
    ((1000, 1048, 24), "mma_async"),
    ((300, 520, 64), "mma_async"),
    ((2048, 2048, 64), "mma_async"),
])
def test_crosspoint_mvm_bf16_routes(cuda, shape, route):
    """K6 in bf16 at ragged shapes that reach each route, held element by
    element against its plain version; the route's launch count moves."""
    m, k, nb = shape
    rng = np.random.default_rng(37)
    g = torch.as_tensor(rng.standard_normal((m, k)), device=cuda).bfloat16()
    v = torch.as_tensor(rng.standard_normal((k, nb)), device=cuda).bfloat16()
    assert mvm.crosspoint_mvm_route(torch.bfloat16, m, k, nb, True) == route
    before = ops.launch_counts_by_route()["crosspoint_mvm"][route]
    got = mvm.crosspoint_mvm(g, v)
    assert got.dtype == torch.bfloat16 and got.shape == (m, nb)
    assert _mvm_bf16_share(got, mvm.crosspoint_mvm_plain(g, v)) <= 1
    assert ops.launch_counts_by_route()["crosspoint_mvm"][route] == before + 1


@pytest.mark.cuda
def test_crosspoint_mvm_unaligned_bf16_takes_the_scalar_route(cuda):
    """A bf16 view off the 16-byte grid, at a shape the asynchronous copies
    would take, goes to the masked-load variant and agrees."""
    rng = np.random.default_rng(38)
    m, k, nb = 130, 136, 16
    g = torch.as_tensor(rng.standard_normal(m * k + 1), device=cuda).bfloat16()[1:].view(m, k)
    v = torch.as_tensor(rng.standard_normal((k, nb)), device=cuda).bfloat16()
    before = ops.launch_counts_by_route()["crosspoint_mvm"]["mma_scalar"]
    got = mvm.crosspoint_mvm(g, v)
    assert _mvm_bf16_share(got, mvm.crosspoint_mvm_plain(g, v)) <= 1
    assert ops.launch_counts_by_route()["crosspoint_mvm"]["mma_scalar"] == before + 1


@pytest.mark.cuda
def test_crosspoint_mvm_bf16_bar_fails_planted_faults(cuda):
    """The per-element bf16 bar rejects a crossbar product (positive
    conductances, voltages in [-0.5, 0.5]) with one 64-deep k-step left out
    of the rows past m / 2, and one with V's last 8 columns dropped."""
    rng = np.random.default_rng(39)
    m, k, nb = 2048, 2048, 64
    g = torch.as_tensor(rng.uniform(1e-5, 1e-4, (m, k)), device=cuda).bfloat16()
    v = torch.as_tensor(rng.uniform(-0.5, 0.5, (k, nb)), device=cuda).bfloat16()
    want = mvm.crosspoint_mvm_plain(g, v)
    assert _mvm_bf16_share(mvm.crosspoint_mvm(g, v), want) <= 1
    skipped = mvm.crosspoint_mvm(g, v)
    skipped[m // 2:] = mvm.crosspoint_mvm(g[m // 2:, 64:].contiguous(), v[64:].contiguous())
    assert _mvm_bf16_share(skipped, want) > 1
    dropped = torch.zeros_like(want)
    dropped[:, :nb - 8] = mvm.crosspoint_mvm(g, v[:, :nb - 8].contiguous())
    assert _mvm_bf16_share(dropped, want) > 1


# ---------------------------------------------------------------------------
# K7a and K6 float32: split reductions across a thread-block cluster
# ---------------------------------------------------------------------------


def _share(got, want, tol):
    """max |got - want| over tol max |want| (the kernel-API bars; above 1
    fails)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / (tol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,route", [
    ((1000, 512), torch.float32, "vec16"),
    ((1000, 516), torch.float32, "vec16"),     # a strip's columns past the end
    ((1000, 516), torch.bfloat16, "scalar"),   # 516 is off bf16's 8-column grid
    ((4000, 4000), torch.bfloat16, "vec16"),
    ((1000, 513), torch.float32, "scalar"),
    ((3, 1024), torch.float32, "vec16"),       # fewer rows than a cluster's blocks
    ((130, 77), torch.bfloat16, "scalar"),
])
def test_colabs_routes(cuda, shape, dtype, route):
    """K7a at shapes that reach each route: the same bits as its order in
    plain PyTorch (colabs_in_kernel_order), within 1e-5 max of the plain
    version, on the route its chooser names."""
    rng = np.random.default_rng(47)
    a = torch.as_tensor(rng.standard_normal(shape), device=cuda).to(dtype)
    assert tr.colabs_route(dtype, *shape, True) == route
    before = ops.launch_counts_by_route()["colabs"][route]
    got = tr.colabs(a)
    assert torch.equal(got, tr.colabs_in_kernel_order(a))
    assert _share(got, tr.colabs_plain(a), 1e-5) <= 1
    assert ops.launch_counts_by_route()["colabs"][route] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_colabs_unaligned_takes_the_scalar_route(cuda, dtype):
    """A view off the 16-byte grid, at a shape the 16-byte loads would
    take, goes to the scalar loads, and gives the same bits as the
    16-byte loads on an aligned copy."""
    rng = np.random.default_rng(48)
    rows, cols = 700, 256
    flat = torch.as_tensor(rng.standard_normal(rows * cols + 1), device=cuda).to(dtype)
    a = flat[1:].view(rows, cols)
    before = ops.launch_counts_by_route()["colabs"]
    got = tr.colabs(a)                     # off the grid: scalar loads
    aligned = tr.colabs(a.clone())         # a fresh copy: 16-byte loads
    after = ops.launch_counts_by_route()["colabs"]
    assert torch.equal(got, tr.colabs_in_kernel_order(a))
    assert torch.equal(got, aligned)
    assert after == dict(vec16=before["vec16"] + 1, scalar=before["scalar"] + 1)


@pytest.mark.cuda
def test_colabs_deterministic_and_bar_fails_a_dropped_rank(cuda):
    """At the main path's shape (4096 x 4096, float32): two launches give
    the same bits; the bar rejects the sums with one cluster rank's rows
    (512 of them) left out of one 128-column strip."""
    rng = np.random.default_rng(49)
    n = 4096
    a = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=cuda)
    first, second = tr.colabs(a), tr.colabs(a)
    assert torch.equal(first, second)
    want = tr.colabs_plain(a)
    assert _share(first, want, 1e-5) <= 1
    ranks = tr.colabs_ranks(n)
    chunk = -(-n // ranks)
    dropped = first.clone()
    dropped[128:256] = tr.colabs(a[:chunk * (ranks - 1), 128:256].contiguous())
    assert _share(dropped, want, 1e-5) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [
    ((1000, 1048, 24), "f32_async"),
    ((300, 520, 68), "f32_async"),     # two column tiles
    ((2048, 2048, 64), "f32_async"),
    ((300, 513, 64), "f32_scalar"),
    ((300, 520, 5), "f32_scalar"),
    ((257, 130, 64), "f32_scalar"),
])
def test_crosspoint_mvm_f32_routes(cuda, shape, route):
    """K6 in float32 at shapes that reach each split-k route, within
    5e-5 max of the plain version and of its own split order in plain
    PyTorch; the route's launch count moves."""
    m, k, nb = shape
    rng = np.random.default_rng(51)
    g = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32, device=cuda)
    v = torch.as_tensor(rng.standard_normal((k, nb)), dtype=torch.float32, device=cuda)
    assert mvm.crosspoint_mvm_route(torch.float32, m, k, nb, True) == route
    before = ops.launch_counts_by_route()["crosspoint_mvm"][route]
    got = mvm.crosspoint_mvm(g, v)
    assert got.dtype == torch.float32 and got.shape == (m, nb)
    assert _share(got, mvm.crosspoint_mvm_plain(g, v), 5e-5) <= 1
    assert _share(got, mvm.crosspoint_mvm_in_split_order(g, v), 5e-5) <= 1
    assert ops.launch_counts_by_route()["crosspoint_mvm"][route] == before + 1


@pytest.mark.cuda
def test_crosspoint_mvm_unaligned_f32_takes_the_scalar_route(cuda):
    """A float32 view off the 16-byte grid, at a shape the asynchronous
    copies would take, goes to the masked-load variant and agrees."""
    rng = np.random.default_rng(52)
    m, k, nb = 300, 1024, 64
    g = torch.as_tensor(rng.standard_normal(m * k + 1), dtype=torch.float32,
                        device=cuda)[1:].view(m, k)
    v = torch.as_tensor(rng.standard_normal((k, nb)), dtype=torch.float32, device=cuda)
    before = ops.launch_counts_by_route()["crosspoint_mvm"]["f32_scalar"]
    got = mvm.crosspoint_mvm(g, v)
    assert _share(got, mvm.crosspoint_mvm_plain(g, v), 5e-5) <= 1
    assert ops.launch_counts_by_route()["crosspoint_mvm"]["f32_scalar"] == before + 1


@pytest.mark.cuda
def test_crosspoint_mvm_f32_deterministic_and_bar_fails_a_dropped_partial(cuda):
    """A crossbar product at the main path's width (G 8192 x 8192, 64
    voltage vectors, float32): two launches give the same bits; the bar
    rejects the product with the last rank's k partial left out."""
    rng = np.random.default_rng(53)
    n, nb = 8192, 64
    g = torch.as_tensor(rng.uniform(1e-5, 1e-4, (n, n)), dtype=torch.float32, device=cuda)
    v = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, nb)), dtype=torch.float32, device=cuda)
    first, second = mvm.crosspoint_mvm(g, v), mvm.crosspoint_mvm(g, v)
    assert torch.equal(first, second)
    want = mvm.crosspoint_mvm_plain(g, v)
    assert _share(first, want, 5e-5) <= 1
    ranks = mvm.crosspoint_mvm_split(n, n, nb)
    assert ranks > 1
    k0, _k1 = mvm.k_ranges(n, ranks)[-1]
    dropped = mvm.crosspoint_mvm(g[:, :k0].contiguous(), v[:k0].contiguous())
    assert _share(dropped, want, 5e-5) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n", [(4, 2048), (1, 8192), (4, 640), (4, 384), (4, 1024)])
def test_dense_step_splits(cuda, bsz, n):
    """K4 at shapes that take each split (R = 2, 4; 2 at the settle sweep's
    (4, 2048) and at B = 1), within 1e-5 max|z'| of its plain version and
    of its split order in plain PyTorch; two launches give the same bits;
    dt = 0 leaves the state as it was."""
    rng = np.random.default_rng(61)
    m = torch.as_tensor(rng.uniform(-1, 1, (bsz, n, n)) / n ** 0.5, dtype=torch.float32,
                        device=cuda)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, n)), dtype=torch.float32, device=cuda)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, n)), dtype=torch.float32, device=cuda)
    assert st.dense_step_ranks(bsz, n) > 1
    got, res = st.transient_step_batched(m, z, c)
    again, res_again = st.transient_step_batched(m, z, c)
    assert torch.equal(got, again) and torch.equal(res, res_again)
    want, want_res = st.transient_step_batched_plain(m, z, c)
    assert _share(got, want, Z_TOL) <= 1 and _share(res, want_res, 1e-4) <= 1
    assert _share(got, st.dense_step_in_kernel_order(m, z, c)[0], Z_TOL) <= 1
    still, res0 = st.transient_step_batched(m, z, c, 0.0)
    assert torch.equal(still, z) and _share(res0, want_res, 1e-4) <= 1


@pytest.mark.cuda
def test_dense_step_bar_fails_a_dropped_rank_and_fits_one_wave(cuda):
    """At the settle sweep's shape (4, 2048, 2048): the bar rejects the step
    with the last cluster rank's columns left out, and the split's clusters
    fit one wave of the card's."""
    rng = np.random.default_rng(62)
    bsz, n = 4, 2048
    m = torch.as_tensor(rng.uniform(-1, 1, (bsz, n, n)) / n ** 0.5, dtype=torch.float32,
                        device=cuda)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, n)), dtype=torch.float32, device=cuda)
    c = torch.zeros_like(z)
    ranks = st.dense_step_ranks(bsz, n)
    c0, c1 = st.dense_step_column_ranges(n, ranks)[-1]
    got, _ = st.transient_step_batched(m, z, c)
    dropped = got - torch.einsum("bij,bj->bi", m[:, :, c0:c1], z[:, c0:c1])
    assert _share(dropped, st.transient_step_batched_plain(m, z, c)[0], Z_TOL) > 1000
    assert bsz * n // 128 <= st.dense_step_clusters_per_wave(ranks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,route_f32,route_bf16", [
    ((8192, 16), "narrow_async", "narrow_async"),
    ((8190, 16), "narrow_scalar", "narrow_scalar"),
    ((137, 5), "narrow_scalar", "narrow_scalar"),
    ((4096, 2), "narrow_scalar", "narrow_scalar"),
    ((1000, 16), "narrow_async", "narrow_async"),
    ((4096, 12), "narrow_async", "narrow_scalar"),
])
def test_transient_step_narrow_routes(cuda, dtype, shape, route_f32, route_bf16):
    """K5 with 2 <= nb <= 16 at shapes that reach each narrow route, in
    both dtypes: float32 within 5e-5 max of the plain version and of its
    split order in plain PyTorch, bf16 element by element within one bf16
    rounding (1e-2 |want| + 1e-3 max|want|); two launches give the same
    bits; the route's launch count moves."""
    n, nb = shape
    route = route_f32 if dtype == torch.float32 else route_bf16
    rng = np.random.default_rng(63)
    m = torch.as_tensor(rng.uniform(-1, 1, (n, n)) / n ** 0.5, device=cuda).to(dtype)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, nb)), device=cuda).to(dtype)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, nb)), device=cuda).to(dtype)
    assert st.transient_step_route(dtype, n, nb, True) == route
    before = ops.launch_counts_by_route()["transient_step"][route]
    got = st.transient_step(m, z, c, 0.5)
    assert torch.equal(got, st.transient_step(m, z, c, 0.5))
    assert ops.launch_counts_by_route()["transient_step"][route] == before + 2
    assert got.dtype == dtype and got.shape == (n, nb)
    want = st.transient_step_plain(m, z, c, 0.5)
    if dtype == torch.float32:
        assert _share(got, want, 5e-5) <= 1
        assert _share(got, st.transient_step_in_kernel_order(m, z, c, 0.5), 5e-5) <= 1
    else:
        w = want.double()
        assert bool(((got.double() - w).abs() <= 1e-2 * w.abs() + 1e-3 * w.abs().max()).all())


@pytest.mark.cuda
def test_transient_step_unaligned_takes_the_scalar_route(cuda):
    """A float32 operator view off the 16-byte grid, at a shape the
    asynchronous copies would take, goes to the masked-load variant."""
    rng = np.random.default_rng(64)
    n, nb = 1000, 16
    m = torch.as_tensor(rng.uniform(-1, 1, n * n + 1) / n ** 0.5, dtype=torch.float32,
                        device=cuda)[1:].view(n, n)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, nb)), dtype=torch.float32, device=cuda)
    before = ops.launch_counts_by_route()["transient_step"]["narrow_scalar"]
    got = st.transient_step(m, z, z, 0.5)
    assert _share(got, st.transient_step_plain(m, z, z, 0.5), 5e-5) <= 1
    assert ops.launch_counts_by_route()["transient_step"]["narrow_scalar"] == before + 1


@pytest.mark.cuda
def test_transient_step_narrow_bar_fails_a_dropped_partial_and_fits_one_wave(cuda):
    """At the kernel API's shape (8192^2, nb = 16, float32): the bar
    rejects the step with the last cluster rank's k partial left out, and
    the split's clusters fit one wave of the card's."""
    rng = np.random.default_rng(65)
    n, nb = 8192, 16
    m = torch.as_tensor(rng.uniform(-1, 1, (n, n)) / n ** 0.5, dtype=torch.float32,
                        device=cuda)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, nb)), dtype=torch.float32, device=cuda)
    ranks = st.transient_step_split(n)
    assert ranks > 1
    k0, k1 = st.narrow_k_ranges(n, ranks)[-1]
    got = st.transient_step(m, z, z, 1.0)
    dropped = got - torch.matmul(m[:, k0:k1], z[k0:k1])
    assert _share(dropped, st.transient_step_plain(m, z, z, 1.0), 5e-5) > 1000
    assert -(-n // st.NARROW_BM) <= st.narrow_clusters_per_wave(ranks)


# the GEMV (K6 at b = 1, K5 at nb = 1): (m, k) on each variant, the
# smoke's main shape among them; ragged rows, k off the 4- and 8-element
# grids, fewer rows than blocks
GEMV_SHAPES = [(8192, 8192), (4096, 4096), (8190, 8190), (300, 513), (137, 137),
               (4000, 4004), (100, 8), (1, 5)]


def _gemv_operands(cuda, m, k, dtype, seed, offset=0):
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.standard_normal(m * k + offset) * k ** -0.5,
                        device=cuda).to(dtype)[offset:].view(m, k)
    v = torch.as_tensor(rng.standard_normal(k + offset), device=cuda).to(dtype)[offset:]
    return g, v[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_is_its_order_bit_for_bit(cuda, shape, dtype):
    """K6 at b = 1 and K5 at nb = 1 equal gemv_in_kernel_order's bits (the
    same order in plain PyTorch), twice; each counted on its route and on
    the variant gemv_variant names."""
    m, k = shape
    g, v = _gemv_operands(cuda, m, k, dtype, 41 + m)
    variant = gemv.gemv_variant(dtype, k, True)
    before = ops.launch_counts_by_gemv_variant()
    got = mvm.crosspoint_mvm(g, v)
    assert torch.equal(got, mvm.crosspoint_mvm_in_kernel_order(g, v))
    assert torch.equal(mvm.crosspoint_mvm(g, v), got)
    if m == k:
        c = v.flip(0).contiguous()
        z1 = st.transient_step(g, v, c, 0.75)
        assert torch.equal(z1, st.transient_step_in_kernel_order(g, v, c, 0.75))
        assert torch.equal(st.transient_step(g, v, c, 0.75), z1)
    after = ops.launch_counts_by_gemv_variant()
    assert after["crosspoint_mvm"][variant] == before["crosspoint_mvm"][variant] + 2
    assert after["transient_step"][variant] == before["transient_step"][variant] + 2 * (m == k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_off_the_grid_takes_the_scalar_variant(cuda, dtype):
    """Views off the 16-byte grid, at shapes the 16-byte variant would take
    aligned, go to the masked scalar loads, give the same order's bits and
    hold the plain version's bar (5e-5 of max in float32; bf16 element by
    element, 1e-2 |want| + 1e-3 max|want|)."""
    for m, k in ((300, 1024), (4096, 4096)):
        g, v = _gemv_operands(cuda, m, k, dtype, 43, offset=1)
        assert gemv.gemv_variant(dtype, k, build.aligned16(g, v)) == "scalar"
        before = ops.launch_counts_by_gemv_variant()
        got = mvm.crosspoint_mvm(g, v)
        assert torch.equal(got, mvm.crosspoint_mvm_in_kernel_order(g, v))
        want = mvm.crosspoint_mvm_plain(g, v)
        if dtype == torch.float32:
            assert _share(got, want, 5e-5) <= 1
        else:
            assert _mvm_bf16_share(got, want) <= 1
        if m == k:
            c = v.flip(0).contiguous()
            z1 = st.transient_step(g, v, c, 1.0)
            assert torch.equal(z1, st.transient_step_in_kernel_order(g, v, c, 1.0))
        after = ops.launch_counts_by_gemv_variant()
        assert after["crosspoint_mvm"]["scalar"] == before["crosspoint_mvm"]["scalar"] + 1
        assert after["transient_step"]["scalar"] == before["transient_step"]["scalar"] + (m == k)


@pytest.mark.cuda
def test_gemv_plan_on_device_is_the_python_plan(cuda):
    """The plan the kernels launch (repro_gemv_plan, C) equals gemv_plan
    (Python), and its grid fits one wave of the card."""
    for m in (1, 5, 131, 132, 133, 137, 1000, 4096, 8190, 8192, 16384, 100_003):
        got = gemv.gemv_plan_on_device(m)
        assert {key: got[key] for key in gemv.gemv_plan(m)} == gemv.gemv_plan(m), m
        assert got["blocks"] <= got["blocks_per_wave"], got


@pytest.mark.cuda
def test_gemv_bar_fails_a_warp_whose_rows_are_skipped(cuda):
    """The float32 bar (5e-5 of max|want|) rejects a GEMV that leaves the
    rows of one warp, the one owning the largest output, unwritten (zero)
    by more than 1000x."""
    g, v = _gemv_operands(cuda, 4096, 4096, torch.float32, 47)
    want = mvm.crosspoint_mvm_plain(g, v)
    got = mvm.crosspoint_mvm(g, v)
    assert _share(got, want, 5e-5) <= 1
    top = int(want.abs().argmax())
    plan = gemv.gemv_plan(4096)
    rows = next(rows for b in range(plan["blocks"]) for w in range(plan["warps"])
                if top in (rows := gemv.gemv_rows_of(4096, b, w)))
    got[rows] = 0.0
    assert _share(got, want, 5e-5) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 80])
def test_transient_sweep_m_transposed_on_the_card(cuda, n):
    """The public dense sweep on the card with the transposed operator
    (m_transposed=True) on both sides of the persistent route's 1 MiB
    limit (nz = 320: K3; nz = 640: K4) equals the untransposed call."""
    a, _x, b = _systems(66, n, 2)
    bss = engine.assemble_batch(build_proposed_batch(a, b, device=cuda), device=cuda)
    dt = torch.as_tensor(engine._settle_dt(bss, 0.5, "diag"), device=cuda)
    m = (bss.m * dt[:, None, None]).float()
    c = (bss.c * dt[:, None]).float()
    z0 = torch.zeros_like(c)
    route, _ = ops.dense_prepare(m)
    assert route == ("dense" if n == 40 else "dense-step")
    want_z, want_r = ops.transient_sweep(m, z0, c, n_steps=20)
    mt = ops.pad_rows(m, (1, 2)).transpose(1, 2).contiguous()
    got_z, got_r = ops.transient_sweep(mt, ops.pad_rows(z0, (1,)), ops.pad_rows(c, (1,)),
                                       n_steps=20, m_transposed=True)
    assert torch.equal(got_z[:, :m.shape[1]], want_z) and torch.equal(got_r, want_r)


def _ell_operator(seed, bsz, k, nz, dtype, dev):
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, nz, (bsz, k, nz)), dtype=torch.int32, device=dev)
    w = torch.as_tensor(rng.uniform(-1, 1, (bsz, k, nz)) * 0.4 / k, dtype=torch.float32,
                        device=dev).to(dtype)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, nz)), dtype=torch.float32, device=dev)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, nz)), dtype=torch.float32, device=dev)
    return idx, w, z, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,k,nz,variant", [
    (4, 32, 8192, "resident"),    # the matrix-free n = 1024 case, R = 16
    (3, 29, 2048, "resident"),    # R = 4 (f32) / 2 (bf16)
    (2, 20, 640, "resident"),     # R = 1, 640 rows: a partial warp
    (2, 33, 16384, "streamed"),   # R = 16, the slots stream from L2
])
def test_ell_sweep_equals_the_step_loop_in_both_variants(cuda, dtype, bsz, k, nz, variant):
    """K1 over a cluster: n steps give the bits of n K2 launches and the
    dt = 0 launch, two launches the same bits, within the bar of its plain
    version; the variant's launch count moves."""
    idx, w, z, c = _ell_operator(nz + k, bsz, k, nz, dtype, cuda)
    isz = w.element_size()
    assert ell.ell_sweep_variant(nz, k, isz) == variant
    assert ell.ell_sweep_clusters_per_wave(nz, k, dtype) > 0
    before = ops.launch_counts_by_variant()["ell_sweep"][variant]
    got_z, got_r = ell.ell_sweep(idx, w, z, c, n_steps=20, dt=0.5)
    again_z, again_r = ell.ell_sweep(idx, w, z, c, n_steps=20, dt=0.5)
    assert ops.launch_counts_by_variant()["ell_sweep"][variant] == before + 2
    assert torch.equal(got_z, again_z) and torch.equal(got_r, again_r)
    zl = z
    for _ in range(20):
        zl, _ = ell.ell_step(idx, w, zl, c, 0.5)
    _, rl = ell.ell_step(idx, w, zl, c, 0.0)
    assert torch.equal(got_z, zl) and torch.equal(got_r[:, 0], rl.amax(dim=1))
    want_z, _ = ell.ell_sweep_plain(idx, w, z, c, n_steps=20, dt=0.5)
    tol = Z_TOL if dtype == torch.float32 else 2e-3
    assert _share(got_z, want_z, tol) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,variant", [(384, "resident"), (640, "resident"),
                                       (1024, "streamed"), (2048, "streamed")])
def test_dense_sweep_in_both_variants(cuda, n, variant):
    """K3 over a cluster: within 1e-5 max|z| of its plain version after 20
    steps (1e-4 relative for the residual, which the operator keeps well
    above its cancellation noise), two launches the same bits; the
    variant's launch count moves."""
    rng = np.random.default_rng(n)
    m = torch.as_tensor(rng.uniform(-1, 1, (3, n, n)) * 0.1 / n ** 0.5 - 0.2 * np.eye(n),
                        dtype=torch.float32, device=cuda)
    m_t = m.transpose(1, 2).contiguous()
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (3, n)), dtype=torch.float32, device=cuda)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (3, n)), dtype=torch.float32, device=cuda)
    assert st.dense_sweep_variant(n) == variant and st.dense_sweep_clusters_per_wave(n) > 0
    before = ops.launch_counts_by_variant()["transient_sweep"][variant]
    got_z, got_r = st.transient_sweep(m_t, z, c, n_steps=20)
    again_z, again_r = st.transient_sweep(m_t, z, c, n_steps=20)
    assert ops.launch_counts_by_variant()["transient_sweep"][variant] == before + 2
    assert torch.equal(got_z, again_z) and torch.equal(got_r, again_r)
    want_z, want_r = st.transient_sweep_plain(m_t, z, c, n_steps=20)
    assert _share(got_z, want_z, Z_TOL) <= 1 and _share(got_r, want_r, 1e-4) <= 1


@pytest.mark.cuda
def test_ell_sweep_refuses_unaligned_operands(cuda):
    """The resident variant copies the slots by 16-byte copies: an operand
    view off the 16-byte grid raises instead of launching."""
    idx, w, z, c = _ell_operator(7, 1, 4, 256, torch.float32, cuda)
    w_off = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda)[1:].view(w.shape)
    w_off.copy_(w)
    with pytest.raises(ValueError, match="aligned"):
        ell.ell_sweep(idx, w_off, z, c, n_steps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ell", "dense"])
def test_sweep_refuses_a_cluster_the_card_cannot_place(cuda, kernel):
    """A resident sweep asked for on one block at the main shape (2 MiB of
    K1's slots, 576 KiB of K3's rows: no block holds them) is refused by
    the C entry and raises; nothing runs in its place, and the next launch
    does not inherit the error."""
    from repro_torch.kernels import build

    lib = build.load_library()
    stream = build.current_stream(torch.device("cuda", torch.cuda.current_device()))
    if kernel == "ell":
        idx, w, z, c = _ell_operator(8, 4, 32, 8192, torch.float32, cuda)
        out, res = torch.empty_like(z), torch.empty((4, 1), device=cuda)
        args = ("repro_ell_sweep", idx.data_ptr(), w.data_ptr(), 0, z.data_ptr(), c.data_ptr(),
                out.data_ptr(), res.data_ptr(), 4, 8192, 32, 2, 1.0, 1, 1, stream)
    else:
        m_t = torch.zeros((4, 384, 384), device=cuda)
        z = torch.zeros((4, 384), device=cuda)
        out, res = torch.empty_like(z), torch.empty((4, 1), device=cuda)
        args = ("repro_dense_sweep", m_t.data_ptr(), z.data_ptr(), z.data_ptr(), out.data_ptr(),
                res.data_ptr(), 4, 384, 2, 1.0, 1, 1, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        lib.call(*args)
    if kernel == "ell":
        ell.ell_sweep(idx, w, z, c, n_steps=2)
    else:
        st.transient_sweep(m_t, z, z, n_steps=2)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_service_streams_give_the_bytes_of_one_stream(cuda):
    """The solve service on one CUDA stream and on two streams of the
    card, each at one and two micro-batches in flight, delivers the same
    bytes; settling tickets launch K3 from the service."""
    from repro_torch.serving import SolveService

    a, _x, b = _systems(23, 16, 12)
    got = {}
    for devices in (["cuda"], ["cuda", "cuda"]):
        for inflight in (1, 2):
            svc = SolveService(devices=devices, batch_slots=2, inflight_per_device=inflight)
            rids = [svc.submit(a[k], b[k], method=("analog_2n", "cholesky", "cg")[k % 3])
                    for k in range(12)]
            rids += [svc.submit(a[k], b[k], compute_settling=True, settle_method="euler")
                     for k in range(4)]
            ops.reset_launch_counts()
            res = svc.drain()
            torch.cuda.synchronize()
            assert ops.launch_counts()["transient_sweep"] > 0
            assert svc.stats["errors"] == {k: 0 for k in svc.stats["errors"]}
            got[(len(devices), inflight)] = [res[r].x for r in rids]
    first = got[(1, 1)]
    for xs in got.values():
        assert all(np.array_equal(x, y) for x, y in zip(xs, first))


@pytest.mark.cuda
def test_mesh_of_one_card_is_the_card(cuda):
    """solve_batch(mesh=solver_mesh()) gives the bytes of device="cuda"."""
    from repro_torch.distributed.sharding import solver_mesh

    a, _x, b = _systems(24, 16, 4)
    for method in ("analog_2n", "cholesky", "cg"):
        whole = solve_batch(a, b, method=method, device=cuda)
        split = solve_batch(a, b, method=method, mesh=solver_mesh())
        assert np.array_equal(split.x, whole.x), method


@pytest.mark.cuda
@pytest.mark.parametrize("n_streams", [1, 2])
def test_service_gate_on_the_card(cuda, monkeypatch, n_streams):
    """The runtime sync gate holds on the card's streams, and a planted
    .item() of a CUDA tensor in the dispatch scope counts exactly once."""
    from repro_torch.analysis import SyncWatch, run_service_gate
    from repro_torch.serving import solve_service

    report = run_service_gate(device="cuda", n_streams=n_streams)
    assert report["ok"] and report["dispatch_aten_syncs"] == 0, report
    assert report["harvest_syncs"] > 0 and report["aten_sync_counts"]["harvest"] > 0

    orig = solve_service.solve_batch_submit
    planted = []

    def submit(*args, **kwargs):
        if SyncWatch._active is not None and not planted:
            planted.append(torch.zeros((), device=cuda).item())
        return orig(*args, **kwargs)

    monkeypatch.setattr(solve_service, "solve_batch_submit", submit)
    report = run_service_gate(device="cuda", n_streams=n_streams)
    assert report["dispatch_syncs"] == 1 and not report["ok"]


def _bwd_close(got, want, rtol, atol_rel, label):
    """|got - want| <= atol_rel max|want| + rtol |want|, element by element."""
    got, want = got.double().cpu(), want.double().cpu()
    bar = atol_rel * float(want.abs().max()) + rtol * want.abs()
    err = (got - want).abs()
    assert bool((err <= bar).all()), f"{label}: max err {float(err.max())}, " \
        f"{float((err / bar).max())} of the bar"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grad_runs_the_backward_kernels(cuda, dtype):
    """A CUDA flash_attention under grad mode returns a tensor with a
    grad_fn (the FlashAttention Function), and its gradients, from the
    hand-written backward kernels (one launch each of Delta, dK/dV and dQ
    per call), match the plain backward on the kernel's own forward output
    and log-sum-exp: float32 within 1e-5 of each array's largest element; bf16
    also within one bf16 ulp of the element (2^-8 < 1e-2 |want|), the
    gradients being rounded once.  With p rounded, a p whose rounding flips
    between the two moves dV by 2^-8 p |dO|: 1e-2 of the largest element.
    The forward's lse matches the plain version's within 1e-5 max|lse|."""
    rounded = torch.bfloat16 if dtype == torch.bfloat16 else None
    gen = torch.Generator(device=cuda).manual_seed(43)
    cases = [  # b, s, t, h, kv, d, causal, window, p_dtype
        (2, 128, 128, 4, 2, 32, True, 0, None),
        (1, 100, 100, 4, 1, 16, True, 0, None),
        (1, 192, 192, 8, 2, 64, True, 64, None),
        (2, 77, 130, 6, 3, 128, False, 0, None),
        (1, 131, 131, 4, 4, 112, True, 0, None),
        (1, 200, 200, 48, 1, 128, True, 0, None),
        (1, 150, 150, 4, 2, 64, True, 0, rounded),
    ]
    names = [fn.__name__ for fn in k8.BWD_KERNELS]
    before = {n: ops.launch_counts()[n] for n in names}
    for b, s, t, h, kv, d, causal, window, p_dtype in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype).requires_grad_()
                   for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
        do = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
        out = k8.flash_attention(q, k, v, causal=causal, window=window, p_dtype=p_dtype)
        assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
        out.backward(do)
        o_plain, lse_plain = k8.flash_attention_plain_lse(
            q.detach(), k.detach(), v.detach(), causal=causal, window=window, p_dtype=p_dtype)
        _, lse = k8.flash_attention_lse(q.detach(), k.detach(), v.detach(), causal=causal,
                                        window=window, p_dtype=p_dtype)
        _bwd_close(lse, lse_plain, 0.0, 1e-5, f"lse {(b, s, t, h, kv, d)}")
        assert torch.equal(o_plain, k8.flash_attention_plain(
            q.detach(), k.detach(), v.detach(), causal=causal, window=window, p_dtype=p_dtype))
        # the backward kernels against the plain backward on the kernel's
        # own forward output and lse
        want = k8.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(),
                                            lse, do, causal=causal, window=window,
                                            p_dtype=p_dtype)
        rtol = 1e-2 if dtype == torch.bfloat16 else 0.0
        atol = 1e-2 if p_dtype is not None else 1e-5
        for name, g, w in zip("qkv", (q.grad, k.grad, v.grad), want):
            assert g.dtype == dtype
            _bwd_close(g, w, rtol, atol, f"d{name} {(b, s, t, h, kv, d, p_dtype)}")
    for n in names:
        assert ops.launch_counts()[n] - before[n] == len(cases), n


# (b, s, t, h, kv, d, causal, window, p_bf16): the cases of
# test_flash_attention_grad_runs_the_backward_kernels, G = 48, a window,
# non-causal S != T and p rounded among them
BWD_MMA_CASES = [
    (2, 128, 128, 4, 2, 32, True, 0, False),
    (1, 100, 100, 4, 1, 16, True, 0, False),
    (1, 192, 192, 8, 2, 64, True, 64, False),
    (2, 77, 130, 6, 3, 128, False, 0, False),
    (1, 131, 131, 4, 4, 112, True, 0, False),
    (1, 200, 200, 48, 1, 128, True, 0, False),
    (1, 150, 150, 4, 2, 64, True, 0, True),
    (1, 300, 300, 8, 2, 64, False, 100, False),
]


def _bwd_inputs(gen, cuda, b, s, t, h, kv, d, causal, window, p_bf16):
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).bfloat16()
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    do = torch.randn((b, s, h, d), generator=gen, device=cuda).bfloat16()
    kw = dict(causal=causal, window=window, p_dtype=torch.bfloat16 if p_bf16 else None)
    o, lse = k8.flash_attention_lse(q, k, v, **kw)
    return q, k, v, o, lse, do, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_MMA_CASES)
def test_flash_attention_bwd_mma_route(cuda, case):
    """bf16 inputs on the 16-byte grid take the tensor-core backward: one
    launch each of the dK/dV and dQ kernels on "mma" and none on "fma",
    with the gradients within the bars of
    test_flash_attention_grad_runs_the_backward_kernels against the plain
    backward (1e-2 |want| + 1e-5 max|want|; 1e-2 max|want| with p rounded)."""
    gen = torch.Generator(device=cuda).manual_seed(47)
    q, k, v, o, lse, do, kw = _bwd_inputs(gen, cuda, *case)
    before = ops.launch_counts_bwd_by_route()
    got = k8.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    after = ops.launch_counts_bwd_by_route()
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        assert after[name]["mma"] == before[name]["mma"] + 1, name
        assert after[name]["fma"] == before[name]["fma"], name
    want = k8.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    atol = 1e-2 if kw["p_dtype"] is not None else 1e-5
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        _bwd_close(g, w, 1e-2, atol, f"d{name} {case}")


@pytest.mark.cuda
def test_flash_attention_bwd_unaligned_bf16_takes_the_fma_route(cuda):
    """A bf16 view off the 16-byte grid takes the FMA backward kernels,
    which read element by element, and agrees with the plain backward."""
    gen = torch.Generator(device=cuda).manual_seed(53)
    q, k, v, o, lse, do, kw = _bwd_inputs(gen, cuda, 1, 150, 150, 8, 2, 64, True, 0, False)
    off = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    off.copy_(q)
    assert k8.flash_attention_bwd_route(torch.bfloat16, 64, False) == "fma"
    before = ops.launch_counts_bwd_by_route()
    got = k8.flash_attention_bwd(off, k, v, o, lse, do, **kw)
    after = ops.launch_counts_bwd_by_route()
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        assert after[name]["fma"] == before[name]["fma"] + 1, name
        assert after[name]["mma"] == before[name]["mma"], name
    want = k8.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip("qkv", got, want):
        _bwd_close(g, w, 1e-2, 1e-5, f"d{name} unaligned")


@pytest.mark.cuda
def test_flash_attention_bwd_mma_is_deterministic(cuda):
    """Two tensor-core backward runs on the same inputs give the same bits
    (the GQA sum and every product in a fixed order, no atomics), and so
    does the dK/dV kernel called on its own."""
    gen = torch.Generator(device=cuda).manual_seed(59)
    q, k, v, o, lse, do, kw = _bwd_inputs(gen, cuda, 1, 515, 515, 16, 4, 128, True, 0, False)
    first = k8.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = k8.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    delta = k8.flash_attention_bwd_delta(o, do)
    kw.pop("p_dtype")
    alone = k8.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    for a, c in zip(alone, first[1:]):
        assert torch.equal(a, c)


# (b, s, t, h, kv, d, causal, window, p_bf16): the cases of
# test_flash_attention_grad_runs_the_backward_kernels and a window at G = 48
# with a ragged S = 515
BWD_FMA_CASES = BWD_MMA_CASES[:7] + [(1, 515, 515, 48, 1, 64, True, 100, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_FMA_CASES)
def test_flash_attention_bwd_fma_route(cuda, case):
    """float32 inputs take the FMA backward (dK/dV split over a cluster,
    dQ a block per 32 queries): one launch each of the dK/dV and dQ
    kernels on "fma" and none on "mma", with the gradients within 1e-5 of
    each array's largest element of the plain backward (1e-2 with p
    rounded, as test_flash_attention_grad_runs_the_backward_kernels)."""
    b, s, t, h, kv, d, causal, window, p_bf16 = case
    gen = torch.Generator(device=cuda).manual_seed(61)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    do = torch.randn((b, s, h, d), generator=gen, device=cuda)
    kw = dict(causal=causal, window=window, p_dtype=torch.bfloat16 if p_bf16 else None)
    o, lse = k8.flash_attention_lse(q, k, v, **kw)
    before = ops.launch_counts_bwd_by_route()
    got = k8.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    after = ops.launch_counts_bwd_by_route()
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        assert after[name]["fma"] == before[name]["fma"] + 1, name
        assert after[name]["mma"] == before[name]["mma"], name
    want = k8.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        _bwd_close(g, w, 0.0, 1e-2 if p_bf16 else 1e-5, f"d{name} {case}")


@pytest.mark.cuda
def test_flash_attention_bwd_fma_is_deterministic(cuda):
    """Two float32 backward runs on the same inputs give the same bits (the
    dK/dV split's partial sums added in rank order, no atomics), and so
    does the dK/dV kernel called on its own."""
    gen = torch.Generator(device=cuda).manual_seed(67)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((1, 515, 16, 64), (1, 515, 4, 64), (1, 515, 4, 64)))
    do = torch.randn(q.shape, generator=gen, device=cuda)
    o, lse = k8.flash_attention_lse(q, k, v)
    assert k8.fma_dkdv_ranks(1, 515, 515, 16, 4, 64, True, 0) > 1
    first = k8.flash_attention_bwd(q, k, v, o, lse, do)
    second = k8.flash_attention_bwd(q, k, v, o, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    alone = k8.flash_attention_bwd_dkdv(q, k, v, do, lse, k8.flash_attention_bwd_delta(o, do))
    for a, c in zip(alone, first[1:]):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (4, 192, 192, 12, 4, 64, True, 0),
    (1, 2048, 2048, 32, 8, 128, True, 0),
    (2, 515, 515, 8, 2, 112, True, 0),
    (2, 515, 300, 8, 2, 32, False, 0),
    (1, 515, 515, 48, 1, 64, True, 100),
    (2, 515, 515, 8, 2, 16, True, 0),
])
def test_fma_dkdv_plan_matches_the_launcher(cuda, shape):
    """The Python plan of the FMA dK/dV split (cluster size, each key
    tile's query tiles and the ranks' shares) equals the one the C
    launcher computes, and its clusters fit one wave on this card."""
    plan = k8.fma_dkdv_plan(*shape)
    on_card = k8.fma_dkdv_plan_on_device(*shape)
    assert plan == {key: on_card[key] for key in ("ranks", "tiles")}
    clusters = shape[0] * shape[4] * len(plan["tiles"])
    assert plan["ranks"] == 1 or clusters <= on_card["clusters_per_wave"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_8b", "whisper_base"])
def test_train_step_on_the_card_matches_cpu(cuda, arch):
    """One AdamW train step of a SMOKE config (float32) on the card and on
    the CPU from one state, with the CPU parity bars: the loss within
    1e-5, every gradient leaf within 1e-4 of its largest element (float32
    sums in other orders; the embedding's backward adds with atomics on
    the card), the updated parameters within 1e-4 of their largest
    wherever the gradient stands above that bar's noise (|g| > 1e-3
    max|g|); below it Adam's first step g / (|g| + eps) is sign-like, so
    there the bar is the step itself, 2 lr.  The K8 forward and backward
    kernels launched on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import forward_train
    from repro_torch.optim.adamw import adamw
    from repro_torch.training import cross_entropy_loss, init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    opt = adamw(1e-3)
    states = {}
    for dev in ("cpu", cuda):
        state = init_train_state(cfg, opt, torch.Generator().manual_seed(3), device="cpu")
        state["params"].to(dev)
        state["opt_state"] = opt.init(dict(state["params"].named_parameters()))
        states[dev] = state
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(np.float32)
    before = ops.launch_counts()
    grads, losses = {}, {}
    for dev, state in states.items():
        feed = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        logits, aux = forward_train(state["params"], feed, cfg)
        loss = cross_entropy_loss(logits, feed["targets"], cfg.vocab)[0] + 0.01 * aux
        loss.backward()
        grads[dev] = {n: p.grad.detach().cpu().double()
                      for n, p in state["params"].named_parameters()}
        state["params"].zero_grad(set_to_none=True)
        states[dev], metrics = make_train_step(cfg, opt)(state, feed)
        losses[dev] = float(metrics["loss"])
    after = ops.launch_counts()
    assert abs(losses[cuda] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])
    for name, want in grads["cpu"].items():
        err = float((grads[cuda][name] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), name
    for name, p in states["cpu"]["params"].named_parameters():
        got = states[cuda]["params"].get_parameter(name).detach().cpu().double()
        want = p.detach().double()
        g = grads["cpu"][name].abs()
        signal = g > 1e-3 * float(g.max())
        err = (got - want).abs()
        assert float(torch.where(signal, err, 0.0).max()) <= 1e-4 * float(want.abs().max()), \
            name
        assert float(torch.where(signal, 0.0, err).max()) <= 2 * 1e-3, name
    for name in ("flash_attention", "flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        assert after[name] > before[name], name


# K8's float32 forward ("fma", redesigned): every head size, ragged S and
# T, causal, windows and non-causal, G from 1 to 48, p rounded or not
FMA_FWD_CASES = [  # b, s, t, h, kv, d, causal, window, p_bf16
    (2, 131, 131, 4, 2, 16, True, 0, False),
    (1, 100, 100, 4, 1, 16, True, 0, True),
    (2, 515, 300, 8, 2, 32, False, 0, False),
    (4, 192, 192, 12, 4, 64, True, 0, False),
    (1, 192, 192, 8, 2, 64, True, 64, True),
    (1, 515, 515, 48, 1, 64, True, 100, False),
    (1, 77, 200, 8, 8, 112, False, 0, False),
    (2, 131, 131, 4, 4, 112, True, 0, True),
    (1, 700, 700, 12, 2, 128, True, 256, False),
    (1, 300, 300, 32, 8, 128, True, 0, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FMA_FWD_CASES)
def test_flash_attention_fma_forward_at_every_head_size(cuda, case):
    """The float32 forward against its plain version within 1e-5 |want| +
    1e-6 (sums in other orders, exp2 of the log2-domain scores; with p
    rounded to bf16 the bf16 bars, 1e-2 |want| + 1e-3, since a p whose
    rounding flips between the two moves an output by 2^-8 p / l |v|),
    one launch on "fma" each; its lse within 1e-5 of the largest |lse|;
    with lse the same output bits as without.  With p rounded, the output
    also differs from the launch with p float32 and lies closer (mean
    |error|, by more than 4x) to the plain version that rounds p than to
    the one that does not, which a kernel ignoring p_bf16 would not."""
    b, s, t, h, kv, d, causal, window, p_bf16 = case
    gen = torch.Generator(device=cuda).manual_seed(71)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    kw = dict(causal=causal, window=window, p_dtype=torch.bfloat16 if p_bf16 else None)
    before = ops.launch_counts_by_route()["flash_attention"]["fma"]
    got = k8.flash_attention(q, k, v, **kw)
    assert ops.launch_counts_by_route()["flash_attention"]["fma"] == before + 1
    want, lse_want = k8.flash_attention_plain_lse(q, k, v, **kw)
    rtol, atol = (1e-2, 1e-3) if p_bf16 else (1e-5, 1e-6)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{case}: {m}")
    with_lse, lse = k8.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(with_lse.view(torch.int32), got.view(torch.int32))
    _bwd_close(lse, lse_want, 0.0, 1e-5, f"lse {case}")
    if p_bf16:
        unrounded = k8.flash_attention(q, k, v, causal=causal, window=window)
        assert not torch.equal(got, unrounded)
        to_rounded = float((got - want).abs().mean())
        to_unrounded = float((got - k8.flash_attention_plain(q, k, v, causal=causal,
                                                             window=window)).abs().mean())
        assert to_rounded * 4 < to_unrounded, (case, to_rounded, to_unrounded)


@pytest.mark.cuda
def test_flash_attention_fma_forward_is_deterministic(cuda):
    """Two launches at train_lm's shape give the same bits, and so does a
    bf16 view off the 16-byte grid twice (the scalar staging of the same
    schedule)."""
    gen = torch.Generator(device=cuda).manual_seed(73)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((4, 192, 12, 64), (4, 192, 4, 64), (4, 192, 4, 64)))
    assert torch.equal(k8.flash_attention(q, k, v), k8.flash_attention(q, k, v))
    views = []
    for x in (q, k, v):
        y = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(x.shape)
        views.append(y.copy_(x))
    first, second = k8.flash_attention(*views), k8.flash_attention(*views)
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(), k8.flash_attention_plain(*views).float(),
                               rtol=1e-2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[:8] for c in FMA_FWD_CASES] + [
    (1, 2048, 2048, 32, 8, 128, True, 0), (1, 6000, 6000, 48, 8, 128, True, 4096)])
def test_fma_forward_plan_matches_the_launcher(cuda, case):
    """The Python plan of the float32 forward (row tile, threads, shared
    memory, blocks, each row tile's key tiles) equals the C launcher's,
    and the card holds at least one block an SM."""
    plan, on_card = k8.fma_forward_plan(*case), k8.fma_forward_plan_on_device(*case)
    for key in ("rows", "threads", "smem_bytes", "blocks", "row_tiles"):
        assert plan[key] == on_card[key], key
    assert [tile[2:] for tile in plan["tiles"]] == on_card["key_tiles"]
    assert on_card["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 77, 6, 16), (4, 192, 12, 64), (1, 2048, 32, 128),
                                   (2, 515, 8, 112), (8, 4096, 32, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_plan_matches_the_launcher(cuda, shape, dtype):
    """Delta's Python plan (lanes, warps a block, blocks) equals the grid
    the C entry point launches, within one wave."""
    b, s, h, d = shape
    plan, on_card = k8.delta_plan(dtype, d, b * s * h), k8.delta_plan_on_device(dtype, b, s, h, d)
    assert {key: plan[key] for key in on_card} == on_card
    assert on_card["blocks"] * on_card["warps"] <= 132 * 64


@pytest.mark.cuda
@pytest.mark.parametrize("d", k8.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["vec16", "scalar"])
def test_delta_is_its_order_bit_for_bit(cuda, d, dtype, variant):
    """Delta equals delta_in_kernel_order bit for bit, in both variants
    (off the 16-byte grid: the scalar loads of the same chunks), counted
    by variant."""
    gen = torch.Generator(device=cuda).manual_seed(79)
    o, do = (torch.randn((2, 77, 6, d), generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    if variant == "scalar":
        views = []
        for x in (o, do):
            y = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(x.shape)
            views.append(y.copy_(x))
        o, do = views
    assert k8.delta_variant(dtype, d, build.aligned16(o, do)) == variant
    name = str(dtype).removeprefix("torch.")
    before = ops.launch_counts_bwd_delta_by_variant()[name][variant]
    got = k8.flash_attention_bwd_delta(o, do)
    assert ops.launch_counts_bwd_delta_by_variant()[name][variant] == before + 1
    assert torch.equal(got.view(torch.int32), k8.delta_in_kernel_order(o, do).view(torch.int32))
