"""Routing of the kernels with more than one route (K6, K8), on the CPU.

* The route choosers are pure functions of dtype, shape and alignment:
  each returns the route its source note documents.
* K8's ``p_dtype = None`` on the tensor cores splits p into two bf16
  parts, p_hi + p_lo; a plain emulation shows the split keeps p float32
  in meaning.
* On the CPU the wrappers run the plain versions and count no launch.

No JAX here: the parity of the plain versions with the reference is in
``tests/test_torch_ops.py`` and ``tests/test_torch_attention.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as k8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# repro_torch.kernels re-exports a function named like this submodule
mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")

BF16, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# (a) the route choosers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [1, 5, 64])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_crosspoint_mvm_route(dtype, nb, aligned):
    """float32 and the bf16 GEMV take the FMA product; bf16 with nb >= 2
    the tensor cores, by 16-byte copies only where k and nb are multiples
    of 8 and both bases are aligned."""
    m, k = 8192, 8192
    route = mvm.crosspoint_mvm_route(dtype, m, k, nb, aligned)
    if dtype == F32 or nb == 1:
        assert route == "fma"
    elif nb % 8 == 0 and aligned:
        assert route == "mma_async"
    else:
        assert route == "mma_scalar"
    assert route in mvm.ROUTES


@pytest.mark.parametrize("m,k,nb,route", [
    (1000, 1048, 24, "mma_async"),    # m and k tails, 16-byte copies
    (300, 520, 64, "mma_async"),
    (300, 513, 5, "mma_scalar"),      # k and nb off the 8-element grid
    (257, 130, 64, "mma_scalar"),     # k off the grid
    (300, 513, 1, "fma"),             # the GEMV
    (1, 8, 8, "mma_async"),           # m does not change the route
])
def test_crosspoint_mvm_route_of_ragged_shapes(m, k, nb, route):
    """The ragged bf16 shapes the smoke run holds (RAGGED_MVM) reach the
    route it expects of each."""
    assert mvm.crosspoint_mvm_route(BF16, m, k, nb, True) == route


@pytest.mark.parametrize("d", k8.HEAD_DIMS)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_route(dtype, d, aligned):
    """bf16 takes the tensor cores at every head size when aligned;
    float32, and a bf16 view off the 16-byte grid, the FMA kernel."""
    want = "mma" if dtype == BF16 and aligned else "fma"
    assert k8.flash_attention_route(dtype, d, aligned) == want
    assert want in k8.ROUTES


# ---------------------------------------------------------------------------
# (b) the p_hi + p_lo split of K8's p_dtype = None on the tensor cores
# ---------------------------------------------------------------------------


def _split(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: p_hi = bf16(p), p_lo = bf16(p - p_hi), both
    rounded to nearest even (``pack_bf16``/``bf16_residual`` in
    ``csrc/mma_bf16.cuh``)."""
    p_hi = p.to(BF16)
    p_lo = (p - p_hi.float()).to(BF16)
    return p_hi, p_lo


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_p_split_reconstructs_p(seed):
    """p_hi + p_lo is p within 2^-16 p for p in [0, 1] (the residual's
    bf16 rounding leaves at most 2^-9 of |p - p_hi| <= 2^-8 p)."""
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(rng.uniform(0.0, 1.0, 100_000), dtype=F32)
    p = torch.cat([p, torch.exp(-torch.as_tensor(rng.uniform(0, 80, 10_000), dtype=F32)),
                   torch.tensor([0.0, 1.0])])
    p_hi, p_lo = _split(p)
    err = (p_hi.double() + p_lo.double() - p.double()).abs()
    assert bool((err <= 2.0**-16 * p.double()).all())


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits; the smallest normal's
    below it)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0**-126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("keys", [64, 2048])
def test_p_split_keeps_the_float32_pv_product(seed, keys):
    """(p_hi + p_lo) @ v for bf16 v, as two bf16 products into one float32
    sum, is the float32-p product within 2^-15 of sum p |v| (the split's
    2^-16 plus float32 sums in another order), and the two round to bf16
    outputs at most one bf16 ulp apart wherever the output is not
    cancelled below 2^-7 of sum p |v| (there float32 sums taken in two
    orders alone move it by more than its ulp): the split keeps
    p_dtype = None's meaning."""
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(np.exp(-rng.uniform(0, 12, (32, keys))), dtype=F32)
    v = torch.as_tensor(rng.standard_normal((keys, 128)), dtype=F32).to(BF16).float()
    p_hi, p_lo = _split(p)
    want = p.double() @ v.double()
    got = p_hi.float() @ v + p_lo.float() @ v
    scale = p.double() @ v.double().abs()
    assert bool(((got.double() - want).abs() <= 2.0**-15 * scale).all())
    ref32 = (p @ v).to(BF16).double()
    out = got.to(BF16).double()
    kept = want.abs() >= 2.0**-7 * scale
    assert int(kept.sum()) > kept.numel() // 2
    ulps = (out - ref32).abs() / _bf16_ulp(ref32.float()).double()
    assert bool((ulps[kept] <= 1).all())


# ---------------------------------------------------------------------------
# (c) on the CPU the wrappers run the plain versions and count no launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("nb", [1, 5, 64])
def test_crosspoint_mvm_on_cpu_runs_the_plain_version(dtype, nb):
    rng = np.random.default_rng(nb)
    g = torch.as_tensor(rng.standard_normal((70, 90)), dtype=F32).to(dtype)
    v = torch.as_tensor(rng.standard_normal((90, nb)), dtype=F32).to(dtype)
    before = (ops.launch_counts(), ops.launch_counts_by_route())
    assert torch.equal(mvm.crosspoint_mvm(g, v), mvm.crosspoint_mvm_plain(g, v))
    assert (ops.launch_counts(), ops.launch_counts_by_route()) == before


@pytest.mark.parametrize("dtype,p_dtype", [(F32, None), (BF16, None), (BF16, BF16)])
@pytest.mark.parametrize("d", [16, 128])
def test_flash_attention_on_cpu_runs_the_plain_version(dtype, p_dtype, d):
    gen = torch.Generator().manual_seed(d)
    q = torch.randn((1, 70, 4, d), generator=gen).to(dtype)
    k = torch.randn((1, 70, 2, d), generator=gen).to(dtype)
    v = torch.randn((1, 70, 2, d), generator=gen).to(dtype)
    before = (ops.launch_counts(), ops.launch_counts_by_route())
    got = k8.flash_attention(q, k, v, p_dtype=p_dtype)
    assert torch.equal(got, k8.flash_attention_plain(q, k, v, p_dtype=p_dtype))
    assert (ops.launch_counts(), ops.launch_counts_by_route()) == before


def test_launch_counts_by_route_keys_and_reset():
    """Every route of K6 and K8 has a count, and the reset zeroes them
    beside the per-kernel counts."""
    counts = ops.launch_counts_by_route()
    assert set(counts) == {"crosspoint_mvm", "flash_attention"}
    assert set(counts["crosspoint_mvm"]) == set(mvm.ROUTES)
    assert set(counts["flash_attention"]) == set(k8.ROUTES)
    ops.reset_launch_counts()
    assert all(n == 0 for by_route in ops.launch_counts_by_route().values()
               for n in by_route.values())
    assert all(n == 0 for n in ops.launch_counts().values())
