"""Port parity: the roofline (``repro_torch.roofline``) against the
reference's ``repro.roofline``.

* ``roofline_report`` gives the reference's numbers for the same hardware
  figures passed to both (the reference's default ``tpu-v5e`` spec is only
  a test input here; the port's compute term takes the peak of the step's
  dtype, which these figures make one).  Exact: the same arithmetic.
* The counter (``roofline.cost.CostCounter``) on the reference's three
  hand-counted programs (``tests/test_roofline_serving.py:16-56``): a
  loop of 7 products of 128^2, nested 3 x 5 products of 64^2, and a cache
  update of (64, 1, 128) bf16 into (64, 1024, 128).  Exact.
* The counter's FLOPs for a SMOKE prefill (dense and MoE) against the
  reference's ``loop_aware_costs`` of the same jitted prefill on the CPU.
  The attention is the one term counted differently: the reference's
  block attention computes whole (512-block) tile pairs, 4 B H D qb kb
  FLOPs each, K8 the pairs the causal mask leaves, 4 B H D each.  With
  both attention terms taken out the FLOPs must be equal, exactly.
* ``model_flops`` (6 N D / 2 N D) equal to the reference's on every SMOKE
  config; the closed-form ``attn_pairs`` (K8's, beside its cost formulas)
  equal to the mask count.
* The counter's memory, exact: the peak a step adds to what it found
  (storages made before it and freed in it credited), and the peak of its
  temporaries; the kernels' counting hook evaluates no cost formula while
  no counter is active, and the kernel module imports nothing of the
  roofline.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.roofline.analysis import HardwareSpec as JHardwareSpec  # noqa: E402
from repro.roofline.analysis import roofline_report as jroofline_report  # noqa: E402
from repro.roofline.hlo_parse import loop_aware_costs  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.cost import CostCounter  # noqa: E402

DEVICES = ("cpu", "meta")


def _mask_pairs(s, t, causal, window):
    qpos, kpos = np.arange(s)[:, None], np.arange(t)[None, :]
    ok = np.ones((s, t), dtype=bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return int(ok.sum())


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("terms", [
    dict(flops=197e12, bytes_accessed=819e9, collective_bytes=50e9, n_chips=256,
         model_flops=197e12 * 256 * 0.5),
    dict(flops=3.1e15, bytes_accessed=2.0e12, collective_bytes=0.0, n_chips=1,
         model_flops=2.4e15),
    dict(flops=1e9, bytes_accessed=7.5e12, collective_bytes=1e11, n_chips=4, model_flops=0.0),
])
def test_roofline_report_is_the_references(terms):
    ref_hw = JHardwareSpec()
    hw = analysis.HardwareSpec(name=ref_hw.name, hbm_bw=ref_hw.hbm_bw,
                               bf16_flops=ref_hw.peak_flops, f32_flops=ref_hw.peak_flops,
                               link_bw=ref_hw.link_bw)
    want = jroofline_report(**terms, hw=ref_hw)
    got = analysis.roofline_report(**terms, hw=hw, dtype=torch.bfloat16)
    assert {k: got[k] for k in want} == want
    assert got["compute_dtype"] == "bfloat16"


def test_peak_follows_the_compute_dtype():
    """bf16 on the tensor cores, float32 on FMA: the H100 SXM data sheet."""
    hw = analysis.H100_SXM
    f32 = analysis.roofline_report(flops=67e12, bytes_accessed=0.0, collective_bytes=0.0,
                                   n_chips=1, model_flops=67e12, hw=hw, dtype=torch.float32)
    bf16 = analysis.roofline_report(flops=989e12, bytes_accessed=0.0, collective_bytes=0.0,
                                    n_chips=1, model_flops=989e12, hw=hw, dtype=torch.bfloat16)
    assert f32["compute_s"] == pytest.approx(1.0) and bf16["compute_s"] == pytest.approx(1.0)
    assert f32["mfu_upper_bound"] == pytest.approx(1.0)
    with pytest.raises(ValueError):
        hw.flops_s(torch.float64)


def test_spec_is_picked_by_the_card_name_and_an_unknown_card_raises():
    assert analysis.spec_for_card("NVIDIA H100 80GB HBM3") is analysis.H100_SXM
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no hardware spec"):
            analysis.spec_for_card(name)


def test_bound_takes_the_larger_term():
    hw = analysis.H100_SXM
    f32 = hw.flops_s(torch.float32)
    assert analysis.bound(3.35e9, 1.0, f32, hw) == (pytest.approx(1.0), "bytes")
    assert analysis.bound(1.0, 67e9, f32, hw) == (pytest.approx(1.0), "operations")
    assert analysis.bound(1.0, 989e9, hw.flops_s(torch.bfloat16), hw) == (pytest.approx(1.0),
                                                                          "operations")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 3, 64, 200])
def test_attn_pairs_closed_form_is_the_mask_count(causal, window):
    for s in (0, 1, 2, 5, 63, 64, 65, 130, 300):
        for t in (1, 2, 5, 64, 65, 130, 301):
            assert fa.attn_pairs(s, t, causal, window) == _mask_pairs(s, t, causal,
                                                                      window), (s, t)


def test_attn_pairs_at_the_dry_run_lengths():
    """No mask is built: 500k tokens in closed form (causal: S (S + 1) / 2;
    a window w: w (w + 1) / 2 + (S - w) w)."""
    s = 524288
    assert fa.attn_pairs(s, s, True, 0) == s * (s + 1) // 2
    assert fa.attn_pairs(s, s, True, 4096) == 4096 * 4097 // 2 + (s - 4096) * 4096


# ---------------------------------------------------------------------------
# the counter on the reference's hand-counted programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", DEVICES)
def test_counter_loop_of_seven_products(device):
    x = torch.zeros((128, 128), device=device)
    w = torch.zeros((7, 128, 128), device=device)
    with CostCounter() as c:
        for i in range(7):
            x = torch.tanh(x @ w[i])
    assert c.flops == 2 * 128 ** 3 * 7


@pytest.mark.parametrize("device", DEVICES)
def test_counter_nested_products(device):
    x = torch.zeros((64, 64), device=device)
    w = torch.zeros((3, 5, 64, 64), device=device)
    with CostCounter() as c:
        for i in range(3):
            for j in range(5):
                x = x @ w[i, j]
    assert c.flops == 2 * 64 ** 3 * 15


@pytest.mark.parametrize("device", DEVICES)
def test_counter_cache_update_moves_the_region_only(device):
    """The reference's bound is the region plus the buffer's entry/exit
    copy (< 36 MB); the port updates in place: the region, read and
    written, exactly."""
    cache = torch.zeros((64, 1024, 128), dtype=torch.bfloat16, device=device)
    tok = torch.ones((64, 1, 128), dtype=torch.bfloat16, device=device)
    with CostCounter() as c:
        cache[:, 0:1, :] = tok
    assert c.bytes == 2 * 64 * 1 * 128 * 2
    assert c.flops == 0


@pytest.mark.parametrize("device", DEVICES)
def test_counter_row_writes_and_gathers_move_their_rows(device):
    """A decode step's cache row write (index_put_) reads indices and
    values and writes the rows; a gather (the embedding) reads the rows it
    returns."""
    cache = torch.zeros((2, 100, 8, 16), device=device)
    new = torch.ones((2, 8, 16), device=device)
    rows, pos = torch.arange(2, device=device), torch.tensor([3, 5], device=device)
    with CostCounter() as c:
        cache[rows, pos] = new
    assert c.bytes == 2 * 8 + 2 * 8 + 2 * 8 * 16 * 4 + 2 * 8 * 16 * 4
    table = torch.zeros((1000, 64), device=device)
    idx = torch.zeros((2, 5), dtype=torch.int64, device=device)
    with CostCounter() as c:
        table[idx]
    assert c.bytes == 2 * (2 * 5 * 64 * 4) + 2 * 5 * 8


@pytest.mark.parametrize("device", DEVICES)
def test_counter_counts_elementwise_bytes_and_broadcasts_once(device):
    a = torch.zeros((256, 64), device=device)
    row = torch.zeros((64,), device=device).expand(256, 64)
    with CostCounter() as c:
        a + row
        a.reshape(64, 256).t()                       # views: nothing moves
    assert c.bytes == 256 * 64 * 4 + 64 * 4 + 256 * 64 * 4
    assert c.flops == 0


@pytest.mark.parametrize("device", DEVICES)
def test_counter_peak_live_bytes(device):
    n = 1000 * 4
    with CostCounter() as c:
        a = torch.zeros(1000, device=device)
        b = a + 1
        del a
        d = b + 1
        del b
        e = d[:10]                                   # a view: nothing new
    assert c.peak_live_bytes == 2 * n
    assert c.peak_temp_bytes == 2 * n                # a and b; d is an output
    assert c.live_bytes == n
    del d, e
    assert c.live_bytes == 0
    assert c.peak_temp_bytes == 2 * n                # fixed when the block ended


@pytest.mark.parametrize("device", DEVICES)
def test_counter_credits_storages_the_step_frees(device):
    """A storage made before the counter and freed in it (the moment that
    AdamW replaces) is credited: the peak is what the step adds to what it
    found, as the card's max_memory_allocated() less memory_allocated()
    before the step.  The temporaries' peak leaves out the argument and
    the output: m1 and m2 are temporaries, as they would be for XLA."""
    n = 1000 * 4
    state = {"m": torch.zeros(1000, device=device)}
    with CostCounter() as c:
        for _ in range(3):
            state["m"] = state["m"] * 0.9 + 1        # a temporary, a new m, the old m freed
    assert c.live_bytes == 0                         # one m for one m
    assert c.peak_live_bytes == 2 * n                # the temporary and the new m
    assert c.peak_temp_bytes == 3 * n                # m_i, t_(i+1) and m_(i+1)
    with CostCounter() as c:
        out = torch.zeros(1000, device=device) + 1
    assert c.peak_temp_bytes == n and c.peak_live_bytes == 2 * n and out.numel() == 1000


def test_counter_lowers_composites_under_inference_mode():
    """Under inference_mode matmul and einsum reach the mode whole; their
    lowering is counted, as under autograd."""
    x = torch.zeros((2, 16, 32), device="meta")
    w = torch.zeros((32, 8), device="meta")
    counts = []
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), CostCounter() as c:
            x @ w
            torch.einsum("bsd,de->bse", x, w)
        counts.append((c.flops, c.bytes))
    assert counts[0] == counts[1]
    assert counts[0][0] == 2 * (2 * 2 * 16 * 32 * 8)


def test_counter_device_filter_leaves_host_work_out():
    x = torch.zeros((4, 4), device="meta")
    with CostCounter(device="meta") as c:
        torch.tensor(0.9) ** torch.tensor(3.0)       # a host scalar
        y = x * 2
    assert c.bytes == 2 * 16 * 4 and tuple(y.shape) == (4, 4)


# ---------------------------------------------------------------------------
# K8 as one counted operation
# ---------------------------------------------------------------------------

def _k8_operands(device, b=2, s=40, t=40, h=4, kv=2, d=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    return [x.to(device) for x in (q, k, v)]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("window", [0, 7])
def test_k8_forward_is_one_counted_operation(device, window):
    q, k, v = _k8_operands(device)
    with CostCounter() as c:
        out = fa.flash_attention(q, k, v, window=window)
    pairs = fa.attn_pairs(40, 40, True, window)
    want = dict(calls=1, flops=4 * 2 * 4 * 16 * pairs,
                bytes=(2 * q.numel() + k.numel() + v.numel()) * 4)
    assert c.kernels["flash_attention"] == want
    assert (c.flops, c.bytes) == (want["flops"], want["bytes"])   # nothing else counted
    assert out.shape == q.shape and out.dtype == q.dtype and out.device == q.device


@pytest.mark.parametrize("device", DEVICES)
def test_k8_backward_is_three_counted_operations(device):
    """Through autograd (FlashAttention): the forward with its row lse and
    Delta, dK/dV and dQ by formula; on meta nothing runs, on the CPU the
    plain versions run uncounted."""
    q, k, v = (x.requires_grad_() for x in _k8_operands(device, dtype=torch.bfloat16))
    with CostCounter() as c:
        out = fa.flash_attention(q, k, v)
        out.backward(torch.ones_like(out))
    want = fa.backward_costs(q, k, v, True, 0)
    for name, (flops, nbytes) in want.items():
        assert c.kernels[name] == dict(calls=1, flops=flops, bytes=nbytes)
    fwd = fa.forward_cost(q, k, v, True, 0, True)
    assert c.kernels["flash_attention"] == dict(calls=1, flops=fwd[0], bytes=fwd[1])
    assert fwd[1] == (2 * q.numel() + k.numel() + v.numel()) * 2 + 2 * 4 * 40 * 4
    assert q.grad.shape == q.shape and k.grad.dtype == torch.bfloat16


def test_k8_plain_version_never_runs_on_meta(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on meta")

    monkeypatch.setattr(fa, "flash_attention_plain_lse", refuse)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", refuse)
    q, k, v = (x.requires_grad_() for x in _k8_operands("meta"))
    fa.flash_attention(q, k, v).sum().backward()


def test_k8_refuses_a_non_contiguous_meta_operand():
    """Meta takes the card's path, which takes row-major operands."""
    q, k, v = _k8_operands("meta")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


def test_uncounted_outside_a_counter_is_a_no_op():
    def refuse():
        raise AssertionError("a cost evaluated with no counter active")

    with build.uncounted():
        build.record_operation("flash_attention", refuse)
    assert build.kernel_counters() == []


def test_k8_evaluates_no_cost_without_a_counter(monkeypatch):
    """The serving and training paths pay no formula when nothing counts."""
    def refuse(*a, **k):
        raise AssertionError("a cost formula ran with no counter active")

    monkeypatch.setattr(fa, "forward_cost", refuse)
    monkeypatch.setattr(fa, "backward_costs", refuse)
    for device in DEVICES:
        q, k, v = (x.requires_grad_() for x in _k8_operands(device))
        fa.flash_attention(q, k, v).sum().backward()


def test_kernel_module_imports_nothing_of_the_roofline():
    code = ("import sys; import repro_torch.kernels.flash_attention; "
            "assert not [m for m in sys.modules if m.startswith('repro_torch.roofline')]")
    subprocess.run([sys.executable, "-c", code], check=True)


# ---------------------------------------------------------------------------
# against the reference's HLO count
# ---------------------------------------------------------------------------

PREFILL_B, PREFILL_S = 2, 64


def _block_attention_flops(cfg, b, s, causal=True):
    """The reference's block attention: 4 B H D qb kb a reachable tile pair
    (``repro/models/attention.py:29``), per layer."""
    qb = kb = min(512, s)
    nq, nk = -(-s // qb), -(-s // kb)
    pairs = sum(1 for qi in range(nq) for ki in range(nk) if not (causal and ki > qi))
    return 4 * b * cfg.n_heads * cfg.head_dim * qb * kb * pairs * cfg.n_layers


@pytest.mark.parametrize("arch", ["qwen3_8b", "mixtral_8x22b"])
def test_prefill_flops_match_the_references_hlo_count(arch):
    """Dense and MoE SMOKE prefills (window 0 at S = 64 for Mixtral's SMOKE
    window of 64: every causal pair is in reach)."""
    jcfg = jget_smoke(arch)
    assert jcfg.sliding_window in (0, PREFILL_S)
    params = jax.eval_shape(lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((PREFILL_B, PREFILL_S), jnp.int32)}
    hlo = jax.jit(lambda p, bt: jmodel.prefill(p, bt, jcfg, max_seq=PREFILL_S + 8)).lower(
        params, batch).compile().as_text()
    ref = loop_aware_costs(hlo)["flops"]

    cfg = get_smoke_config(arch)
    tparams = tmodel.init_params(cfg, None, device="meta")
    tokens = torch.empty((PREFILL_B, PREFILL_S), dtype=torch.int32, device="meta")
    with CostCounter(device="meta") as c:
        tmodel.prefill(tparams, {"tokens": tokens}, cfg, PREFILL_S + 8)
    k8 = c.kernels["flash_attention"]["flops"]
    assert k8 == 4 * PREFILL_B * cfg.n_heads * cfg.head_dim * cfg.n_layers * \
        fa.attn_pairs(PREFILL_S, PREFILL_S, True, cfg.sliding_window)
    assert c.flops - k8 == ref - _block_attention_flops(cfg, PREFILL_B, PREFILL_S)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_is_the_references(arch):
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jparams = jax.eval_shape(lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = tmodel.init_params(cfg, None, device="meta")
    for train, n_tokens in ((True, 8 * 4096), (False, 128)):
        assert tmodel.model_flops(tparams, cfg, n_tokens, train=train) == \
            jmodel.model_flops(jparams, jcfg, n_tokens, train=train)
    assert tmodel.count_active_params(tparams, cfg) == jmodel.count_active_params(jparams, jcfg)
