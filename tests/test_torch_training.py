"""Port parity: training — the loss, ``forward_train`` of every family
and its gradients, remat, and whole AdamW train steps — against the
reference's ``repro.training`` and ``repro.models.model`` on the SMOKE
configs (float32), the reference's weights carried across by
``repro_torch.convert``.

Bars, relative to each array's largest element: the loss 1e-6; logits
and the aux loss 1e-5 (float32 sums in other orders through two to five
layers); every gradient leaf 1e-4 (the same sums, differentiated); five
train steps: losses 1e-5, moments and parameters 1e-4 (``lm_head`` 1e-3,
see the test).  On the CPU the attention is
K8's plain version with its plain backward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro.training.loss import cross_entropy_loss as jce  # noqa: E402
from repro.training.step import init_train_state as jinit_state  # noqa: E402
from repro.training.step import make_train_step as jmake_step  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_arrays,
    reference_leaf,
    train_state_from_arrays,
)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.training import cross_entropy_loss, init_train_state, make_train_step  # noqa: E402

CPU = "cpu"
ARCHS = ["qwen3_8b", "internvl2_1b", "granite_moe_1b_a400m", "mamba2_370m", "zamba2_7b",
         "whisper_base"]
B, S = 2, 32        # S: a multiple of the SMOKE ssm_chunk (32)


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return batch


def test_cross_entropy_with_ignore_ids_and_padded_vocab():
    rng = np.random.default_rng(0)
    b, s, vp, v = 2, 8, 512 + 256, 500
    logits = (3 * rng.standard_normal((b, s, vp))).astype(np.float32)
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    targets[:, :3] = -1
    targets[0, 5] = -1
    loss_j, m_j = jce(jnp.asarray(logits), jnp.asarray(targets), v)
    loss_t, m_t = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets), v)
    assert _rel(loss_t, loss_j) <= 1e-6
    for key in ("ce", "z_loss", "accuracy", "tokens"):
        assert _rel(m_t[key], m_j[key]) <= 1e-6, key
    assert float(m_t["tokens"]) == b * s - 7
    # uniform logits: the real vocab only
    _, m0 = cross_entropy_loss(torch.zeros(b, s, vp), torch.full((b, s), 3), v)
    np.testing.assert_allclose(float(m0["ce"]), np.log(v), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_gradients_match_reference(arch):
    """forward_train's logits and aux within 1e-5, and the gradient of
    sum(w * logits) + aux for every parameter within 1e-4 of the
    reference's jax.grad leaf."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    params = jax.jit(lambda key: jmodel.init_params(jcfg, key))(jax.random.PRNGKey(1))
    batch = _batch(cfg, 1)
    feed = {k: jnp.asarray(x) for k, x in batch.items() if k != "targets"}
    w = np.random.default_rng(2).standard_normal((B, S, cfg.vocab_padded)).astype(np.float32)

    def loss_j(p):
        logits, aux = jmodel.forward_train(p, feed, jcfg)
        return jnp.sum(logits * w) + aux

    logits_j, aux_j = jmodel.forward_train(params, feed, jcfg)
    grads_j = jax.grad(loss_j)(params)

    model = lm_params_from_arrays(jax.tree.map(np.asarray, params), cfg, CPU).requires_grad_()
    logits, aux = tmodel.forward_train(model, batch, cfg)
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert _rel(logits, logits_j) <= 1e-5
    assert abs(float(aux.detach()) - float(aux_j)) <= 1e-5 * max(1.0, abs(float(aux_j)))
    (torch.sum(logits * torch.from_numpy(w)) + aux).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert _rel(p.grad, reference_leaf(grads_j, name)) <= 1e-4, name


@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_moe_1b_a400m", "zamba2_7b",
                                  "whisper_base"])
def test_remat_policies_give_equal_gradients(arch):
    """Remat changes memory, not values: "full" (torch.utils.checkpoint),
    "dots" (matrix products saved) and "none" give the same gradients
    bit for bit on the CPU, and the same logits."""
    cfg0 = get_smoke_config(arch)
    batch = _batch(cfg0, 3)
    results = {}
    for policy in ("full", "dots", "none"):
        cfg = cfg0.__class__(**{**cfg0.__dict__, "remat_policy": policy})
        model = tmodel.init_params(cfg, torch.Generator().manual_seed(4), device=CPU)
        model.requires_grad_()
        logits, aux = tmodel.forward_train(model, batch, cfg)
        (logits.square().mean() + aux).backward()
        results[policy] = (logits.detach(), {n: p.grad for n, p in model.named_parameters()})
    for policy in ("dots", "none"):
        assert torch.equal(results[policy][0], results["full"][0]), policy
        for name, g in results["full"][1].items():
            assert torch.equal(results[policy][1][name], g), (policy, name)
    with pytest.raises(ValueError, match="remat_policy"):
        bad = cfg0.__class__(**{**cfg0.__dict__, "remat_policy": "some"})
        tmodel.forward_train(tmodel.init_params(bad, torch.Generator(), device=CPU)
                             .requires_grad_(), batch, bad)


def test_five_adamw_train_steps_match_reference():
    """Five AdamW train steps of the qwen3_8b SMOKE config from one state
    (the reference's, converted): losses within 1e-5, both moments of
    every leaf and every parameter within 1e-4 of their largest element,
    but ``lm_head`` within 1e-3.  Adam divides by sqrt(v^) + eps (1e-8):
    the ``lm_head`` columns of tokens absent from a batch take gradients
    that cancel to about 1e-7 of the leaf's largest, where float32 sums in
    other orders differ by several percent, and those elements then move
    by lr times that difference over eps (2.8e-4 of max|p| measured)."""
    jcfg, cfg = jget_smoke("qwen3_8b"), get_smoke_config("qwen3_8b")
    jopt = jadamw(3e-3)
    jstate = jinit_state(jcfg, jopt, jax.random.PRNGKey(0))
    state = train_state_from_arrays(jax.tree.map(np.asarray, jstate), cfg, "adamw", CPU)
    jstep = jax.jit(jmake_step(jcfg, jopt))
    step = make_train_step(cfg, adamw(3e-3))
    rng = np.random.default_rng(9)
    for i in range(5):
        tokens = rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32)
        batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        state, m = step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
        assert _rel(m["loss"], jm["loss"]) <= 1e-5, i
        for key in ("ce", "accuracy", "aux"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * max(1, abs(float(jm[key])))
    assert state["step"] == int(jstate["step"]) == 5
    assert state["opt_state"]["step"] == int(jstate["opt_state"]["step"])
    for name, p in state["params"].named_parameters():
        bar = 1e-3 if name == "lm_head" else 1e-4
        assert _rel(p, reference_leaf(jstate["params"], name)) <= bar, name
        for moment in ("mu", "nu"):
            assert _rel(state["opt_state"][moment][name],
                        reference_leaf(jstate["opt_state"][moment], name)) <= 1e-4, name


def test_training_reduces_loss():
    """30 steps on the structured synthetic stream must cut the loss (the
    reference's test, on the port alone)."""
    from repro_torch.data.tokens import SyntheticTokens

    cfg = get_smoke_config("qwen3_8b")
    opt = adamw(3e-3)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0), device=CPU)
    step = make_train_step(cfg, opt)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=64, batch_size=8, seed=0)
    losses = []
    for _ in range(30):
        state, m = step(state, {k: torch.from_numpy(x) for k, x in next(data).items()})
        losses.append(float(m["loss"]))
    data.close()
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])
