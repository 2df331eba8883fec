"""Port parity: the vlm and encdec families' tensor parallelism over
``"model"`` in the sharded train, prefill and decode steps, held against
the port's one-device steps and the reference's on the global batch.

InternVL2's blocks are dense blocks, split as the dense family's; its
patches meet the vocab-parallel lookup's sum, whole embeddings.  A
Whisper rank computes its share of the encoder and the decoder: each
self-attention as a dense block's (heads mode: its q heads over the kv
heads they read; head_dim mode: q, k and v gathered to whole heads, its
columns of the output kept for ``wo``); the cross attention alike, q from
the decoder's ``ln_x`` output entering through f, the cross K/V the
projections of the encoder's output, which enters the decoder through one
f where it leaves the encoder (so the layers' shares of its gradient are
summed over "model" once); the GELU MLP Megatron's, ``w_up``/``b_up``
column- and ``w_down`` row-parallel, g before the replicated ``b_down``.
Decode (head_dim mode) works on a rank's columns of the self and cross
caches, the float32 scores summed over "model" at the whole head's scale.

Eight gloo processes (``tests/torch_distributed_worker.py`` with
``encdec_parallel``) run the SMOKE configs of internvl2_1b (4 heads over
2 kv heads, 8 patches) and whisper_base (4 heads, 4 kv heads, 32 frames)
from the reference's parameters (``jax.random.PRNGKey(0)``) carried
across by ``repro_torch.convert``, patches and frames seeded with numpy,
in ``worker.ENCDEC_CASES``: (2, 4) in heads mode (InternVL2 one q head a
rank over a sliced kv head, Whisper one q and one kv head), (2, 4) in
forced head_dim mode (the production route of both: 4 of head_dim's 16
columns a rank, q, k and v gathered) and (4, 2) in heads mode.  Each runs
three AdamW steps, then a prefill and four greedy decode steps.  The bars
are ``tests/test_torch_tensor_parallel.py``'s (``hold_train``,
``hold_serving``): losses and every element of the step-1 gradients
within 1e-5 of each leaf's max, parameters within 1e-5 of each leaf's
max with the counted exceptions of AdamW's update gaps; logits and every
cache leaf (``k``, ``v``, Whisper's ``xk``, ``xv``) within 1e-5, the
greedy tokens equal.  Every step's gradients are held, and a
parameter's update gaps are summed over the steps (``hold_train(
every_step=True, cumulative=True)``, as the MoE and SSM tests hold
theirs): at (2, 4) Adam's second step drove an element of Whisper's
``dec_blocks.0.attn.wk`` apart by 1.9e-5 of its max from gradients within
the bar, and at (4, 2) the gaps of ``dec_blocks.1.ln2.bias``, a leaf that
starts at zero (its max is three Adam steps, 3e-3), passed 1e-5 of its
max only summed over three steps.  Three planted faults of Whisper's
split must each miss the gradient bar by more than 1000 times.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import test_torch_tensor_parallel as tp_test  # noqa: E402
import torch_distributed_worker as worker  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.distributed.elastic import reshard_state  # noqa: E402
from repro_torch.distributed.rules import make_rules  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.training.step import AUX_WEIGHT, loss_and_grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_distributed_worker.py"
WORLD = 8
TIME_LIMIT_S = 300      # all 8 ranks together
TOL = tp_test.TOL
CASES = [(mesh, mode, arch) for mesh, mode in worker.ENCDEC_CASES
         for arch in worker.ENCDEC_ARCHS]
CASE_IDS = [f"{mesh[0]}x{mesh[1]}-{mode}-{arch}" for mesh, mode, arch in CASES]


@pytest.fixture(scope="module")
def references():
    """Per arch: the reference's config, parameters and numpy tree."""
    out = {}
    for arch in worker.ENCDEC_ARCHS:
        jcfg = jget_smoke(arch)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def encdec_run(tmp_path_factory, references):
    """The 8 gloo ranks of the worker's vlm and encdec cases, within
    TIME_LIMIT_S together, from the reference's parameters; rank 0's
    results by (mesh, mode, arch)."""
    out = tmp_path_factory.mktemp("encdec_parallel")
    for arch, (_, _, tree) in references.items():
        model = lm_params_from_arrays(tree, get_smoke_config(arch), "cpu")
        torch.save(model.state_dict(), out / f"params_{arch}.pt")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD),
                               str(out / "store"), str(out), "encdec_parallel"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=str(ROOT))
             for r in range(WORLD)]
    logs, deadline = [], time.monotonic() + TIME_LIMIT_S
    try:
        for p in procs:
            log = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0]
            logs.append(log.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad
    return torch.load(out / "encdec_rank0.pt", weights_only=True)


@pytest.fixture(scope="module")
def one_device(references):
    """The port's one-device steps and the reference's, by arch."""
    return {arch: tp_test._one_device_train(get_smoke_config(arch), references, arch,
                                            worker.encdec_train_batch(get_smoke_config(arch)),
                                            every_step=True)
            for arch in worker.ENCDEC_ARCHS}


@pytest.mark.parametrize("mesh,mode,arch", CASES, ids=CASE_IDS)
def test_encdec_parallel_train_steps_match_one_device_and_reference(encdec_run, one_device, mesh,
                                                                    mode, arch, request):
    """Three AdamW steps in each case, InternVL2's dense blocks and
    Whisper's encoder and decoder split over "model", against the port's
    one-device steps and the reference's on the global batch (its patches
    or frames included): each loss within 1e-5, every element of the
    step-1 gradients within 1e-5 of its leaf's max|g|, and every
    parameter after each step within 1e-5 of its leaf's max|p|, the
    elements that Adam's first step drives apart within 2 lr a step
    (their number recorded and bounded)."""
    port, ref = one_device[arch]
    amplified = tp_test.hold_train(encdec_run[mesh, mode, arch]["train"], port, ref,
                                   every_step=True, cumulative=True)
    request.node.user_properties.append(("adam_amplified_elements", amplified))


@pytest.mark.parametrize("mesh,mode,arch", CASES, ids=CASE_IDS)
def test_encdec_parallel_prefill_and_decode_match_one_device_and_reference(
        encdec_run, references, mesh, mode, arch):
    """A sharded prefill (in the case's mode; in heads mode one all-to-all
    sends each rank its head_dim columns of every kv head of ``k``/``v``,
    one more of Whisper's ``xk``/``xv``) and four greedy decode steps
    (head_dim mode) on each mesh, at ``hold_serving``'s bars: the logits
    and every cache leaf within 1e-5 after the prefill and after the last
    step, each rank's shard its rows and ``head_dim / m`` columns of
    ``k``, ``v``, ``xk`` and ``xv``; the greedy tokens equal."""
    cfg = get_smoke_config(arch)
    got = encdec_run[mesh, mode, arch]
    want = {"k", "v", "xk", "xv"} if cfg.family == "encdec" else {"k", "v"}
    assert set(got["cache_local"]) == want
    tp_test.hold_serving(got, references, arch, mesh, extra=worker.encdec_inputs(cfg))


def _held_shapes(cfg, m: int, mode: str) -> dict:
    """Every leaf's local shape on rank 0 of a tensor-parallel step on a
    mesh of ``m`` "model" ranks, in ``mode``."""
    d, h, kv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    if mode == "heads":
        # wk/wv hold their kv heads' share where kv_heads divide the axis,
        # else whole (the rank reads the kv head its q heads read)
        kv_l = kv // m if kv % m == 0 else kv
        attn = {"wq": (d, h // m, dh), "wk": (d, kv_l, dh), "wv": (d, kv_l, dh),
                "wo": (h // m, dh, d)}
    else:
        attn = {"wq": (d, h, dh // m), "wk": (d, kv, dh // m), "wv": (d, kv, dh // m),
                "wo": (h, dh // m, d)}
    out = {"embed": (cfg.vocab_padded // m, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_padded // m)

    def block(prefix: str, leaves: dict) -> None:
        out.update({f"{prefix}.{n}": s for n, s in leaves.items()})

    if cfg.family == "vlm":
        for i in range(cfg.n_layers):
            block(f"blocks.{i}", {"ln1": (d,), "ln2": (d,),
                                  **{f"attn.{n}": s for n, s in attn.items()},
                                  "mlp.w_gate": (d, f // m), "mlp.w_up": (d, f // m),
                                  "mlp.w_down": (f // m, d)})
        return out
    ln = {f"{x}.{w}": (d,) for x in ("ln1", "ln2") for w in ("scale", "bias")}
    mlp = {"mlp.w_up": (d, f // m), "mlp.b_up": (f // m,), "mlp.w_down": (f // m, d),
           "mlp.b_down": (d,)}
    for name, n, cross in (("enc_blocks", cfg.n_enc_layers, False),
                           ("dec_blocks", cfg.n_layers, True)):
        for i in range(n):
            leaves = {**ln, **{f"attn.{a}": s for a, s in attn.items()}, **mlp}
            if cross:
                leaves.update({"ln_x.scale": (d,), "ln_x.bias": (d,),
                               **{f"xattn.{a}": s for a, s in attn.items()}})
            block(f"{name}.{i}", leaves)
    out["enc_final_norm"] = (d,)
    return out


@pytest.mark.parametrize("mesh,mode,arch", CASES, ids=CASE_IDS)
def test_a_rank_of_the_sharded_step_holds_its_model_share(encdec_run, mesh, mode, arch):
    """On rank 0 of each case the train step's model holds its ``"model"``
    shard of every leaf the rules split: the attention's q heads (and kv
    heads where they divide the axis) in heads mode, a ``1 / m`` share of
    every head's columns in head_dim mode (Whisper's self and cross
    attention alike), ``ff`` (InternVL2's ``w_gate``/``w_up``/``w_down``,
    Whisper's ``w_up``/``b_up``/``w_down``) and the vocab; the norms,
    ``b_down`` and ``enc_final_norm`` whole; its split names the mode and
    its heads.  A vlm rank's input to its first block (the patches, then
    the vocab-parallel lookup of the tokens summed over "model") is the
    one-device input, bit for bit."""
    cfg = get_smoke_config(arch)
    m = mesh[1]
    held = encdec_run[mesh, mode, arch]["held"]
    assert held["shapes"] == _held_shapes(cfg, m, mode)
    heads = cfg.n_heads // m if mode == "heads" else cfg.n_heads
    kv = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else max(1, heads // (
        cfg.n_heads // cfg.n_kv_heads))
    assert held["split"] == {"attn": mode, "heads": heads,
                             "kv_heads": kv if mode == "heads" else cfg.n_kv_heads,
                             "kv_sliced": mode == "heads" and cfg.n_kv_heads % m != 0,
                             "ff": cfg.d_ff // m, "vocab": cfg.vocab_padded // m, "count": m,
                             "index": 0}
    if cfg.family == "vlm":
        assert torch.equal(held["vlm_input"], held["vlm_input_one_device"])


@pytest.mark.parametrize("mesh,mode,arch", CASES, ids=CASE_IDS)
def test_replicated_leaves_gradients_are_whole_on_every_model_rank(encdec_run, mesh, mode,
                                                                    arch):
    """The leaves replicated over "model" (the norms, Whisper's LayerNorms'
    scales and biases, ``b_down``, ``enc_final_norm``, ``final_norm``)
    come after a region's g or before its f, so each rank's step-1
    gradient of each is whole: the same on every "model" rank (its spread
    over them, relative to its largest element)."""
    cfg = get_smoke_config(arch)
    spread = encdec_run[mesh, mode, arch]["whole_grad_spread"]
    names = [n for n, _ in tmodel.init_params(cfg, None, device="meta").named_parameters()
             if n.endswith(worker.ENCDEC_WHOLE_LEAVES[cfg.family])]
    assert set(spread) == set(names) and len(names) > 3
    assert max(spread.values()) <= 1e-6, spread


def _worst_share(got: dict, want: dict) -> float:
    """The largest step-1 gradient error over the leaves, in bars: TOL of
    the leaf's max|g| (of the model's, NOISE_SHARE of it, for a leaf whose
    gradient is rounding noise)."""
    gmax = {n: float(g.abs().max()) for n, g in want.items()}
    top = max(gmax.values())
    return max(float((got[n] - w).abs().max())
               / (TOL * max(gmax[n], tp_test.NOISE_SHARE * top)) for n, w in want.items())


@pytest.fixture(scope="module")
def b_down_grads(references):
    """The port's one-device step-1 gradients of SMOKE Whisper at
    ``worker.with_b_down`` of the reference's parameters."""
    cfg = get_smoke_config("whisper_base")
    model = lm_params_from_arrays(references["whisper_base"][2], cfg, "cpu")
    params = worker.with_b_down(model.state_dict())
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    return loss_and_grads(model.requires_grad_(True), worker.encdec_train_batch(cfg), cfg,
                          AUX_WEIGHT)[1]


@pytest.mark.parametrize("fault", worker.ENCDEC_FAULTS)
def test_planted_faults_of_the_split_miss_the_bar_by_1000x(encdec_run, one_device, b_down_grads,
                                                          fault, request):
    """On (2, 4) in heads mode, SMOKE Whisper's step-1 gradients within the
    bar of the port's one-device step (at the reference's parameters, and
    at b_down drawn at ``worker.B_DOWN_SCALE``, where the reference's
    zeros would hide a misplaced b_down), and more than 1000 bars away
    under each planted fault: ``b_down`` added to each rank's partial sum
    before g (4 times), the cross K/V projections' f left out (the
    encoder takes a rank's share of their gradient) or doubled (at each
    layer's projection as well as at the encoder's exit: the shares
    summed 4 times)."""
    faults = encdec_run["faults"]
    if fault == "b_down_before_g":
        want, ok = b_down_grads, faults["b_down_ok"]
    else:
        want = one_device["whisper_base"][0]["grads"]
        ok = encdec_run[(2, 4), "heads", "whisper_base"]["train"]["grads_1"]
    assert _worst_share(ok, want) <= 1
    share = _worst_share(faults[fault], want)
    request.node.user_properties.append(("of_bar", share))
    assert share > 1000, share


def test_an_encdec_whose_attentions_the_rules_place_apart_raises():
    """One split serves Whisper's encoder self-attention, decoder
    self-attention and cross attention, so the port reads their mode from
    the first decoder block's ``wq`` and checks the others against it: a
    placement that puts the cross attention's q heads on "model" while
    the rest split head_dim raises, naming the leaves."""
    cfg = get_smoke_config("whisper_base")
    rules = {**make_rules(cfg, model_axis=4), "batch": "data", "q_heads": None,
             "kv_heads": None, "head_dim": "model"}
    heads = {**rules, "q_heads": "model", "kv_heads": "model", "head_dim": None}
    params = dict(tmodel.init_params(cfg, None, device="meta").named_parameters())
    axes = tmodel.param_logical_axes(cfg)
    with fake_world(mesh_shape=(2, 4)) as mesh:
        sharded = reshard_state(params, axes, mesh, rules)
        assert tmodel.gather_params(cfg, sharded).split.attn == "head_dim"
        cross = {n: p for n, p in params.items() if ".xattn." in n}
        sharded.update(reshard_state(cross, {n: axes[n] for n in cross}, mesh, heads))
        with pytest.raises(NotImplementedError, match="dec_blocks.0.xattn.wq"):
            tmodel.gather_params(cfg, sharded)


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of one rank, rendezvous by a FileStore under
    the test's directory."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", worker.ENCDEC_ARCHS)
def test_encdec_steps_on_a_mesh_of_one_are_the_one_device_steps_bit_for_bit(world1, arch):
    """On a (1, 1) mesh, its split of one rank in heads mode (every head
    the rank's), the sharded train step gives the one-device step's
    losses and parameters, and its sharded prefill and decode the
    one-device logits and every cache leaf (Whisper's cross K/V too), bit
    for bit."""
    from repro_torch.launch.mesh import make_debug_mesh, mesh_context
    from repro_torch.optim.adamw import adamw
    from repro_torch.serving.sharded import make_sharded_decode_step, make_sharded_prefill
    from repro_torch.training.step import (
        full_params,
        init_train_state,
        make_sharded_train_step,
        make_train_step,
        shard_train_state,
    )

    cfg = get_smoke_config(arch)
    opt = adamw(worker.LR)
    extra = worker.encdec_inputs(cfg)
    batch = worker.encdec_train_batch(cfg)
    prompts = {"tokens": worker.tp_batches(cfg.vocab)["prompts"], **extra}
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    rules = worker.tp_rules(cfg, "train", model_axis=1)
    one, sharded = (init_train_state(cfg, opt, torch.Generator().manual_seed(0), device="cpu")
                    for _ in range(2))
    with mesh_context(mesh):
        sharded = shard_train_state(sharded, cfg, mesh, rules)
        split = tmodel.gather_params(cfg, sharded["params"]).split
        assert (split.attn, split.heads, split.count) == ("heads", cfg.n_heads, 1)
        step, sstep = make_train_step(cfg, opt), make_sharded_train_step(cfg, opt, mesh)
        for _ in range(2):
            one, m = step(one, batch)
            sharded, sm = sstep(sharded, batch)
            assert torch.equal(m["loss"], sm["loss"])
        got = full_params(sharded)
    for n, p in one["params"].named_parameters():
        assert torch.equal(got[n], p.detach()), n

    model = one["params"]
    logits, cache = tmodel.prefill(model, prompts, cfg, worker.TP_MAX_SEQ)
    named = {n: p.detach() for n, p in model.named_parameters()}
    pre = worker.tp_rules(cfg, "prefill", model_axis=1)
    dec = worker.tp_rules(cfg, "decode", model_axis=1)
    axes = tmodel.param_logical_axes(cfg)
    with mesh_context(mesh):
        slogits, scache = make_sharded_prefill(cfg, mesh, pre, dec, worker.TP_MAX_SEQ)(
            reshard_state(named, axes, mesh, pre), prompts)
        assert torch.equal(slogits.full_tensor(), logits)
        assert set(scache) == set(cache)
        for n in cache:
            assert torch.equal(scache[n].full_tensor(), cache[n]), n
        token = logits.argmax(-1)[:, None].to(torch.int32)
        pos = torch.tensor(worker.decode_start(cfg))
        logits, cache = tmodel.decode_step(model, token, pos, cache, cfg)
        slogits, scache = make_sharded_decode_step(cfg, mesh, dec)(
            reshard_state(named, axes, mesh, dec), token, pos, scache)
        assert torch.equal(slogits.full_tensor(), logits)
        for n in cache:
            assert torch.equal(scache[n].full_tensor(), cache[n]), n
