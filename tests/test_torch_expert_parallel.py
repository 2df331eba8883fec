"""Port parity: the MoE family's sharded train, prefill and decode steps,
held against the port's one-device steps and the reference's on the
global batch.

The sharded steps dispatch the reference's groups of the global batch
(``repro_torch.models.moe``: a rank holds whole groups, or its share of
a group that spans ranks, its capacity ranks offset by the expert's
pairs on the group's earlier ranks) and split the experts over
``"model"``: Granite-MoE expert parallel (``"expert"`` on ``"model"``),
Mixtral tensor parallel inside the experts (``"ff"`` on ``"model"``),
the attention as the dense family's (heads mode in train and prefill,
head_dim mode in decode).

Eight gloo processes (``tests/torch_distributed_worker.py`` with
``expert_parallel``) run the SMOKE configs of granite_moe_1b_a400m (8
experts, top 4) and mixtral_8x22b (4 experts, top 2), both with
``dispatch_groups`` 2, from the reference's parameters
(``jax.random.PRNGKey(0)``) carried across by ``repro_torch.convert``,
on two ``("data", "model")`` meshes under ``make_rules(...,
model_axis=m)``: (2, 4), where each rank holds one dispatch group, and
(4, 2), where a group spans two ranks and decode's one flat group four.
Each runs three AdamW steps on a seeded batch and on the reference's
(every token 3: every token of a group picks the same experts, so the
capacity binds), then a prefill and four greedy decode steps.  The bars
are ``tests/test_torch_tensor_parallel.py``'s (``hold_train``,
``hold_serving``); the aux loss of each step within 1e-5 of the
reference's.
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
import jax.numpy as jnp  # noqa: E402
import test_torch_tensor_parallel as tp_test  # noqa: E402
import torch_distributed_worker as worker  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import embed_tokens  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_distributed_worker.py"
WORLD = 8
TIME_LIMIT_S = 300      # all 8 ranks together
TOL = tp_test.TOL
CASES = [(mesh, arch) for mesh in worker.EP_MESHES for arch in worker.EP_ARCHS]
BATCHES = ("train", "train_threes")


@pytest.fixture(scope="module")
def references():
    """Per arch: the reference's config, parameters and numpy tree."""
    out = {}
    for arch in worker.EP_ARCHS:
        jcfg = jget_smoke(arch)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory, references):
    """The 8 gloo ranks of the worker's expert-parallel cases, within
    TIME_LIMIT_S together, from the reference's parameters; rank 0's
    results by (mesh, arch)."""
    out = tmp_path_factory.mktemp("expert_parallel")
    for arch, (_, _, tree) in references.items():
        model = lm_params_from_arrays(tree, get_smoke_config(arch), "cpu")
        torch.save(model.state_dict(), out / f"params_{arch}.pt")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD),
                               str(out / "store"), str(out), "expert_parallel"],
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
    return torch.load(out / "ep_rank0.pt", weights_only=True)


def _batch(arch: str, name: str) -> dict:
    vocab = get_smoke_config(arch).vocab
    return worker.tp_batches(vocab)["train"] if name == "train" else \
        worker.batches(vocab)["threes"]


@pytest.fixture(scope="module")
def one_device(references):
    """The port's one-device steps and the reference's, by (arch, batch)."""
    return {(arch, name): tp_test._one_device_train(get_smoke_config(arch), references, arch,
                                                    _batch(arch, name), every_step=True)
            for arch in worker.EP_ARCHS for name in BATCHES}


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mesh,arch", CASES)
def test_expert_parallel_train_steps_match_one_device_and_reference(ep_run, one_device, mesh,
                                                                    arch, batch, request):
    """Three AdamW steps on each mesh, the experts split over "model" and
    the dispatch groups the global batch's, against the port's one-device
    steps and the reference's on the global batch: the losses, every
    element of the step-1 gradients and the parameters after each step
    at ``hold_train``'s bars, the elements that Adam's update at that step
    or an earlier one drives apart held to 2 lr a step (recorded and
    bounded).  The one-device port and the reference differ so at step 2
    themselves (one element of Granite-MoE's layer-0 ``wo``, whose
    gradient changes sign near zero)."""
    port, ref = one_device[arch, batch]
    amplified = tp_test.hold_train(ep_run[mesh, arch][batch], port, ref, every_step=True)
    request.node.user_properties.append(("adam_amplified_elements", amplified))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mesh,arch", CASES)
def test_sharded_aux_loss_is_the_global_batchs(ep_run, one_device, mesh, arch, batch):
    """Each step's aux loss (the rank's shares summed) within 1e-5 of the
    reference's on the global batch and of the port's one-device step's.
    A rank that cut its own rows into ``dispatch_groups`` groups would
    give each group a share of the capacity and its own load statistics
    (the SMOKE Granite-MoE's aux 1.0775 against 1.1015 at 64 tokens)."""
    got = ep_run[mesh, arch][batch]["aux"]
    port, ref = one_device[arch, batch]
    for want in (ref["aux"], port["aux"]):
        for g, w in zip(got, want, strict=True):
            assert abs(g - w) <= TOL * abs(w), (got, want)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_expert_parallel_prefill_and_decode_match_one_device_and_reference(ep_run, references,
                                                                           mesh, arch):
    """A sharded prefill (heads mode, the cache out by the decode rules in
    one all-to-all) and four greedy decode steps (head_dim mode, one flat
    dispatch of the global batch at capacity factor 2) on each mesh, at
    ``hold_serving``'s bars: logits and cache within 1e-5, each rank's
    cache shard its rows and head_dim columns, the greedy tokens equal."""
    tp_test.hold_serving(ep_run[mesh, arch], references, arch, mesh)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_the_router_gradient_is_whole_on_every_model_rank(ep_run, mesh, arch):
    """The router runs whole on every "model" rank and f sits on the
    experts' input alone: the step-1 gradient of every layer's router is
    the same on every "model" rank (its spread over them, relative to its
    largest element)."""
    spread = ep_run[mesh, arch]["router_grad_spread"]
    assert spread and max(spread.values()) <= 1e-6, spread


@pytest.mark.parametrize("arch", worker.EP_ARCHS)
def test_the_capacity_binds_on_the_reference_batch(references, arch):
    """On the reference's batch (every token 3) the first MoE layer's
    input is one vector for every token (the attention averages equal
    values), so every token of a dispatch group picks the same experts
    and the group's capacity drops pairs: the port's one-device dispatch
    of the global batch's groups keeps at most ``cap`` pairs an expert
    and drops the rest."""
    cfg = get_smoke_config(arch)
    model = lm_params_from_arrays(references[arch][2], cfg, "cpu")
    tokens = worker.batches(cfg.vocab)["threes"]["tokens"]
    x = embed_tokens(tokens.long(), model.embed)
    b, s, d = x.shape
    positions = torch.arange(s).expand(b, s)
    p = model.blocks[0]
    x, _ = tblocks._attention_half(x, p, cfg, None, lambda h: tblocks.attn_forward(
        h, p.attn, cfg, positions=positions))
    h = tblocks.rms_norm(x, p.ln2, cfg.norm_eps).reshape(b * s, d)
    groups = cfg.dispatch_groups
    route = tmoe.moe_route(h.reshape(groups, b * s // groups, d), p.moe.w_router,
                           n_experts=cfg.n_experts, top_k=cfg.top_k)
    dropped = route["pair_slot"] == route["src_for_slot"].numel()
    assert (route["top_i"] == route["top_i"][:, :1]).all()
    assert int(dropped.sum()) == groups * cfg.top_k * (b * s // groups - route["cap"]) > 0


class _Shard:
    def __init__(self, index: int, count: int):
        self.index, self.count = index, count


@pytest.mark.parametrize("n,groups,count,want", [
    (64, 2, 1, (2, None)),          # one device: the groups themselves
    (64, 2, 2, (1, None)),          # (2, 4): a group a rank
    (64, 16, 4, (4, None)),         # a rank holds four groups
    (32, 2, 4, (1, (2, 64))),       # (4, 2): a group spans two ranks of 32 tokens
    (1, 1, 4, (1, (4, 4))),         # decode: one flat group over four ranks
    (30, 8, 2, (1, (2, 60))),       # 60 % 8 != 0: flat over the global batch
])
def test_dispatch_plan_places_a_rank_in_the_reference_groups(n, groups, count, want):
    """``dispatch_plan`` of a rank's n tokens, share ``index`` of ``count``
    of a batch that the reference cuts into ``groups`` groups (flat where
    they do not divide the global token count): the rank's whole groups,
    or its group's span (ranks, tokens) and first rank."""
    for index in range(count):
        local, span = tmoe.dispatch_plan(n, groups, None if count == 1 else
                                         _Shard(index, count))
        assert local == want[0]
        if want[1] is None:
            assert span is None
        else:
            ranks, tokens = want[1]
            assert (span.ranks, span.tokens, span.first) == (ranks, tokens,
                                                             index // ranks * ranks)


def test_dispatch_plan_refuses_groups_that_cut_across_ranks():
    """Six batch shards and four groups: neither divides the other, so a
    group would end inside a rank's rows."""
    with pytest.raises(NotImplementedError, match="6 batch shards and 4 MoE dispatch groups"):
        tmoe.dispatch_plan(8, 4, _Shard(0, 6))


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


@pytest.mark.parametrize("arch", worker.EP_ARCHS)
def test_moe_steps_on_a_mesh_of_one_are_the_one_device_steps_bit_for_bit(world1, arch):
    """On a (1, 1) mesh (its split of one rank, no batch shard) the MoE's
    sharded train step gives the one-device step's losses, aux losses and
    parameters, and its sharded prefill and decode the one-device logits
    and cache, bit for bit."""
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_debug_mesh, mesh_context
    from repro_torch.models import model as tmodel
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
    batch = worker.tp_batches(cfg.vocab)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    rules = worker.tp_rules(cfg, "train", model_axis=1)
    one, sharded = (init_train_state(cfg, opt, torch.Generator().manual_seed(0), device="cpu")
                    for _ in range(2))
    with mesh_context(mesh):
        sharded = shard_train_state(sharded, cfg, mesh, rules)
        step, sstep = make_train_step(cfg, opt), make_sharded_train_step(cfg, opt, mesh)
        for _ in range(2):
            one, m = step(one, batch["train"])
            sharded, sm = sstep(sharded, batch["train"])
            assert torch.equal(m["loss"], sm["loss"]) and torch.equal(m["aux"], sm["aux"])
        got = full_params(sharded)
    for n, p in one["params"].named_parameters():
        assert torch.equal(got[n], p.detach()), n

    model = one["params"]
    logits, cache = tmodel.prefill(model, {"tokens": batch["prompts"]}, cfg, worker.TP_MAX_SEQ)
    named = {n: p.detach() for n, p in model.named_parameters()}
    pre = worker.tp_rules(cfg, "prefill", model_axis=1)
    dec = worker.tp_rules(cfg, "decode", model_axis=1)
    axes = tmodel.param_logical_axes(cfg)
    with mesh_context(mesh):
        slogits, scache = make_sharded_prefill(cfg, mesh, pre, dec, worker.TP_MAX_SEQ)(
            reshard_state(named, axes, mesh, pre), {"tokens": batch["prompts"]})
        assert torch.equal(slogits.full_tensor(), logits)
        for n in cache:
            assert torch.equal(scache[n].full_tensor(), cache[n]), n
        token = logits.argmax(-1)[:, None].to(torch.int32)
        pos = torch.tensor(worker.TP_PROMPT)
        logits, cache = tmodel.decode_step(model, token, pos, cache, cfg)
        slogits, scache = make_sharded_decode_step(cfg, mesh, dec)(
            reshard_state(named, axes, mesh, dec), token, pos, scache)
        assert torch.equal(slogits.full_tensor(), logits)
        for n in cache:
            assert torch.equal(scache[n].full_tensor(), cache[n]), n
