"""Port parity: the dense family's tensor parallelism over ``"model"`` in
the sharded train, prefill and decode steps, held against the port's
one-device steps and the reference's, and its per-rank work against the
reference's SPMD program.

Eight gloo processes (``tests/torch_distributed_worker.py`` with
``tensor_parallel``) run the SMOKE configs of qwen3_8b (GQA, qk_norm),
command_r_35b (parallel block) and granite_20b (MQA) on the (2, 4)
``("data", "model")`` mesh under ``make_rules(..., model_axis=4)``, from
the reference's parameters (``jax.random.PRNGKey(0)``) carried across by
``repro_torch.convert``.  The SMOKE heads (4, with 2 or 1 kv heads) put
train and prefill in heads mode (a rank's one q head and the kv head it
reads) and decode in head_dim mode (a rank's 4 of each head's 16
columns); qwen3_8b also trains in forced head_dim mode (yi_34b's route:
q, k and v gathered whole).

Bars, relative to each array's largest element: losses 1e-5, every
element of the step-1 gradients 1e-5, and every parameter after each of
three AdamW steps 1e-5, but within 2 lr a step where Adam's first step,
u = g / (|g| + eps), turns the two step-1 gradients' float32 rounding
into steps further apart than that bar (a gradient within a few eps of
zero; ``worker.adam_first_step_gap``), and in a leaf whose gradient is
rounding noise (under 1e-6 of the model's largest).  Those elements are
counted, recorded as the test's ``adam_amplified_elements`` property,
and held under AMPLIFIED_SHARE of the model's.  Logits and the cache
1e-5 (float32 sums in another order through two layers), greedy tokens
equal.  The processes rendezvous through a ``FileStore`` under the
test's own directory.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_distributed_worker as worker  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.training.loss import cross_entropy_loss as jcross_entropy  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro.training.step import make_train_step as jmake_step  # noqa: E402

from repro_torch.configs import SHAPES, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_arrays, reference_leaf  # noqa: E402
from repro_torch.distributed.rules import make_rules  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.training.step import (  # noqa: E402
    AUX_WEIGHT,
    loss_and_grads,
    make_train_step,
)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_distributed_worker.py"
WORLD = 8
TIME_LIMIT_S = 240      # all 8 ranks together; about 15 s alone
TOL = 1e-5
# a leaf whose largest gradient is under this share of the model's largest
# is rounding noise (zero in exact arithmetic)
NOISE_SHARE = 1e-6
# the elements held to 2 lr a step stay under this share of the model's
AMPLIFIED_SHARE = 1e-3
TRAIN_CASES = [(arch, "heads") for arch in worker.TP_ARCHS] + [("qwen3_8b", "head_dim")]


@pytest.fixture(scope="module")
def references():
    """Per arch: the reference's parameters (numpy tree) and config."""
    out = {}
    for arch in worker.TP_ARCHS:
        jcfg = jget_smoke(arch)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory, references):
    """The 8 gloo ranks of the worker's tensor-parallel cases, within
    TIME_LIMIT_S together, from the reference's parameters; rank 0's
    results."""
    out = tmp_path_factory.mktemp("tensor_parallel")
    for arch, (_, _, tree) in references.items():
        model = lm_params_from_arrays(tree, get_smoke_config(arch), "cpu")
        torch.save(model.state_dict(), out / f"params_{arch}.pt")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD),
                               str(out / "store"), str(out), "tensor_parallel"],
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
    return torch.load(out / "tp_rank0.pt", weights_only=True)


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _reference_tree(like, named: dict):
    """The reference's parameter tree, shaped and typed as ``like``, from
    the port's state-dict tensors ``named`` (:func:`reference_leaf`'s
    names, a stacked leaf's layers stacked again)."""
    def build(node, path: tuple):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        names = ([".".join((path[0], str(i)) + path[1:]) for i in range(node.shape[0])]
                 if path[0] in tmodel.STACKED else [".".join(path)])
        arr = np.stack([named[n].detach().float().numpy() for n in names])
        return jnp.asarray(arr if path[0] in tmodel.STACKED else arr[0], node.dtype)

    return build(like, ())


def _one_device_train(cfg, references, arch, batch: dict, every_step: bool = False):
    """The port's one-device steps and the reference's from the same
    parameters: losses, aux losses, parameters after each step and step-1
    gradients; with ``every_step`` each step's gradients too
    (``grads_steps``), and ``grads_at``: the gradients at given
    parameters (a state dict)."""
    jcfg, jp, tree = references[arch]
    model = lm_params_from_arrays(tree, cfg, "cpu").requires_grad_(True)
    _, grads = loss_and_grads(model, batch, cfg, AUX_WEIGHT)
    opt = adamw(worker.LR)
    state = {"params": model, "opt_state": opt.init(dict(model.named_parameters())), "step": 0}
    jopt = jadamw(worker.LR)
    jstate = {"params": jp, "opt_state": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    step, jstep = make_train_step(cfg, opt), jax.jit(jmake_step(jcfg, jopt))
    jbatch = {k: jnp.asarray(x.numpy()) for k, x in batch.items()}

    def jloss(p):
        logits, aux = jmodel.forward_train(p, jbatch, jcfg)
        return jcross_entropy(logits, jbatch["targets"], jcfg.vocab)[0] + AUX_WEIGHT * aux

    jgrad = jax.jit(jax.grad(jloss))

    def jgrads_of(p):
        jg = jgrad(p)
        return {n: torch.from_numpy(np.array(reference_leaf(jg, n), np.float32)) for n in grads}

    def port_grads_at(named: dict) -> dict:
        at = lm_params_from_arrays(tree, cfg, "cpu")
        with torch.no_grad():
            for n, p in at.named_parameters():
                p.copy_(named[n])
        return loss_and_grads(at.requires_grad_(True), batch, cfg, AUX_WEIGHT)[1]

    port = {"losses": [], "aux": [], "params": [], "grads": grads, "grads_steps": [],
            "grads_at": port_grads_at}
    ref = {"losses": [], "aux": [], "params": [], "grads": jgrads_of(jp), "grads_steps": [],
           "grads_at": lambda named: jgrads_of(_reference_tree(jp, named))}
    for _ in range(worker.TP_STEPS):
        if every_step:
            port["grads_steps"].append(loss_and_grads(state["params"], batch, cfg, AUX_WEIGHT)[1])
            ref["grads_steps"].append(jgrads_of(jstate["params"]))
        state, m = step(state, batch)
        jstate, jm = jstep(jstate, jbatch)
        port["losses"].append(float(m["loss"]))
        port["aux"].append(float(m["aux"]))
        port["params"].append({n: p.detach().clone()
                               for n, p in state["params"].named_parameters()})
        ref["losses"].append(float(jm["loss"]))
        ref["aux"].append(float(jm["aux"]))
        ref["params"].append({n: torch.from_numpy(np.array(reference_leaf(jstate["params"], n),
                                                           np.float32))
                              for n in port["params"][-1]})
    return port, ref


def hold_train(got: dict, port: dict, ref: dict, every_step: bool = False,
               cumulative: bool = False, grad_tols: tuple = ()) -> dict:
    """A sharded run's losses, step-1 gradients (with ``every_step``, both
    runs' ``grads_steps`` given: each step's gradients, held after step 1
    to theirs at the sharded run's parameters of that step) and
    parameters after each step against the port's one-device steps and
    the reference's (:func:`_one_device_train`), at the module's bars.  The
    elements held to 2 lr a step are those that Adam's first step drives
    apart or, with ``every_step``, those that its update at that step or
    an earlier one drives apart (``worker.adam_step_gaps``), or with
    ``cumulative`` those whose updates' gaps summed over the steps so far
    pass the bar (a parameter's difference after k steps is at most that
    sum), each step's number bounded.  ``grad_tols`` are (leaf-name
    suffix, bar) pairs that hold those leaves' gradients at their own bar
    in place of TOL.  Returns the elements, by (against, step)."""
    amplified = {}
    for against, want in (("port", port), ("reference", ref)):
        for g, w in zip(got["losses"], want["losses"], strict=True):
            assert abs(g - w) <= TOL * abs(w), (got["losses"], want["losses"])
        gmax = {n: float(g.abs().max()) for n, g in want["grads"].items()}
        noise = {n for n, g in gmax.items() if g < NOISE_SHARE * max(gmax.values())}
        steps = [(got["grads_1"], want["grads"])]
        if every_step:
            steps += [(g, want["grads_at"](snap))
                      for g, snap in zip(got["grads_steps"][1:], got["params"], strict=False)]
        for k, (grads, wgrads) in enumerate(steps, start=1):
            kmax = {n: float(g.abs().max()) for n, g in wgrads.items()}
            for n, w in wgrads.items():
                tol = next((t for suffix, t in grad_tols if n.endswith(suffix)), TOL)
                bar = tol * (max(kmax.values()) if n in noise else kmax[n])
                err = float((grads[n] - w).abs().max())
                assert err <= bar, (against, f"step-{k} gradient", n, err, bar)
        gaps = (worker.adam_step_gaps(got["grads_steps"], want["grads_steps"]) if every_step
                else [worker.adam_first_step_gap(got["grads_1"], want["grads"])])
        free, spent = {}, {}
        for k, (snap, wsnap) in enumerate(zip(got["params"], want["params"], strict=True)):
            gap = gaps[min(k, len(gaps) - 1)]
            if cumulative:
                spent = gap = {n: gap[n] + spent.get(n, 0.0) for n in wsnap}
            free = {n: torch.ones_like(w, dtype=torch.bool) if n in noise
                    else (gap[n] > TOL * float(w.abs().max())) | free.get(n, False)
                    for n, w in wsnap.items()}
            for n, w in wsnap.items():
                bar = torch.where(free[n], 2 * worker.LR * (k + 1), TOL * float(w.abs().max()))
                err = (snap[n] - w).abs()
                assert bool((err <= bar).all()), (against, k, n, float((err - bar).max()))
            amplified[against, k + 1] = sum(int(f.sum()) for n, f in free.items()
                                            if n not in noise)
        total = sum(w.numel() for n, w in want["params"][0].items() if n not in noise)
        last = len(got["params"]) if every_step else 1
        assert amplified[against, last] <= AMPLIFIED_SHARE * total, (against, amplified, total)
    return amplified


@pytest.mark.parametrize("arch,mode", TRAIN_CASES)
def test_tensor_parallel_train_steps_match_one_device_and_reference(tp_run, references, arch,
                                                                    mode, request):
    """Three AdamW steps on (2, 4), tensor parallel (heads mode, or forced
    head_dim mode), against the port's one-device steps and the
    reference's: each loss within 1e-5, every element of the step-1
    gradients within 1e-5 of its leaf's max|g|, and every parameter after
    each step within 1e-5 of its leaf's max|p|, rounding-noise leaves and
    the elements that Adam's first step drives apart within 2 lr a step
    (their number recorded and bounded)."""
    cfg = get_smoke_config(arch)
    got = tp_run[arch]["train" if mode == "heads" else "train_head_dim"]
    port, ref = _one_device_train(cfg, references, arch, worker.tp_batches(cfg.vocab)["train"])
    amplified = hold_train(got, port, ref)
    request.node.user_properties.append(("adam_amplified_elements", amplified))


# the dimension of each cache leaf that the decode rules put on "model"
# (where it divides): the K/V and cross K/V caches' head_dim, the SSD
# state's SSM heads; the conv window is replicated there
CACHE_MODEL_DIMS = {"k": 4, "v": 4, "xk": 4, "xv": 4, "ssm": 2}


def hold_serving(got: dict, references, arch: str, mesh: tuple = (2, 4),
                 extra: dict | None = None) -> None:
    """A sharded prefill and greedy decode on ``mesh`` (``worker.tp_serve``,
    ``extra`` a vlm's patches or an encdec's frames) against the port's
    one-device steps and the reference's: the logits gathered and every
    cache leaf, after the prefill and after the last decode step, within
    TOL, each rank's cache shard its rows and its share on
    CACHE_MODEL_DIMS, the greedy tokens equal."""
    cfg = get_smoke_config(arch)
    jcfg, jp, tree = references[arch]
    batch = {"tokens": worker.tp_batches(cfg.vocab)["prompts"], **(extra or {})}
    model = lm_params_from_arrays(tree, cfg, "cpu")
    logits, cache = tmodel.prefill(model, batch, cfg, worker.TP_MAX_SEQ)
    jlogits, jcache = jmodel.prefill(jp, {k: jnp.asarray(x.numpy()) for k, x in batch.items()},
                                     jcfg, max_seq=worker.TP_MAX_SEQ)
    for want in (logits, jlogits):
        assert _rel(got["prefill_logits"], want) <= TOL
    assert set(got["cache"]) == set(cache) == set(jcache)
    for name in cache:
        shape = list(cache[name].shape)
        shape[1] //= mesh[0]
        if name in CACHE_MODEL_DIMS:
            shape[CACHE_MODEL_DIMS[name]] //= mesh[1]
        assert got["cache_local"][name] == tuple(shape), name
        for want in (cache[name], jcache[name]):
            assert _rel(got["cache"][name], want) <= TOL, name
    token = logits.argmax(-1)[:, None].to(torch.int32)
    jtoken = jnp.argmax(jlogits, axis=-1)[:, None].astype(jnp.int32)
    for i in range(worker.TP_DECODES):
        assert torch.equal(got["tokens"][i], token)
        assert np.array_equal(np.asarray(jtoken), token.numpy())
        pos = worker.decode_start(cfg) + i
        logits, cache = tmodel.decode_step(model, token, pos, cache, cfg)
        jlogits, jcache = jmodel.decode_step(jp, jtoken, jnp.asarray(pos, jnp.int32), jcache,
                                             jcfg)
        for want in (logits, jlogits):
            assert _rel(got["decode_logits"][i], want) <= TOL, i
        token = logits.argmax(-1)[:, None].to(torch.int32)
        jtoken = jnp.argmax(jlogits, axis=-1)[:, None].astype(jnp.int32)
    assert torch.equal(got["tokens"][-1], token)
    for name in cache:
        for want in (cache[name], jcache[name]):
            assert _rel(got["decode_cache"][name], want) <= TOL, ("after decode", name)


@pytest.mark.parametrize("arch", worker.TP_ARCHS)
def test_tensor_parallel_prefill_and_decode_match_one_device_and_reference(tp_run, references,
                                                                           arch):
    """A sharded prefill (heads mode: one all-to-all sends each rank its
    head_dim columns of every kv head) and four greedy decode steps
    (head_dim mode) on (2, 4): the vocab-sharded logits gathered and the
    head_dim-sharded cache within 1e-5 of the port's one-device steps'
    and the reference's, each rank's cache shard a quarter of head_dim
    over half the rows, and the greedy tokens equal."""
    hold_serving(tp_run[arch], references, arch)


def test_head_dim_decode_attention_by_hand(tp_run):
    """One head_dim-mode decode attention, each of 4 ranks holding 4 of 16
    columns: RoPE's pairs (column i with i + 8) fetched from the rank 2
    away, the scores summed over the ranks before the scale, the scale
    1/sqrt(16) of the whole head (not of a rank's 4 columns), and the
    ranks' output columns gathered, against numpy."""
    h = tp_run["hand"]
    q, k, ck, cv = (h[n].double().numpy() for n in ("q", "k", "cache_k", "cache_v"))
    pos, theta = h["pos"].numpy(), h["theta"]
    b, s, kv, dh = ck.shape
    freqs = 1.0 / theta ** (np.arange(0, dh, 2) / dh)

    def rope(x):
        ang = (pos[:, None] * freqs)[:, None, None, :]
        x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
        return np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                               x2 * np.cos(ang) + x1 * np.sin(ang)], axis=-1)

    qr, kr = rope(q), rope(k)
    ck = ck.copy()
    ck[np.arange(b), pos] = kr[:, 0]
    g = q.shape[2] // kv
    scores = np.einsum("bhgd,bkhd->bhgk", qr.reshape(b, kv, g, dh), ck) / np.sqrt(dh)
    scores = np.where(np.arange(s)[None, None, None, :] <= pos[:, None, None, None], scores,
                      -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhgk,bkhd->bhgd", p, cv).reshape(b, 1, q.shape[2], dh)
    assert _rel(h["out"], want) <= 1e-5
    wrong_scale = np.einsum("bhgd,bkhd->bhgk", qr.reshape(b, kv, g, dh), ck) / np.sqrt(dh // 4)
    assert not np.allclose(scores[np.isfinite(scores)], wrong_scale[np.isfinite(scores)])


# ------------------------------------------ a rank's work against GSPMD's

REF_B, REF_S = 4, 64

_REFERENCE_PROG = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax
    from jax.sharding import NamedSharding as NS, PartitionSpec as P
    from repro.configs import SHAPES, get_smoke_config, input_specs
    from repro.distributed.rules import make_rules
    from repro.distributed.sharding import param_specs, use_rules
    from repro.launch.mesh import make_debug_mesh, mesh_context
    from repro.models.model import (cache_logical_axes, decode_step, init_params,
                                    param_logical_axes, prefill)
    from repro.roofline.hlo_parse import loop_aware_costs

    arch, b, s = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    cfg = get_smoke_config(arch)
    mesh = make_debug_mesh((2, 4), ("data", "model"))

    def tree(t):
        return jax.tree.map(lambda x: NS(mesh, x), t, is_leaf=lambda x: isinstance(x, P))

    params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    dec = {**make_rules(cfg, job="decode", model_axis=4), "batch": "data"}
    out = {}
    for kind in ("prefill", "decode"):
        shape = dataclasses.replace(SHAPES[kind + "_32k"], seq_len=s, global_batch=b)
        rules = {**make_rules(cfg, job=kind, model_axis=4), "batch": "data"}
        with mesh_context(mesh), use_rules(rules):
            specs = input_specs(cfg, shape)
            p_specs = tree(param_specs(param_logical_axes(cfg), rules))
            cache = param_specs(cache_logical_axes(cfg), dec)
            if kind == "prefill":
                rows = {k: P("data", *([None] * (len(v.shape) - 1))) for k, v in specs.items()}
                lowered = jax.jit(
                    lambda p, bt: prefill(p, bt, cfg, max_seq=s),
                    in_shardings=(p_specs, tree(rows)),
                    out_shardings=tree((P("data", "model"), cache))).lower(params, specs)
            else:
                lowered = jax.jit(
                    lambda p, t, pos, c: decode_step(p, t, pos, c, cfg),
                    in_shardings=(p_specs, NS(mesh, P("data", None)), NS(mesh, P()),
                                  tree(cache)),
                    out_shardings=tree((P("data", "model"), cache))).lower(
                        params, specs["token"], specs["pos"], specs["cache"])
            out[kind] = loop_aware_costs(lowered.compile().as_text())["flops"]
    print(json.dumps(out))
""")


def _reference_flops(arch: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REFERENCE_PROG, arch, str(REF_B), str(REF_S)],
                         capture_output=True, text=True, env=env, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _moe_products(cfg, kind: str) -> tuple[int, int]:
    """The products of an MoE rank that GSPMD computes otherwise on (2, 4),
    a layer: (the reference's FLOPs, a port rank's), read from the
    reference's lowered HLO and the port's counter at REF_B x REF_S.

    Prefill: the K/V projections.  The reference's program projects K
    and V on each device in two products of half a kv head's columns and
    one of every kv head's (its MoE prefill recomputes k and v for the
    cache, ``repro/models/model.py:403-409``): 2 t d (2 (dh / 2) + KV dh)
    for t = 128 rows' tokens; a port rank projects K and V of the kv head
    its q head reads: 2 t d (2 dh).

    Decode: the router, whose contraction over d GSPMD splits over
    "model" (2 b (d / 4) E, b = 2 rows) where a port rank runs it whole
    (2 b d E); and the experts' three products, which the reference runs
    on the whole batch's capacity (``moe_capacity(4, E, k, 2.0)`` = 8
    slots an expert, the contraction over d split over "data": 3 x 2 E_r 8
    (d / 2) f_r) where a port rank fills only its own kept pairs (min(8,
    b) = 2 slots: 3 x 2 E_r 2 d f_r), E_r and f_r the rank's experts and
    ``ff`` columns."""
    from repro_torch.models.moe import moe_capacity

    d, dh, e = cfg.d_model, cfg.head_dim, cfg.n_experts
    if kind == "prefill":
        t = REF_B // 2 * REF_S
        return 2 * t * d * (2 * (dh // 2) + cfg.n_kv_heads * dh), 2 * t * d * 2 * dh
    b = REF_B // 2
    ep = cfg.moe_parallel == "ep"
    e_r, f_r = (e // 4, cfg.d_ff) if ep else (e, cfg.d_ff // 4)
    cap = moe_capacity(REF_B, e, cfg.top_k, 2.0)
    return (2 * b * (d // 4) * e + 3 * 2 * e_r * cap * (d // 2) * f_r,
            2 * b * d * e + 3 * 2 * e_r * min(cap, b) * d * f_r)


def _ssm_products(cfg, kind: str) -> tuple[int, int]:
    """The products of a Mamba block's rank that GSPMD computes otherwise
    on (2, 4), a layer: (the reference's FLOPs, a port rank's), read from
    the reference's lowered HLO and the port's counter at REF_B x REF_S
    (b = 2 rows a rank, t = 128 tokens).  GSPMD splits B and C over
    "model" (``w_bc``'s 2GN columns, a quarter each) where a port rank
    computes them whole (every head of a group reads them):

    Prefill: the B/C in-projection, 2 t d 2GN / 4 against 2 t d 2GN; the
    conv tail's, 2 b (K - 1) d 2GN / 4 against 2 b (K - 1) d 2GN; and the
    SSD's inter-chunk output, whose contraction over the state N GSPMD
    splits with C: 2 t (H / 4) P N / 4 against 2 t (H / 4) P N.

    Decode: the B/C in-projection, 2 b d 2GN / 4 against 2 b d 2GN, and
    the conv window's product over its K taps on B and C's columns (a
    product in both lowerings), 2 b K 2GN / 4 against 2 b K 2GN."""
    d, k, m = cfg.d_model, cfg.ssm_conv, 4
    gn2, b = 2 * cfg.ssm_groups * cfg.ssm_state, REF_B // 2
    if kind == "prefill":
        t = b * REF_S
        port = (2 * t * d * gn2, 2 * b * (k - 1) * d * gn2,
                2 * t * (cfg.ssm_heads // m) * cfg.ssm_head_dim * cfg.ssm_state)
    else:
        port = (2 * b * d * gn2, 2 * b * k * gn2)
    return sum(x // m for x in port), sum(port)


@pytest.mark.parametrize("arch", worker.TP_ARCHS + worker.EP_ARCHS + worker.SSM_ARCHS
                         + worker.ENCDEC_ARCHS)
def test_per_rank_flops_match_the_references_spmd_program(arch):
    """Prefill and decode of the SMOKE config (4 rows, 64 positions) on the
    (2, 4) mesh: the port's counter on rank 0 of a fake (2, 4) world
    against ``loop_aware_costs`` of the reference's program lowered with
    its ``in_shardings``/``out_shardings`` on 8 host devices (per
    device).  A dense rank's decode FLOPs are equal.  Prefill's are equal
    outside the attention's block term (the reference's whole 512-blocks,
    K8's mask pairs: both taken out) but for one product GSPMD partitions
    otherwise: the K/V projection, whose ``kv_heads`` the rules leave
    off "model", it computes for every kv head on every device, where a
    port rank computes the kv head its q head reads (qwen3_8b and
    command_r_35b: 2 kv heads, 2 x 2 rows x 64 x 64 x 16 x 2 FLOPs a
    projection and layer more in the reference; granite_20b has one).
    An MoE rank (Granite-MoE's two of 8 experts, Mixtral's 32 of 128
    ``ff`` columns of its 4 experts) computes the reference's share of
    the experts in prefill; the products GSPMD computes otherwise are
    :func:`_moe_products`', each with both counts.  A Mamba block's rank
    (2 of the 8 SSM heads) computes the reference's share but for B and
    C, which GSPMD splits over "model" and a port rank computes whole
    (:func:`_ssm_products`, each with both counts); Zamba2's shared
    attention (its kv heads on "model") is the dense family's.  InternVL2's
    blocks are dense blocks (its 2 kv heads off "model": the K/V
    projection as qwen3_8b's; its 64 positions are 8 patches and 56
    tokens).  A Whisper rank (its one of 4 q heads and kv heads in every
    attention) computes GSPMD's share of every product, its encoder's,
    decoder's and cross attention's projections, GELU MLP and logits: the
    attention's terms are the encoder's T x T pairs, the decoder's causal
    S x S and its cross attention's S x T (T = 32 frames), a layer each,
    K8 counting the causal mask's pairs and the reference whole blocks."""
    cfg = get_smoke_config(arch)
    ref = _reference_flops(arch)
    rows, heads = REF_B // 2, cfg.n_heads // 4
    n_attn = (0 if cfg.family == "ssm" else tmodel.hybrid_groups(cfg)[0]
              if cfg.family == "hybrid" else cfg.n_layers)
    for kind in ("prefill", "decode"):
        shape = dataclasses.replace(SHAPES[kind + "_32k"], seq_len=REF_S, global_batch=REF_B)
        rules = {**make_rules(cfg, job=kind, model_axis=4), "batch": "data"}
        with fake_world(mesh_shape=(2, 4)) as mesh:
            counter, _ = dryrun.trace_sharded_cell(cfg, shape, mesh, rules)
        k8 = sum(k["flops"] for k in counter.kernels.values())
        extra = 0
        if cfg.family == "moe":
            ref_layer, port_layer = _moe_products(cfg, kind)
            extra = cfg.n_layers * (ref_layer - port_layer)
        elif cfg.family in ("ssm", "hybrid"):
            ref_layer, port_layer = _ssm_products(cfg, kind)
            extra = cfg.n_layers * (ref_layer - port_layer)
        if kind == "decode":
            assert k8 == 0 and counter.flops + extra == ref["decode"], (
                arch, counter.flops, ref["decode"], extra)
            continue
        pairs, k8_pairs = REF_S * REF_S * n_attn, n_attn * (REF_S * (REF_S + 1) // 2)
        if cfg.family == "encdec":
            t = cfg.enc_len
            cross = t * t * cfg.n_enc_layers + REF_S * t * cfg.n_layers
            pairs, k8_pairs = pairs + cross, k8_pairs + cross
        block = 4 * rows * heads * cfg.head_dim * pairs
        kv_local = 1
        if cfg.family in ("dense", "vlm"):
            extra = 2 * cfg.n_layers * 2 * rows * REF_S * cfg.d_model * cfg.head_dim * (
                cfg.n_kv_heads - kv_local)
        assert k8 == 4 * rows * heads * cfg.head_dim * k8_pairs
        assert counter.flops - k8 + extra == ref["prefill"] - block, (
            arch, counter.flops - k8, ref["prefill"] - block, extra)


def test_a_rank_holds_its_share_of_every_leaf():
    """On rank 0 of a fake (2, 4) world, the tensor-parallel model of each
    mode holds each leaf gathered over "data" alone (its "model" shard):
    heads mode a q head of wq and wo, the K/V projections whole (their
    kv_heads off "model"; the rank reads kv head 0), a quarter of ff and
    of the vocab; head_dim mode a quarter of every head's columns; an
    MoE's experts or their ff columns; a Mamba block's quarter of inner
    and the leaves replicated over "model" whole; InternVL2's blocks as
    the dense family's, and Whisper's encoder self-attention, decoder
    self-attention and cross attention alike, a quarter of its GELU MLP's
    ff (``w_up``, ``b_up``, ``w_down``), ``b_down`` and the LayerNorms
    whole, in prefill and decode."""
    from repro_torch.distributed.elastic import reshard_state

    cfg = get_smoke_config("qwen3_8b")
    params = dict(tmodel.init_params(cfg, None, device="meta").named_parameters())
    axes = tmodel.param_logical_axes(cfg)
    for job, mode in (("prefill", "heads"), ("decode", "head_dim")):
        rules = {**make_rules(cfg, job=job, model_axis=4), "batch": "data"}
        with fake_world(mesh_shape=(2, 4)) as mesh:
            model = tmodel.gather_params(cfg, reshard_state(params, axes, mesh, rules))
        split = model.split
        assert (split.attn, split.index, split.count) == (mode, 0, 4)
        attn = model.blocks[0].attn
        d, dh = cfg.d_model, cfg.head_dim
        if mode == "heads":
            assert (split.heads, split.kv_heads, split.kv_first, split.kv_sliced) == (1, 1, 0,
                                                                                    True)
            assert attn.wq.shape == (d, 1, dh) and attn.wo.shape == (1, dh, d)
            assert attn.wk.shape == (d, cfg.n_kv_heads, dh)
        else:
            assert attn.wq.shape == (d, cfg.n_heads, dh // 4)
            assert attn.wk.shape == (d, cfg.n_kv_heads, dh // 4)
            assert attn.wo.shape == (cfg.n_heads, dh // 4, d)
        assert model.blocks[0].mlp.w_gate.shape == (d, cfg.d_ff // 4) == (d, split.ff)
        assert model.embed.shape == (cfg.vocab_padded // 4, d) == (split.vocab, d)
        assert model.final_norm.shape == (d,)
        assert split.moe == "replicated"
    # an MoE rank's experts: Granite-MoE's 2 of 8 (expert parallel),
    # Mixtral's 32 of 128 ff columns of each of its 4 (inside the experts);
    # the router whole; its place among the 2 batch shards
    for arch, mode, experts, ff in (("granite_moe_1b_a400m", "experts", 2, 64),
                                    ("mixtral_8x22b", "ff", 4, 32)):
        cfg = get_smoke_config(arch)
        params = dict(tmodel.init_params(cfg, None, device="meta").named_parameters())
        rules = {**make_rules(cfg, model_axis=4), "batch": "data"}
        with fake_world(mesh_shape=(2, 4)) as mesh:
            model = tmodel.gather_params(cfg, reshard_state(
                params, tmodel.param_logical_axes(cfg), mesh, rules), batch_axes=("data",))
        split, moe, d = model.split, model.blocks[0].moe, cfg.d_model
        assert (split.moe, split.experts, split.expert_first, split.ff) == (mode, experts, 0, ff)
        assert moe.w_gate.shape == moe.w_up.shape == (experts, d, ff)
        assert moe.w_down.shape == (experts, ff, d)
        assert moe.w_router.shape == (d, cfg.n_experts)
        assert model.blocks[0].attn.wq.shape == (d, 1, cfg.head_dim)
        assert (model.batch_shard.index, model.batch_shard.count) == (0, 2)
    # a Mamba block's rank: its quarter of inner (2 of the 8 SSM heads, 32
    # of 128 columns) in w_z, w_x, the x conv, norm_scale and w_out; w_bc,
    # w_dt, the B/C conv and the per-head leaves whole; Zamba2's shared
    # block as the dense family's (train and prefill: a q head, the kv head
    # it reads, a quarter of ff; decode: a quarter of head_dim)
    for arch, job in (("mamba2_370m", "train"), ("zamba2_7b", "prefill"),
                      ("zamba2_7b", "decode")):
        cfg = get_smoke_config(arch)
        params = dict(tmodel.init_params(cfg, None, device="meta").named_parameters())
        rules = {**make_rules(cfg, job=job, model_axis=4), "batch": "data"}
        with fake_world(mesh_shape=(2, 4)) as mesh:
            model = tmodel.gather_params(cfg, reshard_state(
                params, tmodel.param_logical_axes(cfg), mesh, rules))
        split, p = model.split, model.blocks[-1]
        d, d_in, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        gn2, k = 2 * cfg.ssm_groups * cfg.ssm_state, cfg.ssm_conv
        assert (split.ssm, split.ssm_heads, split.ssm_first) == ("heads", h // 4, 0)
        assert {n: tuple(x.shape) for n, x in p.named_parameters()} == {
            "ln": (d,), "w_z": (d, d_in // 4), "w_x": (d, d_in // 4), "w_bc": (d, gn2),
            "w_dt": (d, h), "conv_x_w": (k, d_in // 4), "conv_x_b": (d_in // 4,),
            "conv_bc_w": (k, gn2), "conv_bc_b": (gn2,), "dt_bias": (h,), "a_log": (h,),
            "d_skip": (h,), "norm_scale": (d_in // 4,), "w_out": (d_in // 4, d)}
        assert model.embed.shape == (cfg.vocab_padded // 4, d) == (split.vocab, d)
        if arch == "mamba2_370m":
            assert (split.attn, split.heads, split.ff, model.shared_attn) == ("none", 0, 0, None)
            continue
        attn = model.shared_attn.attn
        if job == "prefill":
            assert (split.attn, split.heads, split.kv_heads, split.kv_sliced) == ("heads", 1, 1,
                                                                                False)
            assert attn.wq.shape == attn.wk.shape == (d, 1, cfg.head_dim)
        else:
            assert split.attn == "head_dim"
            assert attn.wq.shape == (d, cfg.n_heads, cfg.head_dim // 4)
        assert model.shared_attn.mlp.w_gate.shape == (d, cfg.d_ff // 4) == (d, split.ff)
    # InternVL2: 4 q heads over 2 kv heads, so in heads mode a rank's one q
    # head reads a sliced kv head (wk whole); Whisper: 4 q and 4 kv heads, a
    # rank's one of each, in all three attentions
    for arch, job in (("internvl2_1b", "prefill"), ("internvl2_1b", "decode"),
                      ("whisper_base", "prefill"), ("whisper_base", "decode")):
        cfg = get_smoke_config(arch)
        params = dict(tmodel.init_params(cfg, None, device="meta").named_parameters())
        rules = {**make_rules(cfg, job=job, model_axis=4), "batch": "data"}
        with fake_world(mesh_shape=(2, 4)) as mesh:
            model = tmodel.gather_params(cfg, reshard_state(
                params, tmodel.param_logical_axes(cfg), mesh, rules))
        split, vlm = model.split, cfg.family == "vlm"
        d, h, kv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
        if job == "prefill":
            kv_l = kv if vlm else kv // 4
            assert (split.attn, split.heads, split.kv_heads, split.kv_sliced) == ("heads", 1, 1,
                                                                                vlm)
            want = {"wq": (d, 1, dh), "wk": (d, kv_l, dh), "wv": (d, kv_l, dh), "wo": (1, dh, d)}
        else:
            assert split.attn == "head_dim"
            want = {"wq": (d, h, dh // 4), "wk": (d, kv, dh // 4), "wv": (d, kv, dh // 4),
                    "wo": (h, dh // 4, d)}
        attns = ([model.blocks[0].attn] if vlm else
                 [model.enc_blocks[0].attn, model.dec_blocks[-1].attn, model.dec_blocks[-1].xattn])
        for attn in attns:
            assert {n: tuple(x.shape) for n, x in attn.named_parameters()} == want
        assert split.ff == f // 4 and model.embed.shape == (cfg.vocab_padded // 4, d)
        if vlm:
            assert model.blocks[0].mlp.w_gate.shape == (d, f // 4)
            continue
        for block in (model.enc_blocks[0], model.dec_blocks[-1]):
            assert {n: tuple(x.shape) for n, x in block.mlp.named_parameters()} == {
                "w_up": (d, f // 4), "b_up": (f // 4,), "w_down": (f // 4, d), "b_down": (d,)}
            assert block.ln1.scale.shape == block.ln2.bias.shape == (d,)
        assert model.dec_blocks[0].ln_x.bias.shape == model.enc_final_norm.shape == (d,)


def test_one_device_paths_have_no_split():
    """A model from init_params has no split and no batch shard, and its
    MoE, Mamba and Whisper blocks run with neither (the one-device
    arithmetic: every leaf whole, no collective); gather_params gives a
    split to a model of every family on a mesh with a "model" axis (a
    vlm's too: its wq is the rank's share)."""
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.models import ssm as tssm
    from repro_torch.models.layers import gelu_mlp, layer_norm

    archs = ("qwen3_8b", "granite_moe_1b_a400m", "mamba2_370m", "zamba2_7b", "internvl2_1b",
             "whisper_base")
    for arch in archs:
        model = tmodel.init_params(get_smoke_config(arch), None, device="meta")
        assert model.split is None and model.batch_shard is None
    cfg = get_smoke_config("granite_moe_1b_a400m")
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    p, positions = model.blocks[0], torch.arange(8).expand(2, 8)
    with torch.no_grad():
        out, aux, _ = tblocks.moe_block_forward(x, p, cfg, positions)
        a, _ = tblocks.attn_forward(tblocks.rms_norm(x, p.ln1, cfg.norm_eps), p.attn, cfg,
                                    positions=positions)
        h = tblocks.rms_norm(x + a, p.ln2, cfg.norm_eps).reshape(16, cfg.d_model)
        y, want_aux = tmoe.moe_ffn(h, p.moe, n_experts=cfg.n_experts, top_k=cfg.top_k,
                                   groups=cfg.dispatch_groups)
    assert torch.equal(out, x + a + y.reshape(2, 8, -1)) and torch.equal(aux, want_aux)
    # a Mamba block without a split: its own leaves, whole, and the block's
    # one-device sums (the conv tail and the decode window whole too)
    ssm = get_smoke_config("mamba2_370m")
    model = tmodel.init_params(ssm, torch.Generator().manual_seed(0), device="cpu")
    p = model.blocks[0]
    assert tssm.rank_leaves(p, None) is p
    x = torch.randn((2, 32, ssm.d_model), generator=torch.Generator().manual_seed(1))
    conv = torch.randn((2, ssm.ssm_conv - 1, ssm.d_inner + 2 * ssm.ssm_state),
                       generator=torch.Generator().manual_seed(2))
    state = torch.randn((2, ssm.ssm_heads, ssm.ssm_head_dim, ssm.ssm_state),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out, final = tblocks.mamba_block_forward(x, p, ssm)
        hn = tblocks.rms_norm(x, p.ln, ssm.norm_eps)
        y, want_final = tssm.mamba2_forward(hn, p, ssm)
        assert torch.equal(out, x + y) and torch.equal(final, want_final)
        assert final.shape == (2, ssm.ssm_heads, ssm.ssm_head_dim, ssm.ssm_state)
        tail = hn[:, -(ssm.ssm_conv - 1):]
        assert torch.equal(tblocks.mamba_conv_tail(x, p, ssm),
                           torch.cat([tail @ p.w_x, tail @ p.w_bc], dim=-1))
        step, new_conv, new_state = tblocks.mamba_block_decode(x[:, :1], p, ssm, conv, state)
        y, want_conv, want_state = tssm.mamba2_decode(hn[:, :1], p, ssm, conv, state)
        assert torch.equal(step, x[:, :1] + y) and torch.equal(new_conv, want_conv)
        assert torch.equal(new_state, want_state) and new_conv.shape == conv.shape
    # Whisper's blocks without a split: the GELU MLP's b_down added once to
    # the one-device product, the cross attention over the one-device K/V
    enc = get_smoke_config("whisper_base")
    model = tmodel.init_params(enc, torch.Generator().manual_seed(0), device="cpu")
    p = model.dec_blocks[0]
    with torch.no_grad():
        p.mlp.b_down.normal_(generator=torch.Generator().manual_seed(4))
        x = torch.randn((2, 8, enc.d_model), generator=torch.Generator().manual_seed(1))
        e = torch.randn((2, enc.enc_len, enc.d_model), generator=torch.Generator().manual_seed(2))
        h = layer_norm(x, p.ln2.scale, p.ln2.bias, enc.norm_eps)
        u = torch.nn.functional.gelu((h @ p.mlp.w_up + p.mlp.b_up).float(), approximate="tanh")
        assert torch.equal(gelu_mlp(h, p.mlp), u @ p.mlp.w_down + p.mlp.b_down)
        assert tblocks.cross_source(e) is e
        xk, xv = tblocks.encdec_cross_kv(p.xattn, enc, e)
        assert torch.equal(xk, tblocks._project(e, p.xattn.wk))
        out, (k, v) = tblocks.decoder_block_forward(x, p, enc, torch.arange(8).expand(2, 8), e)
        assert out.shape == x.shape and k.shape == (2, 8, enc.n_kv_heads, enc.head_dim)
    # every family splits over "model": InternVL2's rank holds its q head of wq
    vlm = get_smoke_config("internvl2_1b")
    params = dict(tmodel.init_params(vlm, None, device="meta").named_parameters())
    axes = tmodel.param_logical_axes(vlm)
    rules = {**make_rules(vlm, model_axis=4), "batch": "data"}
    with fake_world(mesh_shape=(2, 4)) as mesh:
        model = tmodel.gather_params(vlm, reshard_state(params, axes, mesh, rules))
    assert (model.split.attn, model.split.count) == ("heads", 4)
    assert model.blocks[0].attn.wq.shape == (vlm.d_model, vlm.n_heads // 4, vlm.head_dim)
    for arch in archs:
        cfg = get_smoke_config(arch)
        params = dict(tmodel.init_params(cfg, None, device="meta").named_parameters())
        rules = {**make_rules(cfg, model_axis=4), "batch": "data"}
        with fake_world(mesh_shape=(2, 4)) as mesh:
            split = tmodel.gather_params(cfg, reshard_state(
                params, tmodel.param_logical_axes(cfg), mesh, rules)).split
        assert split is not None and split.count == 4, arch
