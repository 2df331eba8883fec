"""Carry a stamped circuit, or a language model's weights, across from
plain arrays into the port.

The system has no weights; its state is the stamped circuit.  These
functions take the fields of a netlist, a stamp pattern, a dense or ELL
state space, one circuit's state space and a transformed system as plain
numpy arrays and scalars — as read off the reference's ``Netlist``,
``StampPattern``, ``BatchedStateSpace``, ``EllBatchedStateSpace``,
``StateSpace`` and ``Transformed2N`` — and build the port's objects, the
operators on a given device.  A test can then feed the identical operator to both
packages' sweeps and hold a kernel apart from assembly.
:func:`lm_params_from_arrays` does the same for a language model's
parameter tree, of any family, and :func:`train_state_from_arrays` for a
whole train state (parameters, optimizer state, step).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.network import Netlist
from repro_torch.core.specs import CircuitParams
from repro_torch.core.transform import Transformed2N
from repro_torch.core.transient import StateSpace
from repro_torch.device import resolve_device
from repro_torch.models import blocks as lm_blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import STACKED, LanguageModel, family_of

NETLIST_ARRAYS = ("branch_i", "branch_j", "branch_g", "ground_g", "supply_g",
                  "supply_v", "cell_i", "cell_j", "cell_w")


def netlists_from_arrays(fields: list[Mapping[str, Any]]) -> list[Netlist]:
    """Netlists from per-system field mappings.

    Each mapping holds ``design``, ``n_unknowns``, ``n_nodes``, the
    component arrays (:data:`NETLIST_ARRAYS`), ``element_count`` (array
    or None) and ``params`` (a mapping of :class:`CircuitParams`
    fields).  Netlists live on the host in both packages.
    """
    out = []
    for f in fields:
        arrays = {}
        for name in NETLIST_ARRAYS:
            dtype = np.int64 if name in ("branch_i", "branch_j", "cell_i", "cell_j") \
                else np.float64
            arrays[name] = np.array(f[name], dtype=dtype)
        elem = f.get("element_count")
        out.append(Netlist(
            design=str(f["design"]),
            n_unknowns=int(f["n_unknowns"]),
            n_nodes=int(f["n_nodes"]),
            params=CircuitParams(**dict(f["params"])),
            element_count=None if elem is None else np.array(elem, dtype=np.float64),
            **arrays,
        ))
    return out


def pattern_from_arrays(*, design: str, n_nodes: int, n_unknowns: int, pair_i,
                        pair_j, gcell_i, states_per_amp: int,
                        buffers: bool) -> engine.StampPattern:
    """The port's (cached) stamp pattern from the primary pattern fields."""
    return engine._cached_pattern(
        str(design), int(n_nodes), int(n_unknowns), np.asarray(pair_i),
        np.asarray(pair_j), np.asarray(gcell_i), int(states_per_amp), bool(buffers),
    )


def state_space_from_arrays(m, c, *, pattern: engine.StampPattern, amp_active,
                            amp_rail: float, slew: float,
                            device=None) -> engine.BatchedStateSpace:
    """Dense state space: ``m`` (B, nz, nz) and ``c`` (B, nz) as float64."""
    dev = resolve_device(device)
    return engine.BatchedStateSpace(
        m=torch.as_tensor(np.asarray(m, dtype=np.float64), device=dev),
        c=torch.as_tensor(np.asarray(c, dtype=np.float64), device=dev),
        pattern=pattern,
        amp_active=np.asarray(amp_active, dtype=bool),
        amp_rail=float(amp_rail),
        slew=float(slew),
    )


def ell_state_space_from_arrays(indices, weights, c, *, pattern: engine.StampPattern,
                                amp_active, amp_rail: float, slew: float,
                                device=None) -> engine.EllBatchedStateSpace:
    """ELL state space: ``indices`` (B, nz, K) int32, ``weights`` (B, nz, K)
    and ``c`` (B, nz) float64, in the reference's row-major slot layout."""
    dev = resolve_device(device)
    return engine.EllBatchedStateSpace(
        indices=torch.as_tensor(np.asarray(indices, dtype=np.int32), device=dev),
        weights=torch.as_tensor(np.asarray(weights, dtype=np.float64), device=dev),
        c=torch.as_tensor(np.asarray(c, dtype=np.float64), device=dev),
        pattern=pattern,
        amp_active=np.asarray(amp_active, dtype=bool),
        amp_rail=float(amp_rail),
        slew=float(slew),
    )


def single_state_space_from_arrays(m, c, *, n_nodes: int, n_unknowns: int, amp_out_index,
                                   amp_int_index, amp_rail: float, slew: float,
                                   device=None) -> StateSpace:
    """One circuit's state space: ``m`` (nz, nz) and ``c`` (nz,) as float64."""
    dev = resolve_device(device)
    return StateSpace(
        m=torch.as_tensor(np.asarray(m, dtype=np.float64), device=dev),
        c=torch.as_tensor(np.asarray(c, dtype=np.float64), device=dev),
        n_nodes=int(n_nodes),
        n_unknowns=int(n_unknowns),
        amp_out_index=np.asarray(amp_out_index, dtype=np.int64),
        amp_int_index=np.asarray(amp_int_index, dtype=np.int64),
        amp_rail=float(amp_rail),
        slew=float(slew),
    )


def transformed_from_arrays(k_a, k_b, d, k_s, b_sign, *, supply_v: float,
                            device=None) -> Transformed2N:
    """A transformed system (one or a batch) with float64 fields."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float64), device=dev)

    return Transformed2N(k_a=t(k_a), k_b=t(k_b), d=t(d), k_s=t(k_s), b_sign=t(b_sign),
                         supply_v=float(supply_v))


# leaves the reference keeps float32 at any param_dtype
FLOAT32_LEAVES = ("w_router", "conv_x_w", "conv_x_b", "conv_bc_w", "conv_bc_b", "dt_bias",
                  "a_log", "d_skip")


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked subtree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def lm_params_from_arrays(tree: Mapping[str, Any], cfg: ModelConfig,
                          device=None) -> LanguageModel:
    """A model of any family from the reference's parameter tree as numpy
    arrays.

    ``tree`` has the reference's layout: ``embed``, ``final_norm``,
    ``lm_head`` (unless ``tie_embeddings``), and by family ``blocks``
    (a leading layer axis on every leaf: ``blocks["attn"]["wq"]`` is
    (n_layers, d, H, dh)), ``shared_attn`` (one block, no layer axis),
    ``enc_blocks``, ``dec_blocks`` and ``enc_final_norm``.  Values go
    through float32 (exact for float32 and bfloat16 sources) to
    ``cfg.p_dtype()``, except the leaves the reference keeps float32
    (:data:`FLOAT32_LEAVES`), which stay float32.
    """
    family = family_of(cfg)
    dev = resolve_device(device)

    def t(x, name: str = "") -> torch.Tensor:
        dtype = torch.float32 if name in FLOAT32_LEAVES else cfg.p_dtype()
        return torch.as_tensor(np.array(x, dtype=np.float32), device=dev).to(dtype)

    def attn(a) -> lm_blocks.Attention:
        norms = {name: t(a[name]) for name in ("q_norm", "k_norm") if name in a}
        return lm_blocks.Attention(*(t(a[name]) for name in ("wq", "wk", "wv", "wo")), **norms)

    def dense(b) -> lm_blocks.DenseBlock:
        return lm_blocks.DenseBlock(
            t(b["ln1"]), attn(b["attn"]), t(b["ln2"]),
            lm_blocks.MLP(*(t(b["mlp"][name]) for name in ("w_gate", "w_up", "w_down"))))

    def moe(b) -> lm_blocks.MoEBlock:
        return lm_blocks.MoEBlock(
            t(b["ln1"]), attn(b["attn"]), t(b["ln2"]),
            lm_blocks.MoE(*(t(b["moe"][name], name)
                            for name in ("w_router", "w_gate", "w_up", "w_down"))))

    def mamba(b) -> lm_blocks.MambaBlock:
        return lm_blocks.MambaBlock(**{name: t(b[name], name) for name in lm_blocks.MAMBA_LEAVES})

    def ln(b) -> lm_blocks.LayerNorm:
        return lm_blocks.LayerNorm(t(b["scale"]), t(b["bias"]))

    def encdec(b) -> lm_blocks.EncDecBlock:
        mlp = lm_blocks.GeluMLP(*(t(b["mlp"][name])
                                  for name in ("w_up", "b_up", "w_down", "b_down")))
        cross = {}
        if "xattn" in b:
            cross = dict(ln_x=ln(b["ln_x"]), xattn=attn(b["xattn"]))
        return lm_blocks.EncDecBlock(ln(b["ln1"]), attn(b["attn"]), ln(b["ln2"]), mlp, **cross)

    def stack(sub, make, n: int) -> list:
        return [make(_layer(sub, i)) for i in range(n)]

    parts: dict = {}
    if family in ("dense", "vlm"):
        parts["blocks"] = stack(tree["blocks"], dense, cfg.n_layers)
    elif family == "moe":
        parts["blocks"] = stack(tree["blocks"], moe, cfg.n_layers)
    elif family in ("ssm", "hybrid"):
        parts["blocks"] = stack(tree["blocks"], mamba, cfg.n_layers)
        if family == "hybrid":
            parts["shared_attn"] = dense(tree["shared_attn"])
    else:
        parts["enc_blocks"] = stack(tree["enc_blocks"], encdec, cfg.n_enc_layers)
        parts["dec_blocks"] = stack(tree["dec_blocks"], encdec, cfg.n_layers)
        parts["enc_final_norm"] = t(tree["enc_final_norm"])
    lm_head = None if cfg.tie_embeddings else t(tree["lm_head"])
    return LanguageModel(t(tree["embed"]), t(tree["final_norm"]), lm_head=lm_head, **parts)



def reference_leaf(tree: Mapping[str, Any], name: str):
    """The reference tree's array for the port's state-dict name ``name``
    (``blocks.3.attn.wq`` -> ``tree["blocks"]["attn"]["wq"][3]``,
    ``shared_attn.mlp.w_up`` -> ``tree["shared_attn"]["mlp"]["w_up"]``)."""
    parts = name.split(".")
    layer = None
    if parts[0] in STACKED:
        layer = int(parts.pop(1))
    node = tree
    for part in parts:
        node = node[part]
    return node if layer is None else node[layer]


def train_state_from_arrays(tree: Mapping[str, Any], cfg: ModelConfig, optimizer_name: str,
                            device=None) -> dict:
    """A port train state from the reference's ``{params, opt_state,
    step}`` as numpy arrays (``jax.tree.map(np.asarray, state)``, or a
    reference checkpoint restored to host arrays).

    ``params`` go through :func:`lm_params_from_arrays` and become
    trainable; the optimizer state is keyed by the port's state-dict
    names: ``mu`` and ``nu`` (``"adamw"``), or ``mu``, ``cov`` and
    ``pinv`` (``"analog_newton"``; ``cov``/``pinv`` for the leaves the
    reference preconditions, its ``None`` leaves left out), all float32,
    and ``step`` as ints.
    """
    if optimizer_name not in ("adamw", "analog_newton"):
        raise ValueError(f"optimizer {optimizer_name!r}: expected adamw or analog_newton")
    dev = resolve_device(device)
    params = lm_params_from_arrays(tree["params"], cfg, dev).requires_grad_(True)
    names = [n for n, _ in params.named_parameters()]
    opt = tree["opt_state"]

    def f32(x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)

    state: dict = {"mu": {n: f32(reference_leaf(opt["mu"], n)) for n in names}}
    if optimizer_name == "adamw":
        state["nu"] = {n: f32(reference_leaf(opt["nu"], n)) for n in names}
    else:
        for key in ("cov", "pinv"):
            leaves = {n: reference_leaf(opt[key], n) for n in names
                      if n.split(".")[0] not in STACKED}
            state[key] = {n: f32(x) for n, x in leaves.items() if x is not None}
    state["step"] = int(np.asarray(opt["step"]))
    return {"params": params, "opt_state": state, "step": int(np.asarray(tree["step"]))}
