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
:func:`lm_params_from_arrays` does the same for a dense decoder's
parameter tree.
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
from repro_torch.models.model import DenseDecoder, _require_dense

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


def lm_params_from_arrays(tree: Mapping[str, Any], cfg: ModelConfig,
                          device=None) -> DenseDecoder:
    """A dense decoder from the reference's parameter tree as numpy arrays.

    ``tree`` has the reference's layout: ``embed``, ``final_norm``,
    ``lm_head`` (unless ``tie_embeddings``) and ``blocks`` with a leading
    layer axis on every leaf (``blocks["attn"]["wq"]`` is
    (n_layers, d, H, dh)).  Values are cast to ``cfg.p_dtype()`` through
    float32 (exact for float32 and bfloat16 sources).
    """
    _require_dense(cfg)
    dev = resolve_device(device)

    def t(x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, dtype=np.float32), device=dev).to(cfg.p_dtype())

    blocks = tree["blocks"]
    attn, mlp = blocks["attn"], blocks["mlp"]
    layers = []
    for i in range(cfg.n_layers):
        norms = {name: t(attn[name][i]) for name in ("q_norm", "k_norm") if name in attn}
        layers.append(lm_blocks.DenseBlock(
            t(blocks["ln1"][i]),
            lm_blocks.Attention(*(t(attn[name][i]) for name in ("wq", "wk", "wv", "wo")),
                                **norms),
            t(blocks["ln2"][i]),
            lm_blocks.MLP(*(t(mlp[name][i]) for name in ("w_gate", "w_up", "w_down"))),
        ))
    lm_head = None if cfg.tie_embeddings else t(tree["lm_head"])
    return DenseDecoder(t(tree["embed"]), t(tree["final_norm"]), layers, lm_head)
