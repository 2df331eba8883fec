#!/usr/bin/env python3
"""Bit-level record of K8 (flash attention) on a CUDA device.

    PYTHONPATH=<tree>/src python3 scripts/k8_bits.py --save FILE.npz [--train]
    python3 scripts/k8_bits.py --compare A.npz B.npz

``--save`` runs, with whichever ``repro_torch`` is first on the path, K8's
forward without the row log-sum-exp at every case of
``chip_smoke.K8_CASES`` (the serving path's shapes, each head size, both
routes, p rounded or not) from the smoke's seed, and saves every output.
Where the package has ``flash_attention_lse`` it also prints whether the
forward that writes ``lse`` gives, bit for bit, the output of the one that
does not, and saves the backward at every case of
``chip_smoke.K8_BWD_CASES``: Delta; dq, dk and dv on the FMA route at the
float32 cases and, through views off the 16-byte grid, at the bf16 cases
of ``chip_smoke.K8_BWD_FMA_VIEW``; and dq, dk and dv of the bf16 cases on
the 16-byte grid (the tensor-core route where the package has it).
``--train`` also saves the loss curve of ``chip_smoke.py``'s train case
(a), examples/train_lm.py's default run (300 AnalogNewton steps, float32).
``--compare`` prints, per output, whether two saved runs (for example two
commits of the package on one card) agree bit for bit, and for each that
differs how much: the largest |a - b| over max |b| of an array and its
largest share of K8's float32 bar 1e-6 + 1e-5 |b| (``of_f32_bar``), the
largest |a - b| of the loss curve; it exits 1 if any differs.  Each
forward case also saves its row lse (``{label}_lse``).  To compare
two commits, run this script of one tree twice, once with each tree's
``src`` first on the path, so that both runs take the same cases.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16 if x.dtype == smoke.BF16 else torch.int32).cpu().numpy()


def backward_bits(fa, gen) -> dict[str, np.ndarray]:
    """At every case of K8_BWD_CASES: Delta (``{label}_delta``); dq, dk, dv
    of the FMA route at the float32 cases and, off the 16-byte grid, at
    K8_BWD_FMA_VIEW's bf16 cases (``{label}_{name}``); dq, dk, dv of the
    bf16 cases on the grid (``{label}_mma_{name}``)."""
    out = {}
    for case in smoke.K8_BWD_CASES:
        label, dtype, _b, _s, _t, _h, _kv, _d, causal, window, p_dtype = case
        q, k, v, do = smoke.k8_bwd_operands(case, gen)
        kw = dict(causal=causal, window=window, p_dtype=p_dtype)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        out[f"{label}_delta"] = bits(fa.flash_attention_bwd_delta(o, do))
        if dtype != smoke.F32:
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            for name, g in zip(("dq", "dk", "dv"), grads):
                out[f"{label}_mma_{name}"] = bits(g)
            if label not in smoke.K8_BWD_FMA_VIEW:
                continue
            q, k, v, do = (smoke.off_grid(x) for x in (q, k, v, do))
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        for name, g in zip(("dq", "dk", "dv"), grads):
            out[f"{label}_{name}"] = bits(g)
    return out


def train_curve() -> tuple[np.ndarray, float]:
    """(step, loss) of chip_smoke.py's train case (a), float64, and its ms
    a step (host clock around synchronized steps, train_loop's timings)."""
    from repro_torch.launch.train import train_loop

    ex = smoke.load_example("train_lm_torch")
    timings: dict = {}
    with tempfile.TemporaryDirectory(prefix="repro_k8_bits_") as ckpt:
        out = train_loop(ex.lm_100m(), steps=smoke.TRAIN_STEPS, batch_size=smoke.TRAIN_BATCH,
                         seq_len=smoke.TRAIN_SEQ, optimizer_name="analog_newton",
                         lr=smoke.TRAIN_LR, ckpt_dir=ckpt, ckpt_every=100,
                         analog_cfg=ex.analog_config(False), log_fn=lambda line: None,
                         device=torch.device("cuda", 0), timings=timings)
    curve = np.array([[h["step"], h["loss"]] for h in out["history"]], dtype=np.float64)
    return curve, timings["step"] / smoke.TRAIN_STEPS * 1e3


def save(path: str, train: bool) -> None:
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    out: dict[str, np.ndarray] = {}
    report = {}
    with torch.no_grad():
        for case in smoke.K8_CASES:
            label, dtype, _b, _s, _t, _h, _kv, _d, causal, window, p_dtype = case
            q, k, v = smoke.k8_operands(case, gen)
            if p_dtype == "v":
                got = ops.flash_attention(q, k, v, causal=causal, window=window)
                p_dtype = smoke.BF16 if dtype == smoke.BF16 else None
            else:
                got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                         p_dtype=p_dtype)
            out[label] = got.view(torch.int16 if dtype == smoke.BF16 else torch.int32
                                  ).cpu().numpy()
            if hasattr(fa, "flash_attention_lse"):
                with_lse, lse = fa.flash_attention_lse(q, k, v, causal=causal, window=window,
                                                       p_dtype=p_dtype)
                out[label + "_lse"] = bits(lse)
                report[label + "_same_with_lse"] = bool(torch.equal(
                    with_lse.view(torch.int16 if dtype == smoke.BF16 else torch.int32),
                    got.view(torch.int16 if dtype == smoke.BF16 else torch.int32)))
    if hasattr(fa, "flash_attention_lse"):
        out.update(backward_bits(fa, gen))
    curve = {}
    if train:
        out["train_lm_loss_curve"], ms = train_curve()
        curve = {"train_lm_loss_every_10th": out["train_lm_loss_curve"][::10].tolist(),
                 "train_lm_ms_per_step": ms}
    np.savez(path, **out)
    print(json.dumps({"saved": path, "device": torch.cuda.get_device_name(0),
                      "cases": len(out), **report, **curve}))
    if not all(report.values()):
        sys.exit(1)


# K8's float32 bar (chip_smoke.K8_BARS): |a - b| <= 1e-6 + 1e-5 |b|
F32_RTOL, F32_ATOL = 1e-5, 1e-6


def values(x: np.ndarray) -> np.ndarray:
    """A saved array's values in float64: bf16 and float32 outputs are
    saved as their bits (int16, int32), the loss curve as float64."""
    if x.dtype == np.int16:
        x = (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    elif x.dtype == np.int32:
        x = x.view(np.float32)
    return x.astype(np.float64)


def compare(a: str, b: str) -> int:
    x, y = np.load(a), np.load(b)
    same = {key: bool(key in y and np.array_equal(x[key], y[key])) for key in x.files}
    differ = {}
    for key in x.files:
        if same[key] or key not in y or x[key].shape != y[key].shape:
            continue
        va, vb = values(x[key]), values(y[key])
        if key == "train_lm_loss_curve":
            differ[key] = {"max_abs_diff": float(np.abs(va - vb).max())}
        else:
            err = np.abs(va - vb)
            differ[key] = {"max_abs_diff_of_max": float(err.max())
                           / max(float(np.abs(vb).max()), 1e-30),
                           "of_f32_bar": float((err / (F32_ATOL + F32_RTOL * np.abs(vb))).max())}
    print(json.dumps({"compare": [a, b], "bit_equal": same, "differ": differ,
                      "missing": sorted(set(x.files) ^ set(y.files)),
                      "all": all(same.values())}))
    return 0 if all(same.values()) and set(x.files) == set(y.files) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    if args.save:
        save(args.save, args.train)
    if args.compare:
        return compare(*args.compare)
    return 0


if __name__ == "__main__":
    sys.exit(main())
