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
does not, and saves the backward's dq, dk and dv on the FMA route: at every
float32 case of ``chip_smoke.K8_BWD_CASES`` and at its bf16 cases of
``chip_smoke.K8_BWD_FMA_VIEW`` through views off the 16-byte grid (the
route a package without the tensor-core backward also takes there).
``--train`` also saves the loss curve of ``chip_smoke.py``'s train case
(a), examples/train_lm.py's default run (300 AnalogNewton steps, float32).
``--compare`` prints, per output, whether two saved runs (for example two
commits of the package on one card) agree bit for bit, and exits 1 if any
differs.
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
    """dq, dk, dv of the FMA route at K8_BWD_CASES' float32 cases and, off
    the 16-byte grid, at K8_BWD_FMA_VIEW's bf16 cases."""
    out = {}
    for case in smoke.K8_BWD_CASES:
        label, dtype, _b, _s, _t, _h, _kv, _d, causal, window, p_dtype = case
        q, k, v, do = smoke.k8_bwd_operands(case, gen)
        if dtype != smoke.F32 and label not in smoke.K8_BWD_FMA_VIEW:
            continue
        kw = dict(causal=causal, window=window, p_dtype=p_dtype)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        if dtype != smoke.F32:
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
                with_lse, _ = fa.flash_attention_lse(q, k, v, causal=causal, window=window,
                                                     p_dtype=p_dtype)
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


def compare(a: str, b: str) -> int:
    x, y = np.load(a), np.load(b)
    same = {key: bool(key in y and np.array_equal(x[key], y[key])) for key in x.files}
    print(json.dumps({"compare": [a, b], "bit_equal": same, "all": all(same.values())}))
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
