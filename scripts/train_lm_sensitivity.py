#!/usr/bin/env python3
"""How far train_lm's loss curve moves under a tiny change, on a CUDA device.

    PYTHONPATH=<tree>/src python3 scripts/train_lm_sensitivity.py [--rel 1e-6]

Runs ``chip_smoke.py``'s train case (a), examples/train_lm.py's default
run (lm_100m, 300 AnalogNewton steps, float32), twice from the same seed
with whichever ``repro_torch`` is first on the path: at ``TRAIN_LR`` and
at ``TRAIN_LR * (1 + rel)``.  Prints one JSON line with both loss curves
(every logged step), their largest |difference| and the final losses: the
size of a change that a float32 summation order elsewhere (a kernel's
split, say) can be measured against.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def curve(lr: float) -> np.ndarray:
    """(step, loss) of train case (a) at learning rate ``lr``."""
    from repro_torch.launch.train import train_loop

    ex = smoke.load_example("train_lm_torch")
    with tempfile.TemporaryDirectory(prefix="repro_sensitivity_") as ckpt:
        out = train_loop(ex.lm_100m(), steps=smoke.TRAIN_STEPS, batch_size=smoke.TRAIN_BATCH,
                         seq_len=smoke.TRAIN_SEQ, optimizer_name="analog_newton", lr=lr,
                         ckpt_dir=ckpt, ckpt_every=100, analog_cfg=ex.analog_config(False),
                         log_fn=lambda line: None, device=torch.device("cuda", 0))
    return np.array([[h["step"], h["loss"]] for h in out["history"]], dtype=np.float64)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rel", type=float, default=1e-6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_lm_sensitivity.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = curve(smoke.TRAIN_LR)
    moved = curve(smoke.TRAIN_LR * (1 + args.rel))
    diff = np.abs(base[:, 1] - moved[:, 1])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smoke.nvidia_smi(),
                      "lr": smoke.TRAIN_LR, "rel": args.rel,
                      "loss": base.tolist(), "loss_moved": moved[:, 1].tolist(),
                      "max_abs_diff": float(diff.max()),
                      "step_of_max": int(base[int(diff.argmax()), 0]),
                      "final": [float(base[-1, 1]), float(moved[-1, 1])]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
