#!/usr/bin/env python3
"""K8's float32 ("fma") route timed where training runs it, on a CUDA device.

    PYTHONPATH=<tree>/src python3 scripts/k8_fma_times.py [--label NAME]

Runs, with whichever ``repro_torch`` is first on the path and this tree's
``chip_smoke.py`` helpers, and prints one JSON line:

* ``backward_f32``: K8's backward kernels at train_lm's attention
  (``chip_smoke.K8_BWD_F32``: q (4, 192, 12, 64), k/v (4, 192, 4, 64),
  float32, causal): each kernel's median of 20 calls between two events
  and its device time in a CUDA graph, beside the bound and
  ``scaled_dot_product_attention``'s float32 backward (device time under
  the profiler);
* ``backward_bf16``: the same at the forward's main shape in bf16
  (``chip_smoke.K8_BWD_MAIN``), with dK/dV and dQ also on the "fma" route
  through views off the 16-byte grid (``fma_ms``, ``fma_device_ms``);
* ``forward_f32``: K8's forward at train_lm's shape (``chip_smoke.
  K8_TRAIN_F32``) beside SDPA's float32 forward;
* ``train_profile``: train_lm's step under the profiler
  (``chip_smoke.train_profile``).

To compare two commits on one card, unpack the other into a directory that
``.gitignore`` lists and run this script of one tree with each tree's
``src`` first on the path, in turns (parent, change, change, parent), in
one call.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_fma_times.py: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    out = dict(label=args.label, package=str(Path(repro_torch.__file__).resolve().parent),
               device=torch.cuda.get_device_name(0), nvidia_smi=smoke.nvidia_smi())
    out["backward_f32"] = smoke.k8_bwd_times(*smoke.k8_bwd_operands(smoke.K8_BWD_F32, gen))
    out["backward_bf16"] = smoke.k8_bwd_times(*smoke.k8_bwd_operands(smoke.K8_BWD_MAIN, gen))
    out["forward_f32"] = smoke.k8_times(*smoke.k8_operands(smoke.K8_TRAIN_F32, gen))
    out["train_profile"] = smoke.train_profile(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
