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
  K8_TRAIN_F32``) beside SDPA's float32 forward, and ``forward_f32_main``
  the same at the main shape in float32 (``chip_smoke.K8_MAIN_F32``);
  Delta is timed in both dtypes inside ``backward_f32`` and
  ``backward_bf16`` (CUDA graphs of 5 and of 50 launches), beside
  ``torch.einsum("bshd,bshd->bhs", do, o)`` and, where the package has it,
  the device time of a launch over zero rows; a package from before the C
  plan queries (``delta_plan_on_device``) is timed without the plan fields;
* ``train_profile``: train_lm's step under the profiler
  (``chip_smoke.train_profile``);
* with ``--sweep`` (a package that has ``fma_forward_plan``): the forward
  at train_lm's shape with each row tile of SWEEP_ROWS forced through the
  sweep-only C entry point ``repro_flash_attention_fma_rows``, device ms
  in a CUDA graph and the largest share of the float32 bar against the
  plain version, beside the plan's choice.

To compare two commits on one card, unpack the other into a directory that
``.gitignore`` lists and run this script of one tree with each tree's
``src`` first on the path, in turns (parent, change, change, parent), in
one call.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


SWEEP_ROWS = (16, 24, 32, 40, 48, 56, 64)


def sweep_rows(gen) -> dict:
    """The float32 forward at train_lm's shape with each row tile of
    SWEEP_ROWS forced: device ms (a CUDA graph of 20 launches), the loop's
    ms, blocks, and the largest share of the float32 bar."""
    from repro_torch.kernels import build

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q, k, v = smoke.k8_operands(smoke.K8_TRAIN_F32, gen)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    want = fa.flash_attention_plain(q, k, v)
    lib = build.load_library()
    out = {"plan_rows": fa.fma_forward_plan(b, s, t, h, kv, d, True, 0)["rows"]}
    for rows in SWEEP_ROWS:
        def run(rows=rows):
            o = torch.empty_like(q)
            lib.call("repro_flash_attention_fma_rows", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), None, b, s, t, h, kv, d, 1, 0, 1.0 / d ** 0.5,
                     0, rows, build.current_stream(q.device))
            return o

        _err, share = smoke.bar_share(run(), want, *smoke.K8_BARS[torch.float32])
        out[str(rows)] = dict(device_ms=smoke.graph_ms(run, 20), ms=smoke.cuda_ms(run, 20),
                              blocks=-(-s * (h // kv) // rows) * b * kv, of_bar=share)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_fma_times.py: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import build

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    if not hasattr(fa, "delta_plan_on_device"):
        # a package from before the plans' C queries (the parent of the
        # float32 forward's redesign): timed without the plan fields
        smoke.fma_plan_held = lambda shape: {}
        smoke.delta_fixed_ms = lambda o: {}
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
    out["forward_f32_main"] = smoke.k8_times(*smoke.k8_operands(smoke.K8_MAIN_F32, gen))
    if args.sweep:
        out["sweep_rows_train_f32"] = sweep_rows(gen)
    out["train_profile"] = smoke.train_profile(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
