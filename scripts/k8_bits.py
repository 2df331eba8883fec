#!/usr/bin/env python3
"""Bit-level record of K8's forward (flash attention) on a CUDA device.

    PYTHONPATH=<tree>/src python3 scripts/k8_bits.py --save FILE.npz
    python3 scripts/k8_bits.py --compare A.npz B.npz

``--save`` runs, with whichever ``repro_torch`` is first on the path, K8's
forward without the row log-sum-exp at every case of
``chip_smoke.K8_CASES`` (the serving path's shapes, each head size, both
routes, p rounded or not) from the smoke's seed, and saves every output.
Where the package has ``flash_attention_lse`` it also prints whether the
forward that writes ``lse`` gives, bit for bit, the output of the one that
does not.  ``--compare`` prints, per output, whether two saved runs (for
example two commits of the package on one card) agree bit for bit, and
exits 1 if any differs.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def save(path: str) -> None:
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
    np.savez(path, **out)
    print(json.dumps({"saved": path, "device": torch.cuda.get_device_name(0),
                      "cases": len(out), **report}))
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
    args = ap.parse_args()
    if args.save:
        save(args.save)
    if args.compare:
        return compare(*args.compare)
    return 0


if __name__ == "__main__":
    sys.exit(main())
