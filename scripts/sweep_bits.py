#!/usr/bin/env python3
"""Bit-level record of the persistent sweeps K1 and K3 on a CUDA device.

    PYTHONPATH=<tree>/src python3 scripts/sweep_bits.py --save FILE.npz
    python3 scripts/sweep_bits.py --compare A.npz B.npz

``--save`` runs, with whichever ``repro_torch`` is first on the path, K1
(``ell_sweep``, float32 and bf16 slots) and K3 (``transient_sweep``) for
``chip_smoke.KERNEL_STEPS`` steps on the operators ``chip_smoke.py``
builds (ELL n = 256, 1024, 2048; dense n = 48, 64, 80, 128, 256), from the
smoke's seed; it prints whether each K1 result equals, bit for bit, the
same number of K2 launches (``ell_step``) and the dt = 0 launch, and
saves every output.  ``--compare`` prints, per output, whether two saved
runs (for example two commits of the package on one card) agree bit for
bit, and exits 1 if any differs.
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
    from repro_torch.kernels import ell_transient as ek

    sk = importlib.import_module("repro_torch.kernels.transient_step")
    dev = torch.device("cuda", 0)
    steps = smoke.KERNEL_STEPS
    out: dict[str, np.ndarray] = {}
    report = {}
    for n in (smoke.N_DENSE, smoke.N_MATRIX_FREE, smoke.N_MATRIX_FREE_LARGE):
        _ell, idx_t, w_t, w_bf, c = smoke.ell_operands(n, dev)
        z0 = smoke.start_state(c)
        for dtype, w in (("f32", w_t), ("bf16", w_bf)):
            z, r = ek.ell_sweep(idx_t, w, z0, c, n_steps=steps)
            zl = z0
            for _ in range(steps):
                zl, _ = ek.ell_step(idx_t, w, zl, c)
            _, rl = ek.ell_step(idx_t, w, zl, c, 0.0)
            key = f"k1_{dtype}_ell_n{n}"
            report[key + "_equals_k2_loop"] = bool(torch.equal(z, zl)
                                                   and torch.equal(r[:, 0], rl.amax(dim=1)))
            out[key + "_z"], out[key + "_res"] = z.cpu().numpy(), r.cpu().numpy()
    for n in (smoke.N_DENSE_SMALL, *smoke.DENSE_ROUTE_PROBES, smoke.N_DENSE):
        _bss, _m, m_t, c = smoke.dense_operands(n, dev)
        z0 = smoke.start_state(c)
        z, r = sk.transient_sweep(m_t, z0, c, n_steps=steps)
        out[f"k3_dense_n{n}_z"], out[f"k3_dense_n{n}_res"] = z.cpu().numpy(), r.cpu().numpy()
    np.savez(path, **out)
    print(json.dumps({"saved": path, "device": torch.cuda.get_device_name(0), **report}))


def compare(a_path: str, b_path: str) -> int:
    a, b = np.load(a_path), np.load(b_path)
    same = {k: bool(k in b and a[k].tobytes() == b[k].tobytes()) for k in a.files}
    print(json.dumps({"compare": [a_path, b_path], "bit_equal": same}))
    return 0 if all(same.values()) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available() or not args.save:
        print("sweep_bits.py: needs a CUDA device and --save or --compare", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    save(args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
