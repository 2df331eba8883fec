#!/usr/bin/env python3
"""The GEMV of K6 at b = 1 ("fma") and K5 at nb = 1 ("column"), timed on a
CUDA device, and the bits of the routes around it.

    PYTHONPATH=<tree>/src python3 scripts/gemv_times.py [--label NAME] [--save FILE]
    python3 scripts/gemv_times.py --compare PARENT_FILE CHANGE_FILE
    PYTHONPATH=src python3 scripts/gemv_times.py --sweep

Runs with whichever ``repro_torch`` is first on the path and this tree's
``chip_smoke.py`` helpers.  The default prints one JSON line with, for K6
at b = 1 and K5 at nb = 1, at m = k = 8192 and 4096 in float32 and bf16
(every A larger than the 50 MB L2): the median of 20 calls, each between
two events (``ms``), the device time a call in a CUDA graph
(``device_ms``), each call on one of enough copies of A that none is
found in the L2, the bytes bound at the card's HBM rate, and the library call timed
the same two ways: ``torch.matmul(g, y[:, None])`` and ``torch.addmm(zc,
m, z)`` with ``zc = z + c`` made outside the timed call.  ``--save`` also
writes the outputs of K5's narrow and wide routes and K6's b = 64 routes
at the smoke's main and ragged shapes (and of the GEMV, which a redesign
changes) from seeded inputs; ``--compare`` prints, key by key, whether two
such files agree bit for bit.

To compare two commits on one card, unpack the other into a directory that
``.gitignore`` lists and run this script with each tree's ``src`` first on
the path, in turns (parent, change, change, parent), in one call.

``--sweep`` (this tree only) builds ``scripts/gemv_probe.cu`` and times, at
m = k = 8192 and 4096 in float32 and bf16, ``common.cuh:gemv_rows`` at
other rows per warp, unroll depths, pipelining, warps and grids than the
kernels' constants, and (float32) the design with 1-D TMA bulk copies into
a ring of shared-memory stages per warp; each against
``gemv.gemv_in_kernel_order``'s bits.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402

SIZES = (8192, 4096)
DTYPES = (torch.float32, torch.bfloat16)
CALLS = 20
# K6 b = 64 and K5 narrow at the smoke's main shapes (the crossbar of the
# n = 4096 system, the n = 1024 circuit's 8192 states on 16 columns)
MAIN_MVM = (8192, 8192, smoke.K6_BATCH)
MAIN_STEP = (8192, smoke.K5_COLUMNS)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def randn(gen: torch.Generator, shape, dtype, scale: float = 1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


L2_BYTES = 50e6


def timed(fn, copies: int) -> dict:
    """``fn(i)`` timed on copy i of its operands, the copies taken in turn,
    so that a call's matrix has left the 50 MB L2 since its last use (two
    L2s of other copies between): the median of CALLS calls, each between
    two events, and the device time a call in a CUDA graph."""
    turn = iter(range(10 ** 9))

    def call():
        return fn(next(turn) % copies)
    spread = smoke.cuda_ms_spread(call, CALLS)
    return dict(ms=spread["median"], spread_ms=spread, device_ms=smoke.graph_ms(call, CALLS),
                copies=copies)


def times() -> dict:
    """K6 b = 1 and K5 nb = 1 against their bounds and library calls."""
    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    st = importlib.import_module("repro_torch.kernels.transient_step")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    rows = {}
    for n in SIZES:
        for dtype in DTYPES:
            es = torch.finfo(dtype).bits // 8
            copies = max(1, -(-int(3 * L2_BYTES) // (n * n * es)))
            a = [randn(gen, (n, n), dtype, n ** -0.5) for _ in range(copies)]
            y = randn(gen, (n, 1), dtype)
            c = randn(gen, (n, 1), dtype)
            zc = y + c
            k6_bytes = n * n * es + 2 * n * es
            k5_bytes = n * n * es + 3 * n * es
            for key, kern, lib, nbytes in (
                    ("crosspoint_mvm", lambda i: mvm.crosspoint_mvm(a[i], y),
                     lambda i: torch.matmul(a[i], y), k6_bytes),
                    ("transient_step", lambda i: st.transient_step(a[i], y, c, 1.0),
                     lambda i: torch.addmm(zc, a[i], y), k5_bytes)):
                bound_ms = nbytes / smoke.card_spec().hbm_bw * 1e3
                row = dict(shape=[n, n, 1], dtype=dtype_name(dtype), bytes=nbytes,
                           bound_ms=bound_ms, **timed(kern, copies))
                lib_t = timed(lib, copies)
                row.update(library=("torch.matmul(g, y)" if key == "crosspoint_mvm"
                                    else "torch.addmm(z + c, m, z), z + c made outside"),
                           library_ms=lib_t["ms"], library_spread_ms=lib_t["spread_ms"],
                           library_device_ms=lib_t["device_ms"],
                           of_bound=bound_ms / row["device_ms"])
                rows[f"{key}_{dtype_name(dtype)}_{n}"] = row
            del a
    return rows


def outputs() -> dict:
    """Each route's output at the smoke's main and ragged shapes, from
    seeded inputs, as CPU tensors keyed by route, dtype and shape."""
    mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
    st = importlib.import_module("repro_torch.kernels.transient_step")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
    out = {}
    mvm_shapes = [(MAIN_MVM, None)] + [(s, r) for s, r, _ in smoke.RAGGED_MVM]
    for (m, k, nb), _ in mvm_shapes:
        g, v = randn(gen, (m, k), torch.float32), randn(gen, (k, nb), torch.float32)
        for dtype in DTYPES:
            gd, vd = g.to(dtype), v.to(dtype)
            route = mvm.crosspoint_mvm_route(dtype, m, k, nb, True)
            out[f"k6 {route} {dtype_name(dtype)} {m}x{k}x{nb}"] = mvm.crosspoint_mvm(gd, vd).cpu()
    for n, nb in [MAIN_STEP] + [s for s, _, _ in smoke.RAGGED_STEP]:
        mm = randn(gen, (n, n), torch.float32, 0.1 * min(1.0, (137 / n) ** 0.5))
        z, c = randn(gen, (n, nb), torch.float32), randn(gen, (n, nb), torch.float32)
        for dtype in DTYPES:
            md, zd, cd = mm.to(dtype), z.to(dtype), c.to(dtype)
            route = st.transient_step_route(dtype, n, nb, True)
            out[f"k5 {route} {dtype_name(dtype)} {n}x{nb}"] = st.transient_step(md, zd, cd,
                                                                                 1.0).cpu()
        del mm
    return out


def compare(parent_file: str, change_file: str) -> dict:
    """Key by key: equal bits, or the largest difference over the largest
    element; the GEMV's routes ("fma", "column") are the redesigned ones."""
    a, b = torch.load(parent_file), torch.load(change_file)
    rows, unchanged_equal = {}, True
    for key in sorted(set(a) | set(b)):
        if key not in a or key not in b:
            rows[key] = "missing in one file"
            unchanged_equal = False
            continue
        x, y = a[key].float(), b[key].float()
        same = torch.equal(a[key], b[key])
        redesigned = key.split()[1] in ("fma", "column")
        rows[key] = dict(equal=same, redesigned=redesigned,
                         diff_of_max=0.0 if same else float((x - y).abs().max()
                                                            / y.abs().max().clamp_min(1e-30)))
        if not redesigned and not same:
            unchanged_equal = False
    return dict(compare=[parent_file, change_file], unchanged_routes_equal=unchanged_equal,
                keys=rows)


PROBE_LOADS = [(r, u, pipe, w, b)
               for r, u, pipe in ((1, 8, 0), (1, 8, 1), (2, 2, 1), (2, 4, 0), (2, 4, 1), (2, 8, 0),
                                  (4, 2, 1), (4, 4, 0))
               for w in (8, 16) for b in (132, 264)]
PROBE_TMA = [(s, p, w) for s in (2, 4, 8) for p in (512, 1024, 2048) for w in (4, 8, 16)
             if w * s * (p * 4 + 8) <= 227 * 1024]


def sweep() -> dict:
    """The probe's designs at m = k = 8192 and 4096, in float32 and bf16
    (the TMA design in float32): device ms in a CUDA graph, each call on one
    of enough copies of A that none is found in the L2, against the bound;
    each checked bit for bit against the GEMV's order."""
    from repro_torch.kernels import gemv

    lib_path = ROOT / "build" / "gemv_probe.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = Path("/usr/local/cuda/bin/nvcc")
    build = subprocess.run(
        [str(nvcc if nvcc.exists() else "nvcc"), "-gencode=arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o",
         str(lib_path), str(ROOT / "scripts" / "gemv_probe.cu")],
        capture_output=True, text=True, check=False)
    if build.returncode:
        raise RuntimeError("gemv_probe.cu did not build:\n" + build.stdout + build.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_error_string.restype = ctypes.c_char_p
    lib.probe_gemv_loads.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.probe_gemv_tma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.probe_gemv_loads.restype = lib.probe_gemv_tma.restype = ctypes.c_int

    def call(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe: CUDA error {err} ({lib.probe_error_string(err).decode()})")

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    res = dict(ptxas=[ln for ln in build.stderr.splitlines() if "registers" in ln or "spill" in ln],
               sizes={})
    for n in SIZES:
        for dtype in DTYPES:
            es = torch.finfo(dtype).bits // 8
            copies = max(1, -(-int(3 * L2_BYTES) // (n * n * es)))
            a = [randn(gen, (n, n), dtype, n ** -0.5) for _ in range(copies)]
            x = randn(gen, (n,), dtype)
            want = gemv.gemv_in_kernel_order(a[0], x)
            out = torch.empty(n, device="cuda")
            bound_ms = (n * n + 2 * n) * es / smoke.card_spec().hbm_bw * 1e3
            configs = [("loads", c) for c in PROBE_LOADS]
            if dtype == torch.float32:
                configs += [("tma", c) for c in PROBE_TMA]
            rows = []
            for kind, cfg in configs:
                turn = iter(range(10 ** 9))
                if kind == "loads":
                    r, u, pipe, w, b = cfg
                    label = dict(design="loads", rows=r, unroll=u, pipe=bool(pipe), warps=w,
                                 blocks=b)

                    def run():
                        i = next(turn) % copies
                        call(lib.probe_gemv_loads, a[i].data_ptr(), x.data_ptr(), out.data_ptr(),
                             n, n, int(dtype == torch.bfloat16), r, u, pipe, b, w)
                else:
                    st_, p, w = cfg
                    label = dict(design="tma", stages=st_, piece_floats=p, warps=w, blocks=132)

                    def run():
                        i = next(turn) % copies
                        call(lib.probe_gemv_tma, a[i].data_ptr(), x.data_ptr(), out.data_ptr(),
                             n, n, st_, p, 132, w)
                out.zero_()
                run()
                torch.cuda.synchronize()
                same = bool(torch.equal(out, want))
                device_ms = smoke.graph_ms(run, CALLS)
                rows.append(dict(label, device_ms=device_ms, of_bound=bound_ms / device_ms,
                                 bits_equal=same))
            rows.sort(key=lambda row: row["device_ms"])
            res["sizes"][f"{dtype_name(dtype)}_{n}"] = dict(
                bound_ms=bound_ms, copies=copies, kernel_plan=gemv.gemv_plan(n), rows=rows)
            del a
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("gemv_times.py: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    out = dict(label=args.label, package=str(Path(repro_torch.__file__).resolve().parent),
               device=torch.cuda.get_device_name(0), nvidia_smi=smoke.nvidia_smi())
    if args.sweep:
        out["sweep"] = sweep()
    else:
        out["times"] = times()
        if args.save:
            torch.save(outputs(), args.save)
            out["saved"] = args.save
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
