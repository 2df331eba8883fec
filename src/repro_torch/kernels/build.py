"""Build and load the hand-written Hopper kernels at first CUDA use.

Route: ``nvcc`` compiles each source of ``csrc/`` for ``sm_90a`` into
an object file, all of them at once, and links them into one shared
library with a plain C interface, loaded with ``ctypes``.  No source
includes PyTorch's headers, so a build takes seconds.  The library
lands in ``build/repro_torch_kernels/`` at the repository root, named
by a hash of the sources and flags, so an unchanged checkout loads the
library an earlier process built, with that build's nvcc/ptxas log,
kept beside it.

:class:`KernelCounter` and :func:`record_operation` are the hook through
which a wrapper reports its kernel's operation to a counting dispatch
mode (the roofline's), which the launch itself bypasses.

Nothing here runs at import: the CPU tests import every module, and
this machine need not have ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ell_transient.cu", "transient_step.cu", "crosspoint_mvm.cu",
           "spd_transform.cu", "flash_attention.cu")
HEADERS = ("common.cuh", "mma_bf16.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

# The split kernels (K4, K5's narrow route, K6's float32 route) share an
# output tile's work over the R blocks of a thread-block cluster.  An H100
# runs at once 132 clusters of 2 of their blocks, 62 of 4 and 30 of 8
# (cudaOccupancyMaxActiveClusters, which chip_smoke.py reads through each
# kernel's *_clusters_per_wave and holds the chosen R against), so a grid
# of at most 240 blocks runs in one wave at every cluster size.
ONE_WAVE_BLOCKS = 240

# Shared memory a thread block may use on an H100 (sharedMemPerBlockOptin)
SMEM_PER_BLOCK = 232_448

# The persistent sweeps K1 and K3 run each system on the R blocks of a
# thread-block cluster, R a power of two up to SWEEP_MAX_RANKS (past the
# portable 8; csrc/common.cuh), in one of two variants: "resident", each
# rank's share of the operator copied into its shared memory once per
# launch, or "streamed", read from L2/HBM every step.  SWEEP_SCRATCH_BYTES
# covers a block's static shared arrays (a 32-float reduction scratch and
# 16 rank maxima).
SWEEP_MAX_RANKS = 16
SWEEP_VARIANTS = ("resident", "streamed")
SWEEP_SCRATCH_BYTES = 256


def sweep_ranks(fits) -> int:
    """The cluster size of a persistent sweep: the smallest power of two R
    up to SWEEP_MAX_RANKS for which ``fits(R)`` (the rank's share of the
    operator fits its shared memory beside the state), else
    SWEEP_MAX_RANKS, where the operator streams."""
    ranks = 1
    while ranks < SWEEP_MAX_RANKS and not fits(ranks):
        ranks *= 2
    return ranks


def split_ranks(tiles: int, max_split: int, max_by_work: int,
                wave: int = ONE_WAVE_BLOCKS) -> int:
    """The cluster size R of a split kernel with ``tiles`` output tiles: the
    largest power of two up to ``max_split`` that keeps the grid
    ``tiles * R`` within one wave of ``wave`` blocks (ONE_WAVE_BLOCKS for a
    kernel that fits two blocks an SM) and is at most ``max_by_work`` (how
    many ranks the work gives a share each); at least 1.  A pure function
    of the shape, so the CPU tests can hold it."""
    want = min(max_split, wave // max(tiles, 1), max_by_work)
    return 1 << (max(want, 1).bit_length() - 1)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/*.cu: (argtypes, restype)
_SIGNATURES = {
    # idx, w, w_is_bf16, z, c, z_out, res, batch, nz, k, n_steps, dt, ranks, resident, stream
    "repro_ell_sweep": ((_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P), _I),
    # w_is_bf16, nz, k, ranks, resident, clusters (int*)
    "repro_ell_sweep_clusters": ((_I, _I, _I, _I, _I, _P), _I),
    # idx, w, w_is_bf16, z, c, z_out, res, batch, nz, k, dt, stream
    "repro_ell_step": ((_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _P), _I),
    # mt, z, c, z_out, res, batch, n, n_steps, dt, ranks, resident, stream
    "repro_dense_sweep": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P), _I),
    # n, ranks, resident, clusters (int*)
    "repro_dense_sweep_clusters": ((_I, _I, _I, _P), _I),
    # m, z, c, z_out, res, batch, n, ranks, dt, stream
    "repro_dense_step": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _P), _I),
    # ranks, clusters (int*)
    "repro_dense_step_clusters": ((_I, _P), _I),
    # m, z, c, is_bf16, z_out, n, nb, vec16, dt, stream
    "repro_transient_step": ((_P, _P, _P, _I, _P, _I, _I, _I, _F, _P), _I),
    # m, z, c, is_bf16, z_out, n, nb, ranks, vec16, dt, stream
    "repro_transient_step_narrow": ((_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _P), _I),
    # ranks, clusters (int*)
    "repro_transient_step_narrow_clusters": ((_I, _P), _I),
    # g, v, is_bf16, out, m, k, vec16, stream
    "repro_crosspoint_mvm": ((_P, _P, _I, _P, _I, _I, _I, _P), _I),
    # m, plan (int*), plan_len
    "repro_gemv_plan": ((_I, _P, _I), _I),
    # g, v, out, m, k, nb, vec16, stream
    "repro_crosspoint_mvm_mma": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
    # g, v, out, m, k, nb, ranks, vec16, stream
    "repro_crosspoint_mvm_f32": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    # ranks, clusters (int*)
    "repro_crosspoint_mvm_f32_clusters": ((_I, _P), _I),
    # a, a_is_bf16, out, rows, cols, ranks, vec16, stream
    "repro_colabs": ((_P, _I, _P, _I, _I, _I, _I, _P), _I),
    # a, a_is_bf16, d, k_s, k_a, k_b, n, stream
    "repro_assemble": ((_P, _I, _P, _P, _P, _P, _I, _P), _I),
    # q, k, v, is_bf16, o, lse, batch, s, t, h, kv, d, causal, window, scale, p_bf16, stream
    "repro_flash_attention": ((_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                               _I, _P), _I),
    # q, k, v, o, lse, batch, s, t, h, kv, d, causal, window, scale, p_bf16, rows, stream
    "repro_flash_attention_fma_rows": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                        _F, _I, _I, _P), _I),
    # batch, s, t, h, kv, d, causal, window, plan (int*), plan_len
    "repro_flash_attention_fma_plan": ((_I, _I, _I, _I, _I, _I, _I, _I, _P, _I), _I),
    # q, k, v, o, lse, batch, s, t, h, kv, d, causal, window, scale, p_bf16, stream
    "repro_flash_attention_mma": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                   _I, _P), _I),
    # o, dout, is_bf16, delta, batch, s, h, d, vec16, stream
    "repro_flash_attention_bwd_delta": ((_P, _P, _I, _P, _I, _I, _I, _I, _I, _P), _I),
    # is_bf16, batch, s, h, d, stream
    "repro_flash_attention_bwd_delta_empty": ((_I, _I, _I, _I, _I, _P), _I),
    # is_bf16, batch, s, h, d, plan (int*), plan_len
    "repro_flash_attention_bwd_delta_plan": ((_I, _I, _I, _I, _I, _P, _I), _I),
    # q, k, v, dout, is_bf16, lse, delta, dk, dv, batch, s, t, h, kv, d, causal, window,
    # scale, p_bf16, stream
    "repro_flash_attention_bwd_dkdv": ((_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _F, _I, _P), _I),
    # q, k, v, dout, is_bf16, lse, delta, dq, batch, s, t, h, kv, d, causal, window, scale,
    # stream
    "repro_flash_attention_bwd_dq": ((_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _F, _P), _I),
    # batch, s, t, h, kv, d, causal, window, plan (int*), plan_len
    "repro_flash_attention_bwd_dkdv_clusters": ((_I, _I, _I, _I, _I, _I, _I, _I, _P, _I), _I),
    # q, k, v, dout, lse, delta, dk, dv, batch, s, t, h, kv, d, causal, window, scale,
    # p_bf16, stream
    "repro_flash_attention_bwd_dkdv_mma": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                            _I, _I, _I, _F, _I, _P), _I),
    # q, k, v, dout, lse, delta, dq, batch, s, t, h, kv, d, causal, window, scale, stream
    "repro_flash_attention_bwd_dq_mma": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _F, _P), _I),
    "repro_cuda_error_string": ((_I,), ctypes.c_char_p),
}


class KernelLibrary:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when an earlier build was reused
        self.log = log                       # nvcc/ptxas output (-Xptxas=-v) of its build
        self._lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = restype

    def call(self, name: str, *args) -> None:
        """Launch through one C entry point; raise on a CUDA error."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            msg = self._lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


# operand dtypes of K5-K8: float32, or bfloat16 with float32 arithmetic
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1


def aligned16(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary, as the
    kernels' 16-byte asynchronous copies need (a fresh tensor does; a view
    with an offset may not)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check_tensors(dtypes: tuple[torch.dtype, ...], *, allow_meta: bool = False,
                  **tensors: torch.Tensor) -> torch.device:
    """The device the named tensors share; raise unless the wrappers take them.

    Every tensor must be a strided tensor of one of ``dtypes`` on the
    one CPU or CUDA device of the first (or ``meta``, where a dry run
    traces the card's path without data, when the wrapper passes
    ``allow_meta``), with dimensions in the kernels' ``int`` range, and
    contiguous on CUDA and ``meta`` (the kernels take row-major operands
    without strides).
    """
    dev = None
    for name, t in tensors.items():
        if t.layout != torch.strided:
            raise ValueError(f"{name} must be a strided (dense) tensor, got {t.layout}")
        if any(size > _INT_MAX for size in t.shape):
            raise ValueError(f"{name} has a dimension past the kernels' int range: "
                             f"{tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if dev is None:
            dev = t.device
            if dev.type not in ("cpu", "cuda") and not (allow_meta and dev.type == "meta"):
                raise ValueError(f"unsupported device {dev}")
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the other operands on {dev}")
        if dev.type in ("cuda", "meta") and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev.type}")
    return dev


def current_stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream, which the kernels
    launch on.  torch's raw accessor (what its own compiled kernels use)
    costs well under a microsecond; ``torch.cuda.current_stream(dev)``
    builds a Stream object, about 5 us per call on the card's host, which
    a short kernel launched from a Python loop pays every time."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


class KernelCounter(TorchDispatchMode):
    """A dispatch mode that also counts the operations of the hand-written
    kernels, which run outside the dispatcher (a ``ctypes`` launch) or
    not at all (``meta``): their wrappers report each operation through
    :func:`record_operation`.  A subclass (the roofline's
    ``CostCounter``) defines :meth:`record_kernel`; while ``paused`` is
    above 0 it counts nothing."""

    def __init__(self):
        super().__init__()
        self.paused = 0

    def record_kernel(self, name: str, flops: int, nbytes: int) -> None:
        raise NotImplementedError


def kernel_counters() -> list[KernelCounter]:
    """The kernel counters active on this thread (the autograd engine
    carries the mode stack into its backward threads)."""
    if not torch._C._len_torch_dispatch_stack():
        return []
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, KernelCounter)]


def record_operation(name: str, cost: Callable[[], tuple[int, int]]) -> None:
    """Report one kernel operation to every active kernel counter;
    ``cost()`` gives its (flops, bytes) and runs only when one is active."""
    counters = kernel_counters()
    if counters:
        flops, nbytes = cost()
        for c in counters:
            c.record_kernel(name, flops, nbytes)


@contextlib.contextmanager
def uncounted():
    """Count nothing inside the block: the plain version that stands in
    for a kernel whose operation :func:`record_operation` reported, or
    set-up that is not the step's work (a sharded step's model built
    before its leaves are gathered into it)."""
    counters = kernel_counters()
    for c in counters:
        c.paused += 1
    try:
        yield
    finally:
        for c in counters:
            c.paused -= 1


_LIB: KernelLibrary | None = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels of repro_torch are built at first use on the card's machine"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise with their output if any fails."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def _build(target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(src).stem + ".o") for src in SOURCES]
        log = _run([
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            for src, obj in zip(SOURCES, objs)
        ])
        tmp_so = Path(tmp) / target.name
        log += _run([[nvcc, "-shared", "-o", str(tmp_so), *map(str, objs)]])
        tmp_log = Path(tmp) / "build.log"
        tmp_log.write_text(log)
        os.replace(tmp_log, _log_path(target))   # before the library: it marks the build done
        os.replace(tmp_so, target)
    return log


def _log_path(target: Path) -> Path:
    return target.with_suffix(".log")


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; thread-safe."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            target = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
            if target.exists():   # an earlier build's library, and its log
                log_path = _log_path(target)
                log, seconds = (log_path.read_text() if log_path.exists() else ""), 0.0
            else:
                t0 = time.perf_counter()
                log = _build(target)
                seconds = time.perf_counter() - t0
            _LIB = KernelLibrary(target, seconds, log)
        return _LIB
