"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and runs on the CUDA card unless the
caller asks for the CPU.  Without a CUDA device and without an explicit
``device="cpu"`` it raises; it never carries on quietly on the CPU.  A
caller may also ask for ``device="meta"``: tensors of shapes and dtypes
without data, on which the dry run (:mod:`repro_torch.launch.dryrun`)
traces a step and counts its work.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.
    ``"meta"`` only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array (numpy, list, scalar) as a tensor on ``device``.

    ``torch.as_tensor(x, device="cuda")`` copies from pageable memory,
    and such a copy waits for everything queued on the current stream
    (``cudaStreamSynchronize``): a service dispatch that stamps
    micro-batch ``i+1`` on a stream would wait for the solve of ``i``.
    On the card the copy goes through pinned memory with
    ``non_blocking=True`` instead; the caching host allocator keeps the
    pinned block until the copy is done.  The bytes are the same.
    """
    t = torch.as_tensor(x, dtype=dtype)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def as_float64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor.

    A tensor stays on its device unless ``device`` is given (then it
    moves there); anything else (numpy arrays, lists) goes to
    :func:`resolve_device`'s device, so it runs on the card unless the
    caller asks for the CPU.
    """
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.array(x, dtype=np.float64), device=resolve_device(device))


@contextlib.contextmanager
def stage(timings: dict | None, name: str, device: torch.device):
    """Add the wall time of the block to ``timings[name]``.

    A no-op when ``timings`` is None.  Otherwise the device is
    synchronized on entry and exit, so the time covers the device work
    the block enqueued, not just the enqueue.
    """
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
