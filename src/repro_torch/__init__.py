"""repro_torch — the PyTorch/CUDA port of the analog SPD solver.

A second package beside the JAX reference :mod:`repro`, with its layout
(``core/``, ``kernels/``, ``data/``).  It imports ``torch`` and
``numpy``, never ``jax`` and nothing of :mod:`repro`.  Entry points run
on the CUDA card by default (``device="cuda"``) and raise without one
unless given ``device="cpu"``; the settle-sweep kernels K1-K4 are
hand-written CUDA for Hopper (``kernels/csrc``), built at first CUDA use.
"""

from repro_torch.core import (  # noqa: F401
    BatchSolveResult,
    PendingBatchSolve,
    SolveResult,
    solve,
    solve_batch,
    solve_batch_submit,
)
from repro_torch.device import resolve_device  # noqa: F401
