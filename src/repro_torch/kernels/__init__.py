"""Hand-written Hopper kernels K1-K8 and their plain PyTorch versions.

* :mod:`~repro_torch.kernels.ell_transient` — the matrix-free ELL settle
  sweeps K1 (persistent) and K2 (one row-tiled step).
* :mod:`~repro_torch.kernels.transient_step` — the dense settle sweeps
  K3 and K4, and K5, one Euler step ``Z + dt (M Z + C)`` of one operator
  on many state columns.
* :mod:`~repro_torch.kernels.crosspoint_mvm` — K6, the crossbar's
  ``I = G V``.
* :mod:`~repro_torch.kernels.spd_transform` — K7a (column |A| sums) and
  K7b (K_A, K_B of Eqs. 15-16 from one read of A).
* :mod:`~repro_torch.kernels.flash_attention` — K8, GQA attention with
  an online softmax (causal, sliding-window and ragged masks), the
  language-model stack's prefill attention.

:mod:`~repro_torch.kernels.ops` holds the public wrappers: the kernel API
re-exported here in the reference's order (:func:`crosspoint_mvm`,
:func:`transient_step`, :func:`transient_step_batched`,
:func:`transient_sweep`, :func:`spd_transform_arrays`), the settle-sweep
routing and the launch counters (K1-K8, and K5's, K6's, K7a's and K8's
by route).  As in the reference, the re-exported ``crosspoint_mvm`` and
``transient_step`` functions shadow the submodules of the same names:
reach those with ``importlib.import_module``.  The CUDA sources are built
at first CUDA use (:mod:`~repro_torch.kernels.build`).
"""

from repro_torch.kernels.ops import (  # noqa: F401
    crosspoint_mvm,
    transient_step,
    transient_step_batched,
    transient_sweep,
    spd_transform_arrays,
)
