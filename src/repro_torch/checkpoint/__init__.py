"""Fault-tolerant checkpointing: atomic, async, keep-K, auto-resume
(counterpart of :mod:`repro.checkpoint`)."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
