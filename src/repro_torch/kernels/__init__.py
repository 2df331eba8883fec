"""Hand-written Hopper kernels of the settle sweep (K1-K4) and their
plain PyTorch versions; see :mod:`repro_torch.kernels.ops`."""
