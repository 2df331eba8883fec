"""Test-data generators (host-side numpy): the SPD/SDD systems of the
paper's protocol (:mod:`~repro_torch.data.spd`), FEM assembly with its
mesh request stream (:mod:`~repro_torch.data.fem`) and the synthetic
token stream of the training loop (:mod:`~repro_torch.data.tokens`)."""
