"""Launch drivers (counterpart of :mod:`repro.launch`): the training
loop on one device (``launch/train.py``) and the dry run of every
(architecture x shape) cell on one card (``launch/dryrun.py``).  The
mesh and multi-host launch (``launch/mesh.py``) are a later slice."""
