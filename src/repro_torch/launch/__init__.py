"""Launch drivers (counterpart of :mod:`repro.launch`): the training
loop (``launch/train.py``), the dry run of every (architecture x shape)
cell on one card (``launch/dryrun.py``) and the device meshes over the
process group (``launch/mesh.py``)."""
