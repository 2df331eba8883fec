"""Launch drivers (counterpart of :mod:`repro.launch`): the training
loop on one device.  The mesh and multi-host launch (``launch/mesh.py``)
and the dry run are later slices."""
