"""Meshes of devices and the calls sharded over them: grid scans
(:func:`sharded_scan`, :func:`sharded_scan_ot`), background solves
(:func:`sharded_solve_eom_batch`) and parameter sweeps
(:func:`parameter_sweep`, on the batched grid-scan kernels B7a, B7b and
B7d); :mod:`.distributed` starts a ``torch.distributed`` process group
(gloo) for several processes."""

from . import distributed
from .mesh import default_mesh, make_mesh
from .solve import sharded_solve_eom_batch
from .sweep import parameter_sweep, sharded_scan, sharded_scan_ot

__all__ = [
    "distributed",
    "make_mesh",
    "default_mesh",
    "sharded_scan",
    "sharded_scan_ot",
    "sharded_solve_eom_batch",
    "parameter_sweep",
]
