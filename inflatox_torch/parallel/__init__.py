"""Parameter sweeps on one device (:func:`parameter_sweep`, on the batched
grid-scan kernels B7a, B7b and B7d).  Sharding over several devices
(``sharded_scan``, ``sharded_scan_ot``, ``make_mesh``, ``distributed``) is
ROADMAP §A.7."""

from .sweep import parameter_sweep

__all__ = ["parameter_sweep"]
