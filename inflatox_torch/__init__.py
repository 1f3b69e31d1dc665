"""inflatox_torch: multi-field inflation analysis in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of ``inflatox_tpu`` (the JAX/Pallas package beside it, which stays
the reference).  The public surface is the same:

>>> import inflatox_torch as inflatox
>>> model = inflatox.InflationModelBuilder.new(fields, metric, V).build()
>>> artifact = inflatox.Compiler(model).compile()
>>> al = inflatox.consistency_conditions.GeneralisedAL(artifact, device="cuda")
>>> maps = al.complete_analysis(args, x0a, x0b, x1a, x1b)
>>> rows, times = inflatox.background.solve_eom_batch(
...     artifact, args, steps, fields0, derivs0, return_time=True)
>>> ot = al.complete_analysis_ot(args, rows[0, :, :2])
>>> sweep = inflatox.parallel.parameter_sweep(al, args_batch, extent, (512, 512))

Every tensor is float64 and every device is explicit: ``GeneralisedAL``
and the solvers in ``background`` take ``device=`` and never move work to
another device on their own.  This
package imports neither ``jax`` nor ``inflatox_tpu``.
"""

import sys as _sys

# Deeply-nested model expressions (EGNO/D5-class) need headroom for sympy
# printing and for evaluating the lowered source.  Frames are heap-allocated
# in CPython ≥3.11, so a high limit is safe.
if _sys.getrecursionlimit() < 100_000:
    _sys.setrecursionlimit(100_000)

from .compiler import CompilationArtifact, CompiledModel, Compiler
from .symbolic import InflationModel, InflationModelBuilder
from .version import __version__

from . import background
from . import consistency_conditions
from . import models
from . import parallel

__all__ = [
    "CompilationArtifact",
    "CompiledModel",
    "Compiler",
    "InflationModel",
    "InflationModelBuilder",
    "background",
    "consistency_conditions",
    "models",
    "parallel",
]
