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

The CMB-prediction workflow (background on kernel B6, then the end of
inflation, the pivot, n_s, r and P_ζ, COBE normalisation, a Fisher forecast
and a gradient fit):

>>> from inflatox.observables import (cobe_normalize, fisher_matrix,
...     fit_parameters, horizon_exit, n_star_matching, power_spectrum, slow_roll)
>>> rows, times = inflatox.background.solve_eom(
...     artifact, args, 3000, fields0, derivs0, max_err=1e-9, solver="rkf",
...     return_time=True)
>>> pivot = horizon_exit(artifact, rows, times, args, N_before_end=55.0)
>>> spectrum = power_spectrum(artifact, rows, times, args)
>>> scale = cobe_normalize(artifact, rows, times, args)["scale"]
>>> n_star = n_star_matching(artifact, args, rows, times, A_s=2.1e-9)["N_star"]
>>> F = fisher_matrix(artifact, pivot["x"], args, sigma=[0.004, 0.01])
>>> sr = slow_roll(artifact)
>>> fit = fit_parameters(lambda a: (sr(pivot["x"], a)["n_s"] - 0.965) ** 2, args)
>>> ricci = artifact.geometry.ricci_scalar(x_grid, args_tensor)

The primordial spectra (δN on kernel B6; the mode and transport routes as
torch RK4 loops on the device):

>>> from inflatox.perturbations import delta_n_spectrum, mode_spectrum
>>> dn = delta_n_spectrum(artifact, args, rows, times, order=2, device="cuda")
>>> ms = mode_spectrum(artifact, args, rows, times, device="cuda")

Every tensor is float64 and every device is explicit: ``GeneralisedAL``,
the solvers in ``background`` and the functions of ``observables`` and
``perturbations`` take ``device=`` (``"cuda"`` by default) and never move
work to another device on their own; ``artifact.geometry`` computes on the device of its inputs.  This
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
from .utils.logging import log_info, log_warn
from .version import __version__

from . import background
from . import consistency_conditions
from . import geometry
from . import inference
from . import models
from . import observables
from . import parallel
from . import perturbations

__all__ = [
    "CompilationArtifact",
    "CompiledModel",
    "Compiler",
    "InflationModel",
    "InflationModelBuilder",
    "__version__",
    "background",
    "consistency_conditions",
    "geometry",
    "inference",
    "log_info",
    "log_warn",
    "models",
    "observables",
    "parallel",
    "perturbations",
]
