"""Kernels B1, B2, B4 (the analysis over a grid) and B5a, B5b (at given
points), hand-written in CUDA C++: one source, ``csrc/grid_scan.cu``, built
once per (model, precision).

* **B1** (``precision="f64"``) replaces the TPU kernel
  ``_kernel_df``/``_launch_df`` (``inflatox_tpu/ops/pallas_kernels.py:388-533``,
  entries ``scan_pallas_df64`` and ``complete_analysis_pallas_df64``), and
  with it ``_kernel_edf``/``_launch_edf`` (``:835, 889``, the D5-range
  engine): Hopper's f64 has the range.  The TPU kernels evaluate the model in
  (hi, lo) f32 pairs, because Mosaic has no f64, and strip-mine their tiles
  to fit VMEM and the vector registers; the kernel computes in plain f64:
  one thread per grid point, coordinates derived in the thread, the
  generated model functions (:meth:`CompiledModel.cuda_source`) and the
  point tail (``csrc/anguelova.cuh``), n_out f64 planes written once.
* **B2** (``"f32"``) replaces the fp32 kernel ``_kernel``/``_launch``
  (``:231, 257``): the same in float, coordinates ``x0a + i*dx0`` in f32.
* **B4** (``"dd"``) replaces the triple-f32 kernel ``_kernel_tf``/``_launch_tf``
  (``:1536, 1577``): the model in double-double (``csrc/dd.cuh``), demoted
  to f64, then the f64 tail.
* **B7a**, **B7b** and **B7d** (``inflx_grid_scan_batch``) are B1, B2 and B4
  over a batch of S parameter sets in one launch, the set on a third grid
  axis: they replace the batched TPU kernels ``_kernel_df_batch``,
  ``_kernel_f32_batch`` and ``_kernel_tf_batch`` with their launchers
  (``:536-676, 1689-1760``), which ``parameter_sweep`` launches;
  ``_kernel_edf_batch`` (``:678``) maps onto B7a, as B3 onto B1.  The
  output is (S, n_out, N0, N1), each set bit for bit its single scan.
* **B5a** and **B5b** (``inflx_points_scan``, ``"f64"`` and ``"dd"``) replace
  ``_kernel_df_ot``/``_kernel_edf_ot`` and ``_kernel_tf_ot`` with
  ``_launch_ot`` (``:1055-1160``): the four analysis kinds at the points of
  a contiguous (n, 2) float64 tensor, one thread per point, each running
  the header's fused point function of its kind (the model values
  hash-consed together, so each heavy call is made once a point, then the
  tail).  The TPU's (hi, lo) split of the coordinates, its padding to (32,
  128) blocks and its f32 output pairs are dropped: the points are exact
  f64.

Kinds: the four analyses (``complete_analysis`` six planes, ``consistency``,
``consistency_rapidturn``, ``epsilon_v``) and the raw surfaces
``potential`` (V), ``hesse`` (V_vv, V_vw, V_wv, V_ww) and ``gradient``
(∂_0 V, ∂_1 V), as the TPU kernels' ``_core_f32``/``_core_df``.

What bounds them on the H100: B1 and B2 the output writes (at 4096² the
six f64 maps are 805 MB, 0.24 ms at 3.35 TB/s; the f64 work, a few hundred
operations per point for hyperinflation, comes second), B4 its f64
operations (a double-double add is about twenty), B5a its bytes (16 read and
8·n_out written per point).  The design reads no input but the parameter
vector (and the points for B5), so the writes are the only other
device-memory traffic, each written once and coalesced.  Tuning is left to
later PRs.

Beside the kernels:

* :func:`scan_cuda`, :func:`scan_batch_cuda`, :func:`scan_points_cuda` —
  the wrappers: on a CUDA
  device they launch the kernel on the current stream (no synchronisation)
  and count the launch in :data:`LAUNCHES_BY_KERNEL` (:func:`launches`
  sums it);
  on a CPU device they run the plain version.
* :func:`scan_torch`, :func:`scan_batch_torch`, :func:`scan_points_torch` —
  the plain PyTorch
  versions (the lowered torch functions, or their double-double compilation
  :meth:`CompiledModel.dd_fns`, and :mod:`inflatox_torch.ops.anguelova`),
  used by the CPU path, by ``engine="torch"`` and by the tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .anguelova import (
    complete_analysis_op,
    consistency_only_op,
    consistency_rapidturn_only_op,
    epsilon_v_only_op,
)
from ..lowering.special import suppress_domain_warnings
from .dd import DD, to_f64
from ..utils.devices import upload
from .grid import grid_coords

__all__ = ["GRID_KERNELS", "KINDS", "LAUNCHES_BY_KERNEL", "POINT_KINDS", "PRECISIONS", "Precision",
           "evaluate_points", "launches", "scan_batch_cuda", "scan_batch_torch",
           "scan_cuda", "scan_points_cuda", "scan_points_torch", "scan_torch"]

#: scan kind → (kernel KIND id in csrc/grid_scan.cu, number of output planes)
KINDS = {
    "complete_analysis": (0, 6),
    "consistency": (1, 1),
    "consistency_rapidturn": (2, 1),
    "epsilon_v": (3, 1),
    "potential": (4, 1),
    "hesse": (5, 4),
    "gradient": (6, 2),
}
#: the kinds the point scans (B5a, B5b) take, as the JAX package's ``_ot``
#: scans
POINT_KINDS = ("complete_analysis", "consistency", "consistency_rapidturn", "epsilon_v")


class Precision(NamedTuple):
    """A precision's library (``INFLX_PRECISION`` in its header and in
    ``csrc/grid_scan.cu``) and kernels."""

    id: int
    grid_kernel: str
    point_kernel: str | None
    batch_kernel: str


#: the port's precisions: f64, f32 (no point kernel) and double-double
PRECISIONS = {"f64": Precision(0, "B1", "B5a", "B7a"), "f32": Precision(1, "B2", None, "B7b"),
              "dd": Precision(2, "B4", "B5b", "B7d")}

#: the grid and point kernels, which :func:`launches` sums
GRID_KERNELS = ("B1", "B2", "B4", "B5a", "B5b", "B7a", "B7b", "B7d")

#: kernel launches made in this process, by kernel: the grid and point
#: kernels by :func:`scan_cuda`, :func:`scan_batch_cuda` and
#: :func:`scan_points_cuda`, B6 by ``cuda_solver.solve_cuda``, B8 alone by
#: ``special_eval.special_eval_cuda``, B9 (the survey's reduction) by
#: ``cuda_survey.survey_reduce_cuda``
LAUNCHES_BY_KERNEL = {**dict.fromkeys(GRID_KERNELS, 0), "B6": 0, "B8": 0, "B9": 0}


def launches() -> int:
    """Launches of the grid and point kernels (:data:`GRID_KERNELS`: by
    :func:`scan_cuda`, :func:`scan_batch_cuda` and
    :func:`scan_points_cuda`) in this process, all together; not B6, B8
    or B9."""
    return sum(LAUNCHES_BY_KERNEL[k] for k in GRID_KERNELS)


def _check_model(artifact, kind, args, precision, kinds=KINDS, batch=False):
    """``args`` as float64 numpy: (n_parameters,), or (S, n_parameters)
    with S ≥ 1 for a ``batch``."""
    if kind not in kinds:
        raise ValueError(f"unknown scan kind {kind!r}; expected one of {sorted(kinds)}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    if artifact.n_fields != 2:
        raise ValueError("the grid scan needs a 2-field model")
    if torch.is_tensor(args):
        if args.dtype != torch.float64:
            raise TypeError(f"args must be float64, got {args.dtype}")
        args = args.detach().cpu().numpy()
    args = np.asarray(args, dtype=np.float64)
    k = artifact.n_parameters
    if batch:
        if args.ndim != 2 or args.shape[1] != k or args.shape[0] == 0:
            raise ValueError(f"args_batch must have shape (S, {k}) with S >= 1, "
                             f"got {args.shape}")
    elif args.shape != (k,):
        raise ValueError(f"args must have shape ({k},), got {args.shape}")
    return args


def _check(artifact, kind, args, extent, shape, precision, batch=False, rows=None):
    """Checked (args, extent, shape, rows); ``rows`` None becomes the whole
    grid's (0, N0)."""
    args = _check_model(artifact, kind, args, precision, batch=batch)
    extent = tuple(float(v) for v in extent)
    if len(extent) != 4 or not all(math.isfinite(v) for v in extent):
        raise ValueError(f"extent must be 4 finite numbers, got {extent}")
    if len(shape) != 2:
        raise ValueError(f"shape must be (N0, N1), got {shape}")
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] <= 0 or shape[1] <= 0:
        raise ValueError(f"shape must be positive, got {shape}")
    rows = (0, shape[0]) if rows is None else (int(rows[0]), int(rows[1]))
    if rows[0] < 0 or rows[1] <= 0 or rows[0] + rows[1] > shape[0]:
        raise ValueError(f"rows (first, count) must lie within the {shape[0]} rows of the "
                         f"grid, got {rows}")
    return args, extent, shape, rows


def _model_values(artifact, precision):
    """(potential, grad_square, grad, hesse) in ``precision``, each
    returning values of the working type."""
    if precision == "dd":
        fns = artifact.dd_fns()
        return fns["potential"], fns["grad_square"], fns["grad"], fns["hesse"]
    return artifact.potential, artifact.grad_square, artifact._grad, artifact.hesse_tuple


def evaluate_points(artifact, kind, args, xs, precision: str = "f64") -> torch.Tensor:
    """One scan kind at the points ``xs`` (a pair of broadcastable
    coordinate tensors: float64, float32 for ``"f32"``, or
    :class:`~inflatox_torch.ops.dd.DD` for ``"dd"``), in plain PyTorch on
    their device: the model functions in that precision and the point tail
    (f32 for ``"f32"``, else f64 on the demoted model values).  Returns an
    (n_out, *shape) tensor; for an (S, k) ``args`` (a batch of parameter
    sets) an (S, n_out, *shape) tensor, each parameter a (S, 1, ..., 1)
    tensor that broadcasts against the coordinates, so each set is computed
    as alone."""
    first = xs[0].hi if precision == "dd" else xs[0]
    second = xs[1].hi if precision == "dd" else xs[1]
    shape = torch.broadcast_shapes(first.shape, second.shape)
    device = first.device
    dtype = torch.float32 if precision == "f32" else torch.float64
    args = np.asarray(args, dtype=np.float64)
    p = upload(args.T, device, precision)
    if args.ndim == 2:
        p = p.reshape(args.shape[1], args.shape[0], *(1,) * len(shape))
        shape = (args.shape[0], *shape)
    potential, grad_square, grad, hesse = _model_values(artifact, precision)
    with suppress_domain_warnings():
        return _evaluate(potential, grad_square, grad, hesse, kind, xs, p, shape, dtype, device,
                         args.ndim)


def _evaluate(potential, grad_square, grad, hesse, kind, xs, p, shape, dtype, device, ndim):
    def grid(val):
        # constant outputs of the lowering (numbers) and single-axis
        # expressions broadcast to the grid shape first; double-double
        # values are demoted to f64
        if isinstance(val, DD):
            val = to_f64(val)
        return torch.as_tensor(val, dtype=dtype, device=device).expand(shape)

    if kind == "potential":
        outs = (grid(potential(xs, p)),)
    elif kind == "hesse":
        outs = tuple(grid(h) for h in hesse(xs, p))
    elif kind == "gradient":
        outs = tuple(grid(g) for g in grad(xs, p))
    else:
        v = grid(potential(xs, p))
        if kind == "epsilon_v":
            outs = (epsilon_v_only_op(v, grid(grad_square(xs, p))),)
        else:
            v00, _, v10, v11 = (grid(h) for h in hesse(xs, p))
            if kind == "complete_analysis":
                gs = grid(grad_square(xs, p))
                outs = complete_analysis_op(v, v00, v10, v11, gs)
            elif kind == "consistency":
                outs = (consistency_only_op(v, v00, v10, v11),)
            else:
                outs = (consistency_rapidturn_only_op(v, v00, v10, v11),)
    return torch.stack(outs, dim=ndim - 1)


def scan_torch(artifact, kind, args, extent, shape, device, precision: str = "f64",
               rows=None) -> torch.Tensor:
    """Plain PyTorch version of kernels B1, B2 and B4: one scan kind over
    the endpoint-exclusive grid ``extent = (x0a, x0b, x1a, x1b)`` of
    ``shape = (N0, N1)`` points, on ``device``, in ``precision``; ``rows =
    (first, count)`` scans only those rows of the grid, with the whole
    grid's coordinates (:func:`~inflatox_torch.ops.grid.grid_coords`).
    Returns an (n_out, N0, N1) tensor (``count`` rows for ``rows``; float32
    for ``"f32"``, else float64)."""
    args, extent, shape, rows = _check(artifact, kind, args, extent, shape, precision,
                                       rows=rows)
    device = torch.device(device)
    xs = grid_coords(((extent[0], extent[1]), (extent[2], extent[3])), shape, device,
                     precision, rows)
    return evaluate_points(artifact, kind, args, xs, precision)


def scan_batch_torch(artifact, kind, args_batch, extent, shape, device,
                     precision: str = "f64", rows=None) -> torch.Tensor:
    """Plain PyTorch version of kernels B7a, B7b and B7d: :func:`scan_torch`
    for each row of the (S, k) ``args_batch`` at once, on ``device``.
    Returns an (S, n_out, N0, N1) tensor."""
    args_batch, extent, shape, rows = _check(artifact, kind, args_batch, extent, shape,
                                             precision, batch=True, rows=rows)
    device = torch.device(device)
    xs = grid_coords(((extent[0], extent[1]), (extent[2], extent[3])), shape, device,
                     precision, rows)
    return evaluate_points(artifact, kind, args_batch, xs, precision)


def _library(artifact, precision):
    from .build import load_grid_scan  # noqa: PLC0415

    lib = load_grid_scan(artifact.cuda_source(precision))
    if lib.inflx_precision() != PRECISIONS[precision].id:
        raise RuntimeError(f"the grid-scan library was not built for precision {precision!r}")
    return lib


def _launch_grid(artifact, kind, args_batch, extent, shape, rows, device, precision,
                 kernel):
    """Build (first use) and launch the grid-scan kernel for the rows of the
    (S, k) ``args_batch`` on the current stream of the CUDA ``device``, once
    per ``inflx_max_sets()`` sets, counting each launch under ``kernel``;
    returns the (S, n_out, count, N1) output of grid rows ``rows = (first,
    count)``, each row at its global index (row0 = first).  A launch error
    raises."""
    lib = _library(artifact, precision)
    kind_id, n_out = KINDS[kind]
    x0a, x0b, x1a, x1b = extent
    n0, n1 = shape
    row0, count = rows
    n_sets = args_batch.shape[0]
    dtype = torch.float32 if precision == "f32" else torch.float64
    max_sets = lib.inflx_max_sets()
    with torch.cuda.device(device):
        p = upload(args_batch, device, precision)
        out = torch.empty((n_sets, n_out, count, n1), dtype=dtype, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo in range(0, n_sets, max_sets):
            err = lib.inflx_grid_scan_rows(
                kind_id, p[lo].data_ptr() if p.numel() else None, out[lo].data_ptr(),
                x0a, (x0b - x0a) / n0, x1a, (x1b - x1a) / n1, row0, count, n1,
                min(max_sets, n_sets - lo), stream,
            )
            if err != 0:
                msg = lib.inflx_error_string(err).decode()
                raise RuntimeError(f"grid-scan kernel {kernel} launch failed: CUDA error "
                                   f"{err} ({msg})")
            LAUNCHES_BY_KERNEL[kernel] += 1
    return out


def _wrapper_device(device, wrapper):
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{wrapper} runs on a CUDA or CPU device, got {device}")
    return device


def scan_cuda(artifact, kind, args, extent, shape, device, precision: str = "f64",
              rows=None) -> torch.Tensor:
    """The wrapper of kernels B1 (``precision="f64"``), B2 (``"f32"``) and
    B4 (``"dd"``): one scan kind over the endpoint-exclusive grid ``extent =
    (x0a, x0b, x1a, x1b)`` of ``shape = (N0, N1)`` points; ``rows = (first,
    count)`` scans only those rows, bit for bit the same rows of the whole
    scan (a sharded scan's shard).

    On a CUDA device it builds the kernel for the model and precision
    (first use), makes the parameter tensor, allocates one (n_out, N0, N1)
    output (float32 for ``"f32"``, else float64) with ``torch.empty`` and
    launches on the current stream without synchronising (the batched
    kernel's launch for one set); a launch error raises.  On a CPU device it
    returns :func:`scan_torch`'s result and launches nothing."""
    args, extent, shape, rows = _check(artifact, kind, args, extent, shape, precision,
                                       rows=rows)
    device = _wrapper_device(device, "scan_cuda")
    if device.type == "cpu":
        return scan_torch(artifact, kind, args, extent, shape, device, precision, rows)
    return _launch_grid(artifact, kind, args[None], extent, shape, rows, device, precision,
                        PRECISIONS[precision].grid_kernel)[0]


def scan_batch_cuda(artifact, kind, args_batch, extent, shape, device,
                    precision: str = "f64", rows=None) -> torch.Tensor:
    """The wrapper of kernels B7a (``precision="f64"``), B7b (``"f32"``)
    and B7d (``"dd"``): one scan kind over the endpoint-exclusive grid
    ``extent = (x0a, x0b, x1a, x1b)`` of ``shape = (N0, N1)`` points for each
    row of the (S, k) ``args_batch``, in one launch.

    On a CUDA device it builds the kernel for the model and precision
    (first use), copies the parameter sets to the device, allocates one
    (S, n_out, N0, N1) output (float32 for ``"f32"``, else float64) with
    ``torch.empty`` and launches on the current stream without
    synchronising, once per 65535 sets (a launch takes at most that many);
    a launch error raises.  On a CPU device it returns
    :func:`scan_batch_torch`'s result and launches nothing."""
    args_batch, extent, shape, rows = _check(artifact, kind, args_batch, extent, shape,
                                             precision, batch=True, rows=rows)
    device = _wrapper_device(device, "scan_batch_cuda")
    if device.type == "cpu":
        return scan_batch_torch(artifact, kind, args_batch, extent, shape, device, precision,
                                rows)
    return _launch_grid(artifact, kind, args_batch, extent, shape, rows, device, precision,
                        PRECISIONS[precision].batch_kernel)


def _check_points(artifact, kind, args, x, precision):
    args = _check_model(artifact, kind, args, precision, POINT_KINDS)
    if PRECISIONS[precision].point_kernel is None:
        raise ValueError(
            f'precision={precision!r} is not offered on points (as in the JAX '
            'package, whose trajectory scans run the compensated engines only); '
            'use "f64" or "dd"'
        )
    if not torch.is_tensor(x) or x.dtype != torch.float64:
        raise TypeError("points must be a float64 tensor")
    if x.ndim != 2 or x.shape[1] != 2:
        raise ValueError(f"points must have shape (n, 2), got {tuple(x.shape)}")
    return args


def scan_points_torch(artifact, kind, args, x, precision: str = "f64") -> torch.Tensor:
    """Plain PyTorch version of kernels B5a (``precision="f64"``) and B5b
    (``"dd"``): one scan kind at the points of the (n, 2) float64 tensor
    ``x``, on its device.  Returns an (n_out, n) float64 tensor."""
    args = _check_points(artifact, kind, args, x, precision)
    xs = (x[:, 0], x[:, 1])
    if precision == "dd":
        xs = tuple(DD(c, torch.zeros_like(c)) for c in xs)
    return evaluate_points(artifact, kind, args, xs, precision)


def scan_points_cuda(artifact, kind, args, x, precision: str = "f64") -> torch.Tensor:
    """The wrapper of kernels B5a (``precision="f64"``) and B5b (``"dd"``):
    one scan kind at the points of the (n, 2) float64 tensor ``x``.

    On a CUDA device it builds the kernel for the model and precision
    (first use), allocates one (n_out, n) float64 output with
    ``torch.empty`` and launches on the current stream without
    synchronising; a launch error raises.  For a model that calls special
    functions it launches the coherent kernel (``inflx_points_scan_coherent``:
    each block sorts its tile of points by a coarse cell first, so that the
    lanes of a warp take the same routes of kernel B8; each point's bits are
    unchanged).  A non-contiguous ``x`` is made
    contiguous first.  On a CPU device it returns
    :func:`scan_points_torch`'s result and launches nothing."""
    args = _check_points(artifact, kind, args, x, precision)
    device = x.device
    if device.type == "cpu":
        return scan_points_torch(artifact, kind, args, x, precision)
    if device.type != "cuda":
        raise ValueError(f"scan_points_cuda runs on a CUDA or CPU device, got {device}")
    _, n_out = KINDS[kind]
    n = x.shape[0]
    if n == 0:
        return torch.empty((n_out, 0), dtype=torch.float64, device=device)
    lib = _library(artifact, precision)
    with torch.cuda.device(device):
        x = x.contiguous()
        p = upload(args, device)
        out = torch.empty((n_out, n), dtype=torch.float64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        launch = (KINDS[kind][0], p.data_ptr() if p.numel() else None, x.data_ptr(),
                  out.data_ptr(), n)
        entry = (lib.inflx_points_scan_coherent if artifact.uses_special_functions
                 else lib.inflx_points_scan)
        err = entry(*launch, stream)
    if err != 0:
        msg = lib.inflx_error_string(err).decode()
        raise RuntimeError(f"points-scan kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES_BY_KERNEL[PRECISIONS[precision].point_kernel] += 1
    return out
