"""Kernel B1: the complete-analysis grid scan, hand-written in CUDA C++.

Replaces the TPU kernel ``_kernel_df``/``_launch_df``
(``inflatox_tpu/ops/pallas_kernels.py:388-533``, entries
``scan_pallas_df64`` and ``complete_analysis_pallas_df64``).  The TPU kernel
evaluates the model in double-f32 (hi, lo) pairs, because Mosaic has no f64,
and strip-mines its tiles to fit VMEM and the vector registers.  Hopper has
IEEE f64, so the kernel (``csrc/grid_scan.cu``) computes in plain f64: one
thread per grid point, coordinates derived in the thread, the generated
model functions (:meth:`CompiledModel.cuda_source`) and the point tail
(``csrc/anguelova.cuh``), n_out f64 planes written once.

What bounds it on the H100: the f64 ALU (a few hundred f64 operations per
point for hyperinflation, among them about twenty IEEE divisions, three
square roots and an atan; 34 TFLOP/s f64 outside the tensor cores on
paper) and the output writes (at 4096² the six f64 maps are 805 MB,
0.24 ms at 3.35 TB/s).  The design reads no input but the parameter
vector, so the writes are the only device-memory traffic, each written once
and coalesced (j is the fastest index).  Tuning the f64 work per point is
left to later PRs.

Beside the kernel:

* :func:`scan_cuda` — the wrapper: on a CUDA device it launches the kernel
  on the current stream (no synchronisation) and counts the launch in
  :data:`LAUNCHES`; on a CPU device it runs :func:`scan_torch`.
* :func:`scan_torch` — the plain PyTorch version (grid coordinates, the
  lowered torch functions and :mod:`inflatox_torch.ops.anguelova`), used by
  the CPU path, by ``engine="torch"`` and by the tests.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .anguelova import (
    complete_analysis_op,
    consistency_only_op,
    consistency_rapidturn_only_op,
    epsilon_v_only_op,
)
from .grid import grid_coords

__all__ = ["KINDS", "LAUNCHES", "evaluate_points", "scan_cuda", "scan_torch"]

#: scan kind → (kernel KIND id in csrc/grid_scan.cu, number of output planes)
KINDS = {
    "complete_analysis": (0, 6),
    "consistency": (1, 1),
    "consistency_rapidturn": (2, 1),
    "epsilon_v": (3, 1),
}

#: number of kernel launches made by :func:`scan_cuda` in this process
LAUNCHES = 0


def _check(artifact, kind, args, extent, shape):
    if kind not in KINDS:
        raise ValueError(f"unknown scan kind {kind!r}; expected one of {sorted(KINDS)}")
    if artifact.n_fields != 2:
        raise ValueError("the grid scan needs a 2-field model")
    if torch.is_tensor(args):
        if args.dtype != torch.float64:
            raise TypeError(f"args must be float64, got {args.dtype}")
        args = args.detach().cpu().numpy()
    args = np.asarray(args, dtype=np.float64)
    if args.shape != (artifact.n_parameters,):
        raise ValueError(
            f"args must have shape ({artifact.n_parameters},), got {args.shape}"
        )
    extent = tuple(float(v) for v in extent)
    if len(extent) != 4 or not all(math.isfinite(v) for v in extent):
        raise ValueError(f"extent must be 4 finite numbers, got {extent}")
    if len(shape) != 2:
        raise ValueError(f"shape must be (N0, N1), got {shape}")
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] <= 0 or shape[1] <= 0:
        raise ValueError(f"shape must be positive, got {shape}")
    return args, extent, shape


def _params(args: np.ndarray, device: torch.device) -> torch.Tensor:
    """The parameter vector as a float64 tensor on ``device``; to a CUDA
    device through pinned memory, so the copy does not block the host."""
    host = torch.from_numpy(np.ascontiguousarray(args, dtype=np.float64))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def evaluate_points(artifact, kind, args, xs) -> torch.Tensor:
    """One scan kind at the points ``xs`` (a pair of broadcastable float64
    coordinate tensors), in plain PyTorch on their device: the lowered model
    functions and the point tail.  Returns an (n_out, *shape) tensor."""
    shape = torch.broadcast_shapes(xs[0].shape, xs[1].shape)
    device = xs[0].device
    p = _params(np.asarray(args, dtype=np.float64), device)

    def grid(val):
        # constant outputs of the lowering (Python numbers) and
        # single-axis expressions broadcast to the grid shape first
        return torch.as_tensor(val, dtype=torch.float64, device=device).expand(shape)

    v = grid(artifact.potential(xs, p))
    if kind == "epsilon_v":
        outs = (epsilon_v_only_op(v, grid(artifact.grad_square(xs, p))),)
    else:
        v00, _, v10, v11 = (grid(h) for h in artifact.hesse_tuple(xs, p))
        if kind == "complete_analysis":
            gs = grid(artifact.grad_square(xs, p))
            outs = complete_analysis_op(v, v00, v10, v11, gs)
        elif kind == "consistency":
            outs = (consistency_only_op(v, v00, v10, v11),)
        else:
            outs = (consistency_rapidturn_only_op(v, v00, v10, v11),)
    return torch.stack(outs)


def scan_torch(artifact, kind, args, extent, shape, device) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one scan kind over the
    endpoint-exclusive grid ``extent = (x0a, x0b, x1a, x1b)`` of ``shape =
    (N0, N1)`` points, on ``device``.  Returns an (n_out, N0, N1) float64
    tensor."""
    args, extent, shape = _check(artifact, kind, args, extent, shape)
    device = torch.device(device)
    xs = grid_coords(((extent[0], extent[1]), (extent[2], extent[3])), shape, device)
    return evaluate_points(artifact, kind, args, xs)


def scan_cuda(artifact, kind, args, extent, shape, device) -> torch.Tensor:
    """Kernel B1's wrapper: one scan kind over the endpoint-exclusive grid
    ``extent = (x0a, x0b, x1a, x1b)`` of ``shape = (N0, N1)`` points.

    On a CUDA device it builds the kernel for the model (first use), makes
    the float64 parameter tensor, allocates one (n_out, N0, N1) float64
    output with ``torch.empty`` and launches on the current stream without
    synchronising; a launch error raises.  On a CPU device it returns
    :func:`scan_torch`'s result and launches nothing."""
    global LAUNCHES
    args, extent, shape = _check(artifact, kind, args, extent, shape)
    device = torch.device(device)
    if device.type == "cpu":
        return scan_torch(artifact, kind, args, extent, shape, device)
    if device.type != "cuda":
        raise ValueError(f"scan_cuda runs on a CUDA or CPU device, got {device}")
    from .build import load_grid_scan  # noqa: PLC0415

    lib = load_grid_scan(artifact.cuda_source())
    kind_id, n_out = KINDS[kind]
    x0a, x0b, x1a, x1b = extent
    n0, n1 = shape
    with torch.cuda.device(device):
        p = _params(args, device)
        out = torch.empty((n_out, n0, n1), dtype=torch.float64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.inflx_grid_scan(
            kind_id, p.data_ptr() if p.numel() else None, out.data_ptr(),
            x0a, (x0b - x0a) / n0, x1a, (x1b - x1a) / n1, n0, n1, stream,
        )
    if err != 0:
        msg = lib.inflx_error_string(err).decode()
        raise RuntimeError(f"grid-scan kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return out
