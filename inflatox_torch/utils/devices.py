"""Devices and engines, resolved the same way by every entry point.

A device is explicit: ``"cuda"`` (the default of every entry point) on a host
without CUDA raises instead of moving the work to the CPU.  An engine picks
the code that runs there: ``None`` resolves to ``"cuda"`` (the entry's
hand-written kernel) on a CUDA device and to ``"torch"`` (its plain PyTorch
version) on a CPU device; ``"cuda"`` needs a CUDA device; ``"torch"`` runs
on any.  A precision picks the arithmetic: ``"f64"`` (the default),
``"f32"`` or ``"dd"`` (double-double); the JAX package's ``dtype=float32``
spelling of ``"f32"`` is accepted.  :func:`upload` puts a host array on a
device without blocking the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "resolve_engine", "resolve_precision", "upload"]

#: JAX-package engines and what takes their place in the port
_ENGINE_MAP = (
    '"pallas_df64" and "pallas_edf64" map to engine="cuda" with '
    'precision="f64" (kernel B1; B7a in a parameter sweep), "pallas_tf64" to '
    'precision="dd" (the double-double kernel B4; B7d), "pallas" to '
    'precision="f32" (kernel B2; B7b); "xla" has no counterpart — use '
    'engine="torch" for the plain PyTorch version at the same precision'
)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available "
            "on this host; pass device=\"cpu\" to compute on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA or CPU device, got {device}")
    return device


def resolve_engine(engine, device: torch.device, kernel: str) -> str:
    """``"cuda"`` or ``"torch"`` for ``engine`` on ``device``; ``kernel``
    names the hand-written kernel ``"cuda"`` runs, for messages."""
    if engine is None:
        return "cuda" if device.type == "cuda" else "torch"
    if engine == "cuda":
        if device.type != "cuda":
            raise ValueError(
                f'engine="cuda" runs {kernel} on a CUDA device; this call '
                f'computes on {device} (pass device="cuda", or use '
                'engine="torch")'
            )
        return engine
    if engine == "torch":
        return engine
    if engine == "xla" or str(engine).startswith("pallas"):
        raise ValueError(
            f"engine={engine!r} is a JAX-package engine; in the PyTorch "
            f"port {_ENGINE_MAP}"
        )
    raise ValueError(
        f'unknown engine {engine!r}; expected None (auto), "cuda" or "torch"'
    )


def resolve_precision(precision=None, dtype=None) -> str:
    """``"f64"``, ``"f32"`` or ``"dd"`` from ``precision`` (None: from
    ``dtype``, else ``"f64"``) and the JAX package's ``dtype``: float32
    means ``"f32"``, float64 is ``"f64"`` or ``"dd"`` (both deliver f64
    values); a pair that disagrees raises."""
    from ..ops.cuda_kernels import PRECISIONS  # noqa: PLC0415 (it imports this module)

    if precision is not None and precision not in PRECISIONS:
        raise ValueError(
            f"precision must be None or one of {tuple(PRECISIONS)}, got {precision!r}"
        )
    if dtype is None:
        return precision or "f64"
    if dtype in (torch.float32, np.float32):
        implied = ("f32",)
    elif dtype in (torch.float64, np.float64):
        implied = ("f64", "dd")
    else:
        raise ValueError(f"dtype must be None, float32 or float64, got {dtype!r}")
    if precision is None:
        return implied[0]
    if precision not in implied:
        raise ValueError(f"dtype={dtype!r} conflicts with precision={precision!r}")
    return precision


def upload(a, device: torch.device, precision: str = "f64") -> torch.Tensor:
    """An array (parameters, initial conditions) on ``device`` (float32 for
    ``"f32"``, else float64); to a CUDA device through pinned memory, so
    the copy does not block the host: it is ordered on the device's current
    stream, and the host does not wait for what is already enqueued there."""
    dtype = np.float32 if precision == "f32" else np.float64
    host = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)
