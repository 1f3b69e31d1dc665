"""Devices and engines, resolved the same way by every entry point.

A device is explicit: ``"cuda"`` (the default of every entry point) on a host
without CUDA raises instead of moving the work to the CPU.  An engine picks
the code that runs there: ``None`` resolves to ``"cuda"`` (the entry's
hand-written kernel) on a CUDA device and to ``"torch"`` (its plain PyTorch
version) on a CPU device; ``"cuda"`` needs a CUDA device; ``"torch"`` runs
on any.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_engine"]

#: JAX-package engines and what takes their place in the port
_ENGINE_MAP = (
    '"pallas_df64" and "pallas_edf64" map to kernel B1 (engine="cuda"), '
    '"pallas_tf64" to a double-double kernel (ROADMAP B4), "pallas" to an '
    'f32 kernel (ROADMAP B2); "xla" has no counterpart — use engine="torch" '
    "for the plain PyTorch version"
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
