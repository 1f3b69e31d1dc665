"""Field-space grid coordinates.

Grid convention (parity with the reference, anguelova.rs:84-94, and with
``inflatox_tpu/ops/grid.py``): along each axis, ``N`` samples at

    x_i = start + i * (stop - start) / N        for i = 0 .. N-1

i.e. an *endpoint-exclusive* linspace.  The spacing is one correctly rounded
f64 division on the host, and each coordinate one multiply and one add, so
the CUDA grid-scan kernel (which computes ``x0a + i*dx0`` with explicit
round-to-nearest operations) reproduces these coordinates bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["grid_coords", "axis_coords"]


def axis_coords(start, stop, n: int, device="cpu") -> torch.Tensor:
    """1-D endpoint-exclusive float64 axis: start + i*(stop-start)/n."""
    start, stop = float(start), float(stop)
    spacing = (stop - start) / n
    idx = torch.arange(n, dtype=torch.float64, device=device)
    return start + idx * spacing


def grid_coords(start_stop, shape, device="cpu") -> tuple:
    """Per-field coordinate tensors for an n-D grid.

    Args
    ----
    start_stop: sequence of (start, stop) pairs, one per field.
    shape: number of samples per axis.

    Returns ``len(shape)`` float64 tensors, each of shape ``shape`` (a
    broadcast view of one axis, so no grid-sized memory is allocated), giving
    the field-space coordinate of every grid point.
    """
    shape = tuple(int(n) for n in shape)
    coords = []
    for axis, ((start, stop), n) in enumerate(zip(start_stop, shape)):
        view = [1] * len(shape)
        view[axis] = n
        coords.append(axis_coords(start, stop, n, device).reshape(view).expand(shape))
    return tuple(coords)
