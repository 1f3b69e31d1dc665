"""Field-space grid coordinates.

Grid convention (parity with the reference, anguelova.rs:84-94, and with
``inflatox_tpu/ops/grid.py``): along each axis, ``N`` samples at

    x_i = start + i * (stop - start) / N        for i = 0 .. N-1

i.e. an *endpoint-exclusive* linspace.  The spacing is one correctly rounded
f64 division on the host, and each coordinate one multiply and one add, so
the CUDA grid-scan kernel (which computes ``x0a + i*dx0`` with explicit
round-to-nearest operations) reproduces these coordinates bit for bit.

A range of rows (``first``, ``rows=``) keeps the whole grid's start and
spacing and its global index i, so a shard of the grid (a sharded scan's
rows) has the same coordinates as those rows of the whole grid.
"""

from __future__ import annotations

import numpy as np
import torch

from .dd import DD, two_prod

__all__ = ["grid_coords", "axis_coords"]


def axis_coords(start, stop, n: int, device="cpu", precision: str = "f64", first: int = 0,
                count: int | None = None):
    """1-D endpoint-exclusive axis: start + i*(stop-start)/n, in float64
    (``"f64"``), in float32 from f32 scalars (``"f32"``, i an exact float
    up to 2^24), or as an exact :class:`~inflatox_torch.ops.dd.DD`
    (``"dd"``), for i in [``first``, ``first + count``) (default: the whole
    axis)."""
    start, stop = float(start), float(stop)
    spacing = (stop - start) / n
    end = n if count is None else first + int(count)
    if precision == "f32":
        idx = torch.arange(first, end, dtype=torch.float32, device=device)
        return float(np.float32(start)) + idx * float(np.float32(spacing))
    idx = torch.arange(first, end, dtype=torch.float64, device=device)
    if precision == "dd":
        return DD(start, 0.0) + DD(*two_prod(idx, spacing))
    return start + idx * spacing


def grid_coords(start_stop, shape, device="cpu", precision: str = "f64", rows=None) -> tuple:
    """Per-field coordinate tensors for an n-D grid.

    Args
    ----
    start_stop: sequence of (start, stop) pairs, one per field.
    shape: number of samples per axis.
    rows: None (the whole grid) or ``(first, count)``: only rows
        ``first .. first + count - 1`` of the first axis, with the whole
        grid's coordinates.

    Returns ``len(shape)`` tensors (of :func:`axis_coords`'s type), each of
    shape ``shape`` (``count`` along the first axis for ``rows``; a
    broadcast view of one axis, so no grid-sized memory is allocated),
    giving the field-space coordinate of every grid point.
    """
    shape = tuple(int(n) for n in shape)
    first, count = (0, shape[0]) if rows is None else (int(rows[0]), int(rows[1]))
    out_shape = (count, *shape[1:])
    coords = []
    for axis, ((start, stop), n) in enumerate(zip(start_stop, shape)):
        view = [1] * len(shape)
        view[axis] = out_shape[axis]
        axis_ = (axis_coords(start, stop, n, device, precision, first, count) if axis == 0
                 else axis_coords(start, stop, n, device, precision))
        if precision == "dd":
            coords.append(DD(axis_.hi.reshape(view).expand(out_shape),
                             axis_.lo.reshape(view).expand(out_shape)))
        else:
            coords.append(axis_.reshape(view).expand(out_shape))
    return tuple(coords)
