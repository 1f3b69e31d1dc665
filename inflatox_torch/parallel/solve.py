"""Batched background solves sharded over a mesh.

The port of ``inflatox_tpu/parallel/solve.py``.  Trajectories are
independent, so a batch splits over the mesh axis with no collective: each
slot integrates its own contiguous block of trajectories in one launch of
kernel B6 (one thread a trajectory; its plain version on a CPU slot), and
the blocks are joined on return.  The batch is padded to a multiple of the
axis by repeating its last row and trimmed on return.  Each trajectory's
rows are bit for bit those of the unsharded launch: B6 computes each
trajectory alone.  The JAX package's ``solver="rkf_pallas"`` (the TPU
kernel) and its Pallas interpreter have no counterpart: ``solver="rkf"``
runs B6.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_solver import _check_batch, _check_solver, solve_cuda, solve_torch
from ..utils.devices import resolve_engine
from .mesh import check_mesh, gather_shards, launch_shards, pad_rows

__all__ = ["sharded_solve_eom_batch"]


def _buffer(rows):
    """The (steps, 2n+2, b) output of which B6 and its plain version return
    (rows, times) as views: the times are the column after the rows' last
    (``ops/cuda_solver._views``)."""
    b, steps, ny = rows.shape
    return torch.as_strided(rows, (steps, ny + 1, b),
                            (rows.stride(1), rows.stride(2), rows.stride(0)),
                            rows.storage_offset())


def sharded_solve_eom_batch(
    artifact,
    pars,
    steps: int,
    fields_init,
    derivatives_init,
    mesh,
    solve_axis: str = "solve",
    max_err: float = 1e-6,
    solver: str = "rkf",
    return_time: bool = False,
    interpret: bool | None = None,
    combine: str = "host",
    engine: str | None = None,
):
    """Integrate a trajectory batch sharded over ``mesh``'s ``solve_axis``.

    Same contract as :func:`inflatox_torch.background.solve_eom_batch`
    ((B, steps, 2n+1) rows [+ (B, steps) times] as numpy views of one
    pinned host buffer, each slot's block copied straight into its slice;
    ``pars`` shared (k,) or per-trajectory (B, k)).  ``combine="device"`` returns (rows,
    times) tensors on the mesh's first device instead (always both), laid
    out as the unsharded launch's, for reductions on the device
    (:func:`~inflatox_torch.background.survey_initial_conditions`).
    ``engine``: None (kernel B6 on a CUDA slot, the plain version on a CPU
    slot), ``"cuda"`` or ``"torch"``, resolved per slot.  ``interpret`` (the
    JAX package's Pallas interpreter) has no counterpart and raises."""
    if combine not in ("host", "device"):
        raise ValueError(f"combine must be 'host' or 'device', got {combine!r}")
    check_mesh(mesh)
    pars, fields_init, derivatives_init = _check_batch(
        artifact, pars, fields_init, derivatives_init
    )
    if interpret is not None:
        raise ValueError(
            "interpret= runs the JAX package's Pallas interpreter, which the PyTorch port "
            'does not have: solver="rkf" runs kernel B6 (its plain version on a CPU slot)'
        )
    _check_solver(solver)
    slots = mesh.axis_slots(solve_axis)
    n_dev = len(slots)
    B = fields_init.shape[0]
    local = -(-B // n_dev)
    f0 = pad_rows(fields_init, local * n_dev)
    d0 = pad_rows(derivatives_init, local * n_dev)
    per_traj = pars.ndim == 2
    p_all = pad_rows(pars, local * n_dev) if per_traj else pars

    def launch(i, device):
        sl = slice(i * local, (i + 1) * local)
        solve = solve_cuda if resolve_engine(engine, device, "kernel B6") == "cuda" else solve_torch

        def tensor(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=device)

        rows, _ = solve(artifact, tensor(p_all[sl] if per_traj else p_all), int(steps),
                        tensor(f0[sl]), tensor(d0[sl]), max_err, solver)
        # to the host trajectory-major, so that each block is one slice of
        # the joined (B, steps, 2n+2) array; on the device in B6's layout
        return (_buffer(rows).permute(2, 0, 1) if host else _buffer(rows),)

    host = combine == "host"
    (out,) = gather_shards(mesh, launch_shards(mesh, slots, launch, host, dim=0 if host else 2))
    ny = 2 * artifact.n_fields + 1
    if host:
        rows, times = out[:B, :, :ny], out[:B, :, ny]
        return (rows, times) if return_time else rows
    if out.shape[2] != B:
        out = out[:, :, :B].contiguous()
    view = out.permute(2, 0, 1)
    return view[..., :ny], view[..., ny]
