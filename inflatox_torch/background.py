"""Background equation-of-motion solver: batched adaptive Runge-Kutta.

The port of ``inflatox_tpu/background.py`` (reference:
``background.solve_eom``, background.py:30-49, driving the Rust
``RKNSolver``, background_solver.rs:72-336), with the JAX package's
semantics and documented divergences from the reference:

* the integrated system is the multi-field background EoM

      φ'^a = χ^a,   χ'^a = −eom_a(φ, χ) − 3 H χ^a,   H' = −½ G_ab χ^a χ^b

  with H initialised from the Friedmann constraint ``eom_h``;
* each output row records the state after one accepted adaptive step; row
  0 holds the initial state; step control starts at dt = 1e-10, rejects
  when err/max_err > 1.1 and rescales dt by (max_err/err)^(1/(s+1));
* textbook Butcher tableaus (the port's copy is in
  :mod:`inflatox_torch.ops.cuda_solver`, beside the plain version and the
  kernel that use it); ``solver="rk4"`` is classical RK4 with
  step-doubling error control.

Every solve runs kernel B6 (:mod:`inflatox_torch.ops.cuda_solver`), the
hand-written CUDA solver, on a CUDA device, or its plain PyTorch version;
a survey's rows on a CUDA device are reduced by kernel B9
(:mod:`inflatox_torch.ops.cuda_survey`), on the CPU by its plain version.
Devices are explicit: every entry takes ``device="cuda"`` by default and
``engine=None`` (``"cuda"`` on a CUDA device, ``"torch"`` on a CPU device),
``"cuda"`` or ``"torch"``.  ``solver="rkf"`` and ``"rk4"`` both run in the
kernel.  ``mesh=`` (a :func:`~inflatox_torch.parallel.make_mesh` mesh)
splits a batch over the mesh's first axis, one launch a slot
(:func:`~inflatox_torch.parallel.sharded_solve_eom_batch`); the mesh then
decides the devices.  One divergence from the JAX package: an attempt with a
non-finite dt is accepted (the JAX while loop never ends there; see
``csrc/solver.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

from .compiler import CompiledModel
from .ops.cuda_solver import _check_batch, _check_solver, solve_cuda, solve_torch
from .ops.cuda_survey import survey_reduce_cuda
from .parallel.mesh import check_mesh_device
from .parallel.solve import sharded_solve_eom_batch
from .utils.devices import resolve_device, resolve_engine, upload
from .utils.errors import ShapeError
from .utils.profiling import annotate

__all__ = ["SURVEY_COUNTS", "solve_eom", "solve_eom_batch", "survey_counts",
           "survey_initial_conditions", "efolds"]

#: the survey's chunks on a CUDA device through kernel B6, counted always (as
#: ``LAUNCHES_BY_KERNEL``): ``chunks`` solved, and ``overlapped``, those
#: solved in one launch beside an earlier chunk of the same call
#: (:func:`survey_counts`)
SURVEY_COUNTS = {"chunks": 0, "overlapped": 0}

#: kernel B6's block: one warp, a trajectory a thread (``csrc/solver.cu``)
_B6_BLOCK = 32

def _solve_batch_device(artifact, pars, steps, fields_init, derivatives_init,
                        max_err, solver, device, engine):
    """Batched solve returning (rows, times) tensors left on ``device`` —
    they feed on-device reductions.  Inputs must be pre-validated; ``pars``
    may be a float64 tensor on ``device`` already."""
    solve = solve_cuda if engine == "cuda" else solve_torch
    p = pars if torch.is_tensor(pars) else upload(pars, device)
    return solve(artifact, p, int(steps), upload(fields_init, device),
                 upload(derivatives_init, device), max_err, solver)


def _host(rows, times, return_time):
    rows = rows.cpu().numpy()
    if return_time:
        return rows, times.cpu().numpy()
    return rows


def solve_eom(
    artifact: CompiledModel,
    pars,
    steps: int,
    fields_init,
    derivatives_init,
    max_err: float = 1e-6,
    solver: str = "rk4",
    return_time: bool = False,
    device="cuda",
    engine: str | None = None,
):
    """Integrate the background EoM for one trajectory.

    Args mirror reference background.py:30-38.  Returns a (steps, 2n+1)
    array: fields, field derivatives, Hubble parameter per row; row 0 is the
    initial state with H from the Friedmann constraint.  With
    ``return_time=True`` also returns the (steps,) array of physical times
    of each row.  ``device``/``engine`` as in :func:`solve_eom_batch`."""
    n = artifact.n_fields
    fields_init = np.asarray(fields_init, dtype=float)
    derivatives_init = np.asarray(derivatives_init, dtype=float)
    pars = np.asarray(pars, dtype=float)
    if fields_init.shape != (n,) or derivatives_init.shape != (n,):
        raise ShapeError(
            (n,), fields_init.shape, "initial conditions must have one entry per field"
        )
    if pars.shape != (artifact.n_parameters,):
        raise ShapeError(
            (artifact.n_parameters,), pars.shape,
            f'model "{artifact.model_name}" has {artifact.n_parameters} parameters',
        )
    _check_solver(solver)
    device = resolve_device(device)
    engine = resolve_engine(engine, device, "kernel B6")
    rows, times = _solve_batch_device(
        artifact, pars, steps, fields_init[None], derivatives_init[None],
        max_err, solver, device, engine,
    )
    return _host(rows[0], times[0], return_time)


def solve_eom_batch(
    artifact: CompiledModel,
    pars,
    steps: int,
    fields_init,
    derivatives_init,
    max_err: float = 1e-6,
    solver: str = "rk4",
    return_time: bool = False,
    mesh=None,
    device="cuda",
    engine: str | None = None,
):
    """Integrate a batch of trajectories in one launch of kernel B6.

    ``fields_init``/``derivatives_init`` have shape (B, n); ``pars`` is
    either (k,) (shared) or (B, k) (per-trajectory, one parameter set per
    trajectory).  Returns (B, steps, 2n+1) [+ (B, steps) times] numpy
    arrays.

    ``device``: where the solve runs (``"cuda"`` by default; a CUDA device
    on a host without CUDA raises).  ``engine``: None — kernel B6 on a CUDA
    device, the plain PyTorch version on a CPU device; ``"cuda"`` — kernel
    B6; ``"torch"`` — the plain version on any device.  ``solver``:
    ``"rk4"`` or ``"rkf"`` (``"rkf_pallas"``, the JAX package's TPU kernel,
    raises: ``"rkf"`` runs kernel B6).  ``mesh=``: a
    :func:`~inflatox_torch.parallel.make_mesh` mesh, over whose first axis
    the batch is split (one launch a slot, each trajectory bit for bit the
    unsharded launch's); its devices take the place of ``device``, which
    must name their type.  Anything but a mesh raises ``TypeError``."""
    pars, fields_init, derivatives_init = _check_batch(
        artifact, pars, fields_init, derivatives_init
    )
    _check_solver(solver)
    if mesh is not None:
        check_mesh_device(mesh, device)
        return sharded_solve_eom_batch(
            artifact, pars, steps, fields_init, derivatives_init, mesh,
            solve_axis=mesh.axis_names[0], max_err=max_err, solver=solver,
            return_time=return_time, engine=engine,
        )
    device = resolve_device(device)
    engine = resolve_engine(engine, device, "kernel B6")
    rows, times = _solve_batch_device(
        artifact, pars, steps, fields_init, derivatives_init, max_err, solver,
        device, engine,
    )
    return _host(rows, times, return_time)


def _survey_reduce(artifact, rows, times, pars):
    """Per-trajectory summary of a batch of solved backgrounds, on their
    device: the e-fold count through inflation (ε_H = 1 crossing,
    interpolated), the crossing's H and field point, and the integrated
    span — ``(N_inflation, ended, H_end, x_end, N_span)``, (B,) outputs
    (x_end (B, n)) from (B, steps) inputs.  Rows on a CUDA device go
    through kernel B9, rows on the CPU through its plain version
    (:mod:`inflatox_torch.ops.cuda_survey`), whichever engine solved them."""
    return survey_reduce_cuda(artifact, rows, times, pars)


def survey_counts() -> dict:
    """:data:`SURVEY_COUNTS` over this process: ``chunks``, the survey's
    chunks solved by kernel B6 on a CUDA device, and ``overlapped``, those
    among them solved in one launch beside an earlier chunk of the same
    call."""
    return dict(SURVEY_COUNTS)


def _overlap_depth(schedulers, chunk, chunks, free_bytes, steps, n_fields) -> int:
    """How many of a survey's chunks one launch of kernel B6 takes.

    Kernel B6 gives each trajectory a thread and each block one warp, a
    latency-bound chain, so a chunk of ``chunk`` trajectories keeps
    ceil(chunk / 32) of the card's warp ``schedulers`` (four an SM) busy.
    The depth fills the schedulers with whole chunks, is at most
    ``chunks``, and keeps that many chunks' B6 output, steps × (2n + 2) ×
    chunk f64 values, within half of ``free_bytes``; it is at least 1."""
    warps = -(-chunk // _B6_BLOCK)
    rows_bytes = steps * (2 * n_fields + 2) * chunk * 8
    return max(1, min(schedulers // warps, chunks, free_bytes // 2 // rows_bytes))


def survey_initial_conditions(
    artifact: CompiledModel,
    pars,
    steps: int,
    fields_init,
    derivatives_init,
    *,
    max_err: float = 1e-6,
    solver: str | None = None,
    chunk: int = 8192,
    mesh=None,
    device="cuda",
    engine: str | None = None,
) -> dict:
    """Map the inflationary outcome over a batch of initial conditions.

    For every row of ``fields_init``/``derivatives_init`` ((B, n); either
    may broadcast from (n,)), integrates the background and reduces the
    trajectory on the device to a per-IC summary: how many e-folds of
    inflation the initial condition produces (ε_H < 1 → ε_H = 1 crossing,
    interpolated), whether inflation ends inside the integrated span, and
    the crossing's H and field point.  ``pars`` is (k,) shared or (B, k)
    per-trajectory.  The batch runs in ``chunk``-sized pieces (on the card
    several of them in one solve, below); only the (B,) summaries cross to
    the host.  With ``mesh=`` each chunk's solve is split over the mesh's
    first axis and its rows are joined on the mesh's first device, where
    the summaries are reduced.

    Returns a dict of (B,) numpy arrays: ``N_inflation`` (NaN where
    inflation never happens or never ends), ``ended`` (bool), ``H_end``,
    ``x_end`` ((B, n)), ``N_span`` (e-folds over the whole trajectory).

    On a CUDA device nothing in the loop waits for the card: each group
    of chunks has its inputs go up through pinned memory, kernel B6 and
    the reduction (kernel B9, one launch) enqueued on the current stream
    behind them, and its summaries, stacked into one (trajectories, n+4)
    tensor, copied into pinned host memory behind those; the host waits
    once, after the last group's copy is enqueued.  With B6 (no ``mesh``) a
    group is k consecutive chunks in one launch, so that a chunk of fewer
    one-warp blocks than the card has warp schedulers does not leave the
    rest idle (:func:`_overlap_depth` derives k from the SM count, the
    chunk, the number of chunks and the free device memory); otherwise a
    group is one chunk.  Spans per group (``utils.profiling``):
    ``inflx.survey.solve`` (the inputs' uploads and B6's enqueue; no
    wait), ``inflx.survey.reduce`` (B9's launch behind it; on the CPU the
    plain reduction) and ``inflx.survey.deliver`` (the stacking and the
    copy's enqueue, and in the last group the one wait).
    :func:`survey_counts` counts the chunks and those solved beside an
    earlier one.

    ``solver``: None (``"rkf"``), ``"rkf"`` or ``"rk4"``; ``device``,
    ``engine`` and ``mesh`` as in :func:`solve_eom_batch`."""
    fields_init = np.atleast_2d(np.asarray(fields_init, dtype=float))
    B = fields_init.shape[0]
    derivatives_init = np.broadcast_to(
        np.asarray(derivatives_init, dtype=float), (B, artifact.n_fields)
    ).copy()
    pars, fields_init, derivatives_init = _check_batch(
        artifact, pars, fields_init, derivatives_init
    )
    solver = "rkf" if solver is None else solver
    _check_solver(solver)
    if mesh is not None:
        check_mesh_device(mesh, device)
        device = mesh.home
    else:
        device = resolve_device(device)
        engine = resolve_engine(engine, device, "kernel B6")

    d = artifact.n_fields
    cuda = device.type == "cuda"
    b6 = cuda and mesh is None and engine == "cuda"
    chunk = int(chunk)
    chunks = -(-B // chunk)
    k = 1
    if b6 and chunks > 1:
        props = torch.cuda.get_device_properties(device)
        k = _overlap_depth(4 * props.multi_processor_count, min(chunk, B), chunks,
                           torch.cuda.mem_get_info(device)[0], int(steps), d)
    # per trajectory: N_inflation, ended (0 or 1), H_end, x_end[d], N_span
    host = torch.empty((B, d + 4), dtype=torch.float64, pin_memory=cuda)
    for g0 in range(0, B, k * chunk):
        sl = slice(g0, min(B, g0 + k * chunk))
        p_c = pars if pars.ndim == 1 else pars[sl]
        with annotate("inflx.survey.solve"):
            p_t = upload(p_c, device)
            if mesh is not None:
                rows, times = sharded_solve_eom_batch(
                    artifact, p_c, steps, fields_init[sl], derivatives_init[sl], mesh,
                    solve_axis=mesh.axis_names[0], max_err=max_err, solver=solver,
                    combine="device", engine=engine,
                )
            else:
                rows, times = _solve_batch_device(
                    artifact, p_t, steps, fields_init[sl], derivatives_init[sl],
                    max_err, solver, device, engine,
                )
        with annotate("inflx.survey.reduce"):
            n_inf, ended, h_end, x_end, n_span = _survey_reduce(artifact, rows, times, p_t)
        with annotate("inflx.survey.deliver"):
            stacked = torch.cat([n_inf[:, None], ended[:, None], h_end[:, None], x_end,
                                 n_span[:, None]], dim=1)
            host[sl].copy_(stacked, non_blocking=True)
            if cuda and sl.stop == B:
                torch.cuda.current_stream(device).synchronize()
        if b6:
            grouped = -(-(sl.stop - g0) // chunk)
            SURVEY_COUNTS["chunks"] += grouped
            SURVEY_COUNTS["overlapped"] += grouped - 1
    res = host.numpy()
    return {
        "N_inflation": res[:, 0].copy(),
        "ended": res[:, 1] != 0.0,
        "H_end": res[:, 2].copy(),
        "x_end": res[:, 3:3 + d].copy(),
        "N_span": res[:, 3 + d].copy(),
    }


def efolds(rows, times, hdot=None):
    """Cumulative e-fold count N(t) = ∫₀ᵗ H dt' along solved trajectories.

    ``rows``/``times`` are the outputs of :func:`solve_eom` ((steps, 2n+1),
    (steps,)) or :func:`solve_eom_batch` ((B, steps, 2n+1), (B, steps)) with
    ``return_time=True``; H is the last state column.  Returns an array
    shaped like ``times`` with N per output row (trapezoid rule over the
    adaptive step sequence; row 0 is 0).

    ``hdot`` (optional, shaped like ``times``) supplies Ḣ at every row; the
    quadrature is then corrected to cubic-Hermite order (trapezoid +
    Δt²/12·(Ḣᵢ − Ḣᵢ₊₁)).  Host numpy, as in the JAX package."""
    rows = np.asarray(rows, dtype=float)
    times = np.asarray(times, dtype=float)
    if rows.shape[:-1] != times.shape:
        raise ShapeError(rows.shape[:-1], times.shape,
                         "times must match the solver rows per trajectory")
    hubble = rows[..., -1]
    dt = np.diff(times, axis=-1)
    seg = 0.5 * (hubble[..., 1:] + hubble[..., :-1]) * dt
    if hdot is not None:
        hdot = np.asarray(hdot, dtype=float)
        if hdot.shape != times.shape:
            raise ShapeError(times.shape, hdot.shape,
                             "hdot must give Ḣ at every output row")
        seg = seg + (dt * dt / 12.0) * (hdot[..., :-1] - hdot[..., 1:])
    out = np.zeros_like(times)
    np.cumsum(seg, axis=-1, out=out[..., 1:])
    return out
