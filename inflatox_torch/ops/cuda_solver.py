"""Kernel B6: the batched adaptive background-EoM solver, hand-written in
CUDA C++.

Replaces the TPU kernel ``_solver_kernel``/``_launch_solver``
(``inflatox_tpu/ops/pallas_solver.py:173-435``, entry
``solve_eom_batch_pallas``), and computes what
``inflatox_tpu/background.py``'s while-loop solver computes, in true f64:
RKF45 (``solver="rkf"``) or classical RK4 with step doubling
(``solver="rk4"``) on the state y = [φ, χ, H], one accepted adaptive step
per output row, row 0 the initial state with H from the Friedmann
constraint.  The TPU kernel's double-f32 state, f32 controller, (8, 128)
lane blocks, VMEM carry between row chunks and 8-attempt cap are not carried
over (``csrc/solver.cu`` and ``csrc/solver.cuh`` say why): one CUDA thread
integrates one trajectory.  Its time is the latency of the longest serial
chain of rows × attempts, not bytes or the f64 rate.

Beside the kernel:

* :func:`solve_cuda` — the wrapper: on a CUDA device it launches the kernel
  on the current stream (no synchronisation) and counts the launch under
  ``"B6"`` in :data:`~inflatox_torch.ops.cuda_kernels.LAUNCHES_BY_KERNEL`;
  on a CPU device it runs :func:`solve_torch`.
* :func:`solve_torch` — the plain PyTorch version: the same loop over the
  whole batch in torch ops, with masked attempts until every trajectory has
  accepted its row (an accepted trajectory is frozen, so each follows its
  own while-loop sequence).  It reads ``.any()`` on the host once per
  attempt, which makes it slow on the card; it is the reference.
* :func:`derivative`, :func:`rk_step`, :func:`embedded` — its stages.
* :func:`attempt_counts` — B6's work while a profiler records
  (``utils.profiling.recording``): the attempts of every trajectory solved
  in that time, summed, the rejected ones among them, and the lanes'
  attempts, each warp's most times its lanes that hold a trajectory.  Only
  then does the wrapper launch the kernel's counting instance, and the
  plain version add its attempts and rejects; a run with no profiler
  launches the kernel that counts nothing.

Both write (steps, 2n+2, B) with the trajectory index fastest and return
(B, steps, 2n+1) rows and (B, steps) times as views of it.  Every operation
of the plain version is written in the kernel's order — stage inputs
``y + (dt·a)·k`` over ascending m, ``-eom_a - (3·H)·χ_a``, the error norm
summed left to right, ``err·(1/max_err)`` and ``(1/err)·max_err`` — so on
the card the two agree to the last bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..lowering.special import suppress_domain_warnings
from ..utils.errors import ShapeError
from ..utils.profiling import recording
from .cuda_kernels import LAUNCHES_BY_KERNEL

__all__ = ["METHODS", "attempt_counts", "derivative", "embedded", "rk_step",
           "solve_cuda", "solve_torch"]

# Fehlberg 4(5) and classical RK4 (inflatox_tpu/background.py:66-84)
_RKF_A = np.zeros((6, 6))
_RKF_A[1, 0] = 1 / 4
_RKF_A[2, :2] = (3 / 32, 9 / 32)
_RKF_A[3, :3] = (1932 / 2197, -7200 / 2197, 7296 / 2197)
_RKF_A[4, :4] = (439 / 216, -8.0, 3680 / 513, -845 / 4104)
_RKF_A[5, :5] = (-8 / 27, 2.0, -3544 / 2565, 1859 / 4104, -11 / 40)
_RKF_B5 = np.array([16 / 135, 0.0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55])
_RKF_B4 = np.array([25 / 216, 0.0, 1408 / 2565, 2197 / 4104, -1 / 5, 0.0])

_RK4_A = np.zeros((4, 4))
_RK4_A[1, 0] = 0.5
_RK4_A[2, 1] = 0.5
_RK4_A[3, 2] = 1.0
_RK4_B = np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6])

_DT_INIT = 1e-10  # background_solver.rs:227
_DT_FLOOR = 1e-250  # bail-out: forcibly accept rather than loop forever

#: solver name → (kernel method id in csrc/solver.cuh, stages)
METHODS = {"rkf": (0, 6), "rk4": (1, 4)}

#: device → its (attempts, lane_attempts, rejects) int64 tensor, made on the
#: first solve there under a profiler
_COUNTS: dict = {}

#: on the CPU the plain version pads its batch to whole multiples of this
#: many trajectories (copies of the last): torch's CPU kernels run a
#: tensor's elements past its last whole pair of SIMD vectors through the
#: scalar libm, whose pow (and exp, log, ...) may round a last bit otherwise
#: than the vectorised one, so a trajectory's bits would depend on its place
#: in the batch (and a sharded solve's blocks, ``parallel/solve.py``, would
#: differ from the whole batch).  16 is two AVX-512 vectors of f64.  Tensors
#: past torch's parallel grain (32,768 elements) split over threads at
#: other boundaries.
_CPU_LANES = 16


def derivative(artifact, y, args) -> torch.Tensor:
    """y' for the (2n+1, B) state y = [φ, χ, H]: φ' = χ,
    χ'_a = −eom_a − (3H)·χ_a, H' = eom_hdot."""
    n = artifact.n_fields
    x, chi, hub = list(y[:n]), list(y[n:2 * n]), y[2 * n]

    def full(value):
        # constant outputs of the lowering are Python numbers
        return torch.as_tensor(value, dtype=torch.float64, device=y.device).expand(hub.shape)

    eom = artifact.eom(x, chi, args)
    acc = [full(-eom[a] - (3.0 * hub) * chi[a]) for a in range(n)]
    hdot = full(artifact.eom_hdot(x, chi, args))
    return torch.stack([*chi, *acc, hdot])


def rk_step(artifact, y, dt, args, a, b_hi, b_lo=None):
    """One explicit Runge-Kutta step of the tableau (a, b_hi[, b_lo]) from
    the (2n+1, B) state y with per-trajectory (B,) step dt: returns
    ``(y + Σ (dt·b_hi[n])·k_n, y + Σ (dt·b_lo[n])·k_n or None)``; zero
    coefficients are skipped."""
    ks = []
    for n in range(a.shape[0]):
        yn = y
        for m in range(n):
            if a[n, m] != 0.0:
                yn = yn + (dt * float(a[n, m])) * ks[m]
        ks.append(derivative(artifact, yn, args))

    def combine(b):
        acc = y
        for n, bn in enumerate(b):
            if bn != 0.0:
                acc = acc + (dt * float(bn)) * ks[n]
        return acc

    return combine(b_hi), None if b_lo is None else combine(b_lo)


def embedded(artifact, solver, y, dt, args):
    """The (higher, lower)-order pair of one attempt: RKF45's 5th- and
    4th-order solutions, or RK4's two half steps and one full step."""
    if solver == "rkf":
        return rk_step(artifact, y, dt, args, _RKF_A, _RKF_B5, _RKF_B4)
    big, _ = rk_step(artifact, y, dt, args, _RK4_A, _RK4_B)
    half, _ = rk_step(artifact, y, dt * 0.5, args, _RK4_A, _RK4_B)
    small, _ = rk_step(artifact, half, dt * 0.5, args, _RK4_A, _RK4_B)
    return small, big


def _check_solver(solver):
    if solver == "rkf_pallas":
        raise ValueError(
            'solver="rkf_pallas" is the JAX package\'s TPU kernel; in the '
            'PyTorch port solver="rkf" runs kernel B6 (and "rk4" too) on a '
            "CUDA device"
        )
    if solver not in METHODS:
        raise ValueError(f'unknown solver {solver!r}; expected "rk4" or "rkf"')


def _check_batch(artifact, pars, fields_init, derivatives_init):
    """The JAX package's shape checks of a batched solve (ShapeError)."""
    n = artifact.n_fields
    fields_init = np.asarray(fields_init, dtype=float)
    derivatives_init = np.asarray(derivatives_init, dtype=float)
    pars = np.asarray(pars, dtype=float)
    if fields_init.ndim != 2 or fields_init.shape[1] != n:
        raise ShapeError(
            (-1, n), fields_init.shape,
            "batched initial conditions must be (B, n_fields)",
        )
    if derivatives_init.shape != fields_init.shape:
        raise ShapeError(
            fields_init.shape, derivatives_init.shape,
            "derivatives_init must match fields_init (B, n_fields)",
        )
    if pars.ndim == 2 and pars.shape != (fields_init.shape[0], artifact.n_parameters):
        raise ShapeError(
            (fields_init.shape[0], artifact.n_parameters), pars.shape,
            "per-trajectory parameters must be (B, n_parameters)",
        )
    if pars.ndim == 1 and pars.shape != (artifact.n_parameters,):
        raise ShapeError(
            (artifact.n_parameters,), pars.shape,
            "shared parameters must be (n_parameters,)",
        )
    return pars, fields_init, derivatives_init


def _check(artifact, pars, steps, fields_init, derivatives_init, max_err, solver):
    _check_solver(solver)
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"steps must be at least 1, got {steps}")
    max_err = float(max_err)
    if not (math.isfinite(max_err) and max_err > 0.0):
        raise ValueError(f"max_err must be a positive finite number, got {max_err}")
    tensors = (pars, fields_init, derivatives_init)
    if not all(torch.is_tensor(t) and t.dtype == torch.float64 for t in tensors):
        raise TypeError("pars, fields_init and derivatives_init must be float64 tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("pars, fields_init and derivatives_init must be on one device")
    n, k = artifact.n_fields, artifact.n_parameters
    if fields_init.ndim != 2 or fields_init.shape[1] != n or fields_init.shape[0] < 1:
        raise ValueError(f"fields_init must have shape (B, {n}), got {tuple(fields_init.shape)}")
    if derivatives_init.shape != fields_init.shape:
        raise ValueError("derivatives_init must have the shape of fields_init")
    if pars.shape not in ((k,), (fields_init.shape[0], k)):
        raise ValueError(
            f"pars must have shape ({k},) or ({fields_init.shape[0]}, {k}), "
            f"got {tuple(pars.shape)}"
        )
    return steps, max_err


def _counts(device) -> torch.Tensor:
    counts = _COUNTS.get(device)
    if counts is None:
        counts = _COUNTS[device] = torch.zeros(3, dtype=torch.int64, device=device)
    return counts


def attempt_counts() -> dict:
    """B6's work over the solves made while a profiler recorded, in this
    process: ``attempts`` (every trajectory's attempts, accepted and
    rejected, summed; the kernel's and the plain version's),
    ``lane_attempts`` (the kernel's warps: lanes that hold a trajectory ×
    the most attempts one of them made, summed) and ``rejects`` (the
    attempts that were rejected, summed, as ``attempts``).  One device→host
    read a device that solved."""
    total = [0, 0, 0]
    for counts in _COUNTS.values():
        for k, v in enumerate(counts.tolist()):
            total[k] += v
    return {"attempts": total[0], "lane_attempts": total[1], "rejects": total[2]}


def _views(out, ny):
    """(B, steps, 2n+1) rows and (B, steps) times of a (steps, 2n+2, B)
    output."""
    v = out.permute(2, 0, 1)
    return v[..., :ny], v[..., ny]


def solve_torch(artifact, pars, steps, fields_init, derivatives_init,
                max_err=1e-6, solver="rkf", count_attempts=False):
    """Plain PyTorch version of kernel B6 on the device of its inputs.

    ``fields_init``/``derivatives_init``: (B, n) float64 tensors; ``pars``:
    (k,) shared or (B, k) per-trajectory parameters, on the same device.
    Returns ``(rows, times)`` — (B, steps, 2n+1) and (B, steps) — and, with
    ``count_attempts=True``, also the (B,) number of attempts each
    trajectory made over its steps − 1 rows; while a profiler records, their
    sum goes to :func:`attempt_counts`, and so does the sum of the rejected
    ones.  On the CPU each trajectory's
    arithmetic does not depend on its place in the batch (``_CPU_LANES``)."""
    _check(artifact, pars, steps, fields_init, derivatives_init, max_err, solver)
    traced = recording()
    batch = fields_init.shape[0]
    pad = -batch % _CPU_LANES if fields_init.device.type == "cpu" else 0
    if pad:
        def padded(t):
            return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])

        fields_init, derivatives_init = padded(fields_init), padded(derivatives_init)
        if pars.ndim == 2:
            pars = padded(pars)
    with suppress_domain_warnings():
        out = _solve_torch(artifact, pars, steps, fields_init, derivatives_init, max_err,
                           solver, count_attempts or traced)
    if pad:
        out = tuple(o[:batch] for o in out)
    if traced:
        counts = _counts(fields_init.device)
        counts[0] += out[2].sum()
        counts[2] += out[3].sum()
    return out[:3] if count_attempts else out[:2]


def _solve_torch(artifact, pars, steps, fields_init, derivatives_init, max_err, solver,
                 count_attempts):
    steps, max_err = _check(artifact, pars, steps, fields_init, derivatives_init,
                            max_err, solver)
    device = fields_init.device
    n = artifact.n_fields
    ny = 2 * n + 1
    batch = fields_init.shape[0]
    args = pars if pars.ndim == 1 else pars.T
    exponent = 1.0 / (METHODS[solver][1] + 1)
    inv_max_err = 1.0 / max_err

    x0, chi0 = fields_init.T, derivatives_init.T
    h0 = torch.as_tensor(artifact.eom_h(list(x0), list(chi0), args),
                         dtype=torch.float64, device=device).expand(batch)
    y = torch.cat([x0, chi0, h0[None]])
    dt = torch.full((batch,), _DT_INIT, dtype=torch.float64, device=device)
    t = torch.zeros(batch, dtype=torch.float64, device=device)
    attempts = torch.zeros(batch, dtype=torch.int64, device=device)
    rejects = torch.zeros(batch, dtype=torch.int64, device=device)
    out = torch.empty((steps, ny + 1, batch), dtype=torch.float64, device=device)
    out[0, :ny] = y
    out[0, ny] = t
    for s in range(1, steps):
        active = torch.ones(batch, dtype=torch.bool, device=device)
        while True:
            hi, lo = embedded(artifact, solver, y, dt, args)
            d = hi - lo
            sq = d * d
            e2 = sq[0]
            for c in range(1, ny):  # left to right, as the kernel sums
                e2 = e2 + sq[c]
            err = torch.sqrt(e2)
            q = torch.clamp(
                torch.pow(torch.clamp_min(err, 1e-300).reciprocal() * max_err, exponent),
                0.1, 5.0,
            )
            q = torch.where(err > 0.0, q, 5.0)
            q = torch.where(torch.isfinite(err), q, 0.1)
            accept = ((err * inv_max_err <= 1.1) | (dt <= _DT_FLOOR)
                      | ~torch.isfinite(dt))
            take = active & accept
            y = torch.where(take, hi, y)
            t = torch.where(take, t + dt, t)
            dt = torch.where(active, dt * q, dt)
            attempts += active
            if count_attempts:
                rejects += active & ~accept
            active = active & ~accept
            if not bool(active.any()):
                break
        out[s, :ny] = y
        out[s, ny] = t
    rows, times = _views(out, ny)
    if count_attempts:
        return rows, times, attempts, rejects
    return rows, times


def solve_cuda(artifact, pars, steps, fields_init, derivatives_init,
               max_err=1e-6, solver="rkf"):
    """Kernel B6's wrapper; arguments and results as :func:`solve_torch`.

    On a CUDA device it builds the kernel for the model (first use),
    allocates the (steps, 2n+2, B) output with ``torch.empty`` and launches
    on the current stream without synchronising, the counting instance
    while a profiler records; a launch error raises.  On a CPU device it
    returns :func:`solve_torch`'s result and launches nothing."""
    steps, max_err = _check(artifact, pars, steps, fields_init, derivatives_init,
                            max_err, solver)
    device = fields_init.device
    if device.type == "cpu":
        return solve_torch(artifact, pars, steps, fields_init, derivatives_init,
                           max_err, solver)
    if device.type != "cuda":
        raise ValueError(f"solve_cuda runs on a CUDA or CPU device, got {device}")
    from .build import load_solver  # noqa: PLC0415

    lib = load_solver(artifact.cuda_solver_source())
    ny = 2 * artifact.n_fields + 1
    batch = fields_init.shape[0]
    with torch.cuda.device(device):
        f0 = fields_init.contiguous()
        d0 = derivatives_init.contiguous()
        p = pars.contiguous()
        out = torch.empty((steps, ny + 1, batch), dtype=torch.float64, device=device)
        counts = _counts(device).data_ptr() if recording() else None
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.inflx_solve(
            METHODS[solver][0], f0.data_ptr(), d0.data_ptr(),
            p.data_ptr() if p.numel() else None, p.shape[1] if p.ndim == 2 else 0,
            out.data_ptr(), batch, steps, max_err, 1.0 / max_err, stream, counts,
        )
    if err != 0:
        msg = lib.inflx_error_string(err).decode()
        raise RuntimeError(f"solver kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES_BY_KERNEL["B6"] += 1
    return _views(out, ny)
