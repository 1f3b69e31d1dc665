"""Kernel B9: the survey's per-trajectory reduction of kernel B6's rows,
hand-written in CUDA C++ (``csrc/survey.cuh``, built into the solver
library with B6).

It replaces no TPU kernel: the JAX package's ``_survey_reduce``
(``inflatox_tpu/background.py``) is jitted jnp, which XLA fuses on the
TPU.  In the port the same reduction is about 40 torch operations over
(B, steps) arrays, each a kernel of its own; B9 reads B6's rows and times
once (bytes bound it: 393 MB, 0.117 ms at 4096 × 2000 rows of two fields on
an H100) and writes only the summaries.

* :func:`survey_reduce_cuda` — the wrapper: on a CUDA device it launches
  the kernel on the current stream (no synchronisation) and counts the
  launch under ``"B9"`` in
  :data:`~inflatox_torch.ops.cuda_kernels.LAUNCHES_BY_KERNEL`; on a CPU
  device it runs :func:`survey_reduce_torch`.
* :func:`survey_reduce_torch` — the plain PyTorch version, on the device
  of its inputs.  The kernel repeats its operations in their order, so the
  two agree to the last bit where the plain version runs on the CPU (torch's
  CPU ``cumsum`` sums in order, its CUDA one is a parallel scan, and torch
  divides by a number on the card through the reciprocal) and the metric
  calls no libm function.
"""

from __future__ import annotations

import torch

from .cuda_kernels import LAUNCHES_BY_KERNEL

__all__ = ["survey_reduce_cuda", "survey_reduce_torch"]


def survey_reduce_torch(artifact, rows, times, pars):
    """Per-trajectory summary of a batch of solved backgrounds, in torch ops
    on their device: the e-fold count through inflation (ε_H = 1 crossing,
    interpolated), the crossing's H and field point, and the integrated
    span — (B,) outputs from (B, steps) inputs.

    ``rows``/``times``: (B, steps, 2n+1) and (B, steps) float64; ``pars``:
    (k,) shared or (B, k) per-trajectory parameters.  Returns
    ``(N_inflation, ended, H_end, x_end, N_span)``: (B,) float64, (B,)
    bool, (B,), (B, n), (B,); NaN where inflation never ends."""
    d = artifact.n_fields
    x = [rows[..., c] for c in range(d)]
    chi = [rows[..., d + c] for c in range(d)]
    hub = rows[..., 2 * d]
    a_in = pars if pars.ndim == 1 else [pars[:, j:j + 1] for j in range(pars.shape[1])]
    chi_sq = artifact.inner_prod(x, a_in, chi, chi)
    hdot = -0.5 * chi_sq
    eps = -hdot / (hub * hub)
    dt = times[:, 1:] - times[:, :-1]
    seg = 0.5 * (hub[:, 1:] + hub[:, :-1]) * dt \
        + (dt * dt / 12.0) * (hdot[:, :-1] - hdot[:, 1:])
    n = torch.cat([torch.zeros_like(times[:, :1]), torch.cumsum(seg, dim=1)], dim=1)
    finite = torch.isfinite(eps) & (hub > 0.0)
    below = finite & (eps < 1.0)
    inflated = below.any(dim=1)
    start = torch.argmax(below.to(torch.uint8), dim=1)  # first inflating row
    idxs = torch.arange(times.shape[1], device=times.device)[None, :]
    crossing = (idxs > start[:, None]) & finite & (eps >= 1.0)
    ended = inflated & crossing.any(dim=1)
    i = torch.clamp_min(torch.argmax(crossing.to(torch.uint8), dim=1), 1)

    def pair(arr):
        lo = torch.gather(arr, 1, (i - 1)[:, None])[:, 0]
        hi = torch.gather(arr, 1, i[:, None])[:, 0]
        return lo, hi

    e0, e1 = pair(eps)
    frac = torch.where(e1 != e0, (1.0 - e0) / (e1 - e0), 0.0)

    def interp(arr):
        a0, a1 = pair(arr)
        return a0 + frac * (a1 - a0)

    n_start = torch.gather(n, 1, start[:, None])[:, 0]
    nan = torch.full_like(n_start, float("nan"))
    n_inf = torch.where(ended, interp(n) - n_start, nan)
    h_end = torch.where(ended, interp(hub), nan)
    x_end = torch.where(ended[:, None], torch.stack([interp(xc) for xc in x], dim=1),
                        float("nan"))
    return n_inf, ended, h_end, x_end, n[:, -1]


def _check(artifact, rows, times, pars):
    n, k = artifact.n_fields, artifact.n_parameters
    tensors = (rows, times, pars)
    if not all(torch.is_tensor(t) and t.dtype == torch.float64 for t in tensors):
        raise TypeError("rows, times and pars must be float64 tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("rows, times and pars must be on one device")
    if rows.ndim != 3 or rows.shape[0] < 1 or rows.shape[2] != 2 * n + 1:
        raise ValueError(f"rows must have shape (B, steps, {2 * n + 1}), got {tuple(rows.shape)}")
    if times.shape != rows.shape[:2]:
        raise ValueError("times must have shape (B, steps) of the rows")
    if rows.shape[1] < 2:
        raise ValueError("the survey's reduction needs at least two rows a trajectory")
    if pars.shape not in ((k,), (rows.shape[0], k)):
        raise ValueError(f"pars must have shape ({k},) or ({rows.shape[0]}, {k}), "
                         f"got {tuple(pars.shape)}")


def _in_b6_layout(rows, times) -> bool:
    """Whether ``rows`` and ``times`` are views of one (steps, 2n+2, B)
    buffer in kernel B6's layout (the trajectory index fastest, the times
    after the rows' last column), as B6 and its plain version return them."""
    B, _, ny = rows.shape
    return (rows.stride() == (1, (ny + 1) * B, B) and times.stride() == (1, (ny + 1) * B)
            and times.data_ptr() == rows.data_ptr() + ny * B * rows.element_size())


def survey_reduce_cuda(artifact, rows, times, pars):
    """Kernel B9's wrapper; arguments and results as
    :func:`survey_reduce_torch`.

    On a CUDA device it takes ``rows`` and ``times`` as views of one
    output of B6 (or of its plain version), which it reads in place, and
    raises for any other layout; it allocates the summaries with
    ``torch.empty`` and launches on the current stream without
    synchronising; a launch error raises.  On a CPU device it returns
    :func:`survey_reduce_torch`'s result and launches nothing."""
    _check(artifact, rows, times, pars)
    device = rows.device
    if device.type == "cpu":
        return survey_reduce_torch(artifact, rows, times, pars)
    if device.type != "cuda":
        raise ValueError(f"survey_reduce_cuda runs on a CUDA or CPU device, got {device}")
    if not _in_b6_layout(rows, times):
        raise ValueError("on a CUDA device rows and times must be views of one "
                         "(steps, 2n+2, B) output of kernel B6, as solve_cuda returns them")
    from .build import load_solver  # noqa: PLC0415

    lib = load_solver(artifact.cuda_solver_source())
    n = artifact.n_fields
    batch, steps, _ = rows.shape
    with torch.cuda.device(device):
        p = pars.contiguous()
        out = torch.empty((batch, n + 3), dtype=torch.float64, device=device)
        ended = torch.empty(batch, dtype=torch.bool, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.inflx_survey_reduce(
            rows.data_ptr(), p.data_ptr() if p.numel() else None,
            p.shape[1] if p.ndim == 2 else 0, batch, steps, out.data_ptr(),
            ended.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.inflx_error_string(err).decode()
        raise RuntimeError(f"survey reduction kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES_BY_KERNEL["B9"] += 1
    return out[:, 0], ended, out[:, 1], out[:, 2:2 + n], out[:, 2 + n]
