"""Differentiable slow-roll observables and gradient-based parameter fitting.

The port of ``inflatox_tpu/observables.py``.  Every model callable of a
:class:`~inflatox_torch.compiler.CompiledModel` is a torch function, so the
whole pipeline — potential → projected Hesse → slow-roll parameters → CMB
observables → background trajectories — is differentiable under autograd,
and parameter inference is gradient descent on the device instead of a
sweep.

Three pieces:

* **Observable factories** (:func:`epsilon_v`, :func:`eta_v`,
  :func:`spectral_index`, :func:`tensor_to_scalar`, :func:`slow_roll`):
  differentiable point functions ``fn(x, args)``.  Conventions are the
  textbook ones (ε_V includes the ½ like the reference's
  ``epsilon_v_only``; η_V is the gradient-aligned projected Hesse component
  V_σσ/V, ``v00/V`` in the reference's naming) with the leading-order
  slow-roll predictions n_s = 1 − 6ε_V + 2η_V and r = 16 ε_V.
* **A fixed-step, differentiable background integrator**
  (:func:`solve_eom_fixed`): classical RK4 on a user-supplied time grid in
  torch operations.  The adaptive solver (kernel B6,
  :mod:`inflatox_torch.background`) rejects and retries steps and has no
  backward pass; this fixed-grid variant trades adaptive step control for
  end-to-end gradients with respect to parameters and initial conditions.
* **A generic fitting loop** (:func:`fit_parameters`): ``torch.optim``
  gradient descent, one start or many.

Devices are explicit, as everywhere in the port.  Every entry takes
``device="cuda"`` (on a host without CUDA that raises; pass
``device="cpu"``).  Array-likes (numpy, lists) are placed on that device;
tensors that come in keep theirs, and inputs on two devices raise.  The
trajectory-level functions evaluate the model (ε_H's inner product, the
slow-roll maps) on the device and keep the crossing search, interpolation
and horizon-matching fixed point in host numpy, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .background import efolds
from .compiler import CompiledModel, _grid_refs, _stack_f64
from .ops.cuda_solver import _RK4_A, _RK4_B, rk_step
from .utils.devices import resolve_device
from .utils.errors import ShapeError
from .utils.logging import log_warn

__all__ = [
    "epsilon_v",
    "eta_v",
    "spectral_index",
    "tensor_to_scalar",
    "slow_roll",
    "along_trajectory",
    "horizon_exit",
    "power_spectrum",
    "cobe_normalize",
    "n_star_matching",
    "pivots_for_k",
    "observable_jacobian",
    "fisher_matrix",
    "solve_eom_fixed",
    "FitResult",
    "fit_parameters",
]


# ----------------------------------------------------------------------- #
# devices                                                                  #
# ----------------------------------------------------------------------- #


def _common_device(values, device: torch.device) -> torch.device:
    """The one device of the tensors among ``values`` (``device`` if there
    are none); tensors on two devices raise."""
    devices = {v.device for v in values if torch.is_tensor(v)}
    if len(devices) > 1:
        raise ValueError(
            f"inputs lie on several devices ({sorted(map(str, devices))}); "
            "move them to one device first"
        )
    return devices.pop() if devices else device


def _f64(value, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(value):
        return value if value.dtype == torch.float64 else value.to(torch.float64)
    return torch.tensor(np.asarray(value, dtype=np.float64), device=device)


def _place(x, args, device: torch.device):
    """``x`` (a (d,) point, or a sequence of broadcastable grids) and
    ``args`` as float64 tensors on one device: the tensors' own, or
    ``device`` when neither holds a tensor."""
    parts = list(x) if isinstance(x, (list, tuple)) else [x]
    device = _common_device([*parts, args], device)
    if isinstance(x, (list, tuple)):
        x = [_f64(p, device) for p in parts]
    else:
        x = _f64(x, device)
    return x, _f64(args, device)


def _full(value, x) -> torch.Tensor:
    """A lowered output (a tensor, or a Python number for a constant) as a
    float64 tensor of the grid's shape on the grid's device."""
    return _stack_f64([value], *_grid_refs(x))[0]


def _host(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value, dtype=float)


# ----------------------------------------------------------------------- #
# observable factories                                                     #
# ----------------------------------------------------------------------- #


def epsilon_v(artifact: CompiledModel, device="cuda") -> Callable:
    """First potential slow-roll parameter ε_V = |∇V|² / (2 V²).

    Returns ``fn(x, args)`` (x: (d,) field point or broadcastable grids;
    args: (k,) parameters) giving a float64 tensor on the inputs' device.
    Textbook ½ included — matching the reference's standalone
    ``epsilon_v_only``, not the ½-less value inside ``complete_analysis``.
    """
    device = resolve_device(device)

    def fn(x, args):
        x, args = _place(x, args, device)
        v = artifact.potential(x, args)
        return _full(0.5 * artifact.grad_square(x, args) / (v * v), x)

    return fn


def eta_v(artifact: CompiledModel, device="cuda") -> Callable:
    """Second slow-roll parameter η_V = V_σσ / V.

    V_σσ is the covariant Hesse projected twice onto the normalized
    gradient direction — the reference's ``v00`` component — so this is
    exact for curved field spaces, not just flat ones.
    """
    device = resolve_device(device)

    def fn(x, args):
        x, args = _place(x, args, device)
        return _full(artifact.hesse_tuple(x, args)[0] / artifact.potential(x, args), x)

    return fn


def spectral_index(artifact: CompiledModel, device="cuda") -> Callable:
    """Leading-order scalar spectral index n_s = 1 − 6 ε_V + 2 η_V."""
    eps = epsilon_v(artifact, device)
    eta = eta_v(artifact, device)

    def fn(x, args):
        return 1.0 - 6.0 * eps(x, args) + 2.0 * eta(x, args)

    return fn


def tensor_to_scalar(artifact: CompiledModel, device="cuda") -> Callable:
    """Leading-order tensor-to-scalar ratio r = 16 ε_V."""
    eps = epsilon_v(artifact, device)

    def fn(x, args):
        return 16.0 * eps(x, args)

    return fn


def slow_roll(artifact: CompiledModel, device="cuda") -> Callable:
    """All four observables in one evaluation (shared V/∇V/Hesse work).

    Returns ``fn(x, args) -> dict`` with keys ``epsilon_v``, ``eta_v``,
    ``n_s``, ``r``.  The dict values are float64 tensors (0-d at a point,
    or the broadcast shape of the grids in ``x``); differentiate a selected
    entry under autograd, e.g.
    ``torch.autograd.grad(fn(x, a)["n_s"], a)`` for ``a`` requiring grad.
    """
    device = resolve_device(device)

    def fn(x, args):
        x, args = _place(x, args, device)
        v = artifact.potential(x, args)
        eps = 0.5 * artifact.grad_square(x, args) / (v * v)
        eta = artifact.hesse_tuple(x, args)[0] / v
        return {
            "epsilon_v": _full(eps, x),
            "eta_v": _full(eta, x),
            "n_s": _full(1.0 - 6.0 * eps + 2.0 * eta, x),
            "r": _full(16.0 * eps, x),
        }

    return fn


# ----------------------------------------------------------------------- #
# forecasting: observable Jacobians and Fisher information                 #
# ----------------------------------------------------------------------- #

_OBSERVABLE_KEYS = ("epsilon_v", "eta_v", "n_s", "r")


def observable_jacobian(artifact: CompiledModel, keys=("n_s", "r"),
                        device="cuda") -> Callable:
    """Jacobian ∂(observables)/∂(parameters) at a field point.

    Returns ``jac(x, args) -> (len(keys), n_parameters)`` (a float64 tensor
    on the inputs' device) computed in forward mode, one dual-number pass
    (``torch.autograd.forward_ad``) per parameter: the parameter count is
    small, and unlike ``torch.func.jacfwd`` the passes do not run under
    ``vmap``, so the special functions' loops on data
    (:mod:`inflatox_torch.lowering.special`) differentiate as well.
    ``keys`` selects rows from the :func:`slow_roll` dict.
    """
    unknown = [k for k in keys if k not in _OBSERVABLE_KEYS]
    if unknown:
        raise ValueError(f"unknown observable keys {unknown}; pick from "
                         f"{_OBSERVABLE_KEYS}")
    device = resolve_device(device)
    sr = slow_roll(artifact, device)

    def jac(x, args):
        x, args = _place(x, args, device)
        args = args.detach()
        cols = []
        with fwAD.dual_level():
            for j in range(args.shape[0]):
                tangent = torch.zeros_like(args)
                tangent[j] = 1.0
                got = sr(x, fwAD.make_dual(args, tangent))
                col = []
                for k in keys:
                    primal, dual = fwAD.unpack_dual(got[k])
                    col.append(torch.zeros_like(primal) if dual is None else dual)
                cols.append(torch.stack(col))
        return torch.stack(cols, dim=-1)

    return jac


def fisher_matrix(
    artifact: CompiledModel, x, args, sigma, keys=("n_s", "r"), device="cuda"
) -> np.ndarray:
    """Fisher information F = Jᵀ Σ⁻¹ J of the selected observables (numpy).

    ``sigma`` is either a (len(keys),) vector of 1-σ measurement
    uncertainties (diagonal covariance) or a full (len(keys), len(keys))
    covariance matrix Σ.  The inverse of the returned matrix is the
    Cramér–Rao bound on the parameter covariance — the standard forecast
    of how well a measurement of (n_s, r, …) at the field point ``x``
    constrains the model's parameters.  Unconstrained directions (e.g. the
    overall potential normalization, to which all slow-roll observables
    are blind) show up as zero eigenvalues.
    """
    jac = observable_jacobian(artifact, keys, device)(x, args)
    sig = np.asarray(sigma, dtype=float)
    if sig.shape == (len(keys),):
        weight = np.diag(1.0 / sig**2)
    elif sig.shape == (len(keys), len(keys)):
        weight = np.linalg.inv(sig)
    else:
        raise ShapeError(
            (len(keys),), sig.shape,
            "sigma must be per-observable 1-σ values or a covariance matrix",
        )
    jac = _host(jac)
    return jac.T @ weight @ jac


# ----------------------------------------------------------------------- #
# trajectory-level observables                                              #
# ----------------------------------------------------------------------- #


def along_trajectory(artifact: CompiledModel, rows, args, device="cuda") -> dict:
    """Slow-roll observables at every row of a solved background trajectory.

    ``rows`` is the (steps, 2n+1) output of
    :func:`~inflatox_torch.background.solve_eom` / :func:`solve_eom_fixed`
    (fields, derivatives, H per row).  Returns a dict of (steps,) numpy
    arrays: the four :func:`slow_roll` quantities evaluated at each row's
    field point, plus ``epsilon_h`` — the *exact* Hubble slow-roll
    parameter ε_H = −Ḣ/H² = ½ G_ab χ^a χ^b / H² computed from the solved
    state itself (no slow-roll approximation), which is the quantity that
    defines the end of inflation (ε_H = 1 ⇔ ä = 0).  The model is
    evaluated on the device.
    """
    device = resolve_device(device)
    rows, args = _place(rows, args, device)
    x, chi, hubble = _split_rows(artifact, rows)
    out = {k: _host(v) for k, v in slow_roll(artifact, device)(x, args).items()}
    chi_sq = artifact.inner_prod(x, args, chi, chi)
    out["epsilon_h"] = _host(_full(0.5 * chi_sq / (hubble * hubble), x))
    return out


def _eps1_crossing(eps_h):
    """End-of-inflation ε_H = 1 up-crossing of a solved trajectory: the
    index ``i`` of the first row past the crossing and the linear
    interpolation fraction within [i−1, i].  Shared by
    :func:`horizon_exit` and the perturbation-spectra surface detection.

    A velocity-overshoot start (large user-supplied initial χ that the
    Hubble friction damps onto the attractor within a few rows) may begin
    with ε_H ≥ 1 — the search runs from the first *inflating* row, not
    row 0, so only trajectories that never inflate are rejected."""
    eps_h = np.asarray(eps_h)
    below = np.nonzero(eps_h < 1.0)[0]
    if below.size == 0:
        raise ValueError("trajectory never inflates (ε_H ≥ 1 at every row)")
    start = int(below[0])
    above = np.nonzero(eps_h[start:] >= 1.0)[0]
    if above.size == 0:
        raise ValueError(
            "inflation does not end within the integrated span (max ε_H = "
            f"{np.nanmax(eps_h[start:]):.3g} < 1) — integrate further"
        )
    i = start + int(above[0])
    frac = (1.0 - eps_h[i - 1]) / (eps_h[i] - eps_h[i - 1])
    return i, frac


def _split_rows(artifact: CompiledModel, rows: torch.Tensor):
    """Solver rows → (fields, derivatives, H) column lists (shape-checked)."""
    d = artifact.n_fields
    if rows.ndim != 2 or rows.shape[1] != 2 * d + 1:
        raise ShapeError(
            (-1, 2 * d + 1), tuple(rows.shape),
            "rows must be a single solved trajectory (steps, 2n+1)",
        )
    x = [rows[:, a] for a in range(d)]
    chi = [rows[:, d + a] for a in range(d)]
    return x, chi, rows[:, 2 * d]


def _trajectory_eps_h(artifact: CompiledModel, rows, times, args, device="cuda"):
    """Coerce/validate one solved trajectory and compute its Hubble column,
    exact ε_H = ½|χ|²_G/H², and Hermite-corrected e-fold axis — the shared
    preamble of every along-the-trajectory analysis (:func:`horizon_exit`,
    :func:`power_spectrum`, the perturbation-spectra surfaces).  The inner
    product runs on the device; the rest, and what it returns, is numpy."""
    device = resolve_device(device)
    rows_t, args_t = _place(rows, args, device)
    rows = _host(rows_t)
    times = _host(times)
    if rows.ndim != 2 or times.shape != (rows.shape[0],):
        raise ShapeError(
            (rows.shape[0],), times.shape,
            "pass one trajectory's rows with its times (return_time=True)",
        )
    # ε_H directly (inner_prod + H only) — along_trajectory would also
    # evaluate the full projected Hesse at every row just to discard it
    x, chi, _ = _split_rows(artifact, rows_t)
    chi_sq = _host(_full(artifact.inner_prod(x, args_t, chi, chi), x))
    hubble = rows[:, 2 * artifact.n_fields]
    eps_h = 0.5 * chi_sq / (hubble * hubble)
    n_efold = efolds(rows, times, hdot=-0.5 * chi_sq)
    return rows, times, hubble, eps_h, n_efold


def horizon_exit(
    artifact: CompiledModel,
    rows,
    times,
    args,
    N_before_end: float = 55.0,
    device="cuda",
) -> dict:
    """Locate the horizon-exit point N_before_end e-folds before the end of
    inflation along a solved trajectory, and evaluate the observables there.

    The end of inflation is the first crossing ε_H = 1 (exact Hubble
    parameter from the solved state, see :func:`along_trajectory`); e-fold
    counts come from :func:`~inflatox_torch.background.efolds`.  Both the
    crossing and the exit point are linearly interpolated between output
    rows.  Returns a dict with the exit field point ``x`` ((n,) numpy
    array), ``N_exit``/``N_end``/``N_total``, and the :func:`slow_roll`
    observables at ``x`` as floats.

    Raises ``ValueError`` when the trajectory never reaches ε_H ≥ 1 (end of
    inflation not in the integrated span) or is shorter than
    ``N_before_end`` e-folds — integrate longer in either case.

    This is the standard CMB-prediction workflow: solve the background,
    count ~50–60 e-folds back from the end, read off n_s and r.
    """
    d = artifact.n_fields
    rows, times, _, eps_h, efold = _trajectory_eps_h(artifact, rows, times, args,
                                                     device)

    i, frac = _eps1_crossing(eps_h)
    n_end = efold[i - 1] + frac * (efold[i] - efold[i - 1])
    n_exit = n_end - float(N_before_end)
    if n_exit < efold[0]:
        raise ValueError(
            f"trajectory spans only {n_end - efold[0]:.1f} e-folds before the "
            f"end of inflation; cannot rewind {N_before_end} — start deeper in "
            "the inflating region"
        )
    x_exit = np.array(
        [np.interp(n_exit, efold[: i + 1], rows[: i + 1, a]) for a in range(d)]
    )
    result = {
        "x": x_exit,
        "N_exit": float(n_exit),
        "N_end": float(n_end),
        "N_total": float(efold[-1]),
    }
    sr = slow_roll(artifact, device)(x_exit, _host(args))
    result.update({k: float(v) for k, v in sr.items()})
    return result


def power_spectrum(artifact: CompiledModel, rows, times, args, device="cuda") -> dict:
    """First-order slow-roll power spectra along a solved trajectory.

    Evaluates, at every output row of a solved background trajectory
    (``rows``/``times`` from :func:`~inflatox_torch.background.solve_eom`
    with ``return_time=True``), the standard horizon-crossing estimates

    * scalar:  P_ζ(k) = H² / (8π² ε_H)  at k = aH,
    * tensor:  P_T(k) = 2 H² / π²       at k = aH,

    using the **exact** Hubble slow-roll parameter ε_H = −Ḣ/H² from the
    solved state (see :func:`along_trajectory`) rather than the potential
    approximation ε_V.  With a = e^N the crossing wavenumbers are
    ``ln k = N + ln H`` (N from :func:`~inflatox_torch.background.efolds`,
    an arbitrary normalization — only Δ ln k is meaningful), giving the
    whole spectrum from one background solve: each row is the pivot for
    its own k.  Spectral shape comes from numerical differentiation along
    the trajectory: n_s(k) − 1 = d ln P_ζ / d ln k (centered differences),
    its running α_s = d n_s / d ln k, and r(k) = P_T/P_ζ = 16 ε_H.

    Returns a dict of equal-length numpy arrays — ``ln_k``, ``N``,
    ``P_zeta``, ``P_tensor``, ``n_s``, ``alpha_s``, ``r``, ``epsilon_h``
    — restricted to the inflating rows (0 < ε_H < 1, where the
    horizon-crossing formula applies and ln k is strictly increasing:
    d ln k/dN = 1 − ε_H > 0).  ``n_s``/``alpha_s`` carry NaN at the first/
    last retained rows (no centered difference there).

    Units are reduced-Planck (M_Pl = 1), matching the solver; one-field
    limit: P_ζ = H²/(8π²ε) is the textbook result COBE-normalized against
    A_s ≈ 2.1e-9.  This is the leading slow-roll estimate evaluated at
    crossing — accurate to O(ε, η) like ``n_s = 1 − 6ε + 2η`` itself; it
    does not solve mode equations.
    """
    rows, times, hubble, eps_h, n_efold = _trajectory_eps_h(
        artifact, rows, times, args, device
    )

    keep = (eps_h > 0.0) & (eps_h < 1.0) & (hubble > 0.0)
    if not keep.any():
        raise ValueError(
            "no inflating rows (0 < ε_H < 1 with H > 0) in the trajectory"
        )
    # use the contiguous inflating stretch from the first kept row, so the
    # ln k axis is strictly monotone (d ln k/dN = 1 − ε_H > 0 within it)
    first = int(np.argmax(keep))
    stop = int(np.argmax(~keep[first:])) + first if (~keep[first:]).any() \
        else rows.shape[0]
    sl = slice(first, stop)
    eps, hub, nn = eps_h[sl], hubble[sl], n_efold[sl]

    ln_k = nn + np.log(hub)
    p_zeta = hub * hub / (8.0 * np.pi**2 * eps)
    p_tens = 2.0 * hub * hub / np.pi**2
    ln_p = np.log(p_zeta)
    n_s = np.full_like(ln_p, np.nan)
    alpha = np.full_like(ln_p, np.nan)
    if ln_p.size >= 3:
        n_s[1:-1] = 1.0 + (ln_p[2:] - ln_p[:-2]) / (ln_k[2:] - ln_k[:-2])
    if ln_p.size >= 5:
        alpha[2:-2] = (n_s[3:-1] - n_s[1:-3]) / (ln_k[3:-1] - ln_k[1:-3])
    return {
        "ln_k": ln_k,
        "N": nn,
        "P_zeta": p_zeta,
        "P_tensor": p_tens,
        "n_s": n_s,
        "alpha_s": alpha,
        "r": 16.0 * eps,
        "epsilon_h": eps,
    }


def cobe_normalize(
    artifact: CompiledModel,
    rows,
    times,
    args,
    *,
    A_s: float = 2.1e-9,
    N_before_end: float = 55.0,
    device="cuda",
) -> dict:
    """Overall potential rescaling that COBE-normalizes a solved model.

    Along a solved trajectory, reads P_ζ at the pivot ``N_before_end``
    e-folds before the end of inflation and returns the factor ``scale``
    by which an overall potential normalization (a parameter the potential
    is linear in, e.g. the α-attractor's M⁴ or a quadratic model's m²)
    must be multiplied so that P_ζ(k_*) = ``A_s`` (Planck:
    ln(10¹⁰ A_s) ≈ 3.044 → A_s ≈ 2.1·10⁻⁹).

    Valid because scaling V → λV scales H² → λH² at fixed field-space
    path (the e-fold-time trajectory shape is λ-invariant — both sides of
    the EoM in e-fold time scale together) and P_ζ = H²/(8π²ε_H) is
    linear in it.  Returns ``{"scale", "P_zeta", "N_exit", "N_end"}``;
    multiply the scale parameter by ``scale`` and re-solve to confirm.
    """
    spec = power_spectrum(artifact, rows, times, args, device)
    info = horizon_exit(artifact, rows, times, args,
                        N_before_end=N_before_end, device=device)
    n_exit = info["N_exit"]
    if not (spec["N"][0] <= n_exit <= spec["N"][-1]):
        raise ValueError(
            f"pivot N = {n_exit:.1f} lies outside the inflating stretch "
            f"[{spec['N'][0]:.1f}, {spec['N'][-1]:.1f}] of the spectrum"
        )
    p_now = float(np.interp(n_exit, spec["N"], spec["P_zeta"]))
    return {
        "scale": float(A_s) / p_now,
        "P_zeta": p_now,
        "N_exit": float(n_exit),
        "N_end": info["N_end"],
    }


# physical constants for the horizon-matching equation, in reduced Planck
# units (M_Pl = 2.435e18 GeV)
_MPL_GEV = 2.435e18
_GEV_PER_INV_MPC = 1.9733e-14 / 3.0857e24   # ħc [GeV·cm] / Mpc [cm]
_T0_GEV = 2.349e-13                          # T_CMB = 2.7255 K
_GS0 = 3.91                                  # entropy d.o.f. today (γ + ν)


def n_star_matching(
    artifact: CompiledModel,
    args,
    rows,
    times,
    *,
    k_mpc: float = 0.05,
    w_reh: float = 0.0,
    T_reh_gev: float | None = None,
    g_reh: float = 106.75,
    g_s_reh: float | None = None,
    A_s: float | None = None,
    scale: float | None = None,
    device="cuda",
) -> dict:
    """Self-consistent N_* for a physical pivot scale (horizon matching).

    Solves the standard matching equation (Liddle & Leach 2003 form) for
    the number of e-folds before the end of inflation at which the comoving
    scale ``k_mpc`` [Mpc⁻¹] left the horizon — tracing k = a_*H_* through
    the post-inflation expansion history (reheating with equation of state
    ``w_reh`` down to ``T_reh_gev``, then radiation/matter with entropy
    conservation to today):

        N_* = ln(H_*/k) + ln(T₀/T_reh) + (1/3) ln(g_{s,0}/g_{s,reh})
              − [3(1+w_reh)]⁻¹ ln(ρ_end/ρ_reh),

    everything in reduced Planck units (M_Pl = 2.435·10¹⁸ GeV,
    T₀ = 2.7255 K, g_{s,0} = 3.91), with ρ_end = 3H²_end read off the
    trajectory's ε_H = 1 crossing and ρ_reh = (π²/30) g_reh T_reh⁴.
    ``T_reh_gev=None`` means instant reheating (ρ_reh = ρ_end, the w_reh
    value is then irrelevant).  Because H_* itself sits N_* before the
    end, the equation is a fixed point — iterated on the trajectory's
    H(N) table (contraction rate d ln H/dN = −ε_H, converges in a few
    steps).

    The model must carry physical units for the answer to mean anything:
    COBE-normalize first (:func:`cobe_normalize`) so H_* is the real
    inflationary scale — or pass ``A_s`` to apply the normalization
    internally (the matching is evaluated with H² rescaled by the
    :func:`cobe_normalize` factor at the self-consistent pivot, iterated
    alongside N_*; the returned ``scale`` then belongs to an overall
    potential-normalization parameter exactly as in
    :func:`cobe_normalize`).  To place *several* pivots on the same
    physical model, the normalization must be solved **once** — pass the
    ``scale`` returned by the first (reference-k) call as the ``scale=``
    kwarg of the remaining calls instead of ``A_s`` (a per-k A_s refit
    makes the pivot placements mutually inconsistent at the ~ε level;
    :func:`pivots_for_k` does this automatically).  ``A_s`` and ``scale``
    are mutually exclusive.

    For ``w_reh = 1/3`` the result is exactly independent of
    ``T_reh_gev`` (a radiation-like reheating epoch is indistinguishable
    from the radiation era), and for ``w_reh < 1/3`` lower reheating
    temperatures shift N_* down.  A COBE-normalized m²φ² model gives the
    textbook N_*(0.05/Mpc) ≈ 57.5 under instant reheating.

    Returns ``{"N_star", "ln_k", "H_star", "N_end", "T_reh_gev",
    "rho_end", "rho_reh", "residual"[, "scale"]}`` — ``ln_k`` in the
    trajectory frame (N from the supplied trajectory's start + ln H),
    ready for :func:`horizon_exit`'s ``N_before_end``.
    """
    rows, times, hubble, eps_h, n_efold = _trajectory_eps_h(
        artifact, rows, times, args, device
    )
    i, frac = _eps1_crossing(eps_h)
    n_end = n_efold[i - 1] + frac * (n_efold[i] - n_efold[i - 1])
    h_end = hubble[i - 1] + frac * (hubble[i] - hubble[i - 1])

    if A_s is not None and scale is not None:
        raise ValueError(
            "A_s and scale are mutually exclusive — A_s solves the "
            "normalization, scale applies a previously solved one"
        )
    fixed_scale = scale
    scale = 1.0 if fixed_scale is None else float(fixed_scale)
    if A_s is not None:
        # overall V rescaling: H² scales, the e-fold trajectory shape does
        # not (see cobe_normalize) — normalize at the self-consistent pivot
        p_unscaled = hubble[: i + 1] ** 2 / (
            8.0 * np.pi**2 * np.maximum(eps_h[: i + 1], 1e-300)
        )

    w = float(w_reh)
    if not -1.0 < w <= 1.0:
        raise ValueError(f"w_reh must be in (−1, 1], got {w}")
    rho_end = 3.0 * h_end * h_end    # unscaled; A_s scaling applied in-loop
    k_pl = float(k_mpc) * _GEV_PER_INV_MPC / _MPL_GEV
    t0 = _T0_GEV / _MPL_GEV
    g_s_reh = float(g_reh if g_s_reh is None else g_s_reh)

    # fixed point: N ↦ matching(H_*(N)) on the trajectory's H(N) table
    span = slice(0, i + 1)
    n_star = 55.0
    for _ in range(64):
        rho_end_s = rho_end * scale
        if T_reh_gev is None:
            rho_reh = rho_end_s
            t_reh = (30.0 * rho_reh / (np.pi**2 * float(g_reh))) ** 0.25
        else:
            t_reh = float(T_reh_gev) / _MPL_GEV
            rho_reh = (np.pi**2 / 30.0) * float(g_reh) * t_reh**4
            if rho_reh > rho_end_s:
                raise ValueError(
                    f"T_reh_gev = {T_reh_gev:.4g} GeV implies ρ_reh = "
                    f"{rho_reh:.4g} M_Pl⁴ above the end-of-inflation "
                    f"energy density {rho_end_s:.4g} — reheating cannot "
                    "outheat the inflaton; lower T_reh_gev"
                )
        n_pivot = n_end - n_star
        if n_pivot < n_efold[0]:
            raise ValueError(
                f"the matching equation wants N_* ≈ {n_star:.1f}, but the "
                f"trajectory spans only {n_end - n_efold[0]:.1f} e-folds "
                "before the end of inflation — start deeper in the "
                "inflating region"
            )
        h_star = np.interp(n_pivot, n_efold[span], hubble[span])
        if A_s is not None:
            p_now = float(np.interp(n_pivot, n_efold[span], p_unscaled))
            scale = float(A_s) / p_now
        n_new = (
            np.log(h_star * np.sqrt(scale) / k_pl)
            + np.log(t0 / t_reh)
            + np.log(_GS0 / g_s_reh) / 3.0
            - np.log(rho_end_s / rho_reh) / (3.0 * (1.0 + w))
        )
        delta = abs(float(n_new) - n_star)
        n_star = float(n_new)
        if delta < 1e-12:
            break
    else:
        if delta > 1e-6:
            log_warn(
                f"n_star_matching fixed point did not converge in 64 "
                f"iterations (last update {delta:.3g} e-folds; w_reh={w}) "
                "— the returned N_star is unreliable; inspect 'residual'"
            )
    out = {
        "N_star": n_star,
        "ln_k": (n_end - n_star) + np.log(h_star * np.sqrt(scale)),
        "H_star": float(h_star * np.sqrt(scale)),
        "N_end": float(n_end),
        "T_reh_gev": float(t_reh * _MPL_GEV),
        "rho_end": float(rho_end * scale),
        "rho_reh": float(rho_reh),
        "residual": delta,
    }
    if A_s is not None or fixed_scale is not None:
        out["scale"] = scale
    return out


def pivots_for_k(
    artifact: CompiledModel,
    args,
    rows,
    times,
    k_mpc,
    **matching_kwargs,
) -> np.ndarray:
    """N-before-end pivot placements for physical scales [Mpc⁻¹].

    Solves the :func:`n_star_matching` fixed point for every entry of
    ``k_mpc`` (all other matching parameters — ``w_reh``, ``T_reh_gev``,
    ``g_reh``, ``A_s``, ``device`` — pass through) and returns the array of
    e-fold distances before the end of inflation, ready for the spectrum
    routes' ``pivot_N_before_end=``.

    The model must carry physical units (COBE-normalize, or pass ``A_s=``)
    for the placements to be meaningful.  When ``A_s`` is given, the
    normalization is solved **once** — at the first entry of ``k_mpc``
    (put the A_s-defining pivot, conventionally 0.05/Mpc, first) — and the
    resulting ``scale`` is held fixed for the remaining entries.  A per-k
    refit would re-normalize the same physical model differently at every
    scale (~8 %/decade), displacing each pivot by ≈ ¼ Δln(scale) e-folds
    and breaking d ln k/dN = 1 − ε consistency with the spectrum routes.
    """
    ks = np.atleast_1d(np.asarray(k_mpc, dtype=float))
    if ks.size == 0:
        return np.empty((0,))
    first = n_star_matching(
        artifact, args, rows, times, k_mpc=float(ks[0]), **matching_kwargs
    )
    rest_kwargs = dict(matching_kwargs)
    if rest_kwargs.get("A_s") is not None:
        # one model, one normalization: freeze the scale solved at ks[0]
        rest_kwargs.pop("A_s")
        rest_kwargs["scale"] = first["scale"]
    return np.array([first["N_star"]] + [
        n_star_matching(artifact, args, rows, times, k_mpc=float(k),
                        **rest_kwargs)["N_star"]
        for k in ks[1:]
    ])


# ----------------------------------------------------------------------- #
# fixed-step differentiable background integration                         #
# ----------------------------------------------------------------------- #


def solve_eom_fixed(
    artifact: CompiledModel,
    pars,
    times,
    fields_init,
    derivatives_init,
    device="cuda",
) -> torch.Tensor:
    """Integrate the background EoM on a fixed time grid (differentiable).

    Same ODE system as :func:`inflatox_torch.background.solve_eom`
    (φ'=χ, χ'^a = −eom_a − 3Hχ^a, H'=eomhdot; H(0) from the Friedmann
    constraint) but advanced with classical RK4 over the user-supplied
    ``times`` grid (shape (steps,), strictly increasing; row i of the
    output is the state at ``times[i]``, row 0 the initial state).  Each
    step is :func:`inflatox_torch.ops.cuda_solver.rk_step`, the stages
    kernel B6's plain version takes, in torch operations.

    Every step is a fixed sequence of torch operations (no accept/reject),
    so the map (pars, fields_init, derivatives_init) → rows is
    **differentiable under autograd**: call ``backward`` on any scalar of
    the output (or ``torch.autograd.grad``) to fit parameters or initial
    conditions to trajectory-level targets (see :func:`fit_parameters`).
    Accuracy is the user's responsibility via the grid spacing (global
    error ~O(Δt⁴)); for adaptive integration without gradients use
    :func:`~inflatox_torch.background.solve_eom`, which runs kernel B6.

    Returns a (steps, 2n+1) float64 tensor on the device (fields,
    derivatives, H per row).  Tensor arguments keep their device (and
    their autograd graph); array-likes go to ``device``.
    """
    n = artifact.n_fields
    if np.shape(fields_init) != (n,):
        raise ShapeError(
            (n,), tuple(np.shape(fields_init)),
            "initial fields must have one entry per field",
        )
    if np.shape(derivatives_init) != (n,):
        raise ShapeError(
            (n,), tuple(np.shape(derivatives_init)),
            "initial derivatives must have one entry per field",
        )
    if np.shape(pars) != (artifact.n_parameters,):
        raise ShapeError(
            (artifact.n_parameters,), tuple(np.shape(pars)),
            f'model "{artifact.model_name}" has {artifact.n_parameters} parameters',
        )
    if len(np.shape(times)) != 1 or np.shape(times)[0] < 2:
        raise ShapeError(
            (-1,), tuple(np.shape(times)), "times must be a 1-D grid of ≥2 points"
        )
    inputs = (pars, times, fields_init, derivatives_init)
    device = _common_device(inputs, resolve_device(device))
    args, times, x0, chi0 = (_f64(v, device) for v in inputs)
    h0 = _full(artifact.eom_h(x0, chi0, args), x0)
    y = torch.cat([x0, chi0, h0.reshape(1)])
    rows = [y]
    dts = times[1:] - times[:-1]
    for i in range(dts.shape[0]):
        y, _ = rk_step(artifact, y, dts[i], args, _RK4_A, _RK4_B)
        rows.append(y)
    return torch.stack(rows)


# ----------------------------------------------------------------------- #
# fitting loop                                                             #
# ----------------------------------------------------------------------- #


class FitResult(NamedTuple):
    """Result of :func:`fit_parameters`.

    ``params``: fitted parameter vector (numpy; ``(n_starts, k)`` for
    multi-start calls); ``loss_history``: (steps,) (or ``(n_starts,
    steps)``) loss value *before* each update — ``loss_history[..., -1]``
    is the loss one step before ``params``; evaluate the loss at ``params``
    for the final value.
    """

    params: np.ndarray
    loss_history: np.ndarray


_fit_cache: dict = {}
_CACHE_CAP = 8  # keys pin their closures (and every tensor they capture)
                # alive, so bound the cache LRU-style


def _cache_put(cache: dict, key, value):
    cache[key] = value
    while len(cache) > _CACHE_CAP:
        cache.pop(next(iter(cache)))  # dicts preserve insertion order


def _build_fit(loss_fn: Callable, make_optimizer: Callable, steps: int) -> Callable:
    """The fitting loop for one (loss, optimizer, steps): ``run(p0) ->
    (params, history)`` on the device of ``p0``."""
    # a multi-start batch evaluates loss_fn under torch.func.vmap; a loss
    # whose code cannot run under vmap (a loop on data, as the special
    # functions have) is evaluated start by start instead
    batched = {"vmap": True}

    def per_start(p):
        if batched["vmap"]:
            try:
                return torch.func.vmap(loss_fn)(p)
            except RuntimeError:
                batched["vmap"] = False
        return torch.stack([loss_fn(p[s]) for s in range(p.shape[0])])

    def run(p0):
        p = p0.detach().clone().requires_grad_(True)
        opt = make_optimizer([p])
        history = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(p) if p.ndim == 1 else per_start(p)
            # the starts' losses are independent, and Adam and SGD act per
            # coordinate: the sum moves each start as it would move alone
            loss.sum().backward()
            history.append(loss.detach())
            opt.step()
        return p.detach(), torch.stack(history, dim=-1)

    return run


def fit_parameters(
    loss_fn: Callable,
    args0,
    *,
    steps: int = 200,
    learning_rate: float = 0.05,
    optimizer: Callable | None = None,
    device="cuda",
) -> FitResult:
    """Minimize ``loss_fn(args) -> scalar`` by gradient descent.

    ``steps`` iterations of ``torch.optim.Adam(lr=learning_rate)`` by
    default.  ``optimizer`` takes a callable ``params_list ->
    torch.optim.Optimizer`` instead, e.g. ``lambda p: torch.optim.SGD(p,
    lr=0.1)``: the counterpart of the JAX package's optax transformation
    (``optax.adam(lr)`` ↔ ``lambda p: torch.optim.Adam(p, lr=lr)``,
    ``optax.sgd(lr)`` ↔ ``lambda p: torch.optim.SGD(p, lr=lr)``).
    ``loss_fn`` must be differentiable under autograd; build it from the
    observable factories above or :func:`solve_eom_fixed`.  The loop runs on
    the device of ``args0`` if it is a tensor, else on ``device``.

    Multi-start fits are first-class: pass ``args0`` with shape
    ``(n_starts, k)`` and every start is optimized in the same loop (one
    parameter tensor; each start's loss evaluated under
    ``torch.func.vmap``, start by start where the loss cannot run under
    ``vmap``) — ``params`` comes back ``(n_starts, k)`` and
    ``loss_history`` ``(n_starts, steps)``, each start's own loss; pick the
    winner with ``loss_history[:, -1].argmin()``.  The loop is cached per
    (``loss_fn``, ``optimizer`` or ``learning_rate``, ``steps``) identity,
    at most eight entries.
    """
    device = resolve_device(device)
    params0 = _f64(args0, device)
    if params0.ndim not in (1, 2):
        raise ShapeError(
            (-1,), tuple(params0.shape),
            "args0 must be a parameter vector or an (n_starts, k) batch",
        )

    key = (loss_fn, optimizer if optimizer is not None else float(learning_rate),
           int(steps))
    run = _fit_cache.get(key)
    if run is None:
        lr = float(learning_rate)
        make = optimizer if optimizer is not None else (
            lambda params: torch.optim.Adam(params, lr=lr))
        run = _build_fit(loss_fn, make, int(steps))
        _cache_put(_fit_cache, key, run)

    params, history = run(params0)
    return FitResult(_host(params), _host(history))
