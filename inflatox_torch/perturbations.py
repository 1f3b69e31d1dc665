"""First-principles multi-field perturbation spectra.

The port of ``inflatox_tpu/perturbations.py``: the same entries, names,
keyword arguments and returned dict keys, plus ``device=`` (``"cuda"`` by
default; on a host without CUDA that raises, pass ``device="cpu"``).  Three
routes to the primordial spectra, all built on the batched background
solver and the geometry surfaces:

* **δN formalism** (:func:`delta_n_spectrum`, :func:`delta_n_sweep`,
  :func:`squeezed_fnl`): ζ(x) = δN, the difference in e-fold count from a
  flat slice at horizon crossing to a final uniform-H surface.  P_ζ(k) =
  G^{ab} N_a N_b (H_*/2π)² with N_a = ∂N/∂φ^a_* by central finite
  differences of *full nonlinear background solves* from perturbed initial
  field values; every perturbed trajectory of every pivot runs in ONE
  :func:`~inflatox_torch.background.solve_eom_batch` call, which is one
  launch of kernel B6 on a CUDA device (its plain version on the CPU).
* **Mukhanov-Sasaki mode integration** (:func:`mode_spectrum`,
  :func:`mode_sweep`): the coupled perturbation ODEs through horizon
  crossing, cross-validated against δN; also the exact tensor spectrum and
  the isocurvature decomposition.
* **Moment transport** (:func:`transport_spectrum`,
  :func:`transport_sweep`): the phase-space correlation matrix Σ^{AB}(k)
  itself (dΣ/dN = uΣ + Σuᵀ) through the same coefficient streams, read on
  two surfaces for the Wands transfer functions T_RS/T_SS.

Where the work runs, as in the JAX package: stencils, ``np.interp``, the
cubic-Hermite surface read-out, finite differences and tilts are host
numpy; the model and geometry evaluations (inner products, metric,
Christoffels, Riemann, coordinate Hesse, vielbein) and the assembly of the
coefficient streams run in torch on ``device``; the mode and transport
integrators are plain torch RK4 loops over the step axis, batched over the
pivot axis (the JAX package's ``jax.vmap(lax.scan)``), whose state and
streams stay on ``device``.  Like the JAX package, the modes start at unit
Bunch-Davies amplitude and the amplitude is folded into the read-out.

Conventions: reduced Planck units (M_Pl = 1); P_ζ is the dimensionless
spectrum (single-field slow-roll limit H²/(8π²ε)); ln k = N + ln H at
crossing with N normalized to the supplied trajectory's start (only Δln k
is physical).

``mesh=`` (a :func:`~inflatox_torch.parallel.make_mesh` mesh) decides the
devices, as the JAX package's does: the δN routes split their solves over
its first axis (:func:`~inflatox_torch.parallel.sharded_solve_eom_batch`),
and the mode and transport routes split their pivot axis over the mesh
axis ``pivot_axis`` (default the first), padded by repeating the last pivot
and trimmed after the loops, each slot running the RK4 loops on its pivots
(the counterpart of the JAX package's ``_pivot_shard``); the rest runs on
the mesh's first device.  One host thread drives every slot, so a mesh of
k slots launches k times what one loop over 1/k of the pivots launches.
Without a mesh ``pivot_axis`` is ignored, as in the JAX package.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from . import background
from .observables import _eps1_crossing, _trajectory_eps_h
from .parallel.mesh import check_mesh_device, gather_shards, launch_shards
from .utils.devices import resolve_device
from .utils.errors import ShapeError
from .utils.logging import log_warn

__all__ = [
    "delta_n_spectrum",
    "delta_n_sweep",
    "mode_spectrum",
    "mode_sweep",
    "squeezed_fnl",
    "transport_spectrum",
    "transport_sweep",
]


def _placement(mesh, device) -> torch.device:
    """Where a spectrum route's model evaluations run: ``device``, or with a
    mesh (which must be of ``device``'s type) the mesh's first device."""
    if mesh is None:
        return resolve_device(device)
    return check_mesh_device(mesh, device).home


def _mesh_kw(mesh) -> dict:
    """The ``mesh=`` of a route's solves, passed only when there is one (as
    the JAX package's ``mesh_kw``)."""
    return {} if mesh is None else {"mesh": mesh}


def _pivot_shards(mesh, pivot_axis, total_k, run) -> tuple:
    """The host (numpy) results of ``run(idx, dev)``, a tuple of tensors
    with the pivot axis leading: without a mesh ``run(None, None)`` (every
    pivot where its inputs lie); with one, each slot of ``pivot_axis``
    (default the mesh's first axis) runs its block of the pivot axis padded
    to the axis by repeating the last pivot (``idx``, a LongTensor of pivot
    indices), on its device, and the blocks are joined and trimmed to
    ``total_k``."""
    if mesh is None:
        return tuple(_host(t) for t in run(None, None))
    slots = mesh.axis_slots(pivot_axis if pivot_axis is not None else mesh.axis_names[0])
    local = -(-int(total_k) // len(slots))

    def launch(i, device):
        idx = torch.arange(i * local, (i + 1) * local).clamp(max=int(total_k) - 1)
        return run(idx, device)

    out = gather_shards(mesh, launch_shards(mesh, slots, launch, True))
    return tuple(o[:int(total_k)] for o in out)


def _pick(value, dim, idx, device):
    """``value`` (a tensor, or a tuple of them) at the pivot indices ``idx``
    along ``dim``, on ``device``; itself for ``idx`` None."""
    if idx is None:
        return value
    if isinstance(value, tuple):
        return tuple(_pick(v, dim, idx, device) for v in value)
    return value.index_select(dim, idx.to(value.device)).to(device)


def _tensor(value, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(value, dtype=np.float64), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _base_quantities(artifact, args, rows, times, device):
    """Common base-trajectory analysis: e-fold axis, ε_H, end of inflation
    (ε_H = 1 crossing, interpolated) and the H value there."""
    rows, times, hubble, eps_h, n_axis = _trajectory_eps_h(
        artifact, rows, times, args, device
    )
    i, frac = _eps1_crossing(eps_h)
    n_end = n_axis[i - 1] + frac * (n_axis[i] - n_axis[i - 1])
    h_ref = hubble[i - 1] + frac * (hubble[i] - hubble[i - 1])
    return rows, times, hubble, eps_h, n_axis, i, n_end, h_ref


# ----------------------------------------------------------------------- #
# δN machinery, shared by delta_n_spectrum, delta_n_sweep and squeezed_fnl #
# ----------------------------------------------------------------------- #


def _dn_pivot_efolds(n_axis, n_end, pivots, margin_start, margin_end,
                     n_before_end=None):
    """Pivot e-fold times: evenly spaced inside the requested margins, or —
    when ``n_before_end`` is given — at the requested e-fold distances
    before the end of inflation (the CMB convention: N_* = 50–60).  The
    margins still bound the placement (they guarantee the attractor has
    settled / the final surface is clear of the pivot)."""
    n_lo = n_axis[0] + float(margin_start)
    n_hi = n_end - float(margin_end)
    if not n_hi > n_lo:
        raise ValueError(
            f"trajectory spans only {n_end - n_axis[0]:.1f} e-folds — too "
            "short for the requested pivot margins"
        )
    if n_before_end is None:
        return np.linspace(n_lo, n_hi, int(pivots))
    nb = np.sort(np.atleast_1d(np.asarray(n_before_end, dtype=float)))[::-1]
    n_piv = n_end - nb                       # ascending in N (and in ln k)
    if n_piv[0] < n_lo or n_piv[-1] > n_hi:
        raise ValueError(
            f"pivot_N_before_end requests pivots {nb[0]:.1f}–{nb[-1]:.1f} "
            f"e-folds before the end, outside the valid window "
            f"[{n_end - n_hi:.1f}, {n_end - n_lo:.1f}] set by the margins "
            f"(trajectory: {n_end - n_axis[0]:.1f} e-folds) — integrate "
            "longer or relax the margins"
        )
    return n_piv


def _dn_pivot_states(rows, hubble, n_axis, i, d, n_pivots):
    """Pivot field/velocity/Hubble states interpolated in e-fold time."""
    span = slice(0, i + 1)
    x_star = np.stack([
        np.interp(n_pivots, n_axis[span], rows[span, c]) for c in range(d)
    ], axis=1)                                   # (pivots, d)
    chi_star = np.stack([
        np.interp(n_pivots, n_axis[span], rows[span, d + c]) for c in range(d)
    ], axis=1)                                   # (pivots, d)
    h_star = np.interp(n_pivots, n_axis[span], hubble[span])
    return x_star, chi_star, h_star


def _dn_stencil(x_star, chi_star, h, h2, order):
    """Perturbed-initial-condition stencil around each pivot, flattened to
    one trajectory batch.  Per pivot, in order: 2d first-order points at
    ±h_a (for N_a), then with order=2: 1 base point, 2d points at ±h2_a
    (diagonal N_aa) and 4·C(d,2) mixed points at (±h2_a, ±h2_b)
    (off-diagonal N_ab).  Velocities are kept on the attractor."""
    pivots, d = x_star.shape
    h_a = h * np.maximum(1.0, np.abs(x_star))    # (pivots, d) per-field steps
    h2_a = h2 * np.maximum(1.0, np.abs(x_star))
    per_pivot = 2 * d + (1 + 2 * d + 2 * d * (d - 1)) * (order == 2)
    f0 = []
    for p in range(pivots):
        for a in range(d):
            for s in (+1.0, -1.0):
                xp = x_star[p].copy()
                xp[a] += s * h_a[p, a]
                f0.append(xp)
        if order == 2:
            f0.append(x_star[p].copy())
            for a in range(d):
                for s in (+1.0, -1.0):
                    xp = x_star[p].copy()
                    xp[a] += s * h2_a[p, a]
                    f0.append(xp)
            for a in range(d):
                for b in range(a + 1, d):
                    for sa in (+1.0, -1.0):
                        for sb in (+1.0, -1.0):
                            xp = x_star[p].copy()
                            xp[a] += sa * h2_a[p, a]
                            xp[b] += sb * h2_a[p, b]
                            f0.append(xp)
    f0 = np.asarray(f0)                          # (pivots·per_pivot, d)
    return f0, np.repeat(chi_star, per_pivot, axis=0), per_pivot, h_a, h2_a


def _inner_prod_rows(artifact, pars, rows, device):
    """|χ|²_G = G_ab χ^a χ^b at every row of a batch of solved trajectories,
    on ``device``, brought to the host.  ``pars`` is (k,) shared or (B, k)
    per-trajectory: the latter goes to the lowered functions as k (B, 1)
    columns, which broadcast against the (B, steps) rows."""
    d = artifact.n_fields
    pars = np.asarray(pars, dtype=float)
    a_in = ([_tensor(pars[:, j:j + 1], device) for j in range(pars.shape[1])]
            if pars.ndim == 2 else _tensor(pars, device))
    rows_t = _tensor(rows, device)
    x = [rows_t[..., c] for c in range(d)]
    chi = [rows_t[..., d + c] for c in range(d)]
    return _host(artifact.inner_prod(x, a_in, chi, chi))


def _batch_hdot_efolds(artifact, pars_b, rows_b, times_b, device):
    """Ḣ = −½|χ|²_G and the e-fold axis for a batch of solved trajectories
    (one vectorized inner-product call on ``device``; ``pars_b`` (k,)
    shared or (B, k) per-trajectory)."""
    hdot_b = -0.5 * _inner_prod_rows(artifact, pars_b, rows_b, device)
    return hdot_b, background.efolds(rows_b, times_b, hdot=hdot_b)


def _dn_surface(artifact, pars_b, rows_b, times_b, h_ref, steps, device,
                strict=True, aux=None):
    """E-folds from each perturbed start to its uniform-H final surface.

    ``pars_b`` is (k,) shared or (B, k) per-trajectory; ``h_ref`` is a
    scalar or (B,)-broadcastable per-trajectory surface value.  H decreases
    monotonically (H' = −½G_ab χ^a χ^b < 0).  Second differences of N
    amplify read-out noise by 1/h2², so the crossing is resolved with the
    cubic Hermite H(t) (values + Ḣ at the bracketing rows, Newton for
    H(t*) = h_ref) and N(t*) by integrating that cubic — O(Δt⁴) instead of
    the O(Δt²) linear-interpolation floor.  Host numpy.

    ``aux`` accepts a precomputed ``(hdot_b, n_b)`` pair from
    :func:`_batch_hdot_efolds` when the caller also needs those arrays.

    Returns ``(n_surface, ok)``: a trajectory that fails to bracket its
    surface gets ``ok=False`` and NaN — or, with ``strict``, raises with
    the actionable message."""
    rows_b = np.asarray(rows_b)
    times_b = np.asarray(times_b)
    hdot_b, n_b = aux if aux is not None else _batch_hdot_efolds(
        artifact, pars_b, rows_b, times_b, device
    )
    hub_b = rows_b[..., -1]
    h_ref = np.broadcast_to(np.asarray(h_ref, dtype=float), hub_b.shape[:1])

    reached = hub_b.min(axis=1) <= h_ref
    if strict and not reached.all():
        bad = int(np.nonzero(~reached)[0][0])
        raise ValueError(
            f"perturbed trajectory {bad} never reaches the final surface "
            f"H = {h_ref[bad]:.4g} within {steps} rows (min H "
            f"{hub_b[bad].min():.4g}) — raise steps"
        )
    idx = np.argmax(hub_b <= h_ref[:, None], axis=1)  # first row past it
    if strict and (idx == 0).any():
        bad = int(np.nonzero(idx == 0)[0][0])
        raise ValueError(
            f"perturbed trajectory {bad} starts at or below the final "
            f"surface H = {h_ref[bad]:.4g} — the pivot is too close to the "
            "end of inflation; raise N_margin_end"
        )
    ok = reached & (idx != 0)
    # clamp failed rows to a valid bracket so the vector math stays finite;
    # their outputs are NaN-masked below
    idx = np.where(ok, idx, 1)
    rows_idx = np.arange(rows_b.shape[0])
    h0 = hub_b[rows_idx, idx - 1]
    h1 = hub_b[rows_idx, idx]
    d0 = hdot_b[rows_idx, idx - 1]
    d1 = hdot_b[rows_idx, idx]
    dt = times_b[rows_idx, idx] - times_b[rows_idx, idx - 1]
    with np.errstate(invalid="ignore", divide="ignore"):
        s = (h0 - h_ref) / (h0 - h1)             # linear first guess
        for _ in range(3):
            val = (
                (2 * s**3 - 3 * s**2 + 1) * h0
                + (s**3 - 2 * s**2 + s) * dt * d0
                + (-2 * s**3 + 3 * s**2) * h1
                + (s**3 - s**2) * dt * d1
                - h_ref
            )
            dval = (
                (6 * s**2 - 6 * s) * h0
                + (3 * s**2 - 4 * s + 1) * dt * d0
                + (-6 * s**2 + 6 * s) * h1
                + (3 * s**2 - 2 * s) * dt * d1
            )
            s = np.clip(s - val / np.where(dval == 0.0, 1.0, dval), 0.0, 1.0)
        n_surface = n_b[rows_idx, idx - 1] + dt * (
            (0.5 * s**4 - s**3 + s) * h0
            + (0.25 * s**4 - (2.0 / 3.0) * s**3 + 0.5 * s**2) * dt * d0
            + (-0.5 * s**4 + s**3) * h1
            + (0.25 * s**4 - s**3 / 3.0) * dt * d1
        )
    return np.where(ok, n_surface, np.nan), ok


def _dn_pivot_geometry(artifact, args, x_star, order, device):
    """Metric (K, d, d) and, for order=2, Christoffels (d, d, d, K) at the
    pivot points — one vectorized call each on ``device``, brought to the
    host (``args`` may be a list of per-sample arrays, one per parameter,
    which is how the sweep evaluates every set's pivots in one call)."""
    d = x_star.shape[1]
    x_list = [_tensor(x_star[:, c], device) for c in range(d)]
    a = ([_tensor(v, device) for v in args] if isinstance(args, list)
         else _tensor(args, device))
    g = np.moveaxis(_host(artifact.metric(x_list, a)), -1, 0)
    gam = None
    if order == 2:
        gam = _host(artifact.geometry.christoffels(x_list, a))
    return g, gam


def _dn_assemble(g_piv, gam, x_star, h_star, n_pivots, n_surface, h_a, h2_a,
                 order):
    """Finite differences → N_a (and covariant N_{;ab}) → spectra for one
    parameter set.  ``n_surface`` is (pivots, per_pivot) e-fold counts in
    stencil order (:func:`_dn_stencil`); ``g_piv`` the metric at the pivots
    (pivots, d, d); ``gam`` the Christoffels (d, d, d, pivots), required
    for ``order=2``.  Pure host numpy — NaN trajectories (a non-strict
    surface read-out) propagate to NaN pivots."""
    pivots, d = x_star.shape
    n_first = n_surface[:, : 2 * d].reshape(pivots, d, 2)
    n_grad = (n_first[:, :, 0] - n_first[:, :, 1]) / (2.0 * h_a)

    n_hess = None
    if order == 2:
        n_base = n_surface[:, 2 * d]                       # (pivots,)
        n_diag = n_surface[:, 2 * d + 1 : 4 * d + 1].reshape(pivots, d, 2)
        n_hess = np.zeros((pivots, d, d))
        for a in range(d):
            n_hess[:, a, a] = (
                n_diag[:, a, 0] - 2.0 * n_base + n_diag[:, a, 1]
            ) / h2_a[:, a] ** 2
        k = 4 * d + 1
        for a in range(d):
            for b in range(a + 1, d):
                pp, pm, mp, mm_ = (n_surface[:, k + j] for j in range(4))
                k += 4
                n_hess[:, a, b] = n_hess[:, b, a] = (pp - pm - mp + mm_) / (
                    4.0 * h2_a[:, a] * h2_a[:, b]
                )
        # covariant Hessian: N_{;ab} = ∂_a∂_b N − Γ^c_ab N_c at the pivot
        n_hess = n_hess - np.einsum("cabk,kc->kab", gam, n_grad)

    # P_ζ = G^{ab} N_a N_b (H_*/2π)², f_NL = (5/6) N^aN^b N_{;ab}/(N·N)²
    with np.errstate(invalid="ignore", divide="ignore"):
        ginv = np.linalg.inv(g_piv)
        n_up = np.einsum("kab,kb->ka", ginv, n_grad)
        nn = np.einsum("ka,ka->k", n_grad, n_up)
        p_zeta = nn * (h_star / (2 * np.pi)) ** 2
        f_nl = None
        if order == 2:
            f_nl = (5.0 / 6.0) * np.einsum(
                "ka,kab,kb->k", n_up, n_hess, n_up
            ) / nn**2

        ln_k = n_pivots + np.log(h_star)
        p_tens = 2.0 * h_star * h_star / np.pi**2
        n_s = np.full(pivots, np.nan)
        if pivots >= 3:
            ln_p = np.log(p_zeta)
            n_s[1:-1] = 1.0 + (ln_p[2:] - ln_p[:-2]) / (ln_k[2:] - ln_k[:-2])
        out = {
            "ln_k": ln_k,
            "N": n_pivots,
            "P_zeta": p_zeta,
            "P_tensor": p_tens,
            "n_s": n_s,
            "r": p_tens / p_zeta,
            "N_grad": n_grad,
            "H": h_star,
        }
    if order == 2:
        out["N_hess"] = n_hess
        out["f_NL"] = f_nl
    return out


def delta_n_spectrum(
    artifact,
    args,
    rows,
    times,
    *,
    pivots: int = 12,
    N_margin_start: float = 2.0,
    N_margin_end: float = 5.0,
    h: float = 1e-4,
    steps: int = 4000,
    max_err: float = 1e-8,
    solver: str = "rkf",
    mesh=None,
    order: int = 1,
    h2: float = 2e-3,
    pivot_N_before_end=None,
    device="cuda",
) -> dict:
    """Scalar power spectrum from the δN formalism along a solved trajectory.

    ``rows``/``times`` are a solved base trajectory
    (:func:`~inflatox_torch.background.solve_eom` with ``return_time=True``)
    that reaches the end of inflation (ε_H = 1).  ``pivots`` horizon-crossing
    points are placed evenly in e-fold time between ``N_margin_start`` after
    the start and ``N_margin_end`` before the end — or, when
    ``pivot_N_before_end`` is given (a sequence of e-fold distances before
    the end of inflation, the CMB convention N_* = 50–60), at exactly those
    points, overriding ``pivots`` (all six spectrum routes accept this
    kwarg); for each pivot, each field coordinate is perturbed by
    ±h·max(1, |φ^a_*|) (velocities kept on the attractor) and ALL
    2·d·pivots perturbed backgrounds are integrated in one
    :func:`~inflatox_torch.background.solve_eom_batch` call on ``device``
    (one launch of kernel B6 on a CUDA device).  Each trajectory's e-fold
    count to the common final uniform-H surface (H at the base trajectory's
    ε_H = 1 crossing) gives N(φ_*) by central differences, and

        P_ζ(k_*) = G^{ab}(φ_*) N_a N_b · (H_*/2π)²,   k_* = a H|_*.

    Returns a dict of per-pivot numpy arrays: ``ln_k``, ``N``, ``P_zeta``,
    ``P_tensor`` (= 2H²/π²), ``n_s`` (centered differences of ln P_ζ over
    ln k; NaN at the ends), ``r`` (= P_T/P_ζ), ``N_grad`` ((pivots, d) —
    the δN gradients themselves), ``H``.

    With ``order=2`` the stencil is widened (one base solve, ±``h2`` axis
    points and (±h2, ±h2) mixed points per pivot — still ONE batched
    launch) to second differences of N, and the result gains ``N_hess``
    ((pivots, d, d) — the *covariant* Hessian N_{;ab} = ∂_a∂_b N − Γ^c_ab N_c)
    and ``f_NL`` — the local bispectrum amplitude of the δN formalism
    (Lyth–Rodríguez),

        f_NL = (5/6) · N^a N^b N_{;ab} / (N_c N^c)²

    (super-horizon part only; the intrinsic horizon-crossing contribution
    is O(slow-roll) on top).

    Accuracy notes: exact in the super-horizon separate-universe limit
    given slow roll *at crossing*; the (H_*/2π)² mode normalization is
    leading order, so on strongly flattened potentials pivots near the end
    of inflation can differ from :func:`mode_spectrum` by tens of percent —
    trust the mode route there.  ``h`` balances finite-difference
    truncation against solver noise (N is resolved to ~``max_err``); second
    differences amplify that noise by 1/h2², so ``h2`` is wider: the
    defaults resolve N_{;ab} to ~``4·max_err/h2²`` ≈ 1e-2 absolute.  Raise
    ``steps`` if a perturbed trajectory fails to reach the final surface
    (a ``ValueError`` says so).  ``device``: where the solves and the model
    evaluations run.
    """
    order = int(order)
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    device = _placement(mesh, device)
    d = artifact.n_fields
    rows, times, hubble, eps_h, n_axis, i, n_end, h_ref = _base_quantities(
        artifact, args, rows, times, device
    )
    n_pivots = _dn_pivot_efolds(
        n_axis, n_end, pivots, N_margin_start, N_margin_end,
        pivot_N_before_end,
    )
    pivots = len(n_pivots)
    x_star, chi_star, h_star = _dn_pivot_states(
        rows, hubble, n_axis, i, d, n_pivots
    )
    f0, chi0, per_pivot, h_a, h2_a = _dn_stencil(x_star, chi_star, h, h2,
                                                 order)
    a_f = np.asarray(args, dtype=float)
    rows_b, times_b = background.solve_eom_batch(
        artifact, a_f, int(steps), f0, chi0,
        max_err=max_err, solver=solver, return_time=True, device=device, **_mesh_kw(mesh),
    )
    n_surface, _ = _dn_surface(artifact, a_f, rows_b, times_b, h_ref, steps,
                               device)
    g_piv, gam = _dn_pivot_geometry(artifact, a_f, x_star, order, device)
    return _dn_assemble(
        g_piv, gam, x_star, h_star, n_pivots,
        n_surface.reshape(int(pivots), per_pivot), h_a, h2_a, order,
    )


def delta_n_sweep(
    artifact,
    pars,
    fields_init,
    derivatives_init,
    *,
    steps: int = 4000,
    pivots: int = 12,
    N_margin_start: float = 2.0,
    N_margin_end: float = 5.0,
    h: float = 1e-4,
    h2: float = 2e-3,
    order: int = 1,
    max_err: float = 1e-8,
    solver: str = "rkf",
    mesh=None,
    on_failure: str = "raise",
    pivot_N_before_end=None,
    device="cuda",
) -> dict:
    """δN spectra for a batch of parameter sets — the survey tool.

    For every parameter set in ``pars`` ((S, k); initial conditions (d,)
    shared or (S, d) per-set) the sweep solves the base background, places
    ``pivots`` horizon-crossing points, and computes the full δN spectrum
    (same rules, stencils and read-out as :func:`delta_n_spectrum`,
    including ``order=2`` → f_NL) — with ALL device work batched across
    the sweep: one solve integrates every base trajectory and a second
    integrates every perturbed trajectory of every set (S·pivots·(2d
    [+ second-order stencil]) solves in one launch of kernel B6, with
    per-trajectory parameters).  The per-pivot geometry read-back is
    likewise one vectorized call over all S·pivots points, so host↔device
    round-trips stay O(1) in S.

    Per-set failures — a base trajectory that never inflates or ends too
    early for the pivot margins, or a perturbed solve that misses the
    final uniform-H surface — raise by default with the set index in the
    message; ``on_failure="nan"`` instead NaN-fills the affected outputs,
    clears that set's flag in the returned ``ok`` mask, records the reason
    in ``failures``, and logs one warning.  A set whose base solve
    succeeds but loses individual perturbed trajectories keeps its finite
    pivots and NaNs only the affected ones.  ``on_failure`` is about
    physically pathological parameter sets; a device or kernel fault
    always raises.

    Returns a dict of stacked arrays: ``ln_k``/``N``/``P_zeta``/
    ``P_tensor``/``n_s``/``r``/``H`` (S, pivots), ``N_grad``
    (S, pivots, d), ``ok`` (S,) bool, ``failures`` (length-S list of
    ``None`` or the failure reason) [+ ``N_hess`` (S, pivots, d, d),
    ``f_NL`` (S, pivots) with ``order=2``].
    """
    if on_failure not in ("raise", "nan"):
        raise ValueError(
            f"on_failure must be 'raise' or 'nan', got {on_failure!r}"
        )
    order = int(order)
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    device = _placement(mesh, device)
    if pivot_N_before_end is not None:
        pivots = len(np.atleast_1d(pivot_N_before_end))
    d = artifact.n_fields
    pars = np.asarray(pars, dtype=float)
    if pars.ndim == 1:
        pars = pars[None]
    if pars.ndim != 2 or pars.shape[1] != artifact.n_parameters:
        raise ShapeError(
            (-1, artifact.n_parameters), pars.shape,
            "sweep parameters must be (S, n_parameters)",
        )
    S = pars.shape[0]
    f0b = np.broadcast_to(np.asarray(fields_init, dtype=float), (S, d)).copy()
    chi0b = np.broadcast_to(np.asarray(derivatives_init, dtype=float), (S, d)).copy()

    # every base trajectory in one launch, then the shared along-trajectory
    # quantities (ε_H, e-fold axis) vectorized over the whole batch
    rows_base, times_base = background.solve_eom_batch(
        artifact, pars, int(steps), f0b, chi0b,
        max_err=max_err, solver=solver, return_time=True, device=device, **_mesh_kw(mesh),
    )
    chi_sq = _inner_prod_rows(artifact, pars, rows_base, device)
    hub_base = rows_base[..., -1]
    with np.errstate(invalid="ignore", divide="ignore"):
        eps_base = 0.5 * chi_sq / (hub_base * hub_base)
    n_base = background.efolds(rows_base, times_base, hdot=-0.5 * chi_sq)

    # host-side per-set analysis: end-of-inflation crossing, pivot states,
    # stencil construction (pure numpy — no device calls in this loop)
    per_pivot = 2 * d + (1 + 2 * d + 2 * d * (d - 1)) * (order == 2)
    b_set = int(pivots) * per_pivot
    sets = [None] * S
    failures = [None] * S
    for s_i in range(S):
        try:
            i, frac = _eps1_crossing(eps_base[s_i])
            n_end = n_base[s_i, i - 1] + frac * (
                n_base[s_i, i] - n_base[s_i, i - 1]
            )
            h_ref = hub_base[s_i, i - 1] + frac * (
                hub_base[s_i, i] - hub_base[s_i, i - 1]
            )
            n_piv = _dn_pivot_efolds(
                n_base[s_i], n_end, pivots, N_margin_start, N_margin_end,
                pivot_N_before_end,
            )
        except ValueError as e:
            if on_failure == "raise":
                raise ValueError(f"parameter set {s_i}: {e}") from e
            failures[s_i] = str(e)
            continue
        x_star, chi_star, h_star = _dn_pivot_states(
            rows_base[s_i], hub_base[s_i], n_base[s_i], i, d, n_piv
        )
        f0, chi0, _, h_a, h2_a = _dn_stencil(x_star, chi_star, h, h2, order)
        sets[s_i] = (n_piv, x_star, h_star, h_a, h2_a, h_ref, f0, chi0)

    valid = [s_i for s_i in range(S) if sets[s_i] is not None]
    outs = [None] * S
    if valid:
        # every perturbed trajectory of every set in ONE launch,
        # per-trajectory parameters riding the batch
        pars_all = np.repeat(pars[valid], b_set, axis=0)
        rows_b, times_b = background.solve_eom_batch(
            artifact, pars_all, int(steps),
            np.concatenate([sets[s_i][6] for s_i in valid]),
            np.concatenate([sets[s_i][7] for s_i in valid]),
            max_err=max_err, solver=solver, return_time=True, device=device, **_mesh_kw(mesh),
        )
        n_surf, ok_traj = _dn_surface(
            artifact, pars_all, rows_b, times_b,
            np.repeat(np.array([sets[s_i][5] for s_i in valid]), b_set),
            steps, device, strict=False,
        )
        if on_failure == "raise" and not ok_traj.all():
            bad = int(np.nonzero(~ok_traj)[0][0])
            raise ValueError(
                f"parameter set {valid[bad // b_set]}: perturbed trajectory "
                f"{bad % b_set} fails to bracket the final uniform-H "
                "surface — raise steps (it never reaches H_ref) or "
                "N_margin_end (its pivot starts at or below H_ref)"
            )
        # pivot geometry for every valid set in one vectorized call
        x_all = np.concatenate([sets[s_i][1] for s_i in valid])
        a_geo = [np.repeat(pars[valid, j], int(pivots))
                 for j in range(pars.shape[1])]
        g_all, gam_all = _dn_pivot_geometry(artifact, a_geo, x_all, order,
                                            device)

        for v, s_i in enumerate(valid):
            n_piv, x_star, h_star, h_a, h2_a = sets[s_i][:5]
            sl = slice(v * b_set, (v + 1) * b_set)
            if not ok_traj[sl].all():
                failures[s_i] = (
                    f"{int((~ok_traj[sl]).sum())} perturbed trajectories "
                    "fail to bracket the final uniform-H surface — their "
                    "pivots are NaN (raise steps or N_margin_end)"
                )
            gl = slice(v * int(pivots), (v + 1) * int(pivots))
            outs[s_i] = _dn_assemble(
                g_all[gl],
                gam_all[..., gl] if gam_all is not None else None,
                x_star, h_star, n_piv,
                n_surf[sl].reshape(int(pivots), per_pivot),
                h_a, h2_a, order,
            )

    keys = {"ln_k": (int(pivots),), "N": (int(pivots),),
            "P_zeta": (int(pivots),), "P_tensor": (int(pivots),),
            "n_s": (int(pivots),), "r": (int(pivots),),
            "H": (int(pivots),), "N_grad": (int(pivots), d)}
    if order == 2:
        keys["N_hess"] = (int(pivots), d, d)
        keys["f_NL"] = (int(pivots),)
    out = {
        key: np.stack([
            outs[s_i][key] if outs[s_i] is not None else np.full(shape, np.nan)
            for s_i in range(S)
        ])
        for key, shape in keys.items()
    }
    out["ok"] = np.array([
        failures[s_i] is None and outs[s_i] is not None for s_i in range(S)
    ])
    out["failures"] = failures
    n_fail = int(S - out["ok"].sum())
    if n_fail:
        first = int(np.nonzero(~out["ok"])[0][0])
        log_warn(
            f"delta_n_sweep: {n_fail}/{S} parameter sets failed and were "
            f"NaN-filled — first: set {first}: {failures[first]}"
        )
    return out


# ----------------------------------------------------------------------- #
# Squeezed-limit bispectrum (separate-universe response route)             #
# ----------------------------------------------------------------------- #


def _n_from_ln_k(n_axis, hubble, i, targets):
    """Invert ln(aH)(N) = target on the inflating span of a trajectory
    (monotone while ε_H < 1: d ln(aH)/dN = 1 − ε; ``i`` is the first row
    past the ε_H = 1 crossing)."""
    lnah = n_axis[: i + 1] + np.log(hubble[: i + 1])
    return np.interp(targets, lnah, n_axis[: i + 1])


def squeezed_fnl(
    artifact,
    args,
    rows,
    times,
    *,
    N_long_before_end: float = 55.0,
    N_short_before_end=(50.0, 45.0),
    h: float = 2e-3,
    h_short: float = 1e-4,
    steps: int = 4000,
    max_err: float = 1e-8,
    solver: str = "rkf",
    mesh=None,
    N_margin_start: float = 2.0,
    N_margin_end: float = 5.0,
    device="cuda",
) -> dict:
    """Squeezed-limit bispectrum amplitude f_NL(k_L; k_S) by the
    separate-universe response route.

    In the squeezed limit k_L ≪ k_S the bispectrum is the response of the
    short-mode power spectrum to the long mode's background modulation
    (Maldacena's argument, multi-field form); with B = (6/5) f_NL [P P +
    perms],

        f_NL^sq = (5/12) · (N^a ∂_a ln 𝒫_ζ(k_S)) / (N_b N^b),

    where N_a is the δN gradient at the long pivot and the response
    derivative ∂_a ln 𝒫(k_S) is evaluated **at fixed physical k_S** on
    perturbed separate-universe backgrounds: each of the 2d stencil
    trajectories of the long pivot (which double as the N_a finite
    differences — one batched solve serves both) is its own universe, its
    short-mode spectrum read at the common anchored ln k_S, and central
    differences over ±h·max(1, |φ^a|) give the derivative.  The fixed-k
    anchoring captures the **dilation** contribution: for single-field
    models this reproduces the full Maldacena consistency relation
    f_NL^sq = (5/12)(1 − n_s), which the δN local amplitude
    (:func:`delta_n_spectrum` ``order=2``) misses by a factor ~2.

    The short spectra are the δN 𝒫 = G^{ab} N_a N_b (H_*/2π)² of each
    perturbed universe against that universe's **own** final uniform-H
    surface, with all 4d²·len(k_S) short-stencil trajectories in ONE
    batched solve: two launches of kernel B6 in all on a CUDA device.

    Returns a dict: ``f_NL_sq`` (n_S,), ``response`` ((d, n_S) — the
    ∂_a ln 𝒫(k_S) derivatives), ``N_grad_long`` (d,), ``ln_k_long``/
    ``N_long``/``P_zeta_long``/``H_long`` scalars and ``ln_k_short``/
    ``N_short``/``P_zeta_short`` (n_S,) in the base trajectory's frame
    (``P_zeta_short`` is the ± average over the stencil universes — the
    base value up to O(h²)).
    """
    device = _placement(mesh, device)
    d = artifact.n_fields
    a_f = np.asarray(args, dtype=float)
    rows, times, hubble, eps_h, n_axis, i, n_end, h_ref = _base_quantities(
        artifact, a_f, rows, times, device
    )
    nb_long = float(N_long_before_end)
    nb_short = np.atleast_1d(np.asarray(N_short_before_end, dtype=float))
    sep_floor = max(float(N_margin_start), 2.0)
    if not (nb_short <= nb_long - sep_floor).all():
        raise ValueError(
            "every short mode must cross at least "
            f"max(N_margin_start, 2) = {sep_floor:.1f} e-folds after the "
            f"long mode (N_short_before_end ≤ N_long_before_end − "
            f"{sep_floor:.1f} = {nb_long - sep_floor:.1f}): the response is "
            "read on universes branched at the long crossing, which need "
            "the separation to settle onto their own attractors — and the "
            "squeezed limit itself assumes k_L ≪ k_S (tens of e-folds)"
        )
    # validates long + short pivots against the usual margins
    _dn_pivot_efolds(
        n_axis, n_end, 0, N_margin_start, N_margin_end,
        np.concatenate([[nb_long], nb_short]),
    )
    n_long = n_end - nb_long
    n_short = np.sort(n_end - nb_short)              # ascending in N / ln k
    n_s_count = len(n_short)

    x_l, chi_l, h_l = _dn_pivot_states(
        rows, hubble, n_axis, i, d, np.array([n_long])
    )
    h_l = float(h_l[0])
    h_s_base = np.interp(n_short, n_axis[: i + 1], hubble[: i + 1])
    ln_ks_base = n_short + np.log(h_s_base)
    # anchored short-mode targets in the stencil universes' common frame
    # (N = 0 on the flat slice at the long crossing, a continuous there)
    ln_ks_piv = ln_ks_base - n_long
    ln_kl = n_long + np.log(h_l)

    # ONE stencil of 2d trajectories around the long pivot: their e-fold
    # counts to the base final surface give N_a, and the trajectories ARE
    # the perturbed separate-universe backgrounds for the short response
    f0, chi0, per_pivot, h_a, _ = _dn_stencil(x_l, chi_l, h, h, order=1)
    rows_b, times_b = background.solve_eom_batch(
        artifact, a_f, int(steps), f0, chi0,
        max_err=max_err, solver=solver, return_time=True, device=device, **_mesh_kw(mesh),
    )
    hdot_b, n_b = _batch_hdot_efolds(artifact, a_f, rows_b, times_b, device)
    n_surf, _ = _dn_surface(artifact, a_f, rows_b, times_b, h_ref, steps,
                            device, aux=(hdot_b, n_b))
    g_l, _ = _dn_pivot_geometry(artifact, a_f, x_l, 1, device)
    long_out = _dn_assemble(
        g_l, None, x_l, np.array([h_l]), np.array([n_long]),
        n_surf.reshape(1, per_pivot), h_a, h_a, 1,
    )
    n_grad = long_out["N_grad"][0]                   # (d,)
    n_up = np.linalg.solve(g_l[0], n_grad)           # N^a
    nn = float(n_grad @ n_up)
    p_zeta_long = float(long_out["P_zeta"][0])

    # per-universe trajectory analysis (host): ε_H, its own end-of-inflation
    # surface, and fixed-ln-k short-pivot placement in the common frame
    # (Ḣ/e-fold arrays shared with the surface read-out above)
    B = 2 * d
    hub_b = rows_b[..., -1]
    with np.errstate(invalid="ignore", divide="ignore"):
        eps_b = -hdot_b / (hub_b * hub_b)

    f0_s, chi0_s, href_s, x_short, h_short_star = [], [], [], [], []
    for b in range(B):
        ib, frac = _eps1_crossing(eps_b[b])
        n_end_b = n_b[b, ib - 1] + frac * (n_b[b, ib] - n_b[b, ib - 1])
        href_b = hub_b[b, ib - 1] + frac * (hub_b[b, ib] - hub_b[b, ib - 1])
        n_s_b = _n_from_ln_k(n_b[b], hub_b[b], ib, ln_ks_piv)
        if (n_s_b > n_end_b - float(N_margin_end)).any():
            raise ValueError(
                f"stencil universe {b}: the anchored short pivot lands "
                f"within N_margin_end = {N_margin_end} of its end of "
                "inflation — lower N_short_before_end or the margin"
            )
        x_s, c_s, h_s = _dn_pivot_states(
            rows_b[b], hub_b[b], n_b[b], ib, d, n_s_b
        )
        f0b, c0b, pp_s, _, _ = _dn_stencil(x_s, c_s, h_short, h_short, 1)
        f0_s.append(f0b)
        chi0_s.append(c0b)
        href_s.append(np.full(len(f0b), href_b))
        x_short.append(x_s)
        h_short_star.append(h_s)

    # every short-stencil trajectory of every universe in ONE launch
    rows_s, times_s = background.solve_eom_batch(
        artifact, a_f, int(steps), np.concatenate(f0_s),
        np.concatenate(chi0_s),
        max_err=max_err, solver=solver, return_time=True, device=device, **_mesh_kw(mesh),
    )
    n_surf_s, _ = _dn_surface(
        artifact, a_f, rows_s, times_s, np.concatenate(href_s), steps, device,
    )
    x_all = np.concatenate(x_short)                  # (B·n_S, d)
    g_all, _ = _dn_pivot_geometry(artifact, a_f, x_all, 1, device)

    # δN read-out per universe → ln 𝒫(k_S) → central-difference response
    n_first = n_surf_s.reshape(B, n_s_count, d, 2)
    hh = h_short * np.maximum(1.0, np.abs(x_all)).reshape(B, n_s_count, d)
    ng_s = (n_first[..., 0] - n_first[..., 1]) / (2.0 * hh)
    g_bs = g_all.reshape(B, n_s_count, d, d)
    nup_s = np.linalg.solve(g_bs, ng_s[..., None])[..., 0]
    h_star_s = np.stack(h_short_star)                # (B, n_S)
    p_s = np.einsum("bsa,bsa->bs", ng_s, nup_s) * (
        h_star_s / (2.0 * np.pi)
    ) ** 2
    ln_p = np.log(p_s).reshape(d, 2, n_s_count)      # stencil: a-major, +/−
    response = (ln_p[:, 0] - ln_p[:, 1]) / (2.0 * h_a[0][:, None])

    f_nl_sq = (5.0 / 12.0) * (n_up @ response) / nn
    return {
        "f_NL_sq": f_nl_sq,
        "response": response,
        "N_grad_long": n_grad,
        "ln_k_long": ln_kl,
        "ln_k_short": ln_ks_base,
        "N_long": n_long,
        "N_short": n_short,
        "P_zeta_long": p_zeta_long,
        "P_zeta_short": np.exp(ln_p).mean(axis=(0, 1)),
        "H_long": h_l,
    }


# ----------------------------------------------------------------------- #
# Mukhanov-Sasaki mode integration                                         #
# ----------------------------------------------------------------------- #


def _ms_rhs(state, gam_t, c_t, fric, y2):
    """Scalar-mode RHS on a (K, 4d, d) state: rows (Re Q, Im Q, Re P, Im P),
    d realizations each, with the covariant P = dQ/dN + (Γu)Q.  ``gam_t``,
    ``c_t`` are the transposed (K, d, d) coefficient matrices, ``fric``,
    ``y2`` (K, 1, 1).  One batched product by Γᵀ serves Q and P, real and
    imaginary, and one by Cᵀ serves Q, real and imaginary."""
    d = state.shape[-1]
    q, p = state[:, : 2 * d], state[:, 2 * d:]
    sg = torch.bmm(state, gam_t)
    qc = torch.bmm(q, c_t)
    dq = p - sg[:, : 2 * d]
    dp = -sg[:, 2 * d:] - fric * p - y2 * q - qc
    return torch.cat([dq, dp], 1)


def _ms_integrate(state0, streams):
    """RK4 over every pivot's e-fold grid at once (node/midpoint coefficient
    streams of :func:`_ms_streams`, step-major); ``state0`` (K, 4, d, d)."""
    gt_n, ct_n, f_n, y2_n, gt_m, ct_m, f_m, y2_m, dts = streams
    half, sixth = 0.5 * dts, dts / 6.0
    k, _, i, a = state0.shape
    state = state0.reshape(k, 4 * i, a)
    for s in range(dts.shape[0]):
        k1 = _ms_rhs(state, gt_n[s], ct_n[s], f_n[s], y2_n[s])
        k2 = _ms_rhs(state + half[s] * k1, gt_m[s], ct_m[s], f_m[s], y2_m[s])
        k3 = _ms_rhs(state + half[s] * k2, gt_m[s], ct_m[s], f_m[s], y2_m[s])
        k4 = _ms_rhs(state + dts[s] * k3, gt_n[s + 1], ct_n[s + 1],
                     f_n[s + 1], y2_n[s + 1])
        state = state + sixth[s] * (k1 + 2 * k2 + 2 * k3 + k4)
    return state.reshape(state0.shape)


def _ms_rhs_t(state, neg_fric, y2):
    """Tensor-mode RHS on a (K, 4) state (Re Q, Im Q, Re P, Im P): each
    polarization is a massless scalar (no Γ, no M); ``neg_fric`` = −(3−ε)
    and ``y2`` are (K, 1)."""
    q, p = state[:, :2], state[:, 2:]
    return torch.cat([p, neg_fric * p - y2 * q], 1)


def _ms_integrate_t(state0, streams):
    nf_n, y2_n, nf_m, y2_m, dts = streams
    half, sixth = 0.5 * dts, dts / 6.0
    state = state0
    for s in range(dts.shape[0]):
        k1 = _ms_rhs_t(state, nf_n[s], y2_n[s])
        k2 = _ms_rhs_t(state + half[s] * k1, nf_m[s], y2_m[s])
        k3 = _ms_rhs_t(state + half[s] * k2, nf_m[s], y2_m[s])
        k4 = _ms_rhs_t(state + dts[s] * k3, nf_n[s + 1], y2_n[s + 1])
        state = state + sixth[s] * (k1 + 2 * k2 + 2 * k3 + k4)
    return state


def _mass_matrix_over_h2(artifact, args, x_pts, u_pts, h_pts, eps_pts):
    """The coupled perturbation mass matrix M^a_b / H² at sample points.

    Standard multi-field result (spatially flat gauge, cosmic time):

        M^a_b = V^a_{;b} − R^a_{cdb} χ^c χ^d
                − (1/a³) D_t(a³ χ^a χ_b / H)
              = V^a_{;b} − R^a_{cdb} χ^c χ^d + (3 − ε) χ^a χ_b
                + (V^a χ_b + χ^a V_b)/H

    (the last equality expands the kinematic term with the background EoM
    D_t χ^a = −3Hχ^a − V^a and Ḣ = −εH²).  Float64 tensors on one device:
    ``args`` (k,), ``x_pts``/``u_pts`` (d, S) field points and e-fold
    velocities u = χ/H, ``h_pts``/``eps_pts`` (S,); returns (S, d, d)."""
    d = artifact.n_fields
    x_list = [x_pts[c] for c in range(d)]
    chi = u_pts * h_pts                                    # χ^a, (d, S)

    g = artifact.metric(x_list, args).permute(2, 0, 1)     # (S, d, d)
    ginv = torch.linalg.inv(g)
    grad = artifact.grad(x_list, args)                     # V_a, (d, S)
    hess = artifact.geometry.hesse(x_list, args).permute(2, 0, 1)  # V_{;ab}
    riem = artifact.geometry.riemann(x_list, args)         # (d, d, d, d, S)

    chi_s = chi.T                                          # (S, d) upper
    chi_lo = torch.einsum("sbc,sc->sb", g, chi_s)          # χ_b
    grad_s = grad.T                                        # V_b, (S, d)
    grad_up = torch.einsum("sab,sb->sa", ginv, grad_s)     # V^a

    m = torch.einsum("sac,scb->sab", ginv, hess)           # V^a_{;b}
    m = m - torch.einsum("aklbs,sk,sl->sab", riem, chi_s, chi_s)
    m = m + (3.0 - eps_pts)[:, None, None] * torch.einsum(
        "sa,sb->sab", chi_s, chi_lo
    )
    m = m + (
        torch.einsum("sa,sb->sab", grad_up, chi_lo)
        + torch.einsum("sa,sb->sab", chi_s, grad_s)
    ) / h_pts[:, None, None]
    return m / (h_pts * h_pts)[:, None, None]


def _gamma_u(artifact, args, x_pts, u_pts):
    """Transport matrix (Γ^a_{bc} u^b) at sample points → (S, d, d)."""
    d = artifact.n_fields
    gam = artifact.geometry.christoffels([x_pts[c] for c in range(d)], args)
    return torch.einsum("abcs,bs->sac", gam, u_pts)


def _pivot_setup(
    artifact, args, rows, times, pivots, N_margin_start, N_margin_end,
    N_sub, N_dense, dense_steps, tail_steps, device, n_before_end=None,
):
    """Shared linear-perturbation setup for the mode and transport routes.

    Places the pivots, builds the per-pivot two-phase e-fold grids, samples
    every ODE coefficient (Γu, M/H², 3−ε, (k/aH)²) at the grid nodes and
    midpoints, constructs the unit-amplitude Bunch-Davies initial state on
    the vielbein, and exposes a ``surface(targets)`` sampler for read-out
    surfaces.  Both routes integrate the SAME coefficient streams — their
    agreement tests only the integrators.

    The background samples (``np.interp``) and the grids are host numpy;
    ``gam_*``, ``c_*`` ((K, S[+1], d, d)) and ``state0`` ((K, 4, d, d))
    are tensors on ``device``; ``fric_*``, ``y2_*``, ``dts`` and
    ``state0_t`` ((K, 4)) stay numpy until :func:`_ms_streams` /
    :func:`_tr_streams` place them."""
    d = artifact.n_fields
    rows, times, hubble, eps_h, n_axis, i_end, n_end, h_ref = _base_quantities(
        artifact, args, rows, times, device
    )
    span = slice(0, i_end + 1)
    n_span = n_axis[span]
    a_t = _tensor(args, device)

    if float(N_margin_start) < float(N_sub) + 0.25:
        raise ValueError(
            f"N_margin_start ({N_margin_start}) must be at least "
            f"N_sub + 0.25 ({float(N_sub) + 0.25}) so the Bunch-Davies "
            "initialization has tabulated background before the first pivot"
        )
    if float(N_margin_end) < float(N_dense) + 0.25:
        raise ValueError(
            f"N_margin_end ({N_margin_end}) must be at least "
            f"N_dense + 0.25 ({float(N_dense) + 0.25}) so every pivot's "
            "dense phase ends before the ζ read-out surface (np.interp "
            "would silently clamp the ODE coefficients past the table)"
        )
    n_pivots = _dn_pivot_efolds(
        n_axis, n_end, pivots, N_margin_start, N_margin_end, n_before_end
    )
    pivots = len(n_pivots)
    n_stop = n_end - 0.25  # common final surface (ζ read-out)

    def interp(col, targets):
        return np.interp(targets, n_span, col[span])

    h_star = interp(hubble, n_pivots)
    ln_k = n_pivots + np.log(h_star)
    k_phys = np.exp(ln_k)

    # per-pivot two-phase e-fold grids (K, S+1 nodes); node index
    # ``dense_steps`` is exactly N_* + N_dense (the crossing surface)
    grids = []
    for p in range(int(pivots)):
        dense = np.linspace(n_pivots[p] - N_sub, n_pivots[p] + N_dense,
                            int(dense_steps) + 1)
        tail = np.linspace(n_pivots[p] + N_dense, n_stop,
                           int(tail_steps) + 1)[1:]
        grids.append(np.concatenate([dense, tail]))
    grids = np.asarray(grids)                              # (K, S+1)
    mids = 0.5 * (grids[:, :-1] + grids[:, 1:])            # (K, S)
    dts = np.diff(grids, axis=1)                           # (K, S)

    # background samples at every node and midpoint, all pivots at once:
    # interpolated on the host, the model and geometry on the device
    def samples(targets):
        flat = targets.ravel()
        x = np.stack([interp(rows[:, c], flat) for c in range(d)])
        u = np.stack([
            interp(rows[:, d + c], flat) for c in range(d)
        ])
        hh = interp(hubble, flat)
        u = u / hh                                          # u = χ/H
        ee = interp(eps_h, flat)
        x_t, u_t = _tensor(x, device), _tensor(u, device)
        gam = _gamma_u(artifact, a_t, x_t, u_t)
        cmat = _mass_matrix_over_h2(artifact, a_t, x_t, u_t,
                                    _tensor(hh, device), _tensor(ee, device))
        shape = targets.shape
        return (
            gam.reshape(shape + (d, d)),
            cmat.reshape(shape + (d, d)),
            (3.0 - ee).reshape(shape),
            hh.reshape(shape),
        )

    gam_n, c_n, fric_n, h_n = samples(grids)               # nodes (K, S+1, …)
    gam_m, c_m, fric_m, h_m = samples(mids)                # midpoints (K, S, …)

    # y² = (k/aH)² at nodes and midpoints
    y2_n = (k_phys[:, None] * np.exp(-grids) / h_n) ** 2
    y2_m = (k_phys[:, None] * np.exp(-mids) / h_m) ** 2

    # Bunch-Davies initial conditions on the vielbein at the first node, at
    # unit amplitude: the ODE is linear, so the true amplitude
    # 1/(a₀√(2k)) is folded into the read-out, where k³·amp² =
    # k²/(2a₀²) = (H_* e^{N_sub})²/2 analytically (the JAX package's
    # normalization, which keeps the TPU's emulated f64 in range)
    x0 = np.stack([interp(rows[:, c], grids[:, 0]) for c in range(d)])
    basis0 = artifact.basis([_tensor(x0[c], device) for c in range(d)], a_t)
    y0 = np.sqrt(y2_n[:, 0])
    y0_t = _tensor(y0, device)
    q_r0 = basis0.permute(2, 0, 1)                         # (K, i, a)
    q_i0 = torch.zeros_like(q_r0)
    dq_r0 = -q_r0                                          # d/dN of BD mode
    dq_i0 = -y0_t[:, None, None] * q_r0
    # covariant P = dQ/dN + (Γu) Q
    p_r0 = dq_r0 + torch.einsum("kac,kic->kia", gam_n[:, 0], q_r0)
    p_i0 = dq_i0 + torch.einsum("kac,kic->kia", gam_n[:, 0], q_i0)
    state0 = torch.stack([q_r0, q_i0, p_r0, p_i0], 1)      # (K, 4, i, a)
    state0_t = np.stack(
        [np.ones_like(y0), np.zeros_like(y0), -np.ones_like(y0), -y0], axis=1
    )                                                      # (K, 4)

    # k³·amp² = (H_* e^{N_sub})²/2 with amp = 1/(a₀√(2k)), a₀ = e^{N*−N_sub}
    k3_amp2 = 0.5 * (h_star * np.exp(float(N_sub))) ** 2
    norm = k3_amp2 / (2.0 * np.pi**2)

    def surface(targets):
        """Read-out surface data at per-pivot e-fold targets (K,):
        returns (g (K,d,d), χ (d,K), H (K,), ε_H (K,)), numpy."""
        x_f = np.stack([interp(rows[:, c], targets) for c in range(d)])
        chi_f = np.stack([interp(rows[:, d + c], targets) for c in range(d)])
        h_f = interp(hubble, targets)
        eps_f = interp(eps_h, targets)
        g_f = np.moveaxis(_host(artifact.metric(
            [_tensor(x_f[c], device) for c in range(d)], a_t)), -1, 0)
        return g_f, chi_f, h_f, eps_f

    return types.SimpleNamespace(
        d=d, device=device, n_pivots=n_pivots, h_star=h_star, ln_k=ln_k,
        grids=grids, mids=mids, dts=dts, gam_n=gam_n, c_n=c_n,
        fric_n=fric_n, gam_m=gam_m, c_m=c_m, fric_m=fric_m, y2_n=y2_n,
        y2_m=y2_m, state0=state0, state0_t=state0_t, norm=norm,
        surface=surface,
    )


def _sigma_readout(sigma_qq, g, chi, h, eps, norm):
    """Gauge read-outs from the field-field correlation matrix Σ_QQ^{ab}.

    ``sigma_qq`` (K, d, d) is Σ_i Re[Q^a Q^b*] in the unit-amplitude
    normalization (fold ``norm`` back in here); returns
    ``(P_ζ, P_iso, cos Δ, C_ζS)`` with the ζ–S pieces NaN unless d == 2.
    The mode route's per-realization read-out and this matrix form are
    algebraically identical (Σ_i |χ_a Q^a_i|² = χ_a χ_b Σ^{ab} etc.).
    Host numpy."""
    kk = sigma_qq.shape[0]
    chi_t = chi.T                                          # (K, d)
    chi_lo = np.einsum("kab,kb->ka", g, chi_t)             # χ_a
    chi2 = np.einsum("ka,ka->k", chi_lo, chi_t)            # |χ|²
    zz = np.einsum("ka,kab,kb->k", chi_lo, sigma_qq, chi_lo)
    p_zeta = norm * zz / (2.0 * eps * h) ** 2
    s_norm = h / np.sqrt(chi2)                             # H/|χ|
    tr_g = np.einsum("kab,kab->k", g, sigma_qq)            # g_ab Σ^{ab}
    q_s2 = np.maximum(tr_g - zz / chi2, 0.0)
    p_iso = norm * s_norm**2 * q_s2
    cos_delta = np.full(kk, np.nan)
    c_zs = np.full(kk, np.nan)
    if sigma_qq.shape[-1] == 2:
        # signed entropic direction s^a = ε^{ab} σ_b (contravariant
        # Levi-Civita, [[0,1],[−1,0]]/√detG) — G-orthonormal to σ̂ and
        # CONTINUOUS along the trajectory
        sig_lo = chi_lo / np.sqrt(chi2)[:, None]           # σ_b, (K, 2)
        detg = np.linalg.det(g)                            # (K,)
        s_up = np.stack(
            [sig_lo[:, 1], -sig_lo[:, 0]], axis=1
        ) / np.sqrt(detg)[:, None]
        s_lo = np.einsum("kab,kb->ka", g, s_up)
        c_zs = norm * s_norm * np.einsum(
            "ka,kab,kb->k", s_lo, sigma_qq, chi_lo
        ) / (2.0 * eps * h)
        with np.errstate(invalid="ignore", divide="ignore"):
            cos_delta = c_zs / np.sqrt(p_zeta * p_iso)
    return p_zeta, p_iso, cos_delta, c_zs


def _mode_readout(t, final, final_t):
    """The mode route's spectra for one parameter set from its integrated
    scalar (K, 4, i, a) and tensor (K, 4) end states (host numpy)."""
    # ζ/S read-out on the common end surface via the correlation matrix
    # Σ_QQ^{ab} = Σ_i (Re Q^a Re Q^b + Im Q^a Im Q^b) — algebraically the
    # per-realization sums, shared with the transport route
    sigma_qq = (
        np.einsum("kia,kib->kab", final[:, 0], final[:, 0])
        + np.einsum("kia,kib->kab", final[:, 1], final[:, 1])
    )
    g_f, chi_f, h_f, eps_f = t.surface(t.grids[:, -1])
    p_zeta, p_iso, cos_delta, _ = _sigma_readout(
        sigma_qq, g_f, chi_f, h_f, eps_f, t.norm
    )
    # exact tensor spectrum from the massless-mode integration
    p_tens = 8.0 * t.norm * (final_t[:, 0] ** 2 + final_t[:, 1] ** 2)
    n_s, n_t, alpha_s = _tilts(p_zeta, p_tens, t.ln_k)
    return {
        "ln_k": t.ln_k,
        "N": t.n_pivots,
        "P_zeta": p_zeta,
        "P_tensor": p_tens,
        "P_iso": p_iso,
        "cos_delta": cos_delta,
        "n_s": n_s,
        "n_t": n_t,
        "alpha_s": alpha_s,
        "r": p_tens / p_zeta,
        "H": t.h_star,
    }


def mode_spectrum(
    artifact,
    args,
    rows,
    times,
    *,
    pivots: int = 12,
    N_margin_start: float = 5.0,
    N_margin_end: float = 5.0,
    N_sub: float = 4.0,
    N_dense: float = 2.0,
    dense_steps: int = 4000,
    tail_steps: int = 1500,
    mesh=None,
    pivot_axis: str | None = None,
    pivot_N_before_end=None,
    device="cuda",
) -> dict:
    """Scalar power spectrum by direct Mukhanov-Sasaki mode integration.

    For each pivot k = aH|_* the coupled gauge-invariant field perturbations
    Q^a (spatially flat gauge) are evolved in e-fold time through horizon
    crossing,

        D_N² Q^a + (3 − ε) D_N Q^a + (k/aH)² Q^a + (M^a_b/H²) Q^b = 0,

    with D_N the covariant derivative along the trajectory
    (:func:`_gamma_u`), M the standard mass matrix incl. the Riemann term
    (:func:`_mass_matrix_over_h2`), Bunch-Davies initial conditions
    ``N_sub`` e-folds inside the horizon seeded on the model's orthonormal
    vielbein (d independent realizations), and

        P_ζ(k) = (k³/2π²) Σ_i |χ_a Q^a_(i) / (2 ε H)|²

    evaluated on the common read-out surface N_end − 0.25, so
    super-horizon evolution (multi-field entropic feeding) is included
    exactly as the δN route counts it.  All pivots integrate together:
    one torch RK4 loop over the steps on ``device``, batched over the
    pivots, on a two-phase e-fold grid — ``dense_steps`` sub-horizon steps
    over [N_* − N_sub, N_* + N_dense] resolving the oscillations,
    ``tail_steps`` super-horizon steps to the end surface.  The ODE
    coefficients are real, so the complex modes ride as two real systems
    sharing one coefficient stream.

    Returns the same dict layout as :func:`delta_n_spectrum` (without
    ``N_grad``), plus: ``P_tensor`` EXACT here (8 × a canonically-normalized
    massless scalar integrated through crossing) with ``n_t`` its
    centered-difference tilt; ``alpha_s`` the scalar running d n_s/d ln k
    (three-point second difference; NaN at the ends); ``P_iso`` the
    isocurvature spectrum (S = (H/|χ|)·Q_s); ``cos_delta`` the ζ–S
    correlation cosine (two-field models only; NaN otherwise).

    Accuracy budget: massless Bunch-Davies truncation ~1/y₀² ≈ 3·10⁻⁴ at
    the default ``N_sub=4`` plus RK4 phase error ~10⁻³ at the default step
    counts — agreement with δN to ~1% is the validated envelope.
    ``mesh=`` splits the pivots over the mesh axis ``pivot_axis`` (default
    its first); see the module's docstring.
    """
    device = _placement(mesh, device)
    t = _pivot_setup(
        artifact, args, rows, times, pivots, N_margin_start, N_margin_end,
        N_sub, N_dense, dense_steps, tail_steps, device,
        n_before_end=pivot_N_before_end,
    )
    streams, streams_t = _ms_streams(t)
    state0_t = _tensor(t.state0_t, device)
    # scalar modes (K, 4, i, a); tensor modes: each polarization is a
    # canonically-normalized massless scalar (no Γ, no mass matrix), P_T =
    # 8 · P_massless
    final, final_t = _pivot_shards(mesh, pivot_axis, t.state0.shape[0], lambda idx, dev: (
        _ms_integrate(_pick(t.state0, 0, idx, dev), _pick(streams, 1, idx, dev)),
        _ms_integrate_t(_pick(state0_t, 0, idx, dev), _pick(streams_t, 1, idx, dev)),
    ))
    return _mode_readout(t, final, final_t)


def _step_major(value, device, trailing=0):
    """A (K, S, …) stream, tensor or numpy, as a contiguous step-major
    (S, K, …) float64 tensor on ``device`` with ``trailing`` unit axes."""
    t = value if torch.is_tensor(value) else _tensor(value, device)
    t = t.reshape(t.shape + (1,) * trailing)
    return t.movedim(1, 0).contiguous()


def _ms_streams(t):
    """The scalar- and tensor-mode coefficient streams of one
    :func:`_pivot_setup` result, in the argument order of
    :func:`_ms_integrate` / :func:`_ms_integrate_t`: step-major tensors on
    the setup's device, nodes (S+1, K, …) and midpoints/steps (S, K, …),
    Γ and M transposed for the row-vector products (the sweep concatenates
    several setups' streams along the pivot axis, dim 1)."""
    dev = t.device
    streams = (
        _step_major(t.gam_n.transpose(-1, -2), dev),
        _step_major(t.c_n.transpose(-1, -2), dev),
        _step_major(t.fric_n, dev, 2), _step_major(t.y2_n, dev, 2),
        _step_major(t.gam_m.transpose(-1, -2), dev),
        _step_major(t.c_m.transpose(-1, -2), dev),
        _step_major(t.fric_m, dev, 2), _step_major(t.y2_m, dev, 2),
        _step_major(t.dts, dev, 2),
    )
    streams_t = (
        _step_major(-t.fric_n, dev, 1), _step_major(t.y2_n, dev, 1),
        _step_major(-t.fric_m, dev, 1), _step_major(t.y2_m, dev, 1),
        _step_major(t.dts, dev, 1),
    )
    return streams, streams_t


def _sweep_validate(on_failure, N_margin_start, N_margin_end, N_sub,
                    N_dense):
    """Configuration-level validation shared by mode_sweep and
    transport_sweep — these raise regardless of ``on_failure`` (they would
    otherwise NaN-fill every set of a misconfigured sweep)."""
    if on_failure not in ("raise", "nan"):
        raise ValueError(
            f"on_failure must be 'raise' or 'nan', got {on_failure!r}"
        )
    if float(N_margin_start) < float(N_sub) + 0.25:
        raise ValueError(
            f"N_margin_start ({N_margin_start}) must be at least "
            f"N_sub + 0.25 ({float(N_sub) + 0.25}) so the Bunch-Davies "
            "initialization has tabulated background before the first pivot"
        )
    if float(N_margin_end) < float(N_dense) + 0.25:
        raise ValueError(
            f"N_margin_end ({N_margin_end}) must be at least "
            f"N_dense + 0.25 ({float(N_dense) + 0.25}) so every pivot's "
            "dense phase ends before the ζ read-out surface"
        )


def _sweep_base_setups(
    artifact, pars, fields_init, derivatives_init, *,
    steps, max_err, solver, device, on_failure,
    pivots, N_margin_start, N_margin_end, N_sub, N_dense,
    dense_steps, tail_steps, n_before_end=None, mesh=None,
):
    """Shared sweep preamble of mode_sweep/transport_sweep: validate the
    parameter batch, solve every base trajectory in ONE batched solve
    (one launch of kernel B6 on a CUDA device, one a slot with a ``mesh``),
    and run
    :func:`_pivot_setup` per set with failure isolation.  Returns
    ``(pars, setups, failures)`` — a failed set has ``setups[s] = None``
    and its reason in ``failures[s]`` (or raised, under
    ``on_failure="raise"``, with the set index in the message)."""
    d = artifact.n_fields
    pars = np.asarray(pars, dtype=float)
    if pars.ndim == 1:
        pars = pars[None]
    if pars.ndim != 2 or pars.shape[1] != artifact.n_parameters:
        raise ShapeError(
            (-1, artifact.n_parameters), pars.shape,
            "sweep parameters must be (S, n_parameters)",
        )
    S = pars.shape[0]
    f0b = np.broadcast_to(np.asarray(fields_init, dtype=float), (S, d)).copy()
    chi0b = np.broadcast_to(np.asarray(derivatives_init, dtype=float), (S, d)).copy()
    rows_base, times_base = background.solve_eom_batch(
        artifact, pars, int(steps), f0b, chi0b,
        max_err=max_err, solver=solver, return_time=True, device=device, **_mesh_kw(mesh),
    )

    setups = [None] * S
    failures = [None] * S
    for s_i in range(S):
        try:
            setups[s_i] = _pivot_setup(
                artifact, pars[s_i], rows_base[s_i], times_base[s_i],
                pivots, N_margin_start, N_margin_end,
                N_sub, N_dense, dense_steps, tail_steps, device,
                n_before_end=n_before_end,
            )
        except ValueError as e:
            if on_failure == "raise":
                raise ValueError(f"parameter set {s_i}: {e}") from e
            failures[s_i] = str(e)
    return pars, setups, failures


def _sweep_stack(outs, failures, keys, pivots, name):
    """Stack per-set result dicts into (S, pivots) arrays with NaN rows for
    failed sets, the ``ok`` mask, and the one-shot warning."""
    S = len(outs)
    out = {
        key: np.stack([
            outs[s_i][key] if outs[s_i] is not None
            else np.full((int(pivots),), np.nan)
            for s_i in range(S)
        ])
        for key in keys
    }
    out["ok"] = np.array([outs[s_i] is not None for s_i in range(S)])
    out["failures"] = failures
    n_fail = int(S - out["ok"].sum())
    if n_fail:
        first = int(np.nonzero(~out["ok"])[0][0])
        log_warn(
            f"{name}: {n_fail}/{S} parameter sets failed and were "
            f"NaN-filled — first: set {first}: {failures[first]}"
        )
    return out


_MODE_KEYS = ["ln_k", "N", "P_zeta", "P_tensor", "P_iso", "cos_delta",
              "n_s", "n_t", "alpha_s", "r", "H"]


def mode_sweep(
    artifact,
    pars,
    fields_init,
    derivatives_init,
    *,
    steps: int = 4000,
    max_err: float = 1e-8,
    solver: str = "rkf",
    pivots: int = 12,
    N_margin_start: float = 5.0,
    N_margin_end: float = 5.0,
    N_sub: float = 4.0,
    N_dense: float = 2.0,
    dense_steps: int = 4000,
    tail_steps: int = 1500,
    mesh=None,
    pivot_axis: str | None = None,
    on_failure: str = "raise",
    pivot_N_before_end=None,
    device="cuda",
) -> dict:
    """Mukhanov-Sasaki spectra for a batch of parameter sets.

    The linear-theory counterpart of :func:`delta_n_sweep`: for every
    parameter set in ``pars`` ((S, k); initial conditions (d,) shared or
    (S, d) per-set) the sweep solves the base background — ALL sets in one
    batched solve — then integrates the coupled scalar modes and the
    massless tensor modes of EVERY pivot of EVERY set in one torch RK4 loop
    each (the per-set coefficient streams concatenate along the pivot
    axis).

    Same per-set failure semantics as :func:`delta_n_sweep`
    (``on_failure="raise"`` names the set; ``"nan"`` NaN-fills it, flags
    it in ``ok``/``failures``, and warns once).  Returns the
    :func:`mode_spectrum` dict with a leading S axis plus ``ok`` and
    ``failures``.
    """
    _sweep_validate(on_failure, N_margin_start, N_margin_end, N_sub, N_dense)
    device = _placement(mesh, device)
    if pivot_N_before_end is not None:
        pivots = len(np.atleast_1d(pivot_N_before_end))
    pars, setups, failures = _sweep_base_setups(
        artifact, pars, fields_init, derivatives_init,
        steps=steps, max_err=max_err, solver=solver, device=device,
        on_failure=on_failure, pivots=pivots,
        N_margin_start=N_margin_start, N_margin_end=N_margin_end,
        N_sub=N_sub, N_dense=N_dense,
        dense_steps=dense_steps, tail_steps=tail_steps,
        n_before_end=pivot_N_before_end, mesh=mesh,
    )
    S = pars.shape[0]
    valid = [s_i for s_i in range(S) if setups[s_i] is not None]
    outs = [None] * S
    if valid:
        # one scalar-mode loop and one tensor-mode loop for the whole
        # sweep: per-set streams concatenate along the pivot axis
        streams = [_ms_streams(setups[s_i]) for s_i in valid]
        per_step = tuple(torch.cat(parts, 1)
                         for parts in zip(*[st[0] for st in streams]))
        per_step_t = tuple(torch.cat(parts, 1)
                           for parts in zip(*[st[1] for st in streams]))
        state0 = torch.cat([setups[s_i].state0 for s_i in valid])
        state0_t = _tensor(np.concatenate([setups[s_i].state0_t for s_i in valid]), device)
        # (ΣK, 4, i, a) and (ΣK, 4)
        final, final_t = _pivot_shards(mesh, pivot_axis, state0.shape[0], lambda idx, dev: (
            _ms_integrate(_pick(state0, 0, idx, dev), _pick(per_step, 1, idx, dev)),
            _ms_integrate_t(_pick(state0_t, 0, idx, dev), _pick(per_step_t, 1, idx, dev)),
        ))
        for v, s_i in enumerate(valid):
            sl = slice(v * int(pivots), (v + 1) * int(pivots))
            outs[s_i] = _mode_readout(setups[s_i], final[sl], final_t[sl])
    return _sweep_stack(outs, failures, _MODE_KEYS, pivots, "mode_sweep")


def _tilts(p_zeta, p_tens, ln_k):
    """Centered-difference tilts (n_s, n_t) and scalar running α_s
    (three-point second difference, nonuniform-grid form); NaN at the
    ends."""
    kk = len(ln_k)
    n_s = np.full(kk, np.nan)
    n_t = np.full(kk, np.nan)
    alpha_s = np.full(kk, np.nan)
    if kk >= 3:
        ln_p = np.log(p_zeta)
        ln_pt = np.log(p_tens)
        n_s[1:-1] = 1.0 + (ln_p[2:] - ln_p[:-2]) / (ln_k[2:] - ln_k[:-2])
        n_t[1:-1] = (ln_pt[2:] - ln_pt[:-2]) / (ln_k[2:] - ln_k[:-2])
        dk0 = ln_k[1:-1] - ln_k[:-2]
        dk1 = ln_k[2:] - ln_k[1:-1]
        alpha_s[1:-1] = 2.0 * (
            (ln_p[2:] - ln_p[1:-1]) / dk1 - (ln_p[1:-1] - ln_p[:-2]) / dk0
        ) / (dk0 + dk1)
    return n_s, n_t, alpha_s


# ----------------------------------------------------------------------- #
# Moment-transport integration                                             #
# ----------------------------------------------------------------------- #


def _u_matrix(gam, cmat, fric, y2):
    """Phase-space transport matrix u^A_B for X = (Q^a, P^a):

        dQ = P − (Γu) Q
        dP = −(Γu) P − (3−ε) P − (k/aH)² Q − (M/H²) Q

    ``gam``/``cmat`` (..., d, d), ``fric``/``y2`` (...) tensors → u
    (..., 2d, 2d) on their device.  The SAME dynamics as :func:`_ms_rhs`
    in first-order form — the mode and transport routes integrate one u."""
    d = gam.shape[-1]
    eye = torch.eye(d, dtype=gam.dtype, device=gam.device).expand(gam.shape)
    top = torch.cat([-gam, eye], -1)
    bot = torch.cat(
        [-(y2[..., None, None] * eye + cmat),
         -fric[..., None, None] * eye - gam],
        -1,
    )
    return torch.cat([top, bot], -2)


def _tr_rhs(sig, u):
    """dΣ/dN = u Σ + Σ uᵀ (Σ symmetric ⇒ uΣ + (uΣ)ᵀ)."""
    us = torch.bmm(u, sig)
    return us + us.transpose(-2, -1)


def _tr_integrate(sig0, u_n, u_m, dts, start, stop):
    """RK4 on the covariance transport of every pivot over steps
    [start, stop) of the step-major streams: nodes ``u_n`` (S+1, K, m, m),
    midpoints ``u_m`` (S, K, m, m), ``dts`` (S, K, 1, 1)."""
    half, sixth = 0.5 * dts, dts / 6.0
    sig = sig0
    for s in range(start, stop):
        k1 = _tr_rhs(sig, u_n[s])
        k2 = _tr_rhs(sig + half[s] * k1, u_m[s])
        k3 = _tr_rhs(sig + half[s] * k2, u_m[s])
        k4 = _tr_rhs(sig + dts[s] * k3, u_n[s + 1])
        sig = sig + sixth[s] * (k1 + 2 * k2 + 2 * k3 + k4)
    return sig


def _tr_streams(t):
    """Transport u-matrices of one :func:`_pivot_setup` result, step-major
    on its device: the scalar phase-space u at the nodes (S+1, K, 2d, 2d)
    and midpoints (S, K, 2d, 2d), the massless tensor-block u's (…, 2, 2),
    and the steps (S, K, 1, 1)."""
    dev = t.device
    fric_n, fric_m = _tensor(t.fric_n, dev), _tensor(t.fric_m, dev)
    y2_n, y2_m = _tensor(t.y2_n, dev), _tensor(t.y2_m, dev)
    zeros_n = torch.zeros(fric_n.shape + (1, 1), dtype=fric_n.dtype, device=dev)
    zeros_m = zeros_n[:, 1:]
    return (
        _step_major(_u_matrix(t.gam_n, t.c_n, fric_n, y2_n), dev),
        _step_major(_u_matrix(t.gam_m, t.c_m, fric_m, y2_m), dev),
        _step_major(_u_matrix(zeros_n, zeros_n, fric_n, y2_n), dev),
        _step_major(_u_matrix(zeros_m, zeros_m, fric_m, y2_m), dev),
        _step_major(t.dts, dev, 2),
    )


def _tr_sigma0(t):
    """Σ(N₀) for the scalar and tensor transport from the same
    unit-amplitude BD mode matrix (state0 = (K, 4, i, a) → X columns), on
    the setup's device."""
    x_r = torch.cat([t.state0[:, 0], t.state0[:, 2]], -1)
    x_i = torch.cat([t.state0[:, 1], t.state0[:, 3]], -1)
    sig0 = (
        torch.einsum("kiA,kiB->kAB", x_r, x_r)
        + torch.einsum("kiA,kiB->kAB", x_i, x_i)
    )                                                      # (K, 2d, 2d)
    st = _tensor(t.state0_t, t.device)
    xt_r = torch.stack([st[:, 0], st[:, 2]], -1)[:, None]
    xt_i = torch.stack([st[:, 1], st[:, 3]], -1)[:, None]
    sig0_t = (
        torch.einsum("kiA,kiB->kAB", xt_r, xt_r)
        + torch.einsum("kiA,kiB->kAB", xt_i, xt_i)
    )                                                      # (K, 2, 2)
    return sig0, sig0_t


def _tr_integrate_all(ds, streams, sig0, sig0_t):
    """The transport route's three integrations: the scalar Σ over the
    dense segment (→ crossing surface), its continuation over the tail
    (→ end surface), and the massless tensor block.  ``streams`` are
    :func:`_tr_streams`' (possibly sweep-concatenated along the pivot axis,
    dim 1); returns the tensors (Σ*, Σ_end, Σ_T) on their device."""
    u_n, u_m, u_t_n, u_t_m, dts = streams
    n_steps = dts.shape[0]
    sig_star = _tr_integrate(sig0, u_n, u_m, dts, 0, ds)
    sig_end = _tr_integrate(sig_star, u_n, u_m, dts, ds, n_steps)
    sig_t = _tr_integrate(sig0_t, u_t_n, u_t_m, dts, 0, n_steps)
    return sig_star, sig_end, sig_t


def _transport_readout(t, sig_star, sig_end, sig_t, d, ds):
    """Spectra + Wands transfer functions from the integrated Σ blocks of
    one parameter set (``t`` its pivot setup; ``sig_star``/``sig_end`` the
    scalar Σ on the crossing/end surfaces, ``sig_t`` the tensor Σ)."""
    qq_end = sig_end[:, :d, :d]
    g_f, chi_f, h_f, eps_f = t.surface(t.grids[:, -1])
    p_zeta, p_iso, cos_delta, c_zs_end = _sigma_readout(
        qq_end, g_f, chi_f, h_f, eps_f, t.norm
    )
    qq_star = sig_star[:, :d, :d]
    g_s, chi_s, h_s, eps_s = t.surface(t.grids[:, ds])
    p_zeta_star, p_iso_star, _, _ = _sigma_readout(
        qq_star, g_s, chi_s, h_s, eps_s, t.norm
    )

    with np.errstate(invalid="ignore", divide="ignore"):
        t_ss = np.sqrt(p_iso / p_iso_star)
        # correlation-based T_RS = C_ζS(end)/(T_SS·P_S*) where the entropic
        # mode survives to the end surface; where it has fully decayed
        # (double-inflation-style transitions: T_SS → 0 makes the ratio
        # 0/0) fall back to the growth-based magnitude
        # √((P_ζ(end) − P_ζ*)/P_S*) — the sign is unobservable once S has
        # died (only T_RS² enters P_ζ), reported positive
        corr = c_zs_end / (t_ss * p_iso_star)
        growth = np.sqrt(
            np.maximum(p_zeta - p_zeta_star, 0.0) / p_iso_star
        )
        alive = p_iso > 1e-16 * p_zeta
        t_rs = np.where(alive & np.isfinite(corr), corr, growth)

    p_tens = 8.0 * t.norm * sig_t[:, 0, 0]
    n_s, n_t, alpha_s = _tilts(p_zeta, p_tens, t.ln_k)
    return {
        "ln_k": t.ln_k,
        "N": t.n_pivots,
        "P_zeta": p_zeta,
        "P_tensor": p_tens,
        "P_iso": p_iso,
        "cos_delta": cos_delta,
        "n_s": n_s,
        "n_t": n_t,
        "alpha_s": alpha_s,
        "r": p_tens / p_zeta,
        "H": t.h_star,
        "T_RS": t_rs,
        "T_SS": t_ss,
        "P_zeta_star": p_zeta_star,
        "P_iso_star": p_iso_star,
    }


def transport_spectrum(
    artifact,
    args,
    rows,
    times,
    *,
    pivots: int = 12,
    N_margin_start: float = 5.0,
    N_margin_end: float = 5.0,
    N_sub: float = 4.0,
    N_dense: float = 2.0,
    dense_steps: int = 4000,
    tail_steps: int = 1500,
    mesh=None,
    pivot_axis: str | None = None,
    pivot_N_before_end=None,
    device="cuda",
) -> dict:
    """Scalar/tensor spectra by moment transport (the PyTransport-style
    third route): instead of integrating mode realizations, evolve the full
    phase-space correlation matrix

        Σ^{AB}(k, N) = Σᵢ Re⟨X^A X^B⟩,   X = (Q^a, P^a),
        dΣ/dN = u Σ + Σ uᵀ,

    with the SAME covariant transport matrix u (Γu, mass matrix M/H²,
    friction 3−ε, (k/aH)²) the Mukhanov-Sasaki route uses — agreement
    between :func:`mode_spectrum` and this function tests only the two
    integrators.  Bunch-Davies initial conditions, pivot placement,
    read-out surfaces and the returned dict all match
    :func:`mode_spectrum`.

    What transport adds over the mode route: Σ is read out on TWO
    surfaces — shortly after crossing (N_* + ``N_dense``) and at the end
    of inflation — which yields the Wands et al. (astro-ph/0205253)
    super-horizon transfer functions (ζ(N_end) = ζ_* + T_RS S_*,
    S(N_end) = T_SS S_*): ``T_SS = √(P_S(end)/P_S(*))`` and ``T_RS =
    C_ζS(end)/(T_SS P_S(*))``; where the entropic mode has fully decayed
    (T_SS → 0), T_RS falls back to the growth-based magnitude
    ``√((P_ζ(end) − P_ζ*)/P_S*)`` with positive sign.  Extra keys:
    ``T_RS``, ``T_SS``, ``P_zeta_star``, ``P_iso_star`` (for d ≠ 2 T_RS is
    always the growth-based magnitude).  The three integrations (scalar
    dense segment, scalar tail, tensor block) are torch RK4 loops on
    ``device``.  ``mesh=`` splits the pivots over the mesh axis
    ``pivot_axis`` (default its first); see the module's docstring."""
    device = _placement(mesh, device)
    t = _pivot_setup(
        artifact, args, rows, times, pivots, N_margin_start, N_margin_end,
        N_sub, N_dense, dense_steps, tail_steps, device,
        n_before_end=pivot_N_before_end,
    )
    d = t.d
    ds = int(dense_steps)
    sig0, sig0_t = _tr_sigma0(t)
    streams = _tr_streams(t)
    sig_star, sig_end, sig_t = _pivot_shards(
        mesh, pivot_axis, sig0.shape[0], lambda idx, dev: _tr_integrate_all(
            ds, _pick(streams, 1, idx, dev), _pick(sig0, 0, idx, dev),
            _pick(sig0_t, 0, idx, dev)))
    return _transport_readout(t, sig_star, sig_end, sig_t, d, ds)


def transport_sweep(
    artifact,
    pars,
    fields_init,
    derivatives_init,
    *,
    steps: int = 4000,
    max_err: float = 1e-8,
    solver: str = "rkf",
    pivots: int = 12,
    N_margin_start: float = 5.0,
    N_margin_end: float = 5.0,
    N_sub: float = 4.0,
    N_dense: float = 2.0,
    dense_steps: int = 4000,
    tail_steps: int = 1500,
    mesh=None,
    pivot_axis: str | None = None,
    on_failure: str = "raise",
    pivot_N_before_end=None,
    device="cuda",
) -> dict:
    """Moment-transport spectra + Wands transfer functions for a batch of
    parameter sets.

    The survey form of :func:`transport_spectrum`, with the same batching
    plan as :func:`mode_sweep`: every base background solves in one
    batched solve, then the whole sweep's Σ evolution runs in three
    integrations in all (scalar dense segment, scalar tail segment, tensor
    block — per-set u-matrix streams concatenated along the pivot axis).
    Same per-set failure isolation as :func:`delta_n_sweep`.  Returns the
    :func:`transport_spectrum` dict (including ``T_RS``/``T_SS``/
    ``P_zeta_star``/``P_iso_star``) with a leading S axis plus ``ok`` and
    ``failures``.
    """
    _sweep_validate(on_failure, N_margin_start, N_margin_end, N_sub, N_dense)
    device = _placement(mesh, device)
    if pivot_N_before_end is not None:
        pivots = len(np.atleast_1d(pivot_N_before_end))
    pars, setups, failures = _sweep_base_setups(
        artifact, pars, fields_init, derivatives_init,
        steps=steps, max_err=max_err, solver=solver, device=device,
        on_failure=on_failure, pivots=pivots,
        N_margin_start=N_margin_start, N_margin_end=N_margin_end,
        N_sub=N_sub, N_dense=N_dense,
        dense_steps=dense_steps, tail_steps=tail_steps,
        n_before_end=pivot_N_before_end, mesh=mesh,
    )
    S = pars.shape[0]
    valid = [s_i for s_i in range(S) if setups[s_i] is not None]
    outs = [None] * S
    if valid:
        d = artifact.n_fields
        ds = int(dense_steps)
        streams = tuple(
            torch.cat(parts, 1)
            for parts in zip(*[_tr_streams(setups[s_i]) for s_i in valid])
        )
        sig0s = [_tr_sigma0(setups[s_i]) for s_i in valid]
        sig0 = torch.cat([a for a, _ in sig0s])
        sig0_t = torch.cat([b for _, b in sig0s])
        sig_star, sig_end, sig_t = _pivot_shards(
            mesh, pivot_axis, sig0.shape[0], lambda idx, dev: _tr_integrate_all(
                ds, _pick(streams, 1, idx, dev), _pick(sig0, 0, idx, dev),
                _pick(sig0_t, 0, idx, dev)))
        for v, s_i in enumerate(valid):
            sl = slice(v * int(pivots), (v + 1) * int(pivots))
            outs[s_i] = _transport_readout(
                setups[s_i], sig_star[sl], sig_end[sl], sig_t[sl], d, ds
            )

    keys = _MODE_KEYS + ["T_RS", "T_SS", "P_zeta_star", "P_iso_star"]
    return _sweep_stack(outs, failures, keys, pivots, "transport_sweep")
