"""Differentiable observables and fitting (``inflatox_torch.observables``)
against the JAX package's ``inflatox_tpu.observables``, on the CPU.

Every test of tests/test_observables.py has a counterpart here, run on the
port with ``device="cpu"``; the side-by-side comparisons put the same
seeded numpy inputs through both packages.  Models cross by the shared
bundle (the JAX package saves, the port loads).  The trajectory functions
read the **same rows**: the JAX package's RKF45 solves, fed to both, so
what differs is only the port's code; the port's own solver (kernel B6's
plain version on the CPU) runs once, for the end-to-end CMB workflow.
Tolerances, each with its reason:

* analytic values, finite differences and physics checks: the JAX test's
  own;
* the slow-roll maps against the JAX package: rtol 1e-12 (the same f64
  operations in the same order);
* ``observable_jacobian`` and ``fisher_matrix`` against ``jax.jacfwd``:
  rtol 1e-10 (forward-mode rounding differs from XLA's), as derivatives by
  each parameter's log, with a floor of 1e-12 of the observables' size for
  the directions the observables are blind to (both sides are rounding
  noise there);
* ``horizon_exit``, ``power_spectrum``, ``cobe_normalize``,
  ``n_star_matching`` and ``pivots_for_k`` on the same rows: rtol 1e-12;
* ``solve_eom_fixed``'s rows: rtol 1e-12 (both combine the RK4 stages as
  ``(dt·a)·k``, zero coefficients skipped); its gradient against
  ``jax.grad``: rtol 1e-9;
* ``fit_parameters`` with SGD against ``optax.sgd``: the whole history at
  rtol 1e-10, with a floor of 1e-12 of the first loss (near the minimum
  the loss is a difference of values that agree to ~1e-10, so one last bit
  moves it by ~1e-6 relative); the final parameters at rtol 1e-10; with Adam against ``optax.adam``, which rounds its bias
  corrections differently: the first 50 steps at rtol 1e-10 (later the loss
  reaches ~1e-20, where relative differences grow), the final parameters
  at atol 1e-6;
* S2's Jacobian (a special-function model, whose loops on data cannot run
  under ``vmap``) against central differences of the port's own
  ``slow_roll``: rtol 1e-6."""

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch import background as tbg
from inflatox_torch import observables as tob
from inflatox_torch.utils.errors import ShapeError
from inflatox_tpu import background as jbg
from inflatox_tpu import observables as job

ARGS = np.array([1.0, 0.7])  # m_1, m_2 of the trivial quadratic model
X = np.array([1.2, -0.8])
CPU = "cpu"
M = np.array([1.0, 1.0])


def _analytic_slow_roll(x, m):
    """Textbook values for V = (m1 x1)² + (m2 x2)² on a flat metric."""
    v = (m[0] * x[0]) ** 2 + (m[1] * x[1]) ** 2
    grad = np.array([2 * m[0] ** 2 * x[0], 2 * m[1] ** 2 * x[1]])
    eps = 0.5 * np.dot(grad, grad) / v**2
    hesse = np.diag([2 * m[0] ** 2, 2 * m[1] ** 2])
    sigma = grad / np.linalg.norm(grad)
    eta = sigma @ hesse @ sigma / v
    return eps, eta


def _port(jax_art, root, name):
    path = str(root / f"{name}.json")
    jax_art.save(path)
    return inflatox_torch.CompiledModel.load(path)


@pytest.fixture(scope="module")
def arts(trivial_artifact, doc_model_artifact, tmp_path_factory):
    """name → (JAX artifact, port artifact loaded from its bundle, args)."""
    root = tmp_path_factory.mktemp("observables_bundles")
    model, alpha_args = inflatox_tpu.models.alpha_attractor()
    alpha = inflatox_tpu.Compiler(model, silent=True).compile()
    return {
        "trivial": (trivial_artifact, _port(trivial_artifact, root, "trivial"), ARGS),
        "doc": (doc_model_artifact, _port(doc_model_artifact, root, "doc"), np.array([1.0])),
        "alpha_attractor": (alpha, _port(alpha, root, "alpha"), alpha_args),
    }


@pytest.fixture(scope="module")
def art(arts):
    """The port's trivial quadratic model."""
    return arts["trivial"][1]


def _jax_solve(jax_art, pars, steps, f0, max_err, d0=(0.0, 0.0)):
    return jbg.solve_eom(jax_art, pars, steps, list(f0), list(d0), max_err=max_err,
                         solver="rkf", return_time=True)


@pytest.fixture(scope="module")
def rows8(arts):
    """The JAX package's φ² axis trajectory (3000 rows, max_err 1e-8)."""
    return _jax_solve(arts["trivial"][0], M, 3000, (16.0, 0.0), 1e-8)


@pytest.fixture(scope="module")
def long_quadratic(arts):
    """φ² axis trajectory long enough (~64 e-folds) for CMB-scale N_*: the
    JAX package's solve (max_err 1e-9), read by the port."""
    rows, times = _jax_solve(arts["trivial"][0], M, 3000, (16.0, 0.0), 1e-9)
    return arts["trivial"][1], M, rows, times


# ----------------------------------------------------------------------- #
# the JAX package's tests, on the port                                      #
# ----------------------------------------------------------------------- #


def test_observables_match_analytic(art):
    sr = tob.slow_roll(art, device=CPU)(X, ARGS)
    eps_ref, eta_ref = _analytic_slow_roll(X, ARGS)
    np.testing.assert_allclose(float(sr["epsilon_v"]), eps_ref, rtol=1e-13)
    np.testing.assert_allclose(float(sr["eta_v"]), eta_ref, rtol=1e-13)
    np.testing.assert_allclose(float(sr["n_s"]), 1 - 6 * eps_ref + 2 * eta_ref, rtol=1e-13)
    np.testing.assert_allclose(float(sr["r"]), 16 * eps_ref, rtol=1e-13)
    # the standalone factories agree with the fused dict
    assert float(tob.epsilon_v(art, device=CPU)(X, ARGS)) == float(sr["epsilon_v"])
    assert float(tob.eta_v(art, device=CPU)(X, ARGS)) == float(sr["eta_v"])
    assert float(tob.spectral_index(art, device=CPU)(X, ARGS)) == float(sr["n_s"])
    assert float(tob.tensor_to_scalar(art, device=CPU)(X, ARGS)) == float(sr["r"])


def test_observable_gradients_vs_finite_differences(art):
    ns = tob.spectral_index(art, device=CPU)
    a = torch.tensor(ARGS, requires_grad=True)
    (g,) = torch.autograd.grad(ns(X, a), a)
    h = 1e-6
    for i in range(2):
        dp, dm = ARGS.copy(), ARGS.copy()
        dp[i] += h
        dm[i] -= h
        fd = (float(ns(X, dp)) - float(ns(X, dm))) / (2 * h)
        np.testing.assert_allclose(float(g[i]), fd, rtol=1e-6)


def test_observables_broadcast_over_grids(art):
    xs = [np.linspace(0.5, 2.0, 7), np.full(7, -0.8)]
    eps = tob.epsilon_v(art, device=CPU)(xs, ARGS)
    assert eps.shape == (7,)
    for j in range(7):
        ref, _ = _analytic_slow_roll([xs[0][j], xs[1][j]], ARGS)
        np.testing.assert_allclose(float(eps[j]), ref, rtol=1e-13)


def test_observable_jacobian_vs_finite_differences(art):
    jac = tob.observable_jacobian(art, keys=("n_s", "r"), device=CPU)
    J = jac(X, ARGS).numpy()
    assert J.shape == (2, 2)
    ns = tob.spectral_index(art, device=CPU)
    r_fn = tob.tensor_to_scalar(art, device=CPU)
    h = 1e-6
    for col in range(2):
        dp, dm = ARGS.copy(), ARGS.copy()
        dp[col] += h
        dm[col] -= h
        np.testing.assert_allclose(
            J[0, col], (float(ns(X, dp)) - float(ns(X, dm))) / (2 * h), rtol=1e-5, atol=1e-10)
        np.testing.assert_allclose(
            J[1, col], (float(r_fn(X, dp)) - float(r_fn(X, dm))) / (2 * h), rtol=1e-5,
            atol=1e-10)
    with pytest.raises(ValueError, match="unknown observable"):
        tob.observable_jacobian(art, keys=("n_s", "bogus"), device=CPU)


def test_fisher_matrix_properties(art):
    sigma = np.array([0.004, 0.01])  # Planck-ish 1-sigma on (n_s, r)
    F = tob.fisher_matrix(art, X, ARGS, sigma, device=CPU)
    assert isinstance(F, np.ndarray) and F.shape == (2, 2)
    np.testing.assert_allclose(F, F.T)  # symmetric
    evals = np.linalg.eigvalsh(F)
    assert evals.min() >= -1e-6 * abs(evals.max())  # PSD
    # slow-roll observables are invariant under V -> lambda*V, i.e. under
    # scaling both masses together: that direction must be unconstrained
    direction = ARGS / np.linalg.norm(ARGS)
    assert abs(direction @ F @ direction) < 1e-6 * abs(evals.max())
    # diagonal-sigma and explicit-covariance forms agree
    F2 = tob.fisher_matrix(art, X, ARGS, np.diag(sigma**2), device=CPU)
    np.testing.assert_allclose(F, F2, rtol=1e-12)
    with pytest.raises(ShapeError):
        tob.fisher_matrix(art, X, ARGS, np.ones(3), device=CPU)


def test_along_trajectory_and_horizon_exit(art, rows8):
    # single-field setup on the phi_1 axis: V = (m phi_1)^2 with m1=m2=1,
    # phi_2 = chi = 0 stays exactly on the axis.  Textbook large-field
    # analytics: eps_V = 2/phi^2, N(phi -> phi_end) = (phi^2 - phi_end^2)/4
    # with slow-roll phi_end = sqrt(2); n_s = 1 - 8/phi^2, r = 32/phi^2.
    rows, times = rows8
    phi0 = 16.0
    along = tob.along_trajectory(art, rows, M, device=CPU)
    assert set(along) == {"epsilon_v", "eta_v", "n_s", "r", "epsilon_h"}
    assert all(isinstance(v, np.ndarray) and v.shape == (3000,) for v in along.values())
    np.testing.assert_allclose(along["epsilon_v"][0], 2.0 / phi0**2, rtol=1e-12)
    assert along["epsilon_h"].max() >= 1.0, "inflation must end in the span"
    n_of_t = tbg.efolds(rows, times)
    attractor = (n_of_t > 5.0) & (n_of_t < 50.0)
    assert attractor.sum() > 10
    np.testing.assert_allclose(
        along["epsilon_h"][attractor], along["epsilon_v"][attractor], rtol=0.05)

    exit_info = tob.horizon_exit(art, rows, times, M, N_before_end=55.0, device=CPU)
    phi_star = np.sqrt(4 * 55.0 + 2.0)  # slow-roll prediction
    np.testing.assert_allclose(exit_info["x"][0], phi_star, rtol=0.02)
    np.testing.assert_allclose(exit_info["x"][1], 0.0, atol=1e-10)
    np.testing.assert_allclose(exit_info["N_end"], phi0**2 / 4 - 0.5, rtol=0.03)
    np.testing.assert_allclose(exit_info["n_s"], 1 - 8 / phi_star**2, atol=2e-3)
    np.testing.assert_allclose(exit_info["r"], 32 / phi_star**2, rtol=0.05)
    assert exit_info["N_exit"] == pytest.approx(exit_info["N_end"] - 55.0)


def test_horizon_exit_error_paths(arts, long_quadratic):
    jax_art, art, _ = arts["trivial"]
    # short integration deep in slow roll: inflation never ends
    rows, times = _jax_solve(jax_art, M, 50, (16.0, 0.0), 1e-8)
    with pytest.raises(ValueError, match="does not end"):
        tob.horizon_exit(art, rows, times, M, device=CPU)
    # full trajectory but absurd rewind depth
    _, _, rows, times = long_quadratic
    with pytest.raises(ValueError, match="cannot rewind"):
        tob.horizon_exit(art, rows, times, M, N_before_end=1000.0, device=CPU)


def test_horizon_exit_velocity_overshoot_start(arts):
    """A large initial χ puts ε_H ≥ 1 on the first rows before Hubble
    friction damps onto the attractor — the crossing search must skip the
    overshoot and find the genuine end of inflation."""
    jax_art, art, _ = arts["trivial"]
    rows, times = _jax_solve(jax_art, M, 3000, (16.0, 0.0), 1e-8, d0=(-40.0, 0.0))
    chi, hub = rows[0, 2:4], rows[0, 4]
    assert 0.5 * float(chi @ chi) / hub**2 >= 1.0, "fixture must start with an overshoot"
    info = tob.horizon_exit(art, rows, times, M, N_before_end=40.0, device=CPU)
    assert np.isfinite(info["N_end"]) and info["N_end"] > 40.0


def test_solve_eom_fixed_matches_adaptive(arts):
    # the adaptive solver's rows, then the fixed grid over the same span:
    # final states must agree to RK4 accuracy
    jax_art, art, _ = arts["trivial"]
    rows, times = _jax_solve(jax_art, ARGS, 400, (1.0, 0.5), 1e-10)
    grid = np.linspace(0.0, float(times[-1]), 4001)
    fixed = tob.solve_eom_fixed(art, ARGS, grid, [1.0, 0.5], [0.0, 0.0], device=CPU)
    assert fixed.shape == (4001, 5) and fixed.dtype == torch.float64
    np.testing.assert_allclose(fixed[-1].numpy(), rows[-1], rtol=2e-6, atol=1e-9)
    # row 0 is the initial state with H from the constraint
    np.testing.assert_allclose(fixed[0].numpy(), rows[0], rtol=1e-14)


def _final_field(art, grid):
    def fn(a):
        rows = tob.solve_eom_fixed(art, a, grid, torch.tensor([1.0, 0.5], dtype=torch.float64),
                                   torch.tensor([0.0, 0.0], dtype=torch.float64), device=CPU)
        return rows[-1, 0]

    return fn


def test_solve_eom_fixed_gradient_vs_finite_differences(art):
    grid = torch.linspace(0.0, 1.5, 301, dtype=torch.float64)
    final_field = _final_field(art, grid)
    a = torch.tensor(ARGS, requires_grad=True)
    (g,) = torch.autograd.grad(final_field(a), a)
    h = 1e-5
    for i in range(2):
        dp, dm = ARGS.copy(), ARGS.copy()
        dp[i] += h
        dm[i] -= h
        fd = (float(final_field(torch.tensor(dp))) - float(final_field(torch.tensor(dm)))) / (2 * h)
        np.testing.assert_allclose(float(g[i]), fd, rtol=1e-4, atol=1e-8)


def test_solve_eom_fixed_shape_validation(art):
    grid = np.linspace(0.0, 1.0, 10)
    with pytest.raises(ShapeError):
        tob.solve_eom_fixed(art, ARGS, grid, [1.0], [0.0, 0.0], device=CPU)
    with pytest.raises(ShapeError):
        tob.solve_eom_fixed(art, np.ones(3), grid, [1.0, 0.5], [0.0, 0.0], device=CPU)
    with pytest.raises(ShapeError):
        tob.solve_eom_fixed(art, ARGS, np.zeros((2, 5)), [1.0, 0.5], [0.0, 0.0], device=CPU)


def test_fit_parameters_recovers_target_observables(art):
    # target observables produced by known masses; start elsewhere, and
    # require the fit to reproduce them
    sr = tob.slow_roll(art, device=CPU)
    target = {k: float(v) for k, v in sr(X, np.array([0.9, 0.6])).items()}

    def loss(a):
        got = sr(X, a)
        return (got["n_s"] - target["n_s"]) ** 2 + (got["r"] - target["r"]) ** 2

    res = tob.fit_parameters(loss, np.array([1.3, 0.4]), steps=600, learning_rate=0.03,
                             device=CPU)
    assert isinstance(res, tob.FitResult)
    assert res.loss_history.shape == (600,)
    assert float(loss(res.params)) < 1e-10
    got = sr(X, res.params)
    np.testing.assert_allclose(float(got["n_s"]), target["n_s"], atol=1e-5)
    np.testing.assert_allclose(float(got["r"]), target["r"], atol=1e-5)


def test_fit_parameters_multistart_and_cache(art):
    sr = tob.slow_roll(art, device=CPU)
    target = float(sr(X, np.array([0.9, 0.6]))["n_s"])

    def loss(a):
        return (sr(X, a)["n_s"] - target) ** 2

    starts = np.array([[1.3, 0.4], [0.6, 1.2], [1.0, 1.0]])
    n_cached = len(tob._fit_cache)
    res = tob.fit_parameters(loss, starts, steps=300, learning_rate=0.05, device=CPU)
    assert res.params.shape == (3, 2)
    assert res.loss_history.shape == (3, 300)
    # every start's history begins at its own initial loss
    for s in range(3):
        np.testing.assert_allclose(res.loss_history[s, 0], float(loss(starts[s])), rtol=1e-12)
    best = res.loss_history[:, -1].argmin()
    assert float(loss(res.params[best])) < 1e-9
    # the loop is cached per (loss_fn, optimizer, steps): a second call with
    # the same loss reuses the entry
    assert len(tob._fit_cache) == n_cached + 1
    tob.fit_parameters(loss, starts[0], steps=300, learning_rate=0.05, device=CPU)
    assert len(tob._fit_cache) == n_cached + 1
    with pytest.raises(ShapeError):
        tob.fit_parameters(loss, np.zeros((2, 2, 2)), steps=10, device=CPU)


def test_fit_parameters_custom_optimizer(art):
    eps = tob.epsilon_v(art, device=CPU)
    target = float(eps(X, np.array([0.8, 0.8])))

    def loss(a):
        return (eps(X, a) - target) ** 2

    res = tob.fit_parameters(loss, np.array([1.1, 1.1]), steps=300,
                             optimizer=lambda p: torch.optim.SGD(p, lr=0.1), device=CPU)
    assert float(loss(res.params)) < 1e-9
    # history is the pre-update loss: it must start at the initial loss
    np.testing.assert_allclose(res.loss_history[0], float(loss([1.1, 1.1])), rtol=1e-12)


def test_power_spectrum_single_field(art, rows8):
    """Spectrum-from-background on the φ² large-field model.  Slow-roll
    analytics (M_Pl = 1, m = 1): ε = 2/φ², H² = V/3, so at crossing
    P_ζ = H²/(8π²ε) = φ⁴/(48π²), n_s − 1 = −8/φ², r = 32/φ², and the
    running α_s = dn_s/dlnk = −(1 − n_s)²/2."""
    rows, times = rows8
    spec = tob.power_spectrum(art, rows, times, M, device=CPU)
    assert set(spec) == {"ln_k", "N", "P_zeta", "P_tensor", "n_s", "alpha_s", "r", "epsilon_h"}
    assert len({v.shape for v in spec.values()}) == 1
    # crossing wavenumbers strictly ordered (d ln k/dN = 1 − ε_H > 0)
    assert np.all(np.diff(spec["ln_k"]) > 0)
    # r = P_T/P_ζ = 16 ε_H is an identity of the construction
    np.testing.assert_allclose(spec["P_tensor"] / spec["P_zeta"], spec["r"], rtol=1e-12)

    att = (spec["N"] > 5.0) & (spec["N"] < 50.0)  # on the attractor
    assert att.sum() > 10
    phi_sq = 2.0 / spec["epsilon_h"]  # slow roll: ε = 2/φ²
    np.testing.assert_allclose(spec["P_zeta"][att], (phi_sq[att] ** 2) / (48.0 * np.pi**2),
                               rtol=0.05)
    ns_pred = 1.0 - 8.0 / phi_sq
    ok = att & np.isfinite(spec["n_s"])
    np.testing.assert_allclose(spec["n_s"][ok], ns_pred[ok], atol=5e-3)
    np.testing.assert_allclose(spec["r"][att], 32.0 / phi_sq[att], rtol=0.05)
    oka = att & np.isfinite(spec["alpha_s"])
    np.testing.assert_allclose(spec["alpha_s"][oka], -((1.0 - ns_pred[oka]) ** 2) / 2.0,
                               rtol=0.15)


def test_power_spectrum_error_paths(arts):
    jax_art, art, _ = arts["trivial"]
    # no inflating rows: H = 0 everywhere
    with pytest.raises(ValueError, match="no inflating rows"):
        with np.errstate(invalid="ignore"):
            tob.power_spectrum(art, np.zeros((10, 5)), np.linspace(0, 1, 10), M, device=CPU)
    rows, times = _jax_solve(jax_art, M, 100, (16.0, 0.0), 1e-8)
    with pytest.raises(ShapeError):
        tob.power_spectrum(art, rows, times[:-1], M, device=CPU)


@pytest.fixture(scope="module")
def cobe_rows(arts):
    """The α-attractor's JAX solve, its COBE scale (from the JAX package)
    and the JAX solve at the rescaled M⁴."""
    jax_art, art, args = arts["alpha_attractor"]
    rows, times = _jax_solve(jax_art, args, 3000, (0.99, 0.5), 1e-9)
    scale = job.cobe_normalize(jax_art, rows, times, args)["scale"]
    slot = art.lookup_symbol(sympy.Symbol("M4"))
    args2 = args.copy()
    args2[int(slot[slot.index("[") + 1:-1])] *= scale
    rows2, times2 = _jax_solve(jax_art, args2, 3000, (0.99, 0.5), 1e-9)
    return (rows, times, args), (rows2, times2, args2)


def test_cobe_normalize_round_trip(arts, cobe_rows):
    """Scaling the potential's linear normalization by the returned factor
    and re-solving must land P_ζ(k_*) on A_s (V → λV ⇒ H² → λH² at fixed
    field-space path ⇒ P_ζ linear in λ)."""
    art = arts["alpha_attractor"][1]
    (rows, times, args), (rows2, times2, args2) = cobe_rows
    res = tob.cobe_normalize(art, rows, times, args, device=CPU)
    slot = art.lookup_symbol(sympy.Symbol("M4"))
    i = int(slot[slot.index("[") + 1:-1])
    np.testing.assert_allclose(args2[i], args[i] * res["scale"], rtol=1e-12)
    res2 = tob.cobe_normalize(art, rows2, times2, args2, device=CPU)
    np.testing.assert_allclose(res2["P_zeta"], 2.1e-9, rtol=1e-4)
    np.testing.assert_allclose(res2["scale"], 1.0, rtol=1e-4)


def test_n_star_matching_textbook_value(arts, long_quadratic):
    """COBE-normalized m²φ² with instant reheating at k = 0.05/Mpc is the
    textbook N_* ≈ 57.5; the fixed point must close to ~1e-12 and the
    internal A_s normalization must agree with normalizing externally."""
    art, m, rows, times = long_quadratic
    out = tob.n_star_matching(art, m, rows, times, A_s=2.1e-9, device=CPU)
    assert 56.5 < out["N_star"] < 58.5
    assert out["residual"] < 1e-10
    assert 1e15 < out["T_reh_gev"] < 1e16
    # external normalization: V = (mφ)² is linear in m², so m √scale
    mn = m * np.sqrt(out["scale"])
    rows2, times2 = _jax_solve(arts["trivial"][0], mn, 3000, (16.0, 0.0), 1e-9)
    o2 = tob.n_star_matching(art, mn, rows2, times2, device=CPU)
    np.testing.assert_allclose(o2["N_star"], out["N_star"], atol=1e-3)


def test_n_star_matching_reheating_physics(long_quadratic):
    """w_reh = 1/3 must make N_* exactly independent of T_reh; for
    w_reh < 1/3 lower reheating temperatures shift N_* down."""
    art, m, rows, times = long_quadratic
    kw = dict(A_s=2.1e-9, device=CPU)
    o1 = tob.n_star_matching(art, m, rows, times, w_reh=1 / 3, T_reh_gev=1e10, **kw)
    o2 = tob.n_star_matching(art, m, rows, times, w_reh=1 / 3, T_reh_gev=1e4, **kw)
    np.testing.assert_allclose(o1["N_star"], o2["N_star"], atol=1e-9)
    o3 = tob.n_star_matching(art, m, rows, times, w_reh=0.0, T_reh_gev=1e10, **kw)
    o4 = tob.n_star_matching(art, m, rows, times, w_reh=0.0, T_reh_gev=1e4, **kw)
    assert o1["N_star"] > o3["N_star"] > o4["N_star"]


def test_pivots_for_k_compose_with_spectra(arts, long_quadratic):
    """pivots_for_k turns physical scales into pivot placements: a decade
    of k must span ln(10) e-folds (d ln k/dN = 1 − ε ≈ 1), and the
    placements must feed the spectrum routes directly — the JAX package's
    δN spectrum (the port has no perturbations module yet) and the port's
    own power_spectrum."""
    from inflatox_tpu import perturbations

    art, m, rows, times = long_quadratic
    ns = tob.pivots_for_k(art, m, rows, times, [0.05, 0.5], A_s=2.1e-9, device=CPU)
    assert ns.shape == (2,) and ns[0] > ns[1]
    # Δ ln k = ΔN (1 − ε); ε ≈ 1/(2N) ≈ 0.009 here
    np.testing.assert_allclose(ns[0] - ns[1], np.log(10.0), rtol=0.02)
    spec = perturbations.delta_n_spectrum(
        arts["trivial"][0], m, rows, times, pivot_N_before_end=ns, steps=3000)
    assert np.isfinite(spec["P_zeta"]).all()
    np.testing.assert_allclose(spec["ln_k"][1] - spec["ln_k"][0], np.log(10.0), rtol=1e-3)
    own = tob.power_spectrum(art, rows, times, m, device=CPU)
    n_end = tob.horizon_exit(art, rows, times, m, device=CPU)["N_end"]
    ln_k = np.interp(n_end - ns, own["N"], own["ln_k"])
    np.testing.assert_allclose(ln_k[1] - ln_k[0], np.log(10.0), rtol=1e-3)


def test_n_star_matching_fixed_scale(long_quadratic):
    """scale= applies a previously solved normalization without the per-k
    A_s refit: re-running at another k with the frozen scale must place
    the pivots exactly one decade (in k = a_* H_*) apart, and A_s+scale
    together must raise."""
    art, m, rows, times = long_quadratic
    ref = tob.n_star_matching(art, m, rows, times, k_mpc=0.05, A_s=2.1e-9, device=CPU)
    other = tob.n_star_matching(art, m, rows, times, k_mpc=0.5, scale=ref["scale"],
                                device=CPU)
    assert other["scale"] == ref["scale"]
    np.testing.assert_allclose(other["ln_k"] - ref["ln_k"], np.log(10.0), rtol=1e-9)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tob.n_star_matching(art, m, rows, times, A_s=2.1e-9, scale=1.0, device=CPU)


def test_n_star_matching_error_paths(arts, long_quadratic):
    art, m, rows, times = long_quadratic
    with pytest.raises(ValueError, match="outheat"):
        tob.n_star_matching(art, m, rows, times, T_reh_gev=1e19, A_s=2.1e-9, device=CPU)
    with pytest.raises(ValueError, match="w_reh"):
        tob.n_star_matching(art, m, rows, times, w_reh=-1.0, device=CPU)
    # a 36-e-fold trajectory cannot hold a CMB-scale pivot
    rows_s, times_s = _jax_solve(arts["trivial"][0], m, 2000, (12.0, 0.0), 1e-9)
    with pytest.raises(ValueError, match="start deeper"):
        tob.n_star_matching(art, m, rows_s, times_s, A_s=2.1e-9, device=CPU)


# ----------------------------------------------------------------------- #
# the port against the JAX package, side by side                            #
# ----------------------------------------------------------------------- #

GRID_BOXES = {"trivial": ((0.5, -1.5), (2.0, 1.5)), "doc": ((0.5, 0.25), (2.5, 3.0)),
              "alpha_attractor": ((0.1, 0.0), (0.95, 6.2))}
FACTORIES = ("epsilon_v", "eta_v", "spectral_index", "tensor_to_scalar")


def _seeded_grid(name, shape=(6, 7), seed=3):
    lo, hi = GRID_BOXES[name]
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo[i], hi[i], shape) for i in range(2)]


@pytest.mark.parametrize("name", sorted(GRID_BOXES))
def test_slow_roll_maps_match_the_jax_package(arts, name):
    import jax.numpy as jnp

    jax_art, art, args = arts[name]
    grid = _seeded_grid(name)
    got = tob.slow_roll(art, device=CPU)(grid, args)
    want = job.slow_roll(jax_art)([jnp.asarray(g) for g in grid], jnp.asarray(args))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (6, 7) and got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12, atol=0)
    for factory in FACTORIES:
        got = getattr(tob, factory)(art, device=CPU)(grid, args).numpy()
        want = np.asarray(getattr(job, factory)(jax_art)([jnp.asarray(g) for g in grid],
                                                           jnp.asarray(args)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=factory)


@pytest.mark.parametrize("name", sorted(GRID_BOXES))
def test_jacobian_and_fisher_match_jax_jacfwd(arts, name):
    """Compared as derivatives by the log of each parameter (column j times
    |args[j]|), with an absolute floor of 1e-12 of the observables' size at
    the point: where an observable does not depend on a parameter (the
    overall scale: the α-attractor's M⁴ = 1e-10, the doc model's m), both
    packages return rounding noise of that size, or exactly 0.  The Fisher
    matrices likewise, scaled the same way on both sides, with the floor
    carried through F = Jᵀ Σ⁻¹ J."""
    jax_art, art, args = arts[name]
    keys = ("epsilon_v", "eta_v", "n_s", "r")
    sigma = np.array([0.004, 0.01])
    sr = tob.slow_roll(art, device=CPU)
    rng = np.random.default_rng(5)
    lo, hi = GRID_BOXES[name]
    scale = np.abs(args)
    for _ in range(3):
        x = rng.uniform(lo, hi)
        size = max(1.0, max(abs(float(v)) for v in sr(x, args).values()))
        got = tob.observable_jacobian(art, keys, device=CPU)(x, args).numpy()
        want = np.asarray(job.observable_jacobian(jax_art, keys)(x, args))
        assert got.shape == want.shape == (4, len(args))
        np.testing.assert_allclose(got * scale, want * scale, rtol=1e-10, atol=1e-12 * size)
        f_got = tob.fisher_matrix(art, x, args, sigma, device=CPU)
        f_want = job.fisher_matrix(jax_art, x, args, sigma)
        assert isinstance(f_got, np.ndarray) and f_got.shape == (len(args), len(args))
        outer = np.outer(scale, scale)
        floor = 1e-12 * size * max(1.0, np.abs(want * scale).max()) / sigma.min() ** 2
        np.testing.assert_allclose(f_got * outer, f_want * outer, rtol=1e-10, atol=floor)


TRAJECTORY_CALLS = {
    "along_trajectory": lambda mod, art, rows, times, m, **kw: mod.along_trajectory(
        art, rows, m, **kw),
    "horizon_exit": lambda mod, art, rows, times, m, **kw: mod.horizon_exit(
        art, rows, times, m, N_before_end=50.0, **kw),
    "power_spectrum": lambda mod, art, rows, times, m, **kw: mod.power_spectrum(
        art, rows, times, m, **kw),
    "cobe_normalize": lambda mod, art, rows, times, m, **kw: mod.cobe_normalize(
        art, rows, times, m, **kw),
    "n_star_matching": lambda mod, art, rows, times, m, **kw: mod.n_star_matching(
        art, m, rows, times, A_s=2.1e-9, w_reh=0.1, T_reh_gev=1e9, **kw),
    "pivots_for_k": lambda mod, art, rows, times, m, **kw: {"N": mod.pivots_for_k(
        art, m, rows, times, [0.05, 0.002, 0.5], A_s=2.1e-9, **kw)},
}


@pytest.mark.parametrize("model", ["trivial", "alpha_attractor"])
@pytest.mark.parametrize("call", sorted(TRAJECTORY_CALLS))
def test_trajectory_functions_match_jax_on_the_same_rows(arts, long_quadratic, cobe_rows,
                                                         call, model):
    jax_art, art, _ = arts[model]
    if model == "trivial":
        _, m, rows, times = long_quadratic
    else:
        rows, times, m = cobe_rows[0]
    fn = TRAJECTORY_CALLS[call]
    got = fn(tob, art, rows, times, m, device=CPU)
    want = fn(job, jax_art, rows, times, m)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, dtype=float)
        g = np.asarray(got[k], dtype=float)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-300, equal_nan=True, err_msg=k)


def test_solve_eom_fixed_rows_and_gradient_match_jax(arts):
    import jax
    import jax.numpy as jnp

    jax_art, art, args = arts["doc"]
    grid = np.linspace(0.0, 3.0, 401)
    f0, d0 = np.array([2.0, 1.5]), np.array([0.01, -0.02])
    got = tob.solve_eom_fixed(art, args, grid, f0, d0, device=CPU)
    want = np.asarray(job.solve_eom_fixed(jax_art, args, grid, f0, d0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)

    def jax_target(p, x0):
        rows = job.solve_eom_fixed(jax_art, p, jnp.asarray(grid), x0, jnp.asarray(d0))
        return rows[-1, 0] * rows[-1, 1] + rows[200, 4]

    p = torch.tensor(args, requires_grad=True)
    x0 = torch.tensor(f0, requires_grad=True)
    rows = tob.solve_eom_fixed(art, p, grid, x0, d0, device=CPU)
    (rows[-1, 0] * rows[-1, 1] + rows[200, 4]).backward()
    want_p, want_x0 = jax.grad(jax_target, argnums=(0, 1))(jnp.asarray(args), jnp.asarray(f0))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p), rtol=1e-9, atol=0)
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(want_x0), rtol=1e-9, atol=0)


def _fit_pair(arts, optimizer, steps):
    """The same ε_V fit on the trivial model through both packages."""
    import jax.numpy as jnp

    jax_art, art, _ = arts["trivial"]
    eps_j, eps_t = job.epsilon_v(jax_art), tob.epsilon_v(art, device=CPU)
    target = float(eps_t(X, np.array([0.8, 0.6])))
    x_j = jnp.asarray(X)

    def loss_j(a):
        return (eps_j(x_j, a) - target) ** 2

    def loss_t(a):
        return (eps_t(X, a) - target) ** 2

    start = np.array([1.1, 1.3])
    want = job.fit_parameters(loss_j, start, steps=steps, optimizer=optimizer[0])
    got = tob.fit_parameters(loss_t, start, steps=steps, optimizer=optimizer[1], device=CPU)
    return got, want


def test_fit_sgd_matches_optax(arts):
    optax = pytest.importorskip("optax")
    got, want = _fit_pair(arts, (optax.sgd(0.1), lambda p: torch.optim.SGD(p, lr=0.1)), 300)
    # near the minimum the loss (ε_V − target)² is a difference of values
    # that agree to ~1e-10, so one last bit of ε_V moves it by ~1e-6
    # relative: the floor is 1e-12 of the first loss
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-10,
                               atol=1e-12 * want.loss_history[0])
    np.testing.assert_allclose(got.params, want.params, rtol=1e-10, atol=0)


def test_fit_adam_matches_optax(arts):
    optax = pytest.importorskip("optax")
    got, want = _fit_pair(arts, (optax.adam(0.05), lambda p: torch.optim.Adam(p, lr=0.05)),
                          300)
    np.testing.assert_allclose(got.loss_history[:50], want.loss_history[:50], rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(got.params, want.params, rtol=0, atol=1e-6)


def _s2(device_name="s2"):
    x, y, a = sympy.symbols("x y a")
    V = a * sympy.besselj(0, x) ** 2 + sympy.besselk(1, x + 2) * y**2 + 2
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], V, device_name, silent=True, simplify=False,
        assertions=False).build()
    return inflatox_torch.Compiler(model, silent=True).compile()


def test_s2_jacobian_against_central_differences():
    """S2 = a·J₀(x)² + K₁(x+2)·y² + 2 (tests/test_df32_special.py:75): its
    Jacobian runs forward-mode passes through the special functions, which
    ``torch.func.jacfwd`` (vmap) could not."""
    art = _s2()
    assert art.uses_special_functions
    keys = ("epsilon_v", "eta_v", "n_s", "r")
    sr = tob.slow_roll(art, device=CPU)
    h = 1e-6
    for x in ([1.3, 0.7], [2.6, 0.3], [0.6, 1.4]):
        J = tob.observable_jacobian(art, keys, device=CPU)(x, [2.0]).numpy()
        assert J.shape == (4, 1) and np.isfinite(J).all()
        up, down = sr(x, [2.0 + h]), sr(x, [2.0 - h])
        fd = np.array([(float(up[k]) - float(down[k])) / (2 * h) for k in keys])
        np.testing.assert_allclose(J[:, 0], fd, rtol=1e-6, atol=1e-9)
    F = tob.fisher_matrix(art, [1.3, 0.7], [2.0], [0.004, 0.01], device=CPU)
    assert F.shape == (1, 1) and F[0, 0] > 0


def test_port_solve_feeds_the_cmb_workflow(art, long_quadratic):
    """The whole workflow on the port alone: its own solve (kernel B6's
    plain version on the CPU) → horizon exit, spectrum, COBE scale and N_*,
    each close to the same call on the JAX package's rows (the solves part
    at ~1e-6, XLA's f64 pow)."""
    _, m, rows_j, times_j = long_quadratic
    rows, times = tbg.solve_eom(art, m, 3000, [16.0, 0.0], [0.0, 0.0], max_err=1e-9,
                                solver="rkf", return_time=True, device=CPU)
    inflating = rows_j[:, 0] > 1.0  # after the end the field oscillates through 0
    np.testing.assert_allclose(rows[inflating, 0], rows_j[inflating, 0], rtol=1e-6)
    info = tob.horizon_exit(art, rows, times, m, device=CPU)
    want = tob.horizon_exit(art, rows_j, times_j, m, device=CPU)
    for k in ("N_end", "n_s", "r"):
        np.testing.assert_allclose(info[k], want[k], rtol=1e-5, err_msg=k)
    out = tob.n_star_matching(art, m, rows, times, A_s=2.1e-9, device=CPU)
    assert 56.5 < out["N_star"] < 58.5
    cobe = tob.cobe_normalize(art, rows, times, m, device=CPU)
    np.testing.assert_allclose(cobe["scale"], tob.cobe_normalize(
        art, rows_j, times_j, m, device=CPU)["scale"], rtol=1e-5)


def test_multistart_fit_of_a_loss_that_cannot_run_under_vmap(art):
    """A loss with a branch on data cannot run under torch.func.vmap; the
    multi-start loop then evaluates it start by start, and each start moves
    exactly as it does alone."""
    sr = tob.slow_roll(art, device=CPU)
    target = float(sr(X, np.array([0.9, 0.6]))["n_s"])

    def loss(a):
        scale = 2.0 if bool((a > 0).all()) else 1.0
        return scale * (sr(X, a)["n_s"] - target) ** 2

    starts = np.array([[1.3, 0.4], [0.6, 1.2]])
    res = tob.fit_parameters(loss, starts, steps=40, device=CPU)
    for s in range(2):
        alone = tob.fit_parameters(loss, starts[s], steps=40, device=CPU)
        np.testing.assert_array_equal(res.params[s], alone.params)
        np.testing.assert_array_equal(res.loss_history[s], alone.loss_history)


def test_vmapped_multistart_equals_each_start_alone(art):
    sr = tob.slow_roll(art, device=CPU)
    target = float(sr(X, np.array([0.9, 0.6]))["r"])

    def loss(a):
        return (sr(X, a)["r"] - target) ** 2

    starts = np.array([[1.3, 0.4], [0.6, 1.2], [1.0, 1.0]])
    res = tob.fit_parameters(loss, starts, steps=50, learning_rate=0.02, device=CPU)
    for s in range(3):
        alone = tob.fit_parameters(loss, starts[s], steps=50, learning_rate=0.02, device=CPU)
        np.testing.assert_allclose(res.params[s], alone.params, rtol=1e-14, atol=0)
        np.testing.assert_allclose(res.loss_history[s], alone.loss_history, rtol=1e-13, atol=0)


ENTRIES = {
    "epsilon_v": lambda art, **kw: tob.epsilon_v(art, **kw),
    "slow_roll": lambda art, **kw: tob.slow_roll(art, **kw),
    "observable_jacobian": lambda art, **kw: tob.observable_jacobian(art, **kw),
    "fisher_matrix": lambda art, **kw: tob.fisher_matrix(art, X, ARGS, [0.1, 0.1], **kw),
    "along_trajectory": lambda art, **kw: tob.along_trajectory(art, np.ones((4, 5)), ARGS, **kw),
    "solve_eom_fixed": lambda art, **kw: tob.solve_eom_fixed(
        art, ARGS, np.linspace(0, 1, 3), [1.0, 0.5], [0.0, 0.0], **kw),
    "fit_parameters": lambda art, **kw: tob.fit_parameters(lambda a: (a**2).sum(), ARGS,
                                                           steps=2, **kw),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_points_default_to_cuda(art, entry):
    """Every entry computes on device="cuda" unless asked otherwise: on a
    host without CUDA that raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRIES[entry](art)


def test_inputs_on_two_devices_raise(art):
    x = torch.tensor(X)
    args = torch.empty(2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        tob.slow_roll(art, device=CPU)(x, args)
    with pytest.raises(ValueError, match="several devices"):
        tob.solve_eom_fixed(art, args, torch.linspace(0, 1, 3, dtype=torch.float64),
                            [1.0, 0.5], x, device=CPU)
    # tensors keep their device: a CPU tensor with array-likes stays there
    got = tob.slow_roll(art, device=CPU)(x, ARGS)
    assert got["n_s"].device == x.device
