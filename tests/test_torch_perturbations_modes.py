"""The mode and transport routes of ``inflatox_torch.perturbations``
(``mode_spectrum``, ``mode_sweep``, ``transport_spectrum``,
``transport_sweep``) against the JAX package's
``inflatox_tpu.perturbations``, on the CPU.

Models cross by the shared bundle: the φ² quadratic model of
tests/conftest.py and the curved two-field model of
tests/test_perturbations.py:34-48.  Two kinds of test:

* **Parity on the same base rows** (the JAX package's RKF45 solves, fed to
  both; in the sweeps the port's ``background.solve_eom_batch`` returns the
  JAX package's solves of the same starts), so that only the port's code
  differs: the torch geometry and mass matrix, the stream assembly and the
  torch RK4 loops against ``jax.vmap(lax.scan)``.  Tolerances: the streams
  of ``_pivot_setup`` (``gam_n``, ``c_n``, ``y2_n``, ``state0``) and the
  mass matrix rtol 1e-12; ``P_zeta``, ``P_tensor``, ``P_iso``, ``T_RS``,
  ``T_SS`` and every other spectrum value rtol 1e-10; ``n_s``, ``n_t``,
  ``alpha_s`` and the cosine ``cos_delta`` atol 1e-9 (on the φ² axis ζ and
  S are uncorrelated, and cos Δ is rounding noise of ~1e-15 on both
  sides).  Measured: the streams within 7.9e-16; P_zeta and P_tensor
  within 4.8e-15, P_iso, T_RS and T_SS within 2.2e-12 (they are
  differences of nearly equal correlators); the tilts within 4.5e-16 and
  cos_delta within 2.4e-14 absolute (the RK4 loops' products round as BLAS
  rounds, XLA's dot otherwise, over 1,100 steps).
* **Mirrors of tests/test_perturbations.py** with the port's own base
  solves (kernel B6's plain version on the CPU), at the JAX tests' own
  assertions and tolerances.
"""

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch import background as tbg
from inflatox_torch import perturbations as tp
from inflatox_torch.models import _args_by_symbol
from inflatox_tpu import background as jbg
from inflatox_tpu import perturbations as jp

CPU = "cpu"
M = np.array([1.0, 1.0])
RTOL_STREAMS = 1e-12
RTOL_SPECTRA = 1e-10
ATOL_TILTS = 1e-9
TILTS = ("n_s", "n_t", "alpha_s", "cos_delta")
SMALL = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0, dense_steps=800,
             tail_steps=300)


def _port(jax_art, root, name):
    path = str(root / f"{name}.json")
    jax_art.save(path)
    return inflatox_torch.CompiledModel.load(path)


@pytest.fixture(scope="module")
def models(trivial_artifact, tmp_path_factory):
    """name → (JAX artifact, port artifact from its bundle, args, start,
    rows): the φ² axis and the curved two-field model, with the JAX
    package's base solves."""
    root = tmp_path_factory.mktemp("perturbation_bundles")
    p1, p2, m1, m2, b = sympy.symbols("p1 p2 m1 m2 b", real=True)
    V = sympy.Rational(1, 2) * (m1 * p1) ** 2 + sympy.Rational(1, 2) * (m2 * p2) ** 2
    g = [[sympy.Integer(1), 0], [0, sympy.exp(2 * b * p1)]]
    model = inflatox_tpu.InflationModelBuilder.new([p1, p2], g, V, silent=True).build()
    curved = inflatox_tpu.Compiler(model, silent=True).compile()
    c_args = _args_by_symbol(curved.model, {"m1": 1.0, "m2": 0.8, "b": 0.25})
    out = {}
    for name, art, args, f0, steps in (("quadratic", trivial_artifact, M, [12.0, 0.0], 2000),
                                       ("curved", curved, c_args, [10.0, 1.5], 3000)):
        rows, times = jbg.solve_eom(art, args, steps, f0, [0.0, 0.0], max_err=1e-9,
                                    solver="rkf", return_time=True)
        out[name] = (art, _port(art, root, name), args, f0, (rows, times))
    return out


@pytest.fixture(scope="module")
def quadratic(models):
    """The port's own base solve on the φ² axis (m1 = m2 = 1, φ₀ = 12)."""
    _, art, m, f0, _ = models["quadratic"]
    rows, times = tbg.solve_eom(art, m, 2000, f0, [0.0, 0.0], max_err=1e-9,
                                solver="rkf", return_time=True, device=CPU)
    return art, m, rows, times


@pytest.fixture(scope="module")
def curved(models):
    """The port's own base solve of the curved two-field model."""
    _, art, args, f0, _ = models["curved"]
    rows, times = tbg.solve_eom(art, args, 3000, f0, [0.0, 0.0], max_err=1e-9,
                                solver="rkf", return_time=True, device=CPU)
    return art, args, rows, times


def _assert_spectra(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, list):
            assert got[key] == w, key
        elif key in TILTS:
            np.testing.assert_allclose(got[key], w, rtol=0, atol=ATOL_TILTS, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=RTOL_SPECTRA, atol=0, err_msg=key)


# ----------------------------------------------------------------------- #
# parity with the JAX package on the same base rows                        #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["quadratic", "curved"])
def test_pivot_setup_streams_match_jax(models, name):
    jart, tart, args, _, (rows, times) = models[name]
    setup = (SMALL["pivots"], SMALL["N_margin_start"], SMALL["N_margin_end"], 4.0, 2.0,
             SMALL["dense_steps"], SMALL["tail_steps"])
    want = jp._pivot_setup(jart, args, rows, times, *setup)
    got = tp._pivot_setup(tart, args, rows, times, *setup, CPU)
    for key in ("gam_n", "c_n", "gam_m", "c_m", "y2_n", "y2_m", "fric_n", "state0",
                "state0_t", "norm", "grids"):
        value = getattr(got, key)
        value = value.numpy() if torch.is_tensor(value) else value
        np.testing.assert_allclose(value, getattr(want, key), rtol=RTOL_STREAMS, atol=0,
                                   err_msg=key)


def test_mass_matrix_matches_jax(models):
    """M/H² (Riemann term included) and Γu at seeded points of the curved
    model."""
    jart, tart, args, _, _ = models["curved"]
    rng = np.random.default_rng(10)
    x = np.stack([rng.uniform(-2.0, 8.0, 64), rng.uniform(-1.0, 1.5, 64)])
    u = rng.normal(0.0, 0.2, (2, 64))
    hub = rng.uniform(0.5, 4.0, 64)
    eps = rng.uniform(0.0, 0.9, 64)
    want = jp._mass_matrix_over_h2(jart, args, x, u, hub, eps)
    t = [torch.tensor(v) for v in (args, x, u, hub, eps)]
    got = tp._mass_matrix_over_h2(tart, *t)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_STREAMS, atol=0)
    np.testing.assert_allclose(tp._gamma_u(tart, t[0], t[1], t[2]).numpy(),
                               jp._gamma_u(jart, args, x, u), rtol=RTOL_STREAMS, atol=0)


@pytest.mark.parametrize("route", ["mode_spectrum", "transport_spectrum"])
@pytest.mark.parametrize("name", ["quadratic", "curved"])
def test_spectrum_matches_jax(models, name, route):
    jart, tart, args, _, (rows, times) = models[name]
    want = getattr(jp, route)(jart, args, rows, times, **SMALL)
    got = getattr(tp, route)(tart, args, rows, times, device=CPU, **SMALL)
    _assert_spectra(got, want)


@pytest.mark.parametrize("route", ["mode_sweep", "transport_sweep"])
def test_sweep_matches_jax(models, monkeypatch, route):
    """The sweeps on the JAX package's base solves, a failing set included:
    the per-set streams concatenated along the pivot axis."""
    jart, tart, _, _, _ = models["quadratic"]
    pars = np.array([[1.0, 1.0], [1.05, 1.0], [1.0, 1.0]])
    f0 = np.array([[12.0, 0.0], [11.0, 3.0], [1.0, 0.0]])
    kw = dict(SMALL, steps=2000, on_failure="nan")
    want = getattr(jp, route)(jart, pars, f0, [0.0, 0.0], **kw)

    def solve(artifact, pars, steps, f0, chi0, max_err=1e-6, solver="rk4",
              return_time=False, device=None):
        return jbg.solve_eom_batch(jart, pars, steps, f0, chi0, max_err=max_err,
                                   solver=solver, return_time=return_time)

    monkeypatch.setattr(tp.background, "solve_eom_batch", solve)
    got = getattr(tp, route)(tart, pars, f0, [0.0, 0.0], device=CPU, **kw)
    np.testing.assert_array_equal(got["ok"], [True, True, False])
    _assert_spectra(got, want)


# ----------------------------------------------------------------------- #
# tests/test_perturbations.py's mode and transport tests, on the port       #
# ----------------------------------------------------------------------- #


def test_mode_spectrum_cross_validates_delta_n_flat(quadratic):
    """Two independent formalisms, one answer (flat field space)."""
    art, m, rows, times = quadratic
    kw = dict(pivots=5, N_margin_start=5.0, N_margin_end=8.0, device=CPU)
    dn = tp.delta_n_spectrum(art, m, rows, times, steps=2000, **kw)
    ms = tp.mode_spectrum(art, m, rows, times, **kw)
    np.testing.assert_allclose(ms["ln_k"], dn["ln_k"], rtol=1e-12)
    np.testing.assert_allclose(ms["P_zeta"], dn["P_zeta"], rtol=0.08)
    ok = np.isfinite(ms["n_s"])
    np.testing.assert_allclose(ms["n_s"][ok], dn["n_s"][ok], atol=0.012)


def test_mode_spectrum_cross_validates_delta_n_curved(curved):
    """The same on a curved field space with a turning two-field
    background: the Christoffel transport and the Riemann term."""
    art, args, rows, times = curved
    kw = dict(pivots=4, N_margin_start=5.0, N_margin_end=8.0, device=CPU)
    dn = tp.delta_n_spectrum(art, args, rows, times, steps=3000, **kw)
    ms = tp.mode_spectrum(art, args, rows, times, **kw)
    np.testing.assert_allclose(ms["P_zeta"], dn["P_zeta"], rtol=0.08)


def test_mass_matrix_riemann_term_constant_curvature():
    """On a 2-D constant-curvature field space the Riemann term contributes
    −K(χ^aχ_b − δ^a_b|χ|²): +K|χ|² on the entropic direction, zero along
    the adiabatic one."""
    x0, y0, mm, = sympy.symbols("x0 y0 mm", real=True)
    V = sympy.Rational(1, 2) * mm**2 * (x0**2 + y0**2)
    g = [[sympy.Integer(1), 0], [0, sympy.sinh(x0) ** 2]]  # K = −1
    model = inflatox_torch.InflationModelBuilder.new([x0, y0], g, V, silent=True).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    args = np.array([1.0])
    K = -1.0

    pt = np.array([[1.1], [0.7]])
    hub = np.array([2.0])
    eps = np.array([0.02])
    u = np.array([[0.3], [0.15]])          # e-fold velocity χ/H
    chi = u * hub

    m_full = tp._mass_matrix_over_h2(
        art, *(torch.tensor(v) for v in (args, pt, u, hub, eps))
    )[0].numpy()

    x, y = pt[0, 0], pt[1, 0]
    g_m = np.diag([1.0, np.sinh(x) ** 2])
    ginv = np.linalg.inv(g_m)
    grad = np.array([x, y])
    gam = np.zeros((2, 2, 2))
    gam[0, 1, 1] = -np.sinh(x) * np.cosh(x)
    gam[1, 0, 1] = gam[1, 1, 0] = np.cosh(x) / np.sinh(x)
    hesse = np.eye(2) - np.einsum("cab,c->ab", gam, grad)
    chi_v = chi[:, 0]
    chi_lo = g_m @ chi_v
    grad_up = ginv @ grad
    m_ref = ginv @ hesse
    m_ref = m_ref - K * (np.outer(chi_v, chi_lo) - np.eye(2) * (chi_lo @ chi_v))
    m_ref = m_ref + (3.0 - eps[0]) * np.outer(chi_v, chi_lo)
    m_ref = m_ref + (np.outer(grad_up, chi_lo) + np.outer(chi_v, grad)) / hub[0]
    np.testing.assert_allclose(m_full, m_ref / hub[0] ** 2, rtol=1e-10)

    riem_term = -K * (np.outer(chi_v, chi_lo) - np.eye(2) * (chi_lo @ chi_v))
    sig = chi_v / np.sqrt(chi_lo @ chi_v)
    sig_lo = g_m @ sig
    assert abs(sig_lo @ riem_term @ sig) < 1e-12
    w = np.array([-chi_v[1], chi_v[0]])
    s_up = ginv @ w / np.sqrt(w @ ginv @ w)
    s_lo = g_m @ s_up
    np.testing.assert_allclose(
        s_lo @ riem_term @ s_up, K * (chi_lo @ chi_v), rtol=1e-10
    )


def test_mode_spectrum_exact_tensor_and_iso_flat(quadratic):
    """Exact P_T matches 2H²/π² to O(ε), P_iso ≥ 0, n_t ≈ −r/8, and ζ, S
    uncorrelated on the decoupled axis."""
    art, m, rows, times = quadratic
    ms = tp.mode_spectrum(
        art, m, rows, times, pivots=5, N_margin_start=5.0, N_margin_end=8.0,
        device=CPU,
    )
    sr = 2.0 * ms["H"] ** 2 / np.pi**2
    np.testing.assert_allclose(ms["P_tensor"], sr, rtol=0.15)
    assert np.all(ms["P_iso"] >= 0.0)
    ok = np.isfinite(ms["n_t"])
    np.testing.assert_allclose(
        ms["n_t"][ok], -ms["r"][ok] / 8.0, atol=0.02
    )
    assert np.all(np.abs(ms["cos_delta"][np.isfinite(ms["cos_delta"])]) < 0.2)


def test_mode_spectrum_iso_curved_finite(curved):
    art, args, rows, times = curved
    ms = tp.mode_spectrum(
        art, args, rows, times, pivots=3, N_margin_start=5.0, N_margin_end=8.0,
        device=CPU,
    )
    assert np.all(np.isfinite(ms["P_iso"])) and np.all(ms["P_iso"] >= 0)
    ok = np.isfinite(ms["cos_delta"])
    assert np.all(np.abs(ms["cos_delta"][ok]) <= 1.0 + 1e-9)


def test_mode_sweep_batches_parameter_sets(quadratic):
    """mode_sweep reproduces mode_spectrum per set; the φ² m-scaling law
    pins the per-set routing."""
    art, m, rows, times = quadratic
    pars = np.array([[1.0, 1.0], [1.05, 1.0]])
    kw = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0,
              dense_steps=1200, tail_steps=500, device=CPU)
    sw = tp.mode_sweep(
        art, pars, [12.0, 0.0], [0.0, 0.0], steps=2000, max_err=1e-9, **kw
    )
    assert sw["ok"].all() and sw["P_zeta"].shape == (2, 3)
    one = tp.mode_spectrum(art, m, rows, times, **kw)
    np.testing.assert_allclose(sw["ln_k"][0], one["ln_k"], atol=1e-6)
    np.testing.assert_allclose(sw["P_zeta"][0], one["P_zeta"], rtol=1e-3)
    np.testing.assert_allclose(sw["P_tensor"][0], one["P_tensor"], rtol=1e-3)
    np.testing.assert_allclose(sw["P_zeta"][1] / sw["P_zeta"][0],
                               1.05**2, rtol=1e-3)
    np.testing.assert_allclose(sw["P_tensor"][1] / sw["P_tensor"][0],
                               1.05**2, rtol=1e-3)


def test_mode_sweep_failure_isolation_and_config_errors(quadratic):
    art, m, rows, times = quadratic
    pars = np.array([[1.0, 1.0], [1.0, 1.0]])
    f0 = np.array([[12.0, 0.0], [1.0, 0.0]])
    kw = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0,
              dense_steps=800, tail_steps=300, steps=2000, device=CPU)
    sw = tp.mode_sweep(art, pars, f0, [0.0, 0.0], on_failure="nan", **kw)
    np.testing.assert_array_equal(sw["ok"], [True, False])
    assert np.isfinite(sw["P_zeta"][0]).all()
    assert np.isnan(sw["P_zeta"][1]).all()
    assert "too short" in sw["failures"][1]
    with pytest.raises(ValueError, match="parameter set 1"):
        tp.mode_sweep(art, pars, f0, [0.0, 0.0], **kw)
    with pytest.raises(ValueError, match="N_sub"):
        tp.mode_sweep(
            art, pars, f0, [0.0, 0.0], on_failure="nan",
            pivots=3, N_margin_start=2.0, N_sub=4.0, device=CPU,
        )


def test_transport_sweep_batches_parameter_sets(quadratic):
    """transport_sweep reproduces transport_spectrum per set (the Wands
    transfer functions included) and the global m-scaling law."""
    art, m, rows, times = quadratic
    pars = np.array([[1.0, 1.0], [1.05, 1.05]])
    kw = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0,
              dense_steps=1200, tail_steps=500, device=CPU)
    sw = tp.transport_sweep(
        art, pars, [12.0, 0.0], [0.0, 0.0], steps=2000, max_err=1e-9, **kw
    )
    assert sw["ok"].all() and sw["T_RS"].shape == (2, 3)
    one = tp.transport_spectrum(art, m, rows, times, **kw)
    np.testing.assert_allclose(sw["P_zeta"][0], one["P_zeta"], rtol=1e-3)
    np.testing.assert_allclose(sw["P_tensor"][0], one["P_tensor"], rtol=1e-3)
    np.testing.assert_allclose(sw["T_SS"][0], one["T_SS"], rtol=1e-3)
    np.testing.assert_allclose(sw["P_zeta"][1] / sw["P_zeta"][0],
                               1.05**2, rtol=1e-3)
    np.testing.assert_allclose(sw["T_SS"][1], sw["T_SS"][0], rtol=1e-3)
    f0 = np.array([[12.0, 0.0], [1.0, 0.0]])
    sw2 = tp.transport_sweep(
        art, pars, f0, [0.0, 0.0], on_failure="nan", steps=2000,
        pivots=3, N_margin_start=5.0, N_margin_end=8.0,
        dense_steps=800, tail_steps=300, device=CPU,
    )
    np.testing.assert_array_equal(sw2["ok"], [True, False])
    assert np.isnan(sw2["T_RS"][1]).all()
    assert np.isfinite(sw2["P_zeta"][0]).all()


def test_transport_cross_validates_mode_flat(quadratic):
    """The transport route integrates the SAME u-matrix streams as the mode
    route: agreement to integrator error."""
    art, m, rows, times = quadratic
    kw = dict(pivots=5, N_margin_start=5.0, N_margin_end=8.0,
              dense_steps=1500, tail_steps=600, device=CPU)
    ms = tp.mode_spectrum(art, m, rows, times, **kw)
    tr = tp.transport_spectrum(art, m, rows, times, **kw)
    np.testing.assert_allclose(tr["ln_k"], ms["ln_k"], rtol=1e-12)
    np.testing.assert_allclose(tr["P_zeta"], ms["P_zeta"], rtol=5e-5)
    np.testing.assert_allclose(tr["P_tensor"], ms["P_tensor"], rtol=5e-5)
    np.testing.assert_allclose(tr["P_iso"], ms["P_iso"], rtol=5e-5)
    np.testing.assert_allclose(tr["T_RS"], 0.0, atol=1e-8)
    np.testing.assert_allclose(tr["P_zeta"], tr["P_zeta_star"], rtol=0.03)
    assert np.all(tr["T_SS"] < 1.0)
    inner = slice(1, -1)
    assert np.all(tr["alpha_s"][inner] < 0.0)
    assert np.all(np.abs(tr["alpha_s"][inner]) < 0.02)
    np.testing.assert_allclose(
        tr["alpha_s"][inner], ms["alpha_s"][inner], rtol=1e-2
    )


def test_transport_transfer_functions_curved(curved):
    """On a turning background the Wands decomposition is internally
    consistent: P_ζ(end) = P_ζ* + T_RS² P_S* and cos Δ = T_RS √(P_S*/P_ζ)."""
    art, args, rows, times = curved
    kw = dict(pivots=4, N_margin_start=5.0, N_margin_end=8.0,
              dense_steps=1500, tail_steps=600, device=CPU)
    ms = tp.mode_spectrum(art, args, rows, times, **kw)
    tr = tp.transport_spectrum(art, args, rows, times, **kw)
    np.testing.assert_allclose(tr["P_zeta"], ms["P_zeta"], rtol=1e-3)
    np.testing.assert_allclose(tr["P_iso"], ms["P_iso"], rtol=1e-3)
    np.testing.assert_allclose(
        tr["cos_delta"], ms["cos_delta"], rtol=1e-3, atol=1e-8
    )
    pred = tr["P_zeta_star"] + tr["T_RS"] ** 2 * tr["P_iso_star"]
    np.testing.assert_allclose(tr["P_zeta"], pred, rtol=0.05)
    cos_pred = tr["T_RS"] * np.sqrt(tr["P_iso_star"] / tr["P_zeta"])
    np.testing.assert_allclose(tr["cos_delta"], cos_pred, rtol=0.05)
