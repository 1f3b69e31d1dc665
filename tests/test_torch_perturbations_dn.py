"""The δN routes of ``inflatox_torch.perturbations`` (``delta_n_spectrum``,
``delta_n_sweep``, ``squeezed_fnl``) against the JAX package's
``inflatox_tpu.perturbations``, on the CPU.

Models cross by the shared bundle (the JAX package saves, the port loads):
the φ² quadratic model of tests/conftest.py and the curved two-field model
of tests/test_perturbations.py:34-48.  Two kinds of test:

* **Parity on the same trajectories.**  Both packages read the JAX
  package's RKF45 base solves, and the port's ``background.solve_eom_batch``
  is replaced by one that returns the JAX package's solves of the same
  starts, so that the δN assembly (stencils, the ε_H = 1 surface, the
  Hermite read-out, finite differences, the metric and Christoffels on the
  device) is compared on identical trajectories.  Tolerances: ``P_zeta``,
  ``N_grad`` and every other first-order output rtol 1e-10; ``N_hess``,
  ``f_NL`` and ``f_NL_sq`` rtol 1e-8 (the only operations that differ are
  the inner products and geometry evaluations, torch against XLA, a few
  ulp; second differences amplify them by 1/h2²).  Measured: every
  output bit for bit, except the curved model's N_hess and f_NL (1.8e-16,
  the Christoffels' last bit).
* **Mirrors of tests/test_perturbations.py** with the port's own solves
  (kernel B6's plain version on the CPU), at the JAX tests' own
  assertions and tolerances.  The four ``*_sharded_*`` tests are in
  tests/test_torch_parallel_spectra.py; here ``mesh=`` must be a mesh.
"""

import numpy as np
import pytest
import sympy

import inflatox_torch
import inflatox_tpu
from inflatox_torch import background as tbg
from inflatox_torch import perturbations as tp
from inflatox_torch.models import _args_by_symbol
from inflatox_tpu import background as jbg
from inflatox_tpu import perturbations as jp

CPU = "cpu"
M = np.array([1.0, 1.0])
RTOL_FIRST = 1e-10
RTOL_SECOND = 1e-8


def _port(jax_art, root, name):
    path = str(root / f"{name}.json")
    jax_art.save(path)
    return inflatox_torch.CompiledModel.load(path)


@pytest.fixture(scope="module")
def models(trivial_artifact, tmp_path_factory):
    """name → (JAX artifact, port artifact from its bundle, args, start,
    rows): the φ² axis and the curved two-field model of
    tests/test_perturbations.py, with the JAX package's base solves."""
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


@pytest.fixture
def jax_solves(monkeypatch):
    """Route the port's batched solves to the JAX package's solver on the
    same starts: ``use(jax_artifact)``."""

    def use(jax_art):
        def solve(artifact, pars, steps, f0, chi0, max_err=1e-6, solver="rk4",
                  return_time=False, device=None):
            return jbg.solve_eom_batch(jax_art, pars, steps, f0, chi0, max_err=max_err,
                                       solver=solver, return_time=return_time)

        monkeypatch.setattr(tp.background, "solve_eom_batch", solve)

    return use


def _assert_parity(got, want, second=()):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, list):
            assert got[key] == w, key
            continue
        rtol = RTOL_SECOND if key in second else RTOL_FIRST
        np.testing.assert_allclose(got[key], w, rtol=rtol, atol=0, err_msg=key)


# ----------------------------------------------------------------------- #
# parity with the JAX package on the same trajectories                     #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("name, order", [("quadratic", 1), ("quadratic", 2), ("curved", 2)])
def test_delta_n_spectrum_matches_jax(models, jax_solves, name, order):
    jart, tart, args, _, (rows, times) = models[name]
    kw = dict(pivots=4, N_margin_start=5.0, N_margin_end=8.0, steps=rows.shape[0],
              order=order, max_err=1e-9)
    want = jp.delta_n_spectrum(jart, args, rows, times, **kw)
    jax_solves(jart)
    got = tp.delta_n_spectrum(tart, args, rows, times, device=CPU, **kw)
    _assert_parity(got, want, second=("N_hess", "f_NL"))


@pytest.mark.parametrize("order", [1, 2])
def test_delta_n_sweep_matches_jax(models, jax_solves, order):
    """Per-trajectory parameters through the port's inner product and
    geometry (lists of per-sample columns), a failing set included."""
    jart, tart, _, _, _ = models["quadratic"]
    pars = np.array([[1.0, 1.0], [1.05, 1.0], [1.0, 1.0]])
    f0 = np.array([[12.0, 0.0], [11.0, 0.5], [1.0, 0.0]])
    kw = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0, steps=2000, order=order,
              on_failure="nan")
    want = jp.delta_n_sweep(jart, pars, f0, [0.0, 0.0], **kw)
    jax_solves(jart)
    got = tp.delta_n_sweep(tart, pars, f0, [0.0, 0.0], device=CPU, **kw)
    np.testing.assert_array_equal(got["ok"], [True, True, False])
    _assert_parity(got, want, second=("N_hess", "f_NL"))


def test_delta_n_sweep_rows_equal_single_spectra(models, monkeypatch):
    """Hazard of the per-sample parameters: each sweep row equals the
    single-set spectrum of its own parameters on the same trajectories (a
    misrouted parameter moves N_hess at O(1): b = 0.25 against 0.3).  The
    sweep runs on the port's own solves, recorded; each single-set call
    replays its set's slice of them, so the two read identical rows."""
    _, tart, _, _, _ = models["curved"]
    base = _args_by_symbol(tart.model, {"m1": 1.0, "m2": 0.8, "b": 0.25})
    slot = int(tart.lookup_symbol(sympy.Symbol("b", real=True))[5:-1])
    pars = np.stack([base, base])
    pars[1, slot] = 0.3
    kw = dict(pivots=2, N_margin_start=5.0, N_margin_end=8.0, steps=1200, order=2,
              max_err=1e-6)
    solve, calls = tp.background.solve_eom_batch, []

    def record(*a, **k):
        calls.append((a, solve(*a, **k)))
        return calls[-1][1]

    monkeypatch.setattr(tp.background, "solve_eom_batch", record)
    sw = tp.delta_n_sweep(tart, pars, [10.0, 1.5], [0.0, 0.0], device=CPU, **kw)
    assert sw["ok"].all()
    (_, (rows, times)), (pert_args, (rows_b, times_b)) = calls
    n = rows_b.shape[0] // 2
    for s in range(2):
        sl = slice(s * n, (s + 1) * n)

        def replay(artifact, pars_s, steps, f0, chi0, **k):
            np.testing.assert_array_equal(f0, pert_args[3][sl])
            return rows_b[sl], times_b[sl]

        monkeypatch.setattr(tp.background, "solve_eom_batch", replay)
        one = tp.delta_n_spectrum(tart, pars[s], rows[s], times[s], device=CPU, **kw)
        for key in one:
            np.testing.assert_allclose(sw[key][s], one[key], rtol=1e-12, atol=0,
                                       err_msg=f"set {s} {key}")
    assert not np.allclose(sw["N_hess"][0], sw["N_hess"][1], rtol=1e-3)


def test_squeezed_fnl_matches_jax(models, jax_solves):
    jart, tart, args, _, (rows, times) = models["quadratic"]
    kw = dict(N_long_before_end=28.0, N_short_before_end=(18.0, 12.0), steps=2000,
              max_err=1e-9, N_margin_start=2.0, N_margin_end=5.0)
    want = jp.squeezed_fnl(jart, args, rows, times, **kw)
    jax_solves(jart)
    got = tp.squeezed_fnl(tart, args, rows, times, device=CPU, **kw)
    _assert_parity(got, want, second=("f_NL_sq", "response"))


# ----------------------------------------------------------------------- #
# tests/test_perturbations.py's δN tests, on the port's own solves          #
# ----------------------------------------------------------------------- #


def test_delta_n_matches_slow_roll_analytics(quadratic):
    art, m, rows, times = quadratic
    spec = tp.delta_n_spectrum(
        art, m, rows, times, pivots=5, N_margin_start=5.0,
        N_margin_end=10.0, steps=2000, device=CPU,
    )
    # ε = 2/φ² from the δN gradients themselves: N(φ) = φ²/4 → N' = φ/2
    phi = 2.0 * spec["N_grad"][:, 0]
    np.testing.assert_allclose(
        spec["P_zeta"], phi**4 / (48 * np.pi**2), rtol=0.08
    )
    ns_pred = 1.0 - 8.0 / phi**2
    ok = np.isfinite(spec["n_s"])
    np.testing.assert_allclose(spec["n_s"][ok], ns_pred[ok], atol=0.02)
    np.testing.assert_allclose(spec["r"], 32.0 / phi**2, rtol=0.08)
    # the spectator direction contributes nothing on the single-field axis
    np.testing.assert_allclose(spec["N_grad"][:, 1], 0.0, atol=1e-6)


def test_delta_n_fnl_matches_lyth_rodriguez(quadratic):
    """Second-order δN on the φ² axis: f_NL = (5/6)·N''/N'² = 5/(3φ²)."""
    art, m, rows, times = quadratic
    spec = tp.delta_n_spectrum(
        art, m, rows, times, pivots=4, N_margin_start=5.0,
        N_margin_end=10.0, steps=2000, order=2, max_err=1e-10, device=CPU,
    )
    phi = 2.0 * spec["N_grad"][:, 0]
    np.testing.assert_allclose(spec["f_NL"], 5.0 / (3.0 * phi**2), rtol=0.1)
    np.testing.assert_allclose(spec["N_hess"][:, 0, 0], 0.5, rtol=0.02)
    np.testing.assert_allclose(spec["N_hess"][:, 0, 1], 0.0, atol=5e-3)


def test_delta_n_order_validation(quadratic):
    art, m, rows, times = quadratic
    with pytest.raises(ValueError, match="order"):
        tp.delta_n_spectrum(art, m, rows, times, order=3, device=CPU)


def test_delta_n_sweep_batches_parameter_sets(quadratic):
    """delta_n_sweep reproduces delta_n_spectrum per set, and the φ²
    scaling law pins the per-set parameter routing (N_grad m₁-independent,
    P_ζ ∝ m₁²)."""
    art, m, rows, times = quadratic
    pars = np.array([[1.0, 1.0], [1.05, 1.0], [0.95, 1.2]])
    kw = dict(pivots=4, N_margin_start=5.0, N_margin_end=8.0, steps=2000,
              max_err=1e-9, device=CPU)
    sw = tp.delta_n_sweep(art, pars, [12.0, 0.0], [0.0, 0.0], **kw)
    assert sw["P_zeta"].shape == (3, 4)
    assert sw["ok"].all() and sw["failures"] == [None] * 3
    one = tp.delta_n_spectrum(art, m, rows, times, **kw)
    np.testing.assert_allclose(sw["ln_k"][0], one["ln_k"], atol=1e-6)
    np.testing.assert_allclose(sw["P_zeta"][0], one["P_zeta"], rtol=1e-3)
    np.testing.assert_allclose(sw["N_grad"][0], one["N_grad"], atol=1e-4)
    np.testing.assert_allclose(sw["N_grad"][1, :, 0], sw["N_grad"][0, :, 0],
                               rtol=1e-4)
    np.testing.assert_allclose(sw["P_zeta"][1] / sw["P_zeta"][0],
                               1.05**2, rtol=1e-3)
    np.testing.assert_allclose(sw["P_zeta"][2] / sw["P_zeta"][0],
                               0.95**2, rtol=1e-3)
    np.testing.assert_allclose(sw["ln_k"][1] - sw["ln_k"][0],
                               np.log(1.05), atol=1e-3)


def test_delta_n_sweep_failure_isolation(quadratic):
    """A start at φ = 1 leaves slow roll within a fraction of an e-fold: with
    on_failure='nan' its outputs NaN-fill while the healthy set stays
    finite; the default raises with the set index."""
    art, m, rows, times = quadratic
    pars = np.array([[1.0, 1.0], [1.0, 1.0]])
    f0 = np.array([[12.0, 0.0], [1.0, 0.0]])
    kw = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0, steps=2000, device=CPU)
    sw = tp.delta_n_sweep(
        art, pars, f0, [0.0, 0.0], order=2, on_failure="nan", **kw
    )
    np.testing.assert_array_equal(sw["ok"], [True, False])
    assert np.isfinite(sw["P_zeta"][0]).all()
    assert np.isfinite(sw["f_NL"][0]).all()
    assert np.isnan(sw["P_zeta"][1]).all()
    assert np.isnan(sw["N_hess"][1]).all()
    assert "too short" in sw["failures"][1]
    with pytest.raises(ValueError, match="parameter set 1"):
        tp.delta_n_sweep(art, pars, f0, [0.0, 0.0], **kw)


def test_pivot_placement_by_N_before_end(quadratic):
    """pivot_N_before_end places pivots at CMB-style e-fold distances
    before the end of inflation on every route, overriding pivots=."""
    art, m, rows, times = quadratic
    spec = tp.delta_n_spectrum(
        art, m, rows, times, pivot_N_before_end=[25.0, 20.0, 15.0],
        N_margin_start=5.0, N_margin_end=8.0, steps=2000, device=CPU,
    )
    assert spec["P_zeta"].shape == (3,)
    np.testing.assert_allclose(np.diff(spec["N"]), [5.0, 5.0], atol=1e-9)
    ms = tp.mode_spectrum(
        art, m, rows, times, pivot_N_before_end=[20.0, 15.0],
        N_margin_start=5.0, N_margin_end=8.0,
        dense_steps=800, tail_steps=300, device=CPU,
    )
    np.testing.assert_allclose(np.diff(ms["N"]), [5.0], atol=1e-9)
    assert np.isfinite(ms["P_zeta"]).all()
    np.testing.assert_allclose(ms["ln_k"], spec["ln_k"][1:], atol=1e-9)
    sw = tp.delta_n_sweep(
        art, np.array([[1.0, 1.0], [1.05, 1.05]]), [12.0, 0.0], [0.0, 0.0],
        steps=2000, pivot_N_before_end=[20.0, 15.0],
        N_margin_start=5.0, N_margin_end=8.0, device=CPU,
    )
    assert sw["ok"].all() and sw["P_zeta"].shape == (2, 2)
    np.testing.assert_allclose(sw["N_grad"][1], sw["N_grad"][0],
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="valid window"):
        tp.delta_n_spectrum(
            art, m, rows, times, pivot_N_before_end=[2.0], device=CPU
        )


def test_squeezed_fnl_maldacena_consistency(quadratic):
    """The response route reproduces the full Maldacena consistency
    relation f_NL^sq = (5/12)(1 − n_s) on a single-field background."""
    art, m, rows, times = quadratic
    kw = dict(steps=2000, max_err=1e-9, N_margin_start=2.0, N_margin_end=5.0,
              device=CPU)
    sq = tp.squeezed_fnl(
        art, m, rows, times, N_long_before_end=28.0,
        N_short_before_end=(18.0, 12.0), **kw,
    )
    assert sq["f_NL_sq"].shape == (2,)
    dn = tp.delta_n_spectrum(
        art, m, rows, times,
        pivot_N_before_end=[19.0, 18.0, 17.0, 13.0, 12.0, 11.0], **kw,
    )
    maldacena = (5.0 / 12.0) * (1.0 - dn["n_s"][[1, 4]])
    np.testing.assert_allclose(sq["f_NL_sq"], maldacena, rtol=0.02)
    np.testing.assert_allclose(sq["ln_k_short"], dn["ln_k"][[1, 4]],
                               atol=1e-9)
    np.testing.assert_allclose(sq["response"][1], 0.0, atol=1e-4)
    np.testing.assert_allclose(sq["P_zeta_short"], dn["P_zeta"][[1, 4]],
                               rtol=1e-3)
    with pytest.raises(ValueError, match="squeezed limit"):
        tp.squeezed_fnl(
            art, m, rows, times, N_long_before_end=15.0,
            N_short_before_end=(18.0,), **kw,
        )
    with pytest.raises(ValueError, match="valid window"):
        tp.squeezed_fnl(
            art, m, rows, times, N_long_before_end=200.0,
            N_short_before_end=(18.0,), **kw,
        )


def test_squeezed_fnl_multifield_dilation_split(curved):
    """On the turning curved background the response route sits at the
    adiabatic consistency value while the δN local amplitude carries only
    the non-dilation part."""
    art, args, rows, times = curved
    kw = dict(steps=3000, max_err=1e-9, N_margin_start=2.0, N_margin_end=5.0,
              device=CPU)
    sq = tp.squeezed_fnl(
        art, args, rows, times, N_long_before_end=22.0,
        N_short_before_end=(14.0,), **kw,
    )
    dn = tp.delta_n_spectrum(
        art, args, rows, times, pivot_N_before_end=[15.0, 14.0, 13.0],
        order=2, **kw,
    )
    consistency = (5.0 / 12.0) * (1.0 - dn["n_s"][1])
    np.testing.assert_allclose(sq["f_NL_sq"][0], consistency, rtol=0.05)
    assert np.all(np.abs(sq["response"][:, 0]) > 1e-3)
    assert dn["f_NL"][1] < 0.7 * sq["f_NL_sq"][0]


def test_spectra_error_paths(quadratic):
    art, m, rows, times = quadratic
    with pytest.raises(ValueError, match="does not end"):
        tp.delta_n_spectrum(art, m, rows[:50], times[:50], device=CPU)
    with pytest.raises(ValueError, match="N_margin_end"):
        tp.mode_spectrum(art, m, rows, times, N_margin_end=1.0, device=CPU)
    with pytest.raises(ValueError, match="N_margin_start"):
        tp.mode_spectrum(art, m, rows, times, N_margin_start=1.0, device=CPU)
    with pytest.raises(ValueError, match="too short"):
        tp.delta_n_spectrum(
            art, m, rows, times, N_margin_start=50.0, N_margin_end=50.0,
            device=CPU,
        )
    with pytest.raises(ValueError, match="raise steps"):
        tp.delta_n_spectrum(
            art, m, rows, times, pivots=3, N_margin_start=3.0, steps=60,
            device=CPU,
        )


# ----------------------------------------------------------------------- #
# mesh= takes a Mesh (the sharded cases: tests/test_torch_parallel_spectra.py) #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("entry", ["delta_n_spectrum", "squeezed_fnl", "mode_spectrum",
                                   "transport_spectrum"])
def test_mesh_raises_until_multi_gpu(quadratic, entry):
    art, m, rows, times = quadratic
    with pytest.raises(TypeError, match="make_mesh"):
        getattr(tp, entry)(art, m, rows, times, mesh=object(), device=CPU)


@pytest.mark.parametrize("entry", ["delta_n_sweep", "mode_sweep", "transport_sweep"])
def test_sweep_mesh_raises_until_multi_gpu(quadratic, entry):
    art, m, _, _ = quadratic
    with pytest.raises(TypeError, match="make_mesh"):
        getattr(tp, entry)(art, np.array([m]), [12.0, 0.0], [0.0, 0.0], mesh=object(),
                           device=CPU)


def test_cuda_device_without_cuda_raises(quadratic, monkeypatch):
    """The default device is the card; without one the entries raise
    instead of computing on the CPU."""
    import torch

    art, m, rows, times = quadratic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tp.delta_n_spectrum(art, m, rows, times),
                 lambda: tp.mode_spectrum(art, m, rows, times),
                 lambda: tp.transport_sweep(art, np.array([m]), [12.0, 0.0], [0.0, 0.0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
