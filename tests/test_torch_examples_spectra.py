"""The port's spectra examples (``examples/torch_spectra.py``,
``examples/torch_pipeline.py``) on the CPU with ``--device cpu``, at reduced
sizes, against the same calls through the JAX package.

The port's ``background.solve_eom`` and ``solve_eom_batch`` are replaced by
ones that return the JAX package's RKF45 solves of the same starts (as
tests/test_torch_perturbations_dn.py does), so both packages read identical
trajectories and only the port's code differs: the δN assembly, squeezed
f_NL, the mode integrators, the COBE scale, matching and horizon exit.
Tolerances:

* δN, squeezed f_NL and the mode spectrum: first-order outputs
  (``P_zeta``, ``N_grad``, ``P_tensor``, ``P_iso``, …) rtol 1e-10;
  ``N_hess``, ``f_NL`` and ``f_NL_sq`` rtol 1e-8 (second differences
  amplify a few ulp of the inner products by 1/h2²); the mode spectrum's
  tilts (``n_s``, ``n_t``, ``alpha_s``) and ``cos_delta`` atol 1e-9, as
  tests/test_torch_perturbations_modes.py holds them;
* the pipeline's mode spectrum on the α-attractor, where the model's
  second vielbein vector cancels catastrophically near r → 1 (C17: its
  sympy expression expands (1 − r²)⁴; at the pipeline's start (0.99, 0.5)
  XLA's w is 1.6e-3 and torch's 6.4e-4 off 40-digit mpmath, and the two
  part by 2.3e-3): the quantities the start's vielbein reaches are held at
  the envelope that fault leaves, about 10× the measured difference —
  ``P_zeta`` and ``r`` rtol 1e-4 (measured 4.5e-6), ``n_s`` atol 1e-5
  (1.8e-7), ``alpha_s`` atol 1e-6 (1.6e-8), ``P_iso`` rtol 0.1 (8.2e-3),
  ``cos_delta`` atol 5e-3 (5.1e-4); the rest, ``P_tensor`` and ``n_t``
  among them, at the first-order tolerances;
* the survey's map (analysis against ``engine="xla"``): rtol 5e-10,
  identical NaN masks;
* ``cobe_normalize``, ``n_star_matching`` and ``horizon_exit`` on the same
  rows: rtol 1e-12, as tests/test_torch_observables.py holds them.
"""

import numpy as np
import pytest
import sympy

import inflatox_tpu
from inflatox_torch import background as tbg
from inflatox_torch.models import _args_by_symbol
from inflatox_tpu import background as jbg
from inflatox_tpu import observables as job
from inflatox_tpu import perturbations as jp
from inflatox_tpu.consistency_conditions import GeneralisedAL as JaxAL

from test_torch_examples import assert_maps, example

RTOL_FIRST = 1e-10
RTOL_SECOND = 1e-8
SECOND = ("N_hess", "f_NL", "f_NL_sq")
TILTS = ("n_s", "n_t", "alpha_s", "cos_delta")
# (rtol, atol) of the α-attractor's mode spectrum against the JAX package's
# where the start's vielbein (C17) reaches it
C17 = {"P_zeta": (1e-4, 0), "r": (1e-4, 0), "n_s": (0, 1e-5), "alpha_s": (0, 1e-6),
       "P_iso": (0.1, 0), "cos_delta": (0, 5e-3)}


@pytest.fixture
def jax_solves(monkeypatch):
    """Route the port's solves to the JAX package's solver on the same
    starts: ``use(jax_artifact)``."""

    def use(jax_art):
        def solve(artifact, pars, steps, f0, chi0, max_err=1e-6, solver="rk4",
                  return_time=False, **_):
            return jbg.solve_eom(jax_art, pars, steps, f0, chi0, max_err=max_err,
                                 solver=solver, return_time=return_time)

        def solve_batch(artifact, pars, steps, f0, chi0, max_err=1e-6, solver="rk4",
                        return_time=False, **_):
            return jbg.solve_eom_batch(jax_art, pars, steps, f0, chi0, max_err=max_err,
                                       solver=solver, return_time=return_time)

        monkeypatch.setattr(tbg, "solve_eom", solve)
        monkeypatch.setattr(tbg, "solve_eom_batch", solve_batch)

    return use


def assert_spectrum(got, want, label, envelope=None):
    """``envelope``: (rtol, atol) by key, in place of the defaults."""
    assert set(got) == set(want), label
    for key, w in want.items():
        if isinstance(w, list):
            assert got[key] == w, (label, key)
            continue
        w, g = np.asarray(w), np.asarray(got[key])
        assert g.shape == w.shape, (label, key)
        if envelope and key in envelope:
            rtol, atol = envelope[key]
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{label} {key}")
        elif key in TILTS:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=f"{label} {key}")
        else:
            rtol = RTOL_SECOND if key in SECOND else RTOL_FIRST
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, equal_nan=True,
                                       err_msg=f"{label} {key}")


def test_spectra_matches_the_jax_package(jax_solves):
    """examples/torch_spectra.py at its 3000-row backgrounds, 4 pivots (8 in
    the script) and a survey of the first 2 of its 6 parameter sets at 4
    pivots (6): δN, the mode spectrum, their agreement and the survey
    against ``inflatox_tpu.perturbations`` on the JAX package's solves."""
    p1, p2, m1, m2, b = sympy.symbols("p1 p2 m1 m2 b", real=True)
    V = sympy.Rational(1, 2) * (m1 * p1) ** 2 + sympy.Rational(1, 2) * (m2 * p2) ** 2
    g = [[sympy.Integer(1), 0], [0, sympy.exp(2 * b * p1)]]
    model = inflatox_tpu.InflationModelBuilder.new([p1, p2], g, V, silent=True).build()
    art = inflatox_tpu.Compiler(model, silent=True).compile()
    jax_solves(art)
    got = example("spectra").main(["--device", "cpu", "--pivots", "4", "--sweep-pivots", "4",
                                   "--sweep-sets", "2"])
    args = _args_by_symbol(art.model, {"m1": 1e-5, "m2": 0.8e-5, "b": 0.25})
    rows, times = jbg.solve_eom(art, args, 3000, [10.0, 1.5], [0.0, 0.0], max_err=1e-10,
                                solver="rkf", return_time=True)
    np.testing.assert_array_equal(got["rows"], rows)
    dn = jp.delta_n_spectrum(art, args, rows, times, pivots=4, order=2, max_err=1e-10,
                             N_margin_end=8.0)
    assert_spectrum(got["dn"], dn, "delta_n_spectrum")
    ms = jp.mode_spectrum(art, args, rows, times, pivots=4, N_margin_end=8.0)
    assert_spectrum(got["ms"], ms, "mode_spectrum")
    rel = ms["P_zeta"] / np.interp(ms["ln_k"], dn["ln_k"], dn["P_zeta"]) - 1.0
    np.testing.assert_allclose(got["rel"], rel, rtol=RTOL_FIRST, atol=0)
    assert np.all(np.abs(rel) < 0.08)

    grid_m2, grid_b = np.meshgrid([0.6e-5, 0.8e-5, 1.0e-5], [0.15, 0.25])
    pars = np.stack([_args_by_symbol(art.model, {"m1": 1e-5, "m2": mm, "b": bb})
                     for mm, bb in zip(grid_m2.ravel(), grid_b.ravel())])[:2]
    np.testing.assert_array_equal(got["pars"], pars)
    sweep = jp.delta_n_sweep(art, pars, [10.0, 1.5], [0.0, 0.0], steps=3000, pivots=4,
                             max_err=1e-10, N_margin_end=8.0, on_failure="nan")
    assert_spectrum(got["sweep"], sweep, "delta_n_sweep")
    assert got["sweep"]["ok"].all()


@pytest.fixture(scope="module")
def alpha():
    """The JAX package's α-attractor and its default parameters."""
    model, args = inflatox_tpu.models.alpha_attractor()
    return inflatox_tpu.Compiler(model, silent=True).compile(), args


def test_alpha_attractor_vielbein_cancels_in_both_packages(alpha, tmp_path):
    """C17, a fault of the model's symbolic build: the second vielbein
    vector at the pipeline's start (0.99, 0.5) is off 40-digit mpmath by
    more than 1e-4 in both packages (the first within 1e-12), and the two
    packages part by more than 1e-4 there: why the pipeline's mode spectrum
    is held at C17's envelope."""
    import torch

    import inflatox_torch

    art, args = alpha
    art.save(str(tmp_path / "alpha.json"))
    port = inflatox_torch.CompiledModel.load(str(tmp_path / "alpha.json"))
    x = np.array([0.99, 0.5])
    want = np.asarray(art.basis([x[0], x[1]], args), float)
    got = port.basis([torch.tensor(x[0]), torch.tensor(x[1])], torch.tensor(args)).numpy()
    basis = [[sympy.sympify(c) for c in vec] for vec in art.model.basis]
    subs = {}
    for sym in set().union(*(c.free_symbols for vec in basis for c in vec)):
        slot = art.symbol_dictionary[str(sym)]
        k = int(slot[slot.index("[") + 1 : -1])
        subs[sym] = sympy.Float(float(x[k] if slot.startswith("x") else args[k]), 40)
    exact = np.array([[float(sympy.N(c.subs(subs), 40)) for c in vec] for vec in basis])
    np.testing.assert_allclose(got[0], exact[0], rtol=1e-12)
    np.testing.assert_allclose(want[0], exact[0], rtol=1e-12)
    for w in (got[1], want[1]):
        assert np.abs(w / exact[1] - 1).max() > 1e-4
    assert np.abs(got[1] / want[1] - 1).max() > 1e-4


def test_pipeline_matches_the_jax_package(jax_solves, alpha):
    """examples/torch_pipeline.py at a 32² survey (256² in the script), its
    3000-row backgrounds and its 6 pivots: the survey against
    ``engine="xla"``, then COBE normalisation, the re-solve, N_* matching,
    horizon exit, δN, the mode spectrum and squeezed f_NL against the JAX
    package's on the JAX package's solves, and the script's two asserts."""
    art, args0 = alpha
    jax_solves(art)
    got = example("pipeline").main(["--device", "cpu", "--n", "32"])
    extent = (0.05, 0.995, 0.0, np.pi)
    maps = np.stack(JaxAL(art, validate_basis=False).complete_analysis(
        args0, *extent, 32, 32, progress=False, engine="xla"))
    assert_maps(got["maps"], maps, label="survey")
    np.testing.assert_allclose(got["frac"], np.mean(np.nan_to_num(maps[1], nan=np.inf) < 1e-2))

    x0 = np.array([0.99, 0.5])
    rows, times = jbg.solve_eom(art, args0, 3000, x0, np.zeros(2), max_err=1e-9,
                                solver="rkf", return_time=True)
    res = job.cobe_normalize(art, rows, times, args0)
    for key, value in res.items():
        np.testing.assert_allclose(got["cobe"][key], value, rtol=1e-12, atol=0, err_msg=key)
    slot = art.lookup_symbol(sympy.Symbol("M4"))
    args = args0.copy()
    args[int(slot[slot.index("[") + 1 : -1])] *= res["scale"]
    np.testing.assert_allclose(got["args"], args, rtol=1e-12, atol=0)
    args = got["args"]  # the same inputs from here on
    rows, times = jbg.solve_eom(art, args, 3000, x0, np.zeros(2), max_err=1e-9,
                                solver="rkf", return_time=True)
    np.testing.assert_array_equal(got["rows"], rows)

    match = job.n_star_matching(art, args, rows, times, k_mpc=0.05)
    for key, value in match.items():
        np.testing.assert_allclose(got["match"][key], value, rtol=1e-12, atol=0, err_msg=key)
    info = job.horizon_exit(art, rows, times, args, N_before_end=match["N_star"])
    for key, value in info.items():
        np.testing.assert_allclose(got["exit"][key], value, rtol=1e-12, atol=0, err_msg=key)

    dn = jp.delta_n_spectrum(art, args, rows, times, pivots=6, order=2, N_margin_end=10.0,
                             max_err=1e-10)
    assert_spectrum(got["dn"], dn, "delta_n_spectrum")
    ms = jp.mode_spectrum(art, args, rows, times, pivots=6, N_margin_end=10.0)
    assert_spectrum(got["ms"], ms, "mode_spectrum", envelope=C17)
    sq = jp.squeezed_fnl(art, args, rows, times, N_long_before_end=match["N_star"],
                         N_short_before_end=(match["N_star"] - 6.0, match["N_star"] - 10.0),
                         max_err=1e-10)
    assert_spectrum(got["squeezed"], sq, "squeezed_fnl")

    p_at_pivot = np.interp(info["N_exit"], dn["N"], dn["P_zeta"])
    np.testing.assert_allclose(got["p_at_pivot"], p_at_pivot, rtol=RTOL_FIRST)
    assert abs(p_at_pivot / 2.1e-9 - 1) < 0.05
    assert np.all(np.abs(got["rel"][:3]) < 0.08)
