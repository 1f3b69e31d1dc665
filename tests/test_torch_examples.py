"""The port's example scripts (``examples/torch_*.py``) run on the CPU, at
reduced sizes, with ``--device cpu``: each runs to its end, its own checks
hold, and the numbers its ``main`` returns match the same calls through the
JAX package on the same inputs and sizes.

This file: the posterior (a subprocess, its own check), the quickstart, the
engines tour and the special functions.  The trajectory examples are in
tests/test_torch_examples_trajectories.py, the spectra in
tests/test_torch_examples_spectra.py.  Tolerances:

* grid and point scans against ``engine="xla"``: rtol 5e-10, identical NaN
  masks (the repo's tolerance for the analysis maps);
* ``calc_V`` and ``calc_H``: rtol 1e-12;
* values read off one adaptive solve: rtol 1e-6 (XLA's ``pow`` against
  torch's, as in tests/test_torch_parallel.py), on the rows where H > 0
  (past H = 0 the term −3Hχ pumps any difference up; the JAX script's own
  solves run there too);
* the f32 row against the JAX package's ``engine="pallas"`` in Pallas
  interpret mode, as tests/test_torch_precision.py holds the f32 scan.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import sympy

import inflatox_torch
import inflatox_tpu
from inflatox_tpu import background as jbg
from inflatox_tpu.consistency_conditions import GeneralisedAL as JaxAL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_MAPS = 5e-10
RTOL_POINT = 1e-12
RTOL_SOLVE = 1e-6
EXTENT = (0.5, 2.5, 0.25, 3.0)


def example(name):
    """``examples/torch_<name>.py`` as a module (its ``main`` not run)."""
    path = os.path.join(REPO, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_maps(got, want, rtol=RTOL_MAPS, label=""):
    """Identical NaN/±inf masks, the finite values within ``rtol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    assert np.array_equal(np.isnan(got), np.isnan(want)), label
    assert np.array_equal(np.isinf(got), np.isinf(want)), label
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=0, err_msg=label)


def assert_physical_rows(got, want, label=""):
    """Rows of one or more solves, (…, steps, 5): equal where H > 0 in the
    JAX package's rows, within rtol 1e-6 (a floor of 1e-12 for values
    crossing 0)."""
    keep = want[..., 4] > 0
    assert keep.sum() > 0.3 * keep.size, label
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL_SOLVE, atol=1e-12,
                               err_msg=label)


def test_posterior_example_runs_on_the_cpu():
    """examples/torch_posterior.py at 4 chains × 400 draws after 200 warmup
    (the script's defaults are 3000 and 1000): its posterior variances
    within 20 % of the Fisher forecast, as at full size."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_posterior.py"),
         "--device", "cpu", "--num-samples", "400", "--num-warmup", "200"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MCMC posterior matches the autodiff Fisher forecast" in out.stdout


QUICK = ["--n", "32", "--steps", "120", "--batch", "4", "--batch-steps", "60",
         "--sweep-n", "16", "--sweep-sets", "3"]


def test_quickstart_matches_the_jax_package(doc_model_artifact):
    """examples/torch_quickstart.py at a 32² analysis (512² in the script),
    a 120-row solve (200), 4 × 60 batched rows (16 × 100) and a sweep of 3
    masses × 16² (8 × 128²); against the JAX script's calls: ``calc_V``,
    ``calc_H`` at 1e-12, both analyses and the sweep's minima against
    ``engine="xla"`` at 5e-10, the solves at 1e-6 where H > 0."""
    got = example("quickstart").main(["--device", "cpu", *QUICK])
    args = np.array([1.0])
    jal = JaxAL(doc_model_artifact)
    x = np.array([2.0, -2.0])
    np.testing.assert_allclose(got["V"], jal.calc_V(x, args), rtol=RTOL_POINT, atol=0)
    np.testing.assert_allclose(got["H"], jal.calc_H(x, args), rtol=RTOL_POINT, atol=0)
    want = np.stack(jal.complete_analysis(args, 0.0, 2.5, 0.0, np.pi, 32, 32, progress=False,
                                          engine="xla"))
    assert_maps(got["maps"], want, label="complete_analysis")
    assert_maps(got["fast_maps"], want, label="the f64 route")
    np.testing.assert_allclose(got["cons_nanmin"], np.nanmin(want[0]), rtol=RTOL_MAPS)
    assert got["fast_ran"] == "the plain version"

    traj, t = jbg.solve_eom(doc_model_artifact, args, 120, [2.0, 2.0], [0.0, 0.0],
                            solver="rkf", return_time=True)
    assert_physical_rows(got["traj"], traj, "solve_eom")
    np.testing.assert_allclose(got["t"][traj[:, 4] > 0], t[traj[:, 4] > 0], rtol=RTOL_SOLVE)
    inits = np.column_stack([np.linspace(1.8, 2.2, 4), np.full(4, 2.0)])
    batch = jbg.solve_eom_batch(doc_model_artifact, args, 60, inits, np.zeros_like(inits),
                                solver="rkf")
    assert got["batch"].shape == batch.shape == (4, 60, 5)
    assert_physical_rows(got["batch"], batch, "solve_eom_batch")

    from inflatox_tpu.parallel import parameter_sweep

    masses = np.linspace(0.5, 2.0, 3)[:, None]
    sweep = parameter_sweep(jal, masses, EXTENT, (16, 16), progress=False, engine="xla",
                            reduce_fn=lambda maps: maps[0].min())
    assert_maps(got["sweep"], np.asarray(sweep), label="parameter_sweep")
    assert "sharded_shape" not in got  # one device: no mesh


def test_engines_tour_matches_the_jax_package(doc_model_artifact):
    """examples/torch_engines_tour.py at 16 × 16 (256² in the script; the
    script's square grid at test_torch_precision.py's size), every row on
    the plain version: the reference, f64 and double-double rows against
    ``engine="xla"`` at 5e-10, identical NaN masks; the f32 row against the
    JAX package's ``engine="pallas"`` in interpret mode as
    tests/test_torch_precision.py holds it (rtol 1e-4 where the JAX f32 and
    f64 maps agree within 1e-4; ε_H where its condition number passes 1e3
    within 16·κ·2⁻²⁴ of f64; the median error at most twice the JAX
    engine's); the pair output's hi + lo within 2⁻⁴⁸ of the f64 value."""
    from test_torch_precision import _eps_h_condition

    got = example("engines_tour").main(["--device", "cpu", "--n", "16"])
    args = np.array([1.0])
    jal = JaxAL(doc_model_artifact, validate_basis=False)
    f64 = np.stack(jal.complete_analysis(args, *EXTENT, 16, 16, progress=False, engine="xla"))
    f32 = np.stack([np.asarray(m, np.float64) for m in jal.complete_analysis(
        args, *EXTENT, 16, 16, progress=False, engine="pallas")])
    rows = got["rows"]
    assert list(rows) == ["reference", "f64", "f32", "dd"]
    for key in ("reference", "f64", "dd"):
        assert_maps(rows[key]["maps"], f64, label=key)
        np.testing.assert_allclose(rows[key]["nanmax"], np.nanmax(f64[0]), rtol=RTOL_MAPS)
    assert rows["f64"]["median_dev"] == 0.0
    assert rows["dd"]["median_dev"] < 1e-14

    port32 = rows["f32"]["maps"]
    assert port32.dtype == np.float32
    port_doc = inflatox_torch.Compiler(inflatox_torch.models.hyperinflation()[0]).compile()
    kappa = _eps_h_condition(port_doc, args, EXTENT, (16, 16))
    for k, (g, w32, w64) in enumerate(zip(port32.astype(np.float64), f32, f64)):
        assert np.array_equal(np.isnan(g), np.isnan(w32))
        settled = np.isfinite(w64) & (np.abs(w32 - w64) <= 1e-4 * np.abs(w64))
        if k == 2:
            unsettled = kappa > 1e3
            bound = 16 * kappa[unsettled] * 2.0**-24 * np.abs(w64[unsettled])
            assert (np.abs(g[unsettled] - w64[unsettled]) <= bound).all()
            settled &= ~unsettled
        np.testing.assert_allclose(g[settled], w32[settled], rtol=1e-4, atol=0)
        finite = np.isfinite(w64) & (w64 != 0)
        err, jax_err = (np.median(np.abs(a[finite] - w64[finite]) / np.abs(w64[finite]))
                        for a in (g, w32))
        assert err <= 2 * jax_err + 1e-7
    np.testing.assert_allclose(got["pair_value"], rows["f64"]["maps"][0, 0, 0],
                               rtol=2.0**-48, atol=0)
    np.testing.assert_allclose(got["pair_value"], f64[0, 0, 0], rtol=RTOL_MAPS)


def _special_model(v):
    x, y, a = sympy.symbols("x y a")
    model = inflatox_tpu.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], v(x, y, a), silent=True, simplify=False, assertions=False,
    ).build()
    return inflatox_tpu.Compiler(model, silent=True).compile()


def test_special_functions_match_the_jax_package():
    """examples/torch_special_functions.py at a 24² analysis (128² in the
    script) and a 16² V grid (64²): the Bessel model's maps against
    ``engine="xla"`` at 5e-10 with identical NaN masks, the hypergeometric
    model's V grid and V(1.0, 0.7) at 1e-12."""
    got = example("special_functions").main(["--device", "cpu", "--n", "24", "--v-n", "16"])
    assert got["bessel_route"] == got["hyp_route"] == (
        "the plain PyTorch version on the CPU, in f64")
    half, th, fh = sympy.Rational(1, 2), sympy.Rational(3, 2), sympy.Rational(5, 2)
    bessel = _special_model(lambda x, y, a: a * sympy.besselj(sympy.Rational(5, 2), x + 1) ** 2
                            + sympy.besselk(sympy.Rational(201, 100), x + 2) * y**2 + 2)
    hyp = _special_model(lambda x, y, a: a * sympy.hyper((half,), (th,), -(x**2))
                         + sympy.hyper((half, th), (fh,), y**2 / 4) / 10
                         + sympy.erf(x) * sympy.gamma(y + 2) / 50 + 2)
    args = np.array([2.0])
    want = np.stack(JaxAL(bessel, validate_basis=False).complete_analysis(
        args, 0.5, 3.0, 0.2, 1.5, 24, 24, progress=False, engine="xla"))
    assert_maps(got["maps"], want, label="Bessel model")
    np.testing.assert_allclose(got["finite_fraction"], np.isfinite(want[0]).mean())
    jh = JaxAL(hyp, validate_basis=False)
    v_grid = jh.calc_V_array(args, (0.3, 0.2), (2.0, 1.2), N=(16, 16))
    np.testing.assert_allclose(got["V_grid"], v_grid, rtol=RTOL_POINT, atol=0)
    assert got["V_grid_finite"]
    np.testing.assert_allclose(got["V_point"], jh.calc_V(np.array([1.0, 0.7]), args),
                               rtol=RTOL_POINT, atol=0)
