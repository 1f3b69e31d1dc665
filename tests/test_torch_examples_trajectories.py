"""The port's trajectory examples (``examples/torch_background_sweep.py``,
``examples/torch_fit_observables.py``) on the CPU with ``--device cpu``, at
reduced sizes, against the same calls through the JAX package on the same
inputs.  Tolerances:

* values read off one adaptive solve (rows, the end of validity, the
  survey's e-folds and crossings): rtol 1e-6 (XLA's ``pow`` against
  torch's, as in tests/test_torch_parallel.py), the rows where H > 0 (past
  H = 0 the term −3Hχ pumps any difference up);
* the on-trajectory scan of the port's own path against ``engine="xla"`` on
  the same points: rtol 5e-10, identical NaN masks;
* the fit (Adam against ``optax.adam``, which rounds its bias corrections
  differently): the first 50 losses at rtol 1e-10, the final parameters at
  atol 1e-6, as tests/test_torch_observables.py holds the same optimiser;
  the slow-roll values at the fitted point at rtol 1e-12 and the scan-API
  ε_V against ``engine="xla"`` at 5e-10;
* ``solve_eom_fixed``'s gradient against ``jax.grad``: rtol 1e-9, as
  tests/test_torch_observables.py holds it.
"""

import os
import subprocess
import sys

import numpy as np
import sympy

import inflatox_tpu
from inflatox_tpu import background as jbg
from inflatox_tpu import observables as job
from inflatox_tpu.consistency_conditions import GeneralisedAL as JaxAL

from test_torch_examples import (REPO, RTOL_MAPS, RTOL_SOLVE, assert_maps,
                                 assert_physical_rows, example)


def test_background_sweep_runs_as_a_script():
    """``python examples/torch_background_sweep.py --device cpu`` at 8
    trajectories × 80 rows and a 4² survey: exit code 0 and its last line."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_background_sweep.py"),
         "--device", "cpu", "--batch", "8", "--steps", "80", "--survey-n", "4"],
        capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "batch: (8, 80, 5) rows" in out.stdout
    assert "basin survey:" in out.stdout.splitlines()[-1]


def test_background_sweep_matches_the_jax_package(doc_model_artifact):
    """examples/torch_background_sweep.py at 16 trajectories × 120 rows (512
    × 400 in the script) and a 6² survey (32²), the batch's starts drawn as
    the script draws them (numpy, seed 0)."""
    mod = example("background_sweep")
    got = mod.main(["--device", "cpu", "--batch", "16", "--steps", "120", "--survey-n", "6"])
    art, args, steps = doc_model_artifact, np.array([1.0]), 120
    rng = np.random.default_rng(0)
    fields0 = np.column_stack([rng.uniform(1.8, 2.4, 16), rng.uniform(1.7, 2.3, 16)])
    np.testing.assert_array_equal(got["fields0"], fields0)
    rows, times = jbg.solve_eom_batch(art, args, steps, fields0, np.zeros((16, 2)),
                                      solver="rkf", return_time=True)
    assert_physical_rows(got["rows"], rows, "shared parameters")
    ends = mod.t_end(rows, times)
    np.testing.assert_allclose(mod.t_end(got["rows"], got["times"]), ends, rtol=RTOL_SOLVE)
    np.testing.assert_allclose(got["t_end_median"], np.median(ends), rtol=RTOL_SOLVE)

    masses = np.linspace(0.5, 2.0, 16)[:, None]
    s_rows, s_times = jbg.solve_eom_batch(art, masses, steps, fields0, np.zeros((16, 2)),
                                          solver="rkf", return_time=True)
    assert_physical_rows(got["sweep_rows"], s_rows, "per-trajectory masses")
    s_ends = mod.t_end(s_rows, s_times)
    np.testing.assert_allclose([got["sweep_t_end_max"], got["sweep_t_end_min"]],
                               [s_ends.max(), s_ends.min()], rtol=RTOL_SOLVE)
    assert "sharded_matches" not in got  # one device: no mesh

    want_ot = np.stack(JaxAL(art, validate_basis=False).complete_analysis_ot(
        args, got["rows"][0, :, :2], progress=False, engine="xla"))
    assert_maps(got["ot"], want_ot, label="complete_analysis_ot")

    basin = jbg.survey_initial_conditions(art, args, steps, got["survey_starts"], np.zeros(2))
    assert set(got["survey"]) == set(basin)
    np.testing.assert_array_equal(got["survey"]["ended"], basin["ended"])
    for key, want in basin.items():
        if key != "ended":
            np.testing.assert_allclose(got["survey"][key], want, rtol=RTOL_SOLVE, atol=1e-12,
                                       equal_nan=True, err_msg=key)
    assert got["survey_ended"] == int(basin["ended"].sum())
    np.testing.assert_allclose(got["survey_n_max"], np.nanmax(basin["N_inflation"]),
                               rtol=RTOL_SOLVE)


def test_fit_observables_matches_the_jax_package():
    """examples/torch_fit_observables.py at 300 Adam steps (2000 in the
    script) and its 401-point integration, against the JAX script's fit
    (``observables.fit_parameters``, optax's Adam at lr 0.01), slow roll,
    ``engine="xla"`` scan and ``jax.grad`` through ``solve_eom_fixed``."""
    import jax
    import jax.numpy as jnp

    got = example("fit_observables").main(["--device", "cpu", "--steps", "300"])
    model, _ = inflatox_tpu.models.natural()
    art = inflatox_tpu.Compiler(model, silent=True).compile()

    def slot(name):
        s = art.lookup_symbol(sympy.Symbol(name))
        return int(s[s.index("[") + 1 : -1])

    fa, m = slot("f_a"), slot("m")
    sr = job.slow_roll(art)

    def loss(z):
        a = jnp.zeros(art.n_parameters).at[fa].set(z[0]).at[m].set(0.05)
        out = sr(z[1:], a)
        return (out["n_s"] - 0.9649) ** 2 + (out["r"] - 0.036) ** 2

    res = job.fit_parameters(loss, np.array([5.0, 4.0, 0.1]), steps=300, learning_rate=0.01)
    np.testing.assert_allclose(got["loss_history"][:50], np.asarray(res.loss_history)[:50],
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(got["params"], np.asarray(res.params), rtol=0, atol=1e-6)

    args, pivot = got["args"], got["params"][1:]
    assert args[fa] == got["params"][0] and args[m] == 0.05
    want = sr(jnp.asarray(pivot), jnp.asarray(args))
    for key, value in got["fitted"].items():
        np.testing.assert_allclose(value, float(want[key]), rtol=1e-12, atol=0, err_msg=key)
    eps = JaxAL(art, validate_basis=False).epsilon_v(
        args, *(float(pivot[0]),) * 2, *(float(pivot[1]),) * 2, N_x0=1, N_x1=1,
        progress=False, engine="xla")
    np.testing.assert_allclose(got["scan_eps_torch"], float(eps[0, 0]), rtol=RTOL_MAPS)
    np.testing.assert_allclose(got["scan_eps_torch"], got["fitted"]["epsilon_v"], rtol=1e-12)

    grid = jnp.linspace(0.0, 2.0, 401)

    def displacement(a):
        rows = job.solve_eom_fixed(art, a, grid, jnp.asarray(pivot), jnp.zeros(2))
        return rows[-1, 0] - rows[0, 0]

    g = jax.grad(displacement)(jnp.asarray(args))
    np.testing.assert_allclose(got["grad"], np.asarray(g), rtol=1e-9, atol=0)
