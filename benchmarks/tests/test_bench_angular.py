"""The configuration ``angular-f64`` and its cell ``angular.survey``.

The reference (``reference/angular-f64.py`` through ``background.py``)
against inflatox's upstream trajectory: 91.6 e-folds of inflation from the
start (0.7, 0.7) at rest.  The flat loop of ``reference/background_flat.py``
against ``background.solve``: the same rows, bit for bit.  And the check
that decides the cell's ``correct`` (``traffic/survey_basin.py``), on the
host at a small size: a sound run reads ``true``; each fault of its traffic
kind and the control (the reference in f32 in the program's place) read
``false``.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH / "reference"))

import background  # noqa: E402
import background_flat  # noqa: E402
import control  # noqa: E402
import run  # noqa: E402

H = run.H
CELL = "angular.survey"
SMALL = {"batch": 16, "steps": 300, "chunk": 8, "check_stride": 1, "check_among": 1,
         "min_call_ms": 0.5, "trace_calls": 1}
PARAMS = {"alpha": 1 / 600, "m_phi": 2e-5, "m_chi": 6e-5}


def _reference(name):
    spec = importlib.util.spec_from_file_location(name.replace("-", "_"),
                                                  BENCH / "reference" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_reference_reproduces_the_upstream_trajectory():
    """inflatox's tests/trajectories/angular_phi{x,y}.npy start at (0.7,
    0.7) at rest; 2000 RKF45 rows at max_err 1e-6 give 91.6 e-folds."""
    bg = background.Background(*_reference("angular-f64").model())
    rows, times, ambiguous = background.solve(bg, PARAMS, 2000, np.array([[0.7, 0.7]]),
                                              np.zeros((1, 2)), 1e-6, np.float64)
    out = background.summary(bg, PARAMS, rows, times)
    assert out["ended"][0] and not ambiguous[0]
    assert out["N_inflation"][0] == pytest.approx(91.6, abs=0.05)


@pytest.mark.parametrize("name,box", [("angular-f64", (0.64, 0.705)),
                                      ("hyperinflation-f64", (1.5, 2.5))])
def test_flat_loop_solves_the_rows_of_the_row_loop(name, box):
    ref = _reference(name)
    bg = background.Background(*ref.model())
    params = PARAMS if name == "angular-f64" else {"m": 1.0}
    fields = np.random.default_rng(3).uniform(*box, (24, 2))
    for dtype in (np.float64, np.float32):
        want = background.solve(bg, params, 150, fields, np.zeros_like(fields), 1e-6, dtype)
        got = background_flat.solve(bg, params, 150, fields, np.zeros_like(fields), 1e-6,
                                    dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_sound_run_is_correct():
    (row,) = control.readings(CELL, [2**33 + 29], 0.3, SMALL, device="cpu")
    assert row["correct"] is True, row


@pytest.mark.parametrize("fault", ["altered", "half_left_out", "unchanged_state"])
def test_fault_makes_the_run_incorrect(fault):
    (row,) = control.readings(CELL, [2**33 + 29], 0.3, SMALL, fault, device="cpu")
    limits = H.load_json("workloads", f"{CELL}.json")["limits"]
    assert row["attempted"] > 0 and row["failed"] == 0
    assert row["correct"] is False
    assert any(row[k] > limits[k] for k in limits), row


def test_control_fails_the_limits():
    """The reference in f32 in the program's place reads above the cell's
    limit."""
    (row,) = control.readings(CELL, [2**33 + 41], 0.3, {**SMALL, "precision": "f32"},
                              device="cpu")
    limits = H.load_json("workloads", f"{CELL}.json")["limits"]
    assert row["correct"] is False
    assert any(row[k] > limits[k] for k in limits), row
