"""Angular inflation (``inflatox_torch.models.angular()``, the benchmark's
configuration ``angular-f64``) on the survey path, on the CPU.

* The port's plain survey (engine ``"torch"``) against the benchmark's plain
  reference (``benchmarks/reference/angular-f64.py``, through
  ``background.py``'s ``solve`` and ``summary``): seeded starts in the
  cell's box, at the cell's limits on ``N_inflation``, ``H_end``,
  ``x_end`` and ``ended``.  Starts at the edge of the attractor's basin
  are ill-conditioned: their e-folds move by more than the limit when the
  start moves by 1e-12, so the rounding of either side decides them.  As
  the cell's check does (``benchmarks/traffic/survey_basin.py``), those
  whose own reference moves by more than a hundredth of the limit under a
  nudge of the start by 1e-9 are left out.
* B6's rejection counter: the plain version's rejects are its attempts
  less the accepted rows; kernel B6's integrator, built from
  ``csrc/solver.cuh`` with the host's C++ compiler, counts a trajectory's
  rejects as its attempts less its rows, and solves the plain version's
  rows.

The model comes from ``tests/fixtures/angular_bundle.json``, the port's
compiled bundle of ``models.angular()`` (its sympy build takes longer than
this file's tests), checked here against the reference's potential."""

import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import inflatox_torch
from inflatox_torch.background import survey_initial_conditions
from inflatox_torch.ops import cuda_solver
from inflatox_torch.ops.build import CSRC
from inflatox_torch.ops.cuda_solver import solve_torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks" / "reference"))

import background  # noqa: E402

BUNDLE = ROOT / "tests" / "fixtures" / "angular_bundle.json"
PARAMS = {"alpha": 1 / 600, "m_phi": 2e-5, "m_chi": 6e-5}
#: the cell's box of starts and its limits
BOX = (0.64, 0.705)
MAX_GAP, STEPS = 1e-4, 300


@pytest.fixture(scope="module")
def angular():
    art = inflatox_torch.CompiledModel.load(str(BUNDLE))
    args = np.zeros(art.n_parameters)
    for name, slot in art.symbol_dictionary.items():
        if slot.startswith("args["):
            args[int(slot[5:-1])] = PARAMS[name]
    spec = importlib.util.spec_from_file_location(
        "angular_f64", ROOT / "benchmarks" / "reference" / "angular-f64.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return art, args, background.Background(*ref.model())


def _gaps(a, b):
    """Per trajectory, |a − b| / max(|b|, 1) at its widest column; inf where
    one side only is finite, 0 where neither is."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    gap = np.where(np.isfinite(a) & np.isfinite(b), gap, 0.0)
    gap = np.where(np.isfinite(a) != np.isfinite(b), np.inf, gap)
    return gap.reshape(len(gap), -1).max(axis=1)


def _reference(bg, fields):
    rows, times, ambiguous = background.solve(bg, PARAMS, STEPS, fields,
                                              np.zeros_like(fields), 1e-6, np.float64)
    return background.summary(bg, PARAMS, rows, times), ambiguous


def test_bundle_is_the_reference_model(angular):
    """H from the Friedmann constraint of the bundle and of the reference at
    starts in the box and moving."""
    art, args, bg = angular
    rng = np.random.default_rng(0)
    x, chi = rng.uniform(*BOX, (2, 16)), rng.uniform(-1e-6, 1e-6, (2, 16))
    got = np.asarray(art.eom_h(list(torch.tensor(x)), list(torch.tensor(chi)),
                               torch.tensor(args)))
    want = bg.hubble(x[0], x[1], chi[0], chi[1], PARAMS)
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_plain_survey_matches_the_reference_where_it_is_conditioned(angular):
    """8 seeded starts in the box and the upstream start (0.7, 0.7), 300
    rows: every start that the reference pins down (its own summaries move
    by at most a hundredth of the limit when the start is nudged by 1e-9 in
    any of four directions) agrees within the cell's limits, ``ended``
    exactly; most starts are pinned down."""
    art, args, bg = angular
    fields = np.vstack([np.random.default_rng(7).uniform(*BOX, (8, 2)), [[0.7, 0.7]]])
    got = survey_initial_conditions(art, args, STEPS, fields, np.zeros(2), chunk=4,
                                    device="cpu")
    want, ambiguous = _reference(bg, fields)
    ill = ambiguous.copy()
    for signs in ((1, 1), (-1, -1), (1, -1), (-1, 1)):
        nudged, _ = _reference(bg, fields * (1.0 + 1e-9 * np.array(signs)))
        ill |= nudged["ended"] != want["ended"]
        for key in ("N_inflation", "H_end", "x_end"):
            ill |= _gaps(nudged[key], want[key]) > 0.01 * MAX_GAP
    keep = ~ill
    assert keep.sum() >= 5 and keep[-1]
    assert want["ended"][keep].any()
    np.testing.assert_array_equal(got["ended"][keep], want["ended"][keep])
    for key in ("N_inflation", "H_end", "x_end"):
        assert _gaps(got[key][keep], want[key][keep]).max() <= MAX_GAP, key


def test_plain_rejects_are_attempts_less_accepted_rows(angular):
    """Under a profiler the plain solver adds its rejected attempts to
    ``attempt_counts()``: every attempt that did not store a row."""
    art, args, _ = angular
    f0 = torch.tensor(np.random.default_rng(5).uniform(*BOX, (6, 2)))
    pars = torch.tensor(args)
    before = cuda_solver.attempt_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, _, attempts = solve_torch(art, pars, 40, f0, torch.zeros_like(f0),
                                     count_attempts=True)
    after = cuda_solver.attempt_counts()
    rejects = after["rejects"] - before["rejects"]
    assert after["attempts"] - before["attempts"] == int(attempts.sum())
    assert rejects == int(attempts.sum()) - 6 * 39 > 0
    solve_torch(art, pars, 40, f0, torch.zeros_like(f0))
    assert cuda_solver.attempt_counts() == after


_HARNESS = r"""
#include <stdint.h>
#include "inflx_model.h"
#include "solver.cuh"

// kernel B6's counting integrator over each trajectory in turn: rows
// (steps, 2n+2, B) as the kernel writes them; attempts and rejects (B,)
extern "C" void solve_counted(int64_t n_traj, const double* f0, const double* d0,
                              const double* p, int64_t steps, double max_err,
                              double* out, int64_t* attempts, int64_t* rejects) {
  for (int64_t b = 0; b < n_traj; ++b) {
    attempts[b] = inflx_solve_trajectory<INFLX_RKF45, true>(
        f0 + b * INFLX_NF, d0 + b * INFLX_NF, p, steps, max_err, 1.0 / max_err,
        out + b, (INFLX_NY + 1) * n_traj, n_traj, rejects + b);
  }
}
"""


def test_kernel_integrator_counts_its_rejects(angular, tmp_path):
    """The counting instance's integrator, built on the host: a
    trajectory's rejects are its attempts less its accepted rows, its
    attempts the plain version's, and its rows the plain version's (rtol
    1e-7: the host's libm pow is not torch's)."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    art, args, _ = angular
    (tmp_path / "inflx_model.h").write_text(art.cuda_solver_source())
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    lib = tmp_path / "libharness.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(tmp_path), "-I", str(CSRC), "-o", str(lib),
                    str(tmp_path / "harness.cpp")], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    dll.solve_counted.argtypes = [i64, ptr, ptr, ptr, i64, ctypes.c_double, ptr, ptr, ptr]
    n, steps = 6, 60
    f0 = np.random.default_rng(5).uniform(*BOX, (n, 2))
    d0 = np.zeros_like(f0)
    p = np.ascontiguousarray(args)
    out = np.zeros((steps, 6, n))
    attempts, rejects = np.zeros(n, np.int64), np.zeros(n, np.int64)
    dll.solve_counted(n, f0.ctypes.data, d0.ctypes.data, p.ctypes.data, steps, 1e-6,
                      out.ctypes.data, attempts.ctypes.data, rejects.ctypes.data)
    rows, times, plain = solve_torch(art, torch.tensor(p), steps, torch.tensor(f0),
                                     torch.tensor(d0), count_attempts=True)
    np.testing.assert_array_equal(rejects, attempts - (steps - 1))
    assert rejects.sum() > 0
    np.testing.assert_array_equal(attempts, plain.numpy())
    got = out.transpose(2, 0, 1)
    np.testing.assert_allclose(got[..., :5], rows.numpy(), rtol=1e-7, atol=1e-11)
    np.testing.assert_allclose(got[..., 5], times.numpy(), rtol=1e-7)
