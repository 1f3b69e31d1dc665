"""The background solver (``inflatox_torch.background``) and kernel B6's
plain version and C++ integrator, against the JAX package and independent
references.

The same inputs, made with numpy, go through ``inflatox_tpu.background``
and the port on the CPU (where every entry point runs the plain version of
kernel B6).  Kernel B6 itself runs only on a card: its tests are in
tests/test_torch_cuda.py.  Tolerances, each with its reason:

* the RHS and single RK attempts: rtol 1e-12, the same f64 arithmetic;
* whole solves against the JAX package: rtol 1e-6, row 0 at 1e-12.  XLA's
  f64 ``pow`` is only ~1e-8 accurate (CLAUDE.md), so its step-size
  sequence drifts from the port's over the rows;
* against the C oracle (``NativeModel.solve_eom_rkf``: glibc ``pow``, its
  own C printing of the EoM, ``max_err/err`` as a division): rtol 1e-7,
  measured 4.8e-8 on these inputs (the JAX package's while loop is 8.7e-8
  from the oracle there);
* against scipy: rtol 1e-4, atol 5e-7, as tests/test_background.py;
* the kernel's own C++ (``csrc/solver.cuh``, host-built) against the plain
  version: rtol 1e-7, atol 1e-11 for velocities crossing zero.  Both round
  alike op for op, but the host libm's ``pow`` and torch's CPU ``pow``
  differ in the last bit now and then, and the late rows of these
  trajectories (H < 0, growing velocities) amplify one such bit to 2e-8
  (measured)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch import background as tb
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops import cuda_kernels, cuda_solver
from inflatox_torch.ops.build import CSRC
from inflatox_torch.ops.cuda_solver import (
    derivative,
    embedded,
    solve_cuda,
    solve_torch,
)
from inflatox_torch.utils.errors import ShapeError
from inflatox_tpu import background as jb

STEPS = 200
DOC_ARGS = np.array([1.0])


def _three_field(pkg):
    a, b, c, m = sympy.symbols("a3 b3 c3 m3")
    V = sympy.Rational(1, 2) * m**2 * (a**2 + 2 * b**2 + 3 * c**2)
    model = pkg.InflationModelBuilder.new(
        [a, b, c], [[1, 0, 0], [0, 1, 0], [0, 0, 1]], V, silent=True
    ).build(guesses=[[0, 1, 0], [0, 0, 1]])
    return pkg.Compiler(model, silent=True).compile()


@pytest.fixture(scope="module")
def models(doc_model_artifact, trivial_artifact, tmp_path_factory):
    """name → (jax artifact, torch artifact loaded from its bundle, args)."""
    def port(jax_art, name):
        path = str(tmp_path_factory.mktemp("bundles") / f"{name}.json")
        jax_art.save(path)
        return inflatox_torch.CompiledModel.load(path)

    three = _three_field(inflatox_tpu)
    return {
        "doc": (doc_model_artifact, port(doc_model_artifact, "doc"), DOC_ARGS),
        "trivial": (trivial_artifact, port(trivial_artifact, "trivial"), np.array([1.0, 1.0])),
        "three": (three, port(three, "three"), np.array([1.3])),
    }


def _inits(batch, n, seed=0):
    f0 = np.random.default_rng(seed).uniform(1.5, 2.5, (batch, n))
    return f0, np.zeros_like(f0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))


# --------------------------------------------------------------------------- #
# stage primitives                                                             #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["doc", "trivial", "three"])
def test_rhs_and_single_attempts_match_jax(models, name):
    import jax.numpy as jnp

    jax_art, art, args = models[name]
    n = art.n_fields
    rng = np.random.default_rng(11)
    x = rng.uniform(1.5, 2.5, (3, n))
    chi = rng.uniform(-0.1, 0.1, (3, n))
    h = np.array([float(jax_art.eom_h(x[b], chi[b], args)) for b in range(3)])
    y = np.concatenate([x, chi, h[:, None]], axis=1)  # (B, 2n+1)
    dt = np.array([1e-3, 2e-3, 5e-4])
    f = jb._state_derivative(jax_art, jnp.float64)

    def jax_step(yb, dtb, a, b_hi, b_lo):
        return [np.asarray(v) for v in jb._rk_step(f, jnp.asarray(yb), dtb, args, a, b_hi, b_lo)]

    want_k = np.stack([np.asarray(f(jnp.asarray(yb), args)) for yb in y])
    want_rkf = [jax_step(y[b], dt[b], jb._RKF_A, jb._RKF_B5, jb._RKF_B4) for b in range(3)]
    want_rk4 = []
    for b in range(3):
        big = jax_step(y[b], dt[b], jb._RK4_A, jb._RK4_B, jb._RK4_B)[0]
        half = jax_step(y[b], dt[b] / 2.0, jb._RK4_A, jb._RK4_B, jb._RK4_B)[0]
        small = jax_step(half, dt[b] / 2.0, jb._RK4_A, jb._RK4_B, jb._RK4_B)[0]
        want_rk4.append((small, big))

    yt, dtt, at = _t(y.T), _t(dt), _t(args)
    np.testing.assert_allclose(derivative(art, yt, at).numpy().T, want_k, rtol=1e-12, atol=0)
    for solver, want in (("rkf", want_rkf), ("rk4", want_rk4)):
        hi, lo = embedded(art, solver, yt, dtt, at)
        np.testing.assert_allclose(hi.numpy().T, [w[0] for w in want], rtol=1e-12, atol=0)
        np.testing.assert_allclose(lo.numpy().T, [w[1] for w in want], rtol=1e-12, atol=0)


# --------------------------------------------------------------------------- #
# whole solves                                                                 #
# --------------------------------------------------------------------------- #


def _assert_solves_close(got, want, rtol, atol=0.0):
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.parametrize("solver", ["rk4", "rkf"])
@pytest.mark.parametrize("per_trajectory", [False, True], ids=["shared", "per_traj"])
def test_solve_eom_batch_matches_jax(models, solver, per_trajectory):
    jax_art, art, _ = models["doc"]
    pars = np.linspace(0.5, 2.0, 8)[:, None] if per_trajectory else DOC_ARGS
    f0, d0 = _inits(8, 2)
    want, t_want = jb.solve_eom_batch(jax_art, pars, STEPS, f0, d0, solver=solver,
                                      return_time=True)
    got, t_got = tb.solve_eom_batch(art, pars, STEPS, f0, d0, solver=solver,
                                    return_time=True, device="cpu")
    assert got.shape == (8, STEPS, 5) and t_got.shape == (8, STEPS)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12, atol=0)
    _assert_solves_close(got, want, 1e-6)
    _assert_solves_close(t_got, t_want, 1e-6)


@pytest.mark.parametrize("solver", ["rk4", "rkf"])
def test_solve_eom_matches_jax(models, solver):
    jax_art, art, args = models["doc"]
    want, t_want = jb.solve_eom(jax_art, args, STEPS, [2.0, 2.0], [0.0, 0.0],
                                solver=solver, return_time=True)
    got, t_got = tb.solve_eom(art, args, STEPS, [2.0, 2.0], [0.0, 0.0], solver=solver,
                              return_time=True, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    _assert_solves_close(got, want, 1e-6)
    _assert_solves_close(t_got, t_want, 1e-6)
    assert np.all(np.diff(t_got) > 0) and got[-1, 4] < got[0, 4]
    np.testing.assert_array_equal(
        tb.solve_eom(art, args, STEPS, [2.0, 2.0], [0.0, 0.0], solver=solver, device="cpu"),
        got,
    )


def test_solver_matches_c_oracle(models):
    from inflatox_tpu.native import NativeModel, native_available

    if not native_available():
        pytest.skip("no C compiler for the native oracle")
    jax_art, art, args = models["doc"]
    f0, d0 = _inits(8, 2, seed=4)
    want = NativeModel(jax_art.model).solve_eom_rkf(args, np.hstack([f0, d0]), STEPS)
    got, times = tb.solve_eom_batch(art, args, STEPS, f0, d0, solver="rkf",
                                    return_time=True, device="cpu")
    _assert_solves_close(got, want[..., :5], 1e-7)
    _assert_solves_close(times, want[..., 5], 1e-7)


def _scipy_reference(artifact, pars, t_max, x0, chi0):
    from scipy.integrate import solve_ivp

    d = artifact.n_fields

    def rhs(_t, y):
        x, chi, hub = y[:d], y[d:2 * d], y[2 * d]
        eom = [float(v) for v in artifact.eom(x, chi, pars)]
        acc = [-eom[a] - 3.0 * hub * chi[a] for a in range(d)]
        return np.concatenate([chi, acc, [float(artifact.eom_hdot(x, chi, pars))]])

    h0 = float(artifact.eom_h(np.array(x0), np.array(chi0), pars))
    y0 = np.concatenate([x0, chi0, [h0]])
    return solve_ivp(rhs, (0.0, t_max), y0, rtol=1e-10, atol=1e-12, dense_output=True)


@pytest.mark.parametrize("case", [("trivial", "rk4", STEPS), ("trivial", "rkf", STEPS),
                                  ("three", "rkf", 60)], ids=["trivial-rk4", "trivial-rkf",
                                                              "three-rkf"])
def test_solver_matches_scipy(models, case):
    name, solver, steps = case
    jax_art, art, args = models[name]
    n = art.n_fields
    x0 = np.array([1.0, 0.5]) if n == 2 else np.array([1.5, 1.2, 0.8])
    out, times = tb.solve_eom(art, args, steps, x0, np.zeros(n), max_err=1e-8,
                              solver=solver, return_time=True, device="cpu")
    assert out.shape == (steps, 2 * n + 1) and np.all(np.diff(times) > 0)
    ref = _scipy_reference(jax_art, args, float(times[-1]), x0, np.zeros(n))
    np.testing.assert_allclose(out, ref.sol(times).T, rtol=1e-4, atol=5e-7)


# --------------------------------------------------------------------------- #
# the kernel's integrator, compiled with the host C++ compiler                 #
# --------------------------------------------------------------------------- #

_HARNESS = r"""
#include <stdint.h>
#include "inflx_model.h"
#include "solver.cuh"

extern "C" void solve(int method, int64_t n_traj, const double* f0,
                      const double* d0, const double* p, int64_t p_stride,
                      int64_t steps, double max_err, double inv_max_err,
                      double* out) {
  for (int64_t b = 0; b < n_traj; ++b) {
    const double* pb = p == nullptr ? p : p + b * p_stride;
    double* o = out + b;
    const int64_t row = (INFLX_NY + 1) * n_traj;
    if (method == INFLX_RKF45) {
      inflx_solve_trajectory<INFLX_RKF45>(f0 + b * INFLX_NF, d0 + b * INFLX_NF, pb,
                                          steps, max_err, inv_max_err, o, row, n_traj);
    } else {
      inflx_solve_trajectory<INFLX_RK4>(f0 + b * INFLX_NF, d0 + b * INFLX_NF, pb,
                                        steps, max_err, inv_max_err, o, row, n_traj);
    }
  }
}
"""


def _host_solver(artifact, workdir):
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (workdir / "inflx_model.h").write_text(artifact.cuda_solver_source())
    (workdir / "harness.cpp").write_text(_HARNESS)
    lib = workdir / "libharness.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(workdir), "-I", str(CSRC), "-o", str(lib), str(workdir / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    dll.solve.argtypes = [ctypes.c_int, i64, ptr, ptr, ptr, i64, i64, f64, f64, ptr]
    return dll


@pytest.mark.parametrize("case", [("doc", "rkf", False), ("doc", "rk4", True),
                                  ("three", "rkf", True)],
                         ids=["doc-rkf-shared", "doc-rk4-per_traj", "three-rkf-per_traj"])
def test_solver_header_matches_solve_torch(models, case, tmp_path):
    name, solver, per_trajectory = case
    _, art, args = models[name]
    n = art.n_fields
    f0, d0 = _inits(8, n)
    pars = np.linspace(0.5, 2.0, 8)[:, None] if per_trajectory else args
    pars = np.ascontiguousarray(pars, dtype=np.float64)
    out = np.zeros((STEPS, 2 * n + 2, 8))
    dll = _host_solver(art, tmp_path)
    dll.solve(cuda_solver.METHODS[solver][0], 8, f0.ctypes.data, d0.ctypes.data,
              pars.ctypes.data, 1 if per_trajectory else 0, STEPS, 1e-6, 1.0 / 1e-6,
              out.ctypes.data)
    rows, times = solve_torch(art, _t(pars), STEPS, _t(f0), _t(d0), 1e-6, solver)
    got = out.transpose(2, 0, 1)
    _assert_solves_close(got[..., :-1], rows.numpy(), 1e-7, atol=1e-11)
    _assert_solves_close(got[..., -1], times.numpy(), 1e-7)


# --------------------------------------------------------------------------- #
# the rest of the background surface                                           #
# --------------------------------------------------------------------------- #


def test_efolds_matches_jax(models):
    t = np.array([[0.0, 0.1, 0.4, 1.0], [0.0, 0.2, 0.3, 0.9]])
    rows = np.zeros((2, 4, 5))
    rows[..., 4] = 2.0
    np.testing.assert_allclose(tb.efolds(rows, t), 2.0 * t, rtol=1e-15)

    _, art, args = models["doc"]
    out, times = tb.solve_eom_batch(art, args, 40, np.array([[2.0, 2.0]]), np.zeros((1, 2)),
                                    solver="rkf", max_err=1e-9, return_time=True,
                                    device="cpu")
    hdot = -0.5 * np.ones_like(times)
    np.testing.assert_array_equal(tb.efolds(out, times), jb.efolds(out, times))
    np.testing.assert_array_equal(tb.efolds(out, times, hdot), jb.efolds(out, times, hdot))
    with pytest.raises(ShapeError):
        tb.efolds(out, times[:, :-1])
    with pytest.raises(ShapeError):
        tb.efolds(out, times, hdot[:, :-1])


def test_survey_matches_jax(models):
    jax_art, art, _ = models["trivial"]
    m = np.array([1.0, 0.7])
    gx, gy = np.meshgrid(np.linspace(3.0, 24.0, 4), np.linspace(0.0, 6.0, 4))
    f0 = np.stack([gx.ravel(), gy.ravel()], axis=1)  # B = 16, 14 of them end in the span
    want = jb.survey_initial_conditions(jax_art, m, 400, f0, [0.0, 0.0], max_err=1e-8)
    got = tb.survey_initial_conditions(art, m, 400, f0, [0.0, 0.0], max_err=1e-8,
                                       chunk=6, device="cpu")
    assert got["ended"].dtype == bool and got["ended"].any() and not got["ended"].all()
    np.testing.assert_array_equal(got["ended"], want["ended"])
    for key in ("N_inflation", "H_end", "x_end", "N_span"):
        assert got[key].shape == want[key].shape
        _assert_solves_close(got[key], want[key], 1e-6)
    per_traj = tb.survey_initial_conditions(art, np.tile(m, (16, 1)), 400, f0, [0.0, 0.0],
                                            max_err=1e-8, chunk=6, device="cpu")
    for key in got:
        np.testing.assert_array_equal(per_traj[key], got[key])


def test_bundle_saved_by_jax_solves_in_the_port(models, tmp_path):
    jax_art, _, args = models["doc"]
    path = str(tmp_path / "doc.json")
    jax_art.save(path)
    art = inflatox_torch.CompiledModel.load(path)
    f0, d0 = _inits(3, 2, seed=2)
    got = tb.solve_eom_batch(art, args, 60, f0, d0, solver="rkf", device="cpu")
    want = jb.solve_eom_batch(jax_art, args, 60, f0, d0, solver="rkf")
    _assert_solves_close(got, want, 1e-6)


def test_shape_errors(models):
    _, art, args = models["doc"]
    f0, d0 = _inits(2, 2)
    cpu = {"device": "cpu"}
    with pytest.raises(ShapeError):
        tb.solve_eom(art, args, 10, [1.0], [0.0, 0.0], **cpu)
    with pytest.raises(ShapeError):
        tb.solve_eom(art, np.array([1.0, 2.0]), 10, [2.0, 2.0], [0.0, 0.0], **cpu)
    with pytest.raises(ValueError):
        tb.solve_eom(art, args, 10, [2.0, 2.0], [0.0, 0.0], solver="euler", **cpu)
    with pytest.raises(ShapeError, match="per-trajectory"):
        tb.solve_eom_batch(art, np.ones((3, 1)), 10, f0, d0, **cpu)
    with pytest.raises(ShapeError, match="shared parameters"):
        tb.solve_eom_batch(art, np.ones(2), 10, f0, d0, **cpu)
    with pytest.raises(ShapeError, match="\\(B, n_fields\\)"):
        tb.solve_eom_batch(art, args, 10, f0[:, :1], d0, **cpu)
    with pytest.raises(ShapeError, match="derivatives_init"):
        tb.solve_eom_batch(art, args, 10, f0, d0[:, :1], **cpu)
    with pytest.raises(ShapeError, match="initial conditions"):
        tb.survey_initial_conditions(art, args, 10, np.zeros((4, 3)), [0.0, 0.0], **cpu)
    with pytest.raises(ShapeError, match="per-trajectory"):
        tb.survey_initial_conditions(art, np.ones((3, 1)), 10, f0, [0.0, 0.0], **cpu)


def test_jax_only_options_raise(models):
    _, art, args = models["doc"]
    f0, d0 = _inits(2, 2)
    with pytest.raises(ValueError, match="B6"):
        tb.solve_eom_batch(art, args, 10, f0, d0, solver="rkf_pallas", device="cpu")
    with pytest.raises(ValueError, match="B6"):
        tb.survey_initial_conditions(art, args, 10, f0, [0.0, 0.0], solver="rkf_pallas",
                                     device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        tb.solve_eom_batch(art, args, 10, f0, d0, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        tb.survey_initial_conditions(art, args, 10, f0, [0.0, 0.0], mesh=object(),
                                     device="cpu")


def test_devices_and_engines(models, monkeypatch):
    _, art, args = models["doc"]
    f0, d0 = _inits(2, 2)
    with pytest.raises(ValueError, match="B6"):
        tb.solve_eom_batch(art, args, 10, f0, d0, device="cpu", engine="cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        tb.solve_eom_batch(art, args, 10, f0, d0, device="cpu", engine="fast")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tb.solve_eom_batch(art, args, 10, f0, d0)
    torch_rows = tb.solve_eom_batch(art, args, 10, f0, d0, device="cpu", engine="torch")
    np.testing.assert_array_equal(torch_rows, tb.solve_eom_batch(art, args, 10, f0, d0,
                                                                 device="cpu"))


def test_solve_cuda_on_cpu_is_the_plain_version_and_never_launches(models):
    _, art, args = models["three"]
    f0, d0 = _inits(4, 3)
    before = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    for solver in ("rkf", "rk4"):
        got = solve_cuda(art, _t(args), 30, _t(f0), _t(d0), 1e-6, solver)
        want = solve_torch(art, _t(args), 30, _t(f0), _t(d0), 1e-6, solver)
        assert got[0].shape == (4, 30, 7) and got[1].shape == (4, 30)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    tb.survey_initial_conditions(art, args, 30, f0, np.zeros(3), device="cpu")
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == before
    rows, times, attempts = solve_torch(art, _t(args), 30, _t(f0), _t(d0),
                                        count_attempts=True)
    assert attempts.shape == (4,) and bool((attempts >= 29).all())


def test_solver_argument_checks(models):
    _, art, args = models["doc"]
    f0, d0 = (_t(a) for a in _inits(2, 2))
    p = _t(args)
    with pytest.raises(ValueError, match="max_err"):
        solve_torch(art, p, 10, f0, d0, max_err=0.0)
    with pytest.raises(ValueError, match="steps"):
        solve_torch(art, p, 0, f0, d0)
    with pytest.raises(TypeError):
        solve_torch(art, p.float(), 10, f0, d0)
    with pytest.raises(ValueError, match="shape"):
        solve_torch(art, torch.ones(3, dtype=torch.float64), 10, f0, d0)


def test_ot_needs_two_fields(models):
    _, art, _ = models["three"]
    with pytest.raises(ShapeError):
        GeneralisedAL(art, device="cpu", validate_basis=False).complete_analysis_ot(
            [1.3], np.ones((4, 3)), progress=False)


def test_cuda_solver_header_covers_any_field_count(models):
    _, art, _ = models["three"]
    src = art.cuda_solver_source()
    # one merged derivative: 3 velocities, 3 EoM terms and Ḣ
    assert "#define INFLX_NF 3" in src and "void inflx_deriv(" in src and "out[6] = " in src
    assert art.cuda_solver_source() is src
    with pytest.raises(ValueError, match="2-field"):
        art.cuda_source()
    assert os.path.isfile(CSRC / "solver.cuh") and os.path.isfile(CSRC / "solver.cu")
