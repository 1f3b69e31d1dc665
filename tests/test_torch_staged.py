"""The generated headers' hash-consed model functions, host-built: the
solver's merged derivative ``inflx_deriv`` and the grid-scan functions split
into row, column and point stages.

Each header is compiled with the host C++ compiler and
``-ffp-contract=off``, as the other header tests do.  Tolerances, each with
its reason:

* ``inflx_deriv`` against ``artifact.eom`` and ``artifact.eom_hdot`` (the
  JAX package's EoM, ported through a bundle, for the doc model): bit for
  bit; these EoMs use only + − × ÷ and integer powers, which round alike in
  C and in torch;
* the staged grid evaluation (each row stage once per row, each column
  stage once per column, then the point stage at every point) against the
  same header's stages run in a row at each point: bit for bit in every
  precision (the staging only names values);
* against the plain version on the CPU: bit for bit for hyperinflation in
  f64 and EGNO in double-double; D5 in f64 within rtol 2e-15 (its log, cos
  and sin come from the host libm in the harness and from torch's on the
  CPU, which part in the last bit now and then; on the card both are
  CUDA's and the kernel is bit for bit its plain version, chip_smoke.py);
  f32 within 8 ulp, as tests/test_torch_precision.py (the header multiplies
  by a reciprocal where torch divides by a CPU scalar).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
from inflatox_torch.lowering import cuda_codegen
from inflatox_torch.ops.build import CSRC
from inflatox_torch.ops.dd import DD, to_f64
from inflatox_torch.ops.grid import axis_coords

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
HYP_EXTENT = (0.5, 2.5, 0.25, 3.0)
D5_EXTENT = (0.1, 36.0, 0.0, 4 * np.pi)
EGNO_EXTENT = (0.46, 0.50, 0.0, np.pi)
D5_ARGS = {"V0": -1.17e-8, "N": 1000.0, "g_s": 0.01, "l_s": 501.961, "u": 50 * 501.961,
           "q": 1.0, "p": 5.0, "a0": 0.001, "a1": 0.0005, "b1": 0.001}
EGNO_ARGS = {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0}
SHAPE = (12, 10)  # rows, columns: unequal, so a transposed index shows


def _cxx():
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    return cxx


def _build(header, harness, workdir):
    (workdir / "inflx_model.h").write_text(header)
    (workdir / "harness.cpp").write_text(harness)
    lib = workdir / "libharness.so"
    subprocess.run(
        [_cxx(), "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(workdir), "-I", str(CSRC), "-o", str(lib), str(workdir / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


# --------------------------------------------------------------------------- #
# the solver's merged derivative                                               #
# --------------------------------------------------------------------------- #

_DERIV_HARNESS = r"""
#include <stdint.h>
#include "inflx_model.h"

extern "C" void deriv_all(int64_t n, const double* x, const double* xd, const double* p,
                          double* out) {
  for (int64_t i = 0; i < n; ++i)
    inflx_deriv(x + i * INFLX_NF, xd + i * INFLX_NF, p, out + i * (2 * INFLX_NF + 1));
}

// the out-of-line fallback, as inflx_deriv calls it on the card
extern "C" void deriv_cold_all(int64_t n, const double* x, const double* xd, const double* p,
                               double* out) {
  for (int64_t i = 0; i < n; ++i)
    inflx_deriv_cold_into(x + i * INFLX_NF, xd + i * INFLX_NF, p,
                          out + i * (2 * INFLX_NF + 1));
}
"""


def _three_field():
    a, b, c, m = sympy.symbols("a3 b3 c3 m3")
    V = sympy.Rational(1, 2) * m**2 * (a**2 + 2 * b**2 + 3 * c**2)
    model = inflatox_torch.InflationModelBuilder.new(
        [a, b, c], [[1, 0, 0], [0, 1, 0], [0, 0, 1]], V, silent=True,
    ).build(guesses=[[0, 1, 0], [0, 0, 1]])
    return inflatox_torch.Compiler(model, silent=True).compile(), np.array([1.3])


@pytest.fixture(scope="module")
def solver_models(doc_model_artifact, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundles") / "doc.json")
    doc_model_artifact.save(path)
    angular, angular_args = inflatox_torch.models.angular()
    return {
        "doc": (inflatox_torch.CompiledModel.load(path), np.array([1.0])),
        "angular": (inflatox_torch.Compiler(angular, silent=True).compile(),
                    np.asarray(angular_args, dtype=np.float64)),
        "three": _three_field(),
    }


@pytest.mark.parametrize("name", ["doc", "angular", "three"])
def test_inflx_deriv_is_eom_and_eom_hdot_bit_for_bit(solver_models, name, tmp_path):
    art, args = solver_models[name]
    n = art.n_fields
    rng = np.random.default_rng(5)
    lo, hi = (-0.6, 0.6) if name == "angular" else (0.5, 2.5)
    x = rng.uniform(lo, hi, (64, n))
    xd = rng.uniform(-0.3, 0.3, (64, n))
    p = np.ascontiguousarray(args, dtype=np.float64)
    out = np.zeros((64, 2 * n + 1))
    dll = _build(art.cuda_solver_source(), _DERIV_HARNESS, tmp_path)
    dll.deriv_all(ctypes.c_int64(64), _ptr(x), _ptr(xd), _ptr(p), _ptr(out))
    cold = np.zeros_like(out)
    dll.deriv_cold_all(ctypes.c_int64(64), _ptr(x), _ptr(xd), _ptr(p), _ptr(cold))
    np.testing.assert_array_equal(cold, out)
    xs = [torch.from_numpy(np.ascontiguousarray(x[:, a])) for a in range(n)]
    xds = [torch.from_numpy(np.ascontiguousarray(xd[:, a])) for a in range(n)]
    pt = torch.from_numpy(p)
    want = [*xds, *art.eom(xs, xds, pt), art.eom_hdot(xs, xds, pt)]
    for k, w in enumerate(want):
        w = np.broadcast_to(np.asarray(w, dtype=np.float64), (64,))
        np.testing.assert_array_equal(out[:, k], w, err_msg=f"output {k}")


def test_solver_header_has_no_per_term_copies(solver_models):
    src = solver_models["three"][0].cuda_solver_source()
    defined = set(re.findall(r"INFLX_(?:FN|COLD) \w+ (\w+)\(", src))
    assert defined == {"inflx_powi", "inflx_powi_bits", "inflx_max", "inflx_min", "inflx_sign",
                       "f_eom_h", "inflx_deriv", "inflx_deriv_exact", "inflx_deriv_cold",
                       "inflx_deriv_cold_into", "inflx_chi_sq"}


def test_derivative_divides_without_branches_and_falls_back_whole():
    """inflx_deriv's divisions are inflx_div_fast (negative integer powers
    included, as 1 / b**|n|); inflx_deriv_exact, which it runs out of line
    (inflx_deriv_cold) when one of them is out of range, keeps the
    operator."""
    x0, x1, m = sympy.symbols("x0 x1 m")
    V = m**2 * (x0**2 + x1**2) / (1 + x0**2) + 1 / x1**2
    model = inflatox_torch.InflationModelBuilder.new([x0, x1], [[1, 0], [0, x0**2 + 1]], V,
                                                     silent=True).build()
    art = inflatox_torch.Compiler(model, silent=True, cse=True).compile()
    src = art.cuda_solver_source()
    exact = src.split("INFLX_FN void inflx_deriv_exact(")[1].split("\n}\n")[0]
    fast = src.split("INFLX_FN void inflx_deriv(")[1].split("\n}\n")[0]
    assert "inflx_div_fast" not in exact and exact.count(" / ") >= 2
    assert " / v" not in fast and fast.count("inflx_div_fast(") >= 2
    assert "inflx_deriv_cold_into(x, xd, p, out);" in fast and "inflx_deriv_exact" not in fast
    cold = src.split("INFLX_COLD inflx_slope_t inflx_deriv_cold(")[1].split("\n}\n")[0]
    assert "inflx_deriv_exact(s.x, s.xd, p, r.out);" in cold


# --------------------------------------------------------------------------- #
# the grid functions in row, column and point stages                           #
# --------------------------------------------------------------------------- #

#: each grid function whole at one point, for the host harnesses: its row,
#: column and point stages in a row (the header has no whole model
#: functions; the point kernels run the fused point functions)
WHOLE_FUNCTIONS = r"""
template <typename C>
static auto f_V(const C* x, const C* p) {
  C r[F_V_NR + 1], c[F_V_NC + 1];
  f_V_row(x, p, r);
  f_V_col(x, p, c);
  return f_V_point(x, p, r, c);
}
template <typename C>
static auto f_gsq(const C* x, const C* p) {
  C r[F_GSQ_NR + 1], c[F_GSQ_NC + 1];
  f_gsq_row(x, p, r);
  f_gsq_col(x, p, c);
  return f_gsq_point(x, p, r, c);
}
template <typename C, typename R>
static void f_hesse(const C* x, const C* p, R* out) {
  C r[F_HESSE_NR + 1], c[F_HESSE_NC + 1];
  f_hesse_row(x, p, r);
  f_hesse_col(x, p, c);
  f_hesse_point(x, p, r, c, out);
}
template <typename C, typename R>
static void f_grad(const C* x, const C* p, R* out) {
  C r[F_GRAD_NR + 1], c[F_GRAD_NC + 1];
  f_grad_row(x, p, r);
  f_grad_col(x, p, c);
  f_grad_point(x, p, r, c, out);
}
"""

_GRID_HARNESS = r"""
#include <stdint.h>
#include <vector>
#include "inflx_model.h"
""" + WHOLE_FUNCTIONS + r"""

#if INFLX_PRECISION == 2
typedef dd T;
static T coord(const double* a, int64_t i) { return dd_make(a[2 * i], a[2 * i + 1]); }
static T param(double v) { return dd_c(v); }
#elif INFLX_PRECISION == 1
typedef float T;
static T coord(const double* a, int64_t i) { return (float)a[2 * i]; }
static T param(double v) { return (float)v; }
#else
typedef double T;
static T coord(const double* a, int64_t i) { return a[2 * i]; }
static T param(double v) { return v; }
#endif
#define N_OUT 8  // V, V_vv, V_vw, V_wv, V_ww, |grad V|^2, dV/dx0, dV/dx1

// staged: every row stage once per row, every column stage once per column
extern "C" void staged(int64_t n0, int64_t n1, const double* a0, const double* a1,
                       const double* pin, double* out) {
  T p[INFLX_NP + 1];
  for (int k = 0; k < INFLX_NP; ++k) p[k] = param(pin[k]);
  const int nc = F_V_NC + F_HESSE_NC + F_GSQ_NC + F_GRAD_NC + 1;
  const int nr = F_V_NR + F_HESSE_NR + F_GSQ_NR + F_GRAD_NR + 1;
  std::vector<T> cols(n1 * nc), rows(nr);
  for (int64_t j = 0; j < n1; ++j) {
    const T x[2] = {coord(a0, 0), coord(a1, j)};
    T* c = &cols[j * nc];
    f_V_col(x, p, c);
    f_hesse_col(x, p, c + F_V_NC);
    f_gsq_col(x, p, c + F_V_NC + F_HESSE_NC);
    f_grad_col(x, p, c + F_V_NC + F_HESSE_NC + F_GSQ_NC);
  }
  const int64_t plane = n0 * n1;
  for (int64_t i = 0; i < n0; ++i) {
    T x[2] = {coord(a0, i), coord(a1, 0)};
    T* r = rows.data();
    f_V_row(x, p, r);
    f_hesse_row(x, p, r + F_V_NR);
    f_gsq_row(x, p, r + F_V_NR + F_HESSE_NR);
    f_grad_row(x, p, r + F_V_NR + F_HESSE_NR + F_GSQ_NR);
    for (int64_t j = 0; j < n1; ++j) {
      x[1] = coord(a1, j);
      const T* c = &cols[j * nc];
      double* o = out + i * n1 + j;
      decltype(f_V(x, p)) h[4], g[2];
      o[0] = f_V_point(x, p, r, c);
      f_hesse_point(x, p, r + F_V_NR, c + F_V_NC, h);
      o[5 * plane] = f_gsq_point(x, p, r + F_V_NR + F_HESSE_NR, c + F_V_NC + F_HESSE_NC);
      f_grad_point(x, p, r + F_V_NR + F_HESSE_NR + F_GSQ_NR,
                   c + F_V_NC + F_HESSE_NC + F_GSQ_NC, g);
      for (int k = 0; k < 4; ++k) o[(1 + k) * plane] = h[k];
      o[6 * plane] = g[0];
      o[7 * plane] = g[1];
    }
  }
}

// the three stages in a row at each point (WHOLE_FUNCTIONS)
extern "C" void pointwise(int64_t n0, int64_t n1, const double* a0, const double* a1,
                          const double* pin, double* out) {
  T p[INFLX_NP + 1];
  for (int k = 0; k < INFLX_NP; ++k) p[k] = param(pin[k]);
  const int64_t plane = n0 * n1;
  for (int64_t i = 0; i < n0; ++i)
    for (int64_t j = 0; j < n1; ++j) {
      const T x[2] = {coord(a0, i), coord(a1, j)};
      double* o = out + i * n1 + j;
      decltype(f_V(x, p)) h[4], g[2];
      o[0] = f_V(x, p);
      f_hesse(x, p, h);
      o[5 * plane] = f_gsq(x, p);
      f_grad(x, p, g);
      for (int k = 0; k < 4; ++k) o[(1 + k) * plane] = h[k];
      o[6 * plane] = g[0];
      o[7 * plane] = g[1];
    }
}
"""


def _grid_models():
    hyp, hyp_args = inflatox_torch.models.hyperinflation()
    hyp = inflatox_torch.Compiler(hyp, silent=True).compile()
    d5 = inflatox_torch.CompiledModel.load(os.path.join(FIXTURES, "d5_bundle.json"))
    egno = inflatox_torch.CompiledModel.load(os.path.join(FIXTURES, "egno_bundle.json"))
    args = np.asarray(hyp_args, dtype=np.float64)
    return {
        "hyperinflation-f64": (hyp, args, HYP_EXTENT, "f64"),
        "hyperinflation-f32": (hyp, args, HYP_EXTENT, "f32"),
        "d5-f64": (d5, inflatox_torch.models._args_by_symbol(d5.model, D5_ARGS), D5_EXTENT,
                   "f64"),
        "egno-dd": (egno, inflatox_torch.models._args_by_symbol(egno.model, EGNO_ARGS),
                    EGNO_EXTENT, "dd"),
    }


@pytest.fixture(scope="module")
def grid_models():
    return _grid_models()


def _axes(extent, precision):
    """(axis 0, axis 1) as (n, 2) f64 arrays of (hi, lo) words, and the
    plain version's coordinate tensors."""
    axes, plain = [], []
    for (start, stop), n in zip((extent[:2], extent[2:]), SHAPE):
        a = axis_coords(start, stop, n, "cpu", precision)
        if precision == "dd":
            axes.append(np.ascontiguousarray(np.stack([a.hi.numpy(), a.lo.numpy()], 1)))
        else:
            axes.append(np.ascontiguousarray(np.stack([a.double().numpy(),
                                                       np.zeros(n)], 1)))
        plain.append(a)
    return axes, plain


def _plain(art, args, plain_axes, precision):
    """V, the Hesse, |∇V|² and ∇V on the grid from the plain version."""
    n0, n1 = SHAPE
    if precision == "dd":
        a0, a1 = plain_axes
        xs = (DD(a0.hi[:, None].expand(n0, n1), a0.lo[:, None].expand(n0, n1)),
              DD(a1.hi[None].expand(n0, n1), a1.lo[None].expand(n0, n1)))
        fns, p = art.dd_fns(), torch.from_numpy(args)
        values = [fns["potential"](xs, p), *fns["hesse"](xs, p), fns["grad_square"](xs, p),
                  *fns["grad"](xs, p)]
        return [to_f64(v).expand(n0, n1).numpy() for v in values]
    dtype = torch.float32 if precision == "f32" else torch.float64
    a0, a1 = (a.to(dtype) for a in plain_axes)
    xs = (a0[:, None].expand(n0, n1), a1[None].expand(n0, n1))
    p = torch.from_numpy(args).to(dtype)
    values = [art.potential(xs, p), *art.hesse_tuple(xs, p), art.grad_square(xs, p),
              *art._grad(xs, p)]
    return [torch.as_tensor(v, dtype=dtype).expand(n0, n1).double().numpy() for v in values]


@pytest.mark.parametrize("name", ["hyperinflation-f64", "hyperinflation-f32", "d5-f64",
                                  "egno-dd"])
def test_staged_grid_functions_match_the_plain_version(grid_models, name, tmp_path):
    art, args, extent, precision = grid_models[name]
    dll = _build(art.cuda_source(precision), _GRID_HARNESS, tmp_path)
    axes, plain_axes = _axes(extent, precision)
    p = np.ascontiguousarray(args, dtype=np.float64)
    staged, pointwise = (np.zeros((8, *SHAPE)) for _ in range(2))
    for fn, out in ((dll.staged, staged), (dll.pointwise, pointwise)):
        fn(ctypes.c_int64(SHAPE[0]), ctypes.c_int64(SHAPE[1]), _ptr(axes[0]), _ptr(axes[1]),
           _ptr(p), _ptr(out))
    np.testing.assert_array_equal(staged, pointwise)
    assert np.isfinite(staged).mean() > 0.5
    for k, want in enumerate(_plain(art, args, plain_axes, precision)):
        if precision == "f32":
            np.testing.assert_allclose(staged[k], want, rtol=8 * 2.0**-23, atol=0,
                                       err_msg=f"output {k}")
        elif name == "d5-f64":
            np.testing.assert_allclose(staged[k], want, rtol=2e-15, atol=0,
                                       err_msg=f"output {k}")
        else:
            np.testing.assert_array_equal(staged[k], want, err_msg=f"output {k}")


def _stage_of_calls(art, precision, call):
    """{stage: number of distinct nodes calling ``call``} over the four
    grid functions, and {stage: their x slots}."""
    where, slots = {}, {}
    for _, attr, n_out in cuda_codegen._GRID_FUNCTIONS:
        dag, _, st = cuda_codegen._grid_fn(getattr(art, attr), n_out, precision)
        for stage, nodes in (("row", st.row), ("col", st.col), ("point", st.point)):
            for k in nodes:
                if (call + "(") in dag.text[k].replace("_" + call + "(", ""):
                    where[stage] = where.get(stage, 0) + 1
                    slots.setdefault(stage, set()).update(dag.slots[k])
    return where, slots


def test_stages_take_the_one_coordinate_calls_out_of_the_point_stage(grid_models):
    egno = grid_models["egno-dd"][0]
    where, slots = _stage_of_calls(egno, "dd", "dd_pow")
    # EGNO's r-only powers all land in row stages; only a power that reads θ
    # stays in the point stage
    assert where["row"] >= 3 and slots["row"] == {"0"}
    assert where.get("point", 0) <= 1
    d5 = grid_models["d5-f64"][0]
    where, slots = _stage_of_calls(d5, "f64", "log")
    assert where.get("row", 0) >= 1 and set(where) == {"row"} and slots["row"] == {"0"}
    for call in ("cos", "sin"):
        where, slots = _stage_of_calls(d5, "f64", call)
        assert where.get("col", 0) >= 1 and set(where) == {"col"} and slots["col"] == {"1"}
    src = d5.cuda_source("f64")
    point_bodies = [part.split("\n}\n")[0] for part in src.split("_point(")[1:]]
    assert not any(f"{c}(" in body for body in point_bodies for c in ("log", "cos", "sin"))


def test_hash_consing_computes_each_repeated_subexpression_once():
    x0, x1, m = sympy.symbols("x0 x1 m")
    V = m**2 * (sympy.exp(x0**2) * sympy.cos(x1) + sympy.exp(x0**2) * sympy.sin(x1)) + x0 * x1
    model = inflatox_torch.InflationModelBuilder.new([x0, x1], [[1, 0], [0, 1]], V,
                                                     silent=True).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    src = art.cuda_source("f64")
    v_row = src.split("f_V_row(")[1].split("\n}\n")[0]
    assert v_row.count("exp(") == 1  # one exp(x0²), shared by both terms
    v_col = src.split("f_V_col(")[1].split("\n}\n")[0]
    assert v_col.count("cos(") == 1 and v_col.count("sin(") == 1
    ops = cuda_codegen.grid_stage_ops(art, "f64")["f_V"]
    assert ops["row"]["call"] == 1 and ops["col"]["call"] == 2
    assert set(ops) == {"row", "col", "point"}
