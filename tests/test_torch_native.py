"""The port's native C backend (``inflatox_torch.native``) against the JAX
package's (``inflatox_tpu.native``) and against the port's own scans, on the
CPU.

* Every test of tests/test_native.py, on the port: the port's
  ``NativeModel`` against the port's ``GeneralisedAL(device="cpu")`` (the
  plain versions of kernels B1 and B5a) and the port's own solver, at the
  JAX test's tolerances.
* The generated C, text for text the JAX package's apart from the header
  comment that names the generator: hyperinflation, the committed EGNO and
  D5 bundles (tests/fixtures/) and the 1F1/2F1/Γ model of
  tests/test_native.py:140.
* Every ``NativeModel`` method bit for bit the JAX package's on the same
  inputs: the same source, compiler and flags on one host give the same
  bits (NaN at the same places).
* The port's ``GeneralisedAL(device="cpu")`` maps within rtol 5e-10 of the
  port's own oracle, identical NaN/±inf masks (the repo's tolerance for the
  analysis maps, as in tests/test_native.py).
"""

import json
import os

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.lowering.registry import SymbolRegistry
from inflatox_torch.native import NativeModel, native_available
from inflatox_torch.native.codegen import generate_c_source
from inflatox_tpu.lowering.registry import SymbolRegistry as JaxRegistry
from inflatox_tpu.native import NativeModel as JaxNativeModel
from inflatox_tpu.native.codegen import generate_c_source as jax_generate_c_source

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no C compiler available"
)

CPU = "cpu"
PARAMS = np.array([1.0])
EXTENT = (0.5, 2.5, 0.25, 3.0)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _hyp_model(package):
    """The 1F1/2F1/erf/Γ model of tests/test_native.py:140."""
    x, y, a = sympy.symbols("x y a", real=True)
    half, threehalf, fivehalf = (sympy.Rational(1, 2),
                                 sympy.Rational(3, 2), sympy.Rational(5, 2))
    V = (a * sympy.hyper((half,), (threehalf,), -(x**2))
         + sympy.hyper((half, threehalf), (fivehalf,), y**2 / 4) / 10
         + sympy.erf(x) * sympy.gamma(y + 2) / 50 + 2)
    return package.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], V, silent=True, simplify=False, assertions=False,
    ).build()


def _without_header(src):
    first, rest = src.split("\n", 1)
    assert first.startswith("// Generated by inflatox_")
    return rest


@pytest.fixture(scope="module")
def doc():
    model, _ = inflatox_torch.models.hyperinflation()
    return inflatox_torch.Compiler(model, silent=True).compile()


@pytest.fixture(scope="module")
def native(doc):
    return NativeModel(doc.model)


@pytest.fixture(scope="module")
def jax_native(doc_model_artifact):
    return JaxNativeModel(doc_model_artifact.model)


def _al(art):
    return GeneralisedAL(art, device=CPU, validate_basis=False)


# ----------------------------------------------------------------------- #
# tests/test_native.py on the port                                         #
# ----------------------------------------------------------------------- #


def test_symbol_dictionary_matches(doc, native):
    assert native.symbol_dictionary == doc.symbol_dictionary


def test_point_eval_matches_torch(doc, native):
    al = _al(doc)
    x = np.array([2.0, -2.0])
    v, h00, h01, h10, h11, gsq = native.point_eval(x, PARAMS)
    assert np.isclose(v, al.calc_V(x, PARAMS), rtol=1e-12)
    h = al.calc_H(x, PARAMS)
    np.testing.assert_allclose([[h00, h01], [h10, h11]], h, rtol=1e-12)


def test_complete_analysis_matches_torch(doc, native):
    al = _al(doc)
    n = (32, 16)
    torch_maps = al.complete_analysis(PARAMS, *EXTENT, *n, progress=False)
    nat_maps = native.complete_analysis(PARAMS, *EXTENT, *n)
    for k in range(6):
        np.testing.assert_allclose(nat_maps[k], torch_maps[k], rtol=5e-10, equal_nan=True)


def test_trajectory_matches_grid(native):
    xs = np.column_stack([np.linspace(0.6, 2.4, 50), np.linspace(0.3, 2.9, 50)])
    ot = native.complete_analysis_ot(PARAMS, xs)
    for i in (0, 17, 49):
        v, v00, _, v10, v11, gsq = native.point_eval(xs[i], PARAMS)
        lhs = v11 / v
        rhs = 3 + 3 * (v00 / v10) ** 2 + (v00 / v) * (v10 / v00) ** 2
        cons = min(abs(lhs - rhs) / (abs(lhs) + abs(rhs)), 1.0)
        assert np.isclose(ot[i, 0], cons, rtol=1e-12)


def test_potential_grid(native, doc):
    al = _al(doc)
    nat = native.calc_V_grid(PARAMS, *EXTENT, 16, 8)
    tv = al.calc_V_array(PARAMS, EXTENT[::2], EXTENT[1::2], [16, 8])
    np.testing.assert_allclose(nat, tv, rtol=1e-12)


def test_eom_eval(native, doc):
    x = torch.tensor([2.0, 1.5], dtype=torch.float64)
    xd = torch.tensor([0.1, -0.2], dtype=torch.float64)
    p = torch.tensor(PARAMS)
    out = native.eom_eval(x.numpy(), xd.numpy(), PARAMS)
    want_eom = [float(v) for v in doc.eom(x, xd, p)]
    np.testing.assert_allclose(out[:2], want_eom, rtol=1e-10)
    assert np.isclose(out[2], float(doc.eom_h(x, xd, p)), rtol=1e-10)
    assert np.isclose(out[3], float(doc.eom_hdot(x, xd, p)), rtol=1e-10)


def test_rapidturn_refstyle_matches_torch(native, doc):
    want = _al(doc).consistency_rapidturn(PARAMS, *EXTENT, 24, 24, progress=False)
    got = native.consistency_rapidturn_refstyle(PARAMS, *EXTENT, 24, 24)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_native_solver_matches_the_port(native, doc):
    """The C RKF45 solver against the port's ``solve_eom`` (kernel B6's
    plain version on the CPU): same tableau, same step control, rtol 1e-6
    over 200 rows (adaptive steps compound round-off)."""
    steps = 200
    want, t_want = inflatox_torch.background.solve_eom(
        doc, PARAMS, steps, [2.0, 2.0], [0.0, 0.0], solver="rkf", return_time=True,
        device=CPU)
    got = native.solve_eom_rkf(PARAMS, np.array([[2.0, 2.0, 0.0, 0.0]]), steps)
    np.testing.assert_allclose(got[0, :, :5], want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got[0, :, 5], t_want, rtol=1e-6, atol=1e-12)
    assert np.all(np.diff(got[0, :, 5]) > 0)
    assert got[0, -1, 4] < got[0, 0, 4]


def test_native_oracle_covers_extended_function_family():
    """erf + asinh: C99 libm against the port's plain f64 scan."""
    x, y, m = sympy.symbols("x y m", real=True)
    V = (m * x) ** 2 * (1 + sympy.erf(y)) + sympy.asinh(y) ** 2
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[sympy.Integer(1), 0], [0, sympy.Integer(1)]], V, silent=True).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    args = np.array([1.0])
    nat = np.asarray(NativeModel(model).complete_analysis(args, 0.5, 2.0, 0.3, 1.5, 16, 16))
    tv = np.asarray(_al(art).complete_analysis(args, 0.5, 2.0, 0.3, 1.5, 16, 16,
                                               progress=False))
    np.testing.assert_array_equal(np.isfinite(nat), np.isfinite(tv))
    both = np.isfinite(nat)
    np.testing.assert_allclose(nat[both], tv[both], rtol=1e-11)


def test_native_oracle_covers_gsl_hyp_gamma_family():
    """The hypergeometric family + digamma/trigamma helpers against the
    port's special functions (``lowering/special.py``), at the JAX test's
    quantiles (the consistency ratio passes through 1 in this window)."""
    model = _hyp_model(inflatox_torch)
    art = inflatox_torch.Compiler(model, silent=True).compile()
    args = np.array([2.0])
    nat = np.asarray(NativeModel(model).complete_analysis(args, 0.3, 2.0, 0.2, 1.2, 12, 12))
    tv = np.asarray(_al(art).complete_analysis(args, 0.3, 2.0, 0.2, 1.2, 12, 12,
                                               progress=False))
    np.testing.assert_array_equal(np.isfinite(nat), np.isfinite(tv))
    both = np.isfinite(nat)
    rel = np.abs(nat[both] - tv[both]) / np.maximum(np.abs(tv[both]), 1e-300)
    assert np.quantile(rel, 0.95) < 1e-11
    assert rel.max() < 1e-7


# ----------------------------------------------------------------------- #
# the same C as the JAX package's, and the same bits                       #
# ----------------------------------------------------------------------- #


def _models(name, request):
    """(port model, JAX model) of a named case."""
    if name == "hyperinflation":
        return (request.getfixturevalue("doc").model,
                request.getfixturevalue("doc_model_artifact").model)
    if name == "hypergeometric":
        return _hyp_model(inflatox_torch), _hyp_model(inflatox_tpu)
    path = os.path.join(FIXTURES, f"{name}_bundle.json")
    with open(path) as f:
        bundle = json.load(f)["model"]
    return (inflatox_torch.CompiledModel.load(path).model,
            inflatox_tpu.symbolic.InflationModel.from_dict(bundle))


@pytest.mark.parametrize("name", ["hyperinflation", "egno", "d5", "hypergeometric"])
def test_generated_c_is_the_jax_packages(name, request):
    model, jax_model = _models(name, request)
    got = generate_c_source(model, SymbolRegistry.from_model(model))
    want = jax_generate_c_source(jax_model, JaxRegistry.from_model(jax_model))
    assert got.startswith("// Generated by inflatox_torch.native.codegen")
    assert _without_header(got) == _without_header(want)


def _method_calls(rng):
    pts = np.column_stack([rng.uniform(0.5, 2.5, 40), rng.uniform(0.25, 3.0, 40)])
    inits = np.column_stack([rng.uniform(1.8, 2.4, 3), rng.uniform(1.7, 2.3, 3),
                             np.zeros(3), np.zeros(3)])
    return {
        "complete_analysis": lambda nm: nm.complete_analysis(PARAMS, *EXTENT, 24, 20),
        "complete_analysis_refstyle": lambda nm: nm.complete_analysis_refstyle(
            PARAMS, *EXTENT, 24, 20),
        "complete_analysis_ot": lambda nm: nm.complete_analysis_ot(PARAMS, pts),
        "calc_V_grid": lambda nm: nm.calc_V_grid(PARAMS, *EXTENT, 24, 20),
        "point_eval": lambda nm: np.stack([nm.point_eval(p, PARAMS) for p in pts]),
        "grad": lambda nm: np.stack([nm.grad(p, PARAMS) for p in pts]),
        "eom_eval": lambda nm: np.stack([nm.eom_eval(p, p[::-1] / 10, PARAMS) for p in pts]),
        "consistency_rapidturn_refstyle": lambda nm: nm.consistency_rapidturn_refstyle(
            PARAMS, *EXTENT, 24, 20),
        "solve_eom_rkf": lambda nm: nm.solve_eom_rkf(PARAMS, inits, 300),
    }


def test_every_method_is_bit_for_bit_the_jax_packages(native, jax_native):
    calls = _method_calls(np.random.default_rng(13))
    for name, call in calls.items():
        got, want = np.asarray(call(native)), np.asarray(call(jax_native))
        assert got.shape == want.shape, name
        assert np.array_equal(got.view(np.int64), want.view(np.int64)), name


def test_hypergeometric_oracle_is_bit_for_bit_the_jax_packages(request):
    model, jax_model = _models("hypergeometric", request)
    args = np.array([2.0])
    got = np.asarray(NativeModel(model).complete_analysis(args, 0.3, 2.0, 0.2, 1.2, 12, 12))
    want = np.asarray(JaxNativeModel(jax_model).complete_analysis(
        args, 0.3, 2.0, 0.2, 1.2, 12, 12))
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("n", [(64, 48), (33, 65)])
def test_torch_maps_within_the_ports_oracle(doc, native, n):
    """The port's plain f64 scan (kernel B1's plain version) against the
    port's oracle: rtol 5e-10, identical NaN/±inf masks."""
    got = _al(doc).complete_analysis(PARAMS, *EXTENT, *n, progress=False)
    want = native.complete_analysis(PARAMS, *EXTENT, *n)
    for g, w in zip(got, want):
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.array_equal(np.isinf(g), np.isinf(w))
        assert np.array_equal(np.sign(g[np.isinf(g)]), np.sign(w[np.isinf(w)]))
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=5e-10, atol=0)
