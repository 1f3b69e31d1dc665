"""The fused point functions of kernels B5a and B5b, host-built:
``f_point_<kind>(x, p, out)`` for the four analysis kinds, every operation
of V, the Hesse and |∇V|² (as the kind reads them) hash-consed in one dag,
then the kind's tail.

Each header is compiled with the host C++ compiler and
``-ffp-contract=off``, as the other header tests do.  Tolerances, each with
its reason:

* against the header's own staged grid functions evaluated at
  each point, then the tail (``csrc/anguelova.cuh``), which is what the
  point kernel computed before the fusion: bit for bit for every model and
  kind (the fusion only names values; the same host libm on both sides);
* against the plain version (``scan_points_torch``) on the CPU: bit for bit
  for the consistency conditions and ε_V of hyperinflation and of EGNO in
  double-double (arithmetic only: EGNO's ``pow``/``exp``/``log`` are
  ``csrc/dd.cuh``'s arithmetic); wherever a value goes through a libm
  function (D5's log, cos and sin, S1-S3's special functions, the
  complete-analysis tail's sqrt and atan) within rtol 1e-13 with identical
  NaN/±inf masks: the host's libm and torch's CPU functions part in the last
  bit now and then, and the tails amplify it.  On the card both sides use
  CUDA's libm and the kernels are bit for bit their plain version
  (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import inflatox_torch
from inflatox_torch.lowering import cuda_codegen
from inflatox_torch.ops.cuda_kernels import KINDS, POINT_KINDS, scan_points_torch

import test_torch_special_models as special_models
import test_torch_staged as staged

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
N_POINTS = 48
KIND_NAMES = sorted(POINT_KINDS, key=lambda k: KINDS[k][0])

_HARNESS = r"""
#include <stdint.h>
#include "inflx_model.h"

#if INFLX_PRECISION == 2
typedef dd coord_t;
static coord_t point(double v) { return dd_c(v); }
#else
typedef double coord_t;
static coord_t point(double v) { return v; }
#endif

static void params(const double* pin, coord_t* p) {
  for (int t = 0; t < INFLX_NP; ++t) p[t] = point(pin[t]);
}

#define POINTS(NAME, FN, N_OUT)                                                    \
  extern "C" void NAME(int64_t n, const double* pts, const double* pin, double* out) { \
    coord_t p[INFLX_NP + 1];                                                         \
    params(pin, p);                                                                  \
    for (int64_t i = 0; i < n; ++i) {                                                \
      const coord_t x[2] = {point(pts[2 * i]), point(pts[2 * i + 1])};               \
      double o[N_OUT];                                                               \
      FN(x, p, o);                                                                   \
      for (int k = 0; k < N_OUT; ++k) out[k * n + i] = o[k];                         \
    }                                                                                \
  }
POINTS(fused_0, f_point_complete_analysis, 6)
POINTS(fused_1, f_point_consistency, 1)
POINTS(fused_2, f_point_consistency_rapidturn, 1)
POINTS(fused_3, f_point_epsilon_v, 1)

// the unfused evaluation: each model function's stages in a row at the
// point, then the tails, out planes: complete_analysis (6), consistency,
// consistency_rapidturn, epsilon_v
extern "C" void unfused(int64_t n, const double* pts, const double* pin, double* out) {
  coord_t p[INFLX_NP + 1];
  params(pin, p);
  for (int64_t i = 0; i < n; ++i) {
    const coord_t x[2] = {point(pts[2 * i]), point(pts[2 * i + 1])};
    coord_t r[F_V_NR + F_HESSE_NR + F_GSQ_NR + 1], c[F_V_NC + F_HESSE_NC + F_GSQ_NC + 1];
    f_V_row(x, p, r);
    f_V_col(x, p, c);
    f_hesse_row(x, p, r + F_V_NR);
    f_hesse_col(x, p, c + F_V_NC);
    f_gsq_row(x, p, r + F_V_NR + F_HESSE_NR);
    f_gsq_col(x, p, c + F_V_NC + F_HESSE_NC);
    const double v = f_V_point(x, p, r, c);
    double h[4];
    f_hesse_point(x, p, r + F_V_NR, c + F_V_NC, h);
    const double gsq = f_gsq_point(x, p, r + F_V_NR + F_HESSE_NR, c + F_V_NC + F_HESSE_NC);
    double t[6];
    inflx_tail_complete(v, h[0], h[2], h[3], gsq, t);
    for (int k = 0; k < 6; ++k) out[k * n + i] = t[k];
    out[6 * n + i] = inflx_tail_consistency(v, h[0], h[2], h[3]);
    out[7 * n + i] = inflx_tail_consistency_rapidturn(v, h[0], h[2], h[3]);
    out[8 * n + i] = inflx_tail_epsilon_v(v, gsq);
  }
}
"""


def _models():
    hyp, hyp_args = inflatox_torch.models.hyperinflation()
    hyp = inflatox_torch.Compiler(hyp, silent=True).compile()
    d5 = inflatox_torch.CompiledModel.load(os.path.join(FIXTURES, "d5_bundle.json"))
    egno = inflatox_torch.CompiledModel.load(os.path.join(FIXTURES, "egno_bundle.json"))
    table = {
        "hyperinflation": (hyp, np.asarray(hyp_args, dtype=np.float64), staged.HYP_EXTENT, "f64"),
        "d5": (d5, inflatox_torch.models._args_by_symbol(d5.model, staged.D5_ARGS),
               staged.D5_EXTENT, "f64"),
        "egno": (egno, inflatox_torch.models._args_by_symbol(egno.model, staged.EGNO_ARGS),
                 staged.EGNO_EXTENT, "dd"),
    }
    for name in ("S1", "S2", "S3"):
        extent = special_models.S1_EXTENT if name == "S1" else special_models.S2_EXTENT
        table[name] = (special_models._build(inflatox_torch, name), special_models.ARGS, extent,
                       "f64")
    return table


MODELS = ("hyperinflation", "d5", "S1", "S2", "S3", "egno")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{model: (artifact, args, points, precision, harness)}: each model's
    header built once."""
    out = {}
    for name, (art, args, extent, precision) in _models().items():
        header = art.cuda_source(precision)
        rng = np.random.default_rng(8)
        pts = np.ascontiguousarray(np.stack([rng.uniform(extent[0], extent[1], N_POINTS),
                                             rng.uniform(extent[2], extent[3], N_POINTS)], 1))
        dll = staged._build(header, _HARNESS, tmp_path_factory.mktemp(name))
        out[name] = (art, np.ascontiguousarray(args, dtype=np.float64), pts, precision, dll)
    return out


def _run(fn, n_out, pts, args):
    out = np.zeros((n_out, pts.shape[0]))
    fn(ctypes.c_int64(pts.shape[0]), staged._ptr(pts), staged._ptr(args), staged._ptr(out))
    return out


def _same(a, b):
    """Bit for bit, NaN and the sign of zero included."""
    return np.array_equal(a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("kind", KIND_NAMES)
@pytest.mark.parametrize("name", MODELS)
def test_fused_point_functions_match_the_plain_version(built, name, kind):
    art, args, pts, precision, dll = built[name]
    kind_id, n_out = KINDS[kind]
    unfused = _run(dll.unfused, 9, pts, args)
    planes = {0: slice(0, 6), 1: slice(6, 7), 2: slice(7, 8), 3: slice(8, 9)}[kind_id]
    want_host = unfused[planes]
    got = _run(getattr(dll, f"fused_{kind_id}"), n_out, pts, args)
    assert _same(got, want_host), "the fused function differs from the unfused evaluation"
    plain = scan_points_torch(art, kind, args, torch.from_numpy(pts), precision).numpy()
    assert np.isfinite(plain).mean() > 0.5
    libm = name in ("d5", "S1", "S2", "S3") or kind == "complete_analysis"
    if libm:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(plain))
        np.testing.assert_allclose(got, plain, rtol=1e-13, atol=0, equal_nan=True)
    else:
        assert _same(got, plain), "the fused function differs from the plain version"


def _body(src, kind):
    start = src.index(f"INFLX_FN void f_point_{kind}(")
    return src[start:src.index("\n}\n", start)]


#: kernel B8's calls in a C text
_B8_CALL = re.compile(r"\binflx_(?!powi|max|min|sign|tail)\w+<")


@pytest.mark.parametrize("name,fused,whole", [("S1", 10, 17), ("S2", 7, 14), ("S3", 10, 18)])
def test_each_special_call_once_a_point(built, name, fused, whole):
    """S1-S3's complete_analysis point function makes each distinct special
    call once: 10, 7 and 10 call sites where the three lowered model
    functions hold 17, 14 and 18."""
    art = built[name][0]
    sites = sum(getattr(art, attr).source.count("_special.")
                for attr in ("potential", "_hesse", "grad_square"))
    assert sites == whole
    body = _body(art.cuda_source("f64"), "complete_analysis")
    assert len(_B8_CALL.findall(body)) == fused
    assert cuda_codegen.point_fn_ops(art, "complete_analysis")["special"] == fused


def test_egno_dd_pow_once_per_distinct_base(built):
    """EGNO's complete_analysis point function in double-double calls
    ``dd_pow`` once per distinct operation of its fused dag; no two of the
    seven calls of the lowered functions merge (their bases are written in
    different operation orders), and V_vw's calls are gone."""
    art = built["egno"][0]
    distinct = cuda_codegen.point_fn_ops(art, "complete_analysis", "dd")["log"]
    assert distinct == 7
    body = _body(art.cuda_source("dd"), "complete_analysis")
    assert body.count("dd_pow(") == distinct
    rapid = cuda_codegen.point_fn_ops(art, "consistency_rapidturn", "dd")
    eps = cuda_codegen.point_fn_ops(art, "epsilon_v", "dd")
    assert rapid["log"] + eps["log"] >= distinct


def test_header_has_no_whole_model_functions(built):
    """The point kernels read the fused functions; the whole model
    functions (one per lowered function) are gone from the header."""
    src = built["S3"][0].cuda_source("f64")
    for fn in ("f_V", "f_hesse", "f_gsq", "f_grad"):
        assert re.search(rf"INFLX_FN \w+ {fn}\(", src) is None
        assert f"INFLX_FN void {fn}_row(" in src
    assert all(f"INFLX_FN void f_point_{kind}(" in src for kind in KIND_NAMES)


@pytest.mark.parametrize("name", MODELS)
def test_header_marks_special_function_models(built, name):
    """``INFLX_SPECIAL_FUNCTIONS`` (the f64 library's coherent point kernel
    and its launch shape, ``csrc/grid_scan.cu``) is defined exactly in the
    headers of models that call special functions."""
    art, _, _, precision, _ = built[name]
    marked = "#define INFLX_SPECIAL_FUNCTIONS 1" in art.cuda_source(precision)
    assert marked == (name in ("S1", "S2", "S3"))
    assert marked == art.uses_special_functions
