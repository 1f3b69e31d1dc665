"""The port's f32 and double-double precisions against the JAX package and
mpmath.

* The double-double primitives (``inflatox_torch.ops.dd``) against 50-digit
  mpmath: add, sub, mul, div and sqrt within 1e-30 relative, exp, log and pow
  within 1e-28; ``pow`` follows C on a zero or negative base.
* ``precision="f32"`` (kernel B2's plain version) against the JAX package's
  ``engine="pallas"`` in Pallas interpret mode, as its own tests run it: V,
  Hesse and gradient at rtol 1e-5; the six maps at rtol 1e-4 where the JAX
  package's own f32 and f64 results agree within 1e-4 (ε_H where its
  condition number exceeds 1e3 excepted, and held to the f64 map by that
  condition instead), and each map's median error against f64 at most
  twice the JAX f32 engine's.
* ``precision="dd"`` (kernels B4 and B5b's plain version) on EGNO, whose
  projected Hesse cancels about 3e8 (docs/numerics.md §8): the model
  functions within 1e-14 of 40-digit mpmath, ε_V's median error at least 100×
  below f64's (as tests/test_tf32.py holds the JAX package's triple-f32
  engine), and agreement with the JAX package's ``"pallas_tf64"`` on its
  grid and trajectory (rtol 1e-10 for at least 99 % of the finite values of
  each map; ε_H at 1e-6, the repo's tolerance for the double-f32 tail that
  engine ends in, tests/test_pallas.py).
* The kernels' headers built with the host's C++ compiler: the double-double
  model functions (``csrc/dd.cuh`` + the generated header) bit-identical to
  ``ops/dd.py``; the f32 header within 8 f32 ulps of torch's f32 operations
  on the CPU (torch divides by a number there, the card multiplies by its
  reciprocal).

EGNO comes from ``tests/fixtures/egno_bundle.json`` in both packages."""

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
import inflatox_tpu
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops import dd as ddm
from inflatox_torch.ops.build import CSRC
from inflatox_torch.ops.cuda_kernels import scan_torch
from inflatox_torch.ops.dd import DD, to_f64
from inflatox_torch.utils.devices import resolve_precision

from test_torch_staged import WHOLE_FUNCTIONS

mp = pytest.importorskip("mpmath")

HERE = os.path.dirname(os.path.abspath(__file__))
EGNO_EXTENT = (0.46, 0.50, 0.0, np.pi)
DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)


def _f64(values):
    return torch.tensor(np.asarray(values, dtype=np.float64))


@pytest.fixture(scope="module")
def doc(tmp_path_factory):
    """The doc model: built by the port, carried to the JAX package as a
    bundle.  (jax artifact, torch artifact, args)."""
    model, args = inflatox_torch.models.hyperinflation()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    path = str(tmp_path_factory.mktemp("bundles") / "doc.json")
    art.save(path)
    return inflatox_tpu.CompiledModel.load(path), art, args


@pytest.fixture(scope="module")
def egno():
    path = os.path.join(HERE, "fixtures", "egno_bundle.json")
    art = inflatox_torch.CompiledModel.load(path)
    args = inflatox_torch.models._args_by_symbol(
        art.model, {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0})
    return inflatox_tpu.CompiledModel.load(path), art, args


# --------------------------------------------------------------------------- #
# double-double primitives                                                     #
# --------------------------------------------------------------------------- #


def _samples():
    rng = np.random.default_rng(11)
    xs = rng.uniform(0.1, 10.0, 200)
    ys = rng.uniform(0.1, 10.0, 200)
    # operands with a second word, as double-double intermediates have
    x = DD(_f64(xs), _f64(xs * 1e-17 * rng.uniform(-1, 1, 200))) + 0.0
    y = DD(_f64(ys), _f64(ys * 1e-17 * rng.uniform(-1, 1, 200))) + 0.0
    return x, y


def _mp(d, i):
    return mp.mpf(float(d.hi[i])) + mp.mpf(float(d.lo[i]))


_PRIMITIVES = {
    "add": (lambda x, y: x + y, lambda a, b: a + b, 1e-30),
    "sub": (lambda x, y: x - y, lambda a, b: a - b, 1e-30),
    "mul": (lambda x, y: x * y, lambda a, b: a * b, 1e-30),
    "div": (lambda x, y: x / y, lambda a, b: a / b, 1e-30),
    "sqrt": (lambda x, y: ddm.dd_sqrt(x), lambda a, b: mp.sqrt(a), 1e-30),
    "exp": (lambda x, y: ddm.dd_exp(x * 2.0 - 10.0), lambda a, b: mp.exp(a * 2 - 10), 1e-28),
    "log": (lambda x, y: ddm.dd_log(x), lambda a, b: mp.log(a), 1e-28),
    "pow": (lambda x, y: ddm.dd_pow(x, y * 0.3), lambda a, b: a ** (b * mp.mpf(0.3)), 1e-28),
}


@pytest.mark.parametrize("name", sorted(_PRIMITIVES))
def test_dd_primitive_matches_mpmath(name):
    op, ref, tol = _PRIMITIVES[name]
    x, y = _samples()
    got = op(x, y)
    with mp.workdps(50):
        worst = max(abs((_mp(got, i) - ref(_mp(x, i), _mp(y, i))) / ref(_mp(x, i), _mp(y, i)))
                    for i in range(len(x.hi)))
    assert worst < tol, (name, float(worst))


def test_dd_pow_follows_c_on_zero_and_negative_bases():
    bases = [-2.0, -2.0, -2.0, -2.0, 0.0, 0.0, 0.0, 1.0, 3.0]
    exps = [3.0, -2.0, 4.0, 0.5, 2.0, 0.0, -1.0, float("nan"), 0.0]
    got = ddm.dd_pow(DD(_f64(bases), 0.0), DD(_f64(exps), 0.0))
    want = torch.pow(_f64(bases), _f64(exps))  # C pow
    np.testing.assert_array_equal(to_f64(got).numpy(), want.numpy())
    assert float(got.lo[0]) == 0.0  # (-2)^3 is exactly -8
    # EGNO's (2r - c(1-2r)^4)^(-3α): negative base, integral runtime exponent
    r = _f64([0.6, 0.7])
    base = 2 * r - 1000.0 * (1 - 2 * r) ** 4
    got = ddm.dd_pow(DD(base, 0.0), DD(_f64([-3.0, -3.0]), 0.0))
    np.testing.assert_allclose(to_f64(got).numpy(), (base ** -3).numpy(), rtol=1e-15)


def test_dd_pow_keeps_the_second_word_of_a_base_near_one():
    """(1 + 1e-20)^y: the head is exactly 1, the y·1e-20 term lives in the
    second word; only the base 1 exactly gives 1 exactly."""
    ys = [3.0, -2.5, 1e4]
    got = ddm.dd_pow(DD(_f64([1.0] * 3), _f64([1e-20] * 3)), DD(_f64(ys), 0.0))
    with mp.workdps(50):
        for i, y in enumerate(ys):
            want = (1 + mp.mpf(1e-20)) ** mp.mpf(y) - 1
            err = (mp.mpf(float(got.hi[i])) - 1 + mp.mpf(float(got.lo[i])) - want) / want
            assert abs(err) < 1e-12, (y, float(err))
    one = ddm.dd_pow(DD(_f64([1.0]), 0.0), DD(_f64([0.3]), 0.0))
    assert (float(one.hi[0]), float(one.lo[0])) == (1.0, 0.0)


def test_host_compiled_dd_pow_is_bit_identical_to_ops_dd(tmp_path):
    """csrc/dd.cuh's dd_pow, built with the host C++ compiler, against
    ops/dd.py: bases near 1 with a second word, zero and negative bases."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "pow.cpp").write_text(
        '#include "dd.cuh"\n'
        'extern "C" void pow_all(long n, const double* x, const double* y, double* out) {\n'
        '  for (long i = 0; i < n; ++i) {\n'
        '    const dd r = dd_pow(dd_make(x[2 * i], x[2 * i + 1]), dd_c(y[i]));\n'
        '    out[2 * i] = r.hi; out[2 * i + 1] = r.lo;\n'
        '  }\n'
        '}\n')
    lib = tmp_path / "libpow.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(lib), str(tmp_path / "pow.cpp")],
                   check=True, capture_output=True, text=True)
    hi = np.array([1.0, 1.0, 1.0, 2.5, -2.0, -2.0, 0.0, 0.7])
    lo = np.array([1e-20, -3e-19, 0.0, 1e-17, 0.0, 0.0, 0.0, -2e-17])
    ys = np.array([3.0, -2.5, 0.3, 1.7, 3.0, 0.5, -1.0, 12.25])
    x = np.ascontiguousarray(np.stack([hi, lo], 1))
    out = np.zeros((hi.size, 2))
    ptr = ctypes.POINTER(ctypes.c_double)
    dll = ctypes.CDLL(str(lib))
    dll.pow_all.argtypes = [ctypes.c_long, ptr, ptr, ptr]
    dll.pow_all(hi.size, *(a.ctypes.data_as(ptr) for a in (x, ys, out)))
    want = ddm.dd_pow(DD(_f64(hi), _f64(lo)), DD(_f64(ys), 0.0))
    np.testing.assert_array_equal(out[:, 0], want.hi.numpy())
    np.testing.assert_array_equal(out[:, 1], want.lo.numpy())
    assert out[0, 1] != 0.0 and out[2, 1] == 0.0


def test_dd_header_constants_are_the_python_ones():
    text = (CSRC / "dd.cuh").read_text()
    table = re.findall(r"\{(-?0x[0-9a-f.p+-]+), (-?0x[0-9a-f.p+-]+)\},\s*// 1/(\d+)!", text)
    assert [(float.fromhex(h), float.fromhex(lo)) for h, lo, _ in table] == list(ddm.EXP_COEFFS)
    ln2 = re.search(r"dd_make\((0x[0-9a-f.p+-]+), (0x[0-9a-f.p+-]+)\)", text).groups()
    assert tuple(float.fromhex(v) for v in ln2) == ddm.LN2
    assert f"INFLX_DD_EXP_DEGREE {ddm.EXP_DEGREE}" in text


# --------------------------------------------------------------------------- #
# f32 against the JAX package's Pallas fp32 kernel (interpret mode)            #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["potential", "hesse", "gradient"])
def test_f32_surfaces_match_jax_pallas(doc, kind):
    from inflatox_tpu.ops.pallas_kernels import scan_pallas

    jax_art, art, args = doc
    want = np.stack([np.asarray(o) for o in scan_pallas(jax_art, kind, args, DOC_EXTENT, (16, 24))])
    got = scan_torch(art, kind, args, DOC_EXTENT, (16, 24), "cpu", "f32").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _eps_h_condition(art, args, extent, shape):
    """ε_H's condition number at each grid point, from the f64 plain
    version: of the difference ε_V − vt2 in its numerator and of its
    denominator ε_V + |V_tt|/V − vt2 (csrc/anguelova.cuh)."""
    v = scan_torch(art, "potential", args, extent, shape, "cpu").numpy()[0]
    v00, _, v10, v11 = scan_torch(art, "hesse", args, extent, shape, "cpu").numpy()
    eps = scan_torch(art, "complete_analysis", args, extent, shape, "cpu").numpy()[1]
    vt2 = eps / (1 + (v00 / v10) ** 2)
    vtt = np.abs(((v00 * v10**2 + v11 * v00**2) - 2 * v00 * v10**2) / (v00**2 + v10**2)) / v
    return ((np.abs(eps) + np.abs(vt2)) / np.abs(eps - vt2)
            + (np.abs(eps) + vtt + np.abs(vt2)) / np.abs(eps + vtt - vt2))


def test_f32_complete_analysis_matches_jax_pallas(doc):
    """On the points where the JAX package's f32 and f64 maps agree within
    1e-4, the port's f32 maps within rtol 1e-4 of the JAX package's f32 ones.
    One exception, counted: ε_H where its condition number κ exceeds 1e3.
    There f32 keeps fewer than four digits, whichever engine rounds, and the
    port's f32 is held to the f64 map within 16·κ·2^-24.  At this grid that
    excuses 16 of 384 points, 13 of them settled; at one of those the two
    f32 engines part by 5e-4 (κ = 1.1e4)."""
    jax_art, art, args = doc
    shape = (16, 24)
    jal = inflatox_tpu.consistency_conditions.GeneralisedAL(jax_art, validate_basis=False)
    f32 = jal.complete_analysis(args, *DOC_EXTENT, *shape, progress=False, engine="pallas")
    f64 = jal.complete_analysis(args, *DOC_EXTENT, *shape, progress=False, engine="xla")
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    got = al.complete_analysis(args, *DOC_EXTENT, *shape, progress=False, precision="f32")
    kappa = _eps_h_condition(art, args, DOC_EXTENT, shape)
    for k, (g, w32, w64) in enumerate(zip(got, f32, f64)):
        w32, w64 = np.asarray(w32, np.float64), np.asarray(w64)
        assert g.dtype == np.float32
        assert np.array_equal(np.isnan(g), np.isnan(w32))
        g = g.astype(np.float64)
        settled = np.isfinite(w64) & (np.abs(w32 - w64) <= 1e-4 * np.abs(w64))
        assert settled.sum() >= 0.9 * np.isfinite(w64).sum()
        if k == 2:
            unsettled = kappa > 1e3
            assert unsettled.mean() < 0.05
            bound = 16 * kappa[unsettled] * 2.0**-24 * np.abs(w64[unsettled])
            assert (np.abs(g[unsettled] - w64[unsettled]) <= bound).all()
            settled &= ~unsettled
        np.testing.assert_allclose(g[settled], w32[settled], rtol=1e-4, atol=0)
        finite = np.isfinite(w64) & (w64 != 0)
        err, jax_err = (np.median(np.abs(a[finite] - w64[finite]) / np.abs(w64[finite]))
                        for a in (g, w32))
        assert err <= 2 * jax_err + 1e-7


# --------------------------------------------------------------------------- #
# double-double on EGNO                                                        #
# --------------------------------------------------------------------------- #


def _mp_model(art, args):
    """V, V_vv, V_wv, V_ww, |∇V|² of the model at 40 digits (sympy →
    mpmath), as a function of the two coordinates (mpf)."""
    m = art.model
    exprs = [m.potential, m.hesse_cmp[0][0], m.hesse_cmp[1][0], m.hesse_cmp[1][1],
             m.gradient_square]
    symbols = sorted(set().union(*(e.free_symbols for e in exprs)), key=str)
    fn = sympy.lambdify(symbols, exprs, modules="mpmath", cse=True)

    def run(x0, x1):
        values = []
        for s in symbols:
            slot = art.symbol_dictionary[str(s)]
            if slot.startswith("args["):
                values.append(mp.mpf(float(args[int(slot[5:-1])])))
            else:
                values.append((x0, x1)[int(slot[2:-1])])
        return fn(*values)

    return run


def test_egno_dd_model_functions_match_mpmath(egno):
    _, art, args = egno
    rng = np.random.default_rng(7)
    x0, x1 = rng.uniform(0.46, 0.50, 64), rng.uniform(0.0, np.pi, 64)
    fns = art.dd_fns()
    xs = (DD(_f64(x0), 0.0), DD(_f64(x1), 0.0))
    p = _f64(args)
    h = fns["hesse"](xs, p)
    got = [to_f64(v).numpy() for v in
           (fns["potential"](xs, p), h[0], h[2], h[3], fns["grad_square"](xs, p))]
    ref = _mp_model(art, args)
    with mp.workdps(40):
        want = np.array([[float(v) for v in ref(mp.mpf(a), mp.mpf(b))] for a, b in zip(x0, x1)]).T
    for k in range(5):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-14, atol=0)


def test_egno_dd_beats_f64_on_epsilon_v(egno):
    """ε_V = |∇V|²/V² (complete_analysis's, no ½) at the 16² grid of the
    EGNO window: dd's coordinates are exact (x0a + i·dx0), f64's rounded."""
    _, art, args = egno
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    n = 16
    dd_eps = al.complete_analysis(args, *EGNO_EXTENT, n, n, progress=False, precision="dd")[1]
    f64_eps = al.complete_analysis(args, *EGNO_EXTENT, n, n, progress=False)[1]
    ref = _mp_model(art, args)
    x0a, x0b, x1a, x1b = EGNO_EXTENT
    dx0, dx1 = (x0b - x0a) / n, (x1b - x1a) / n
    err_dd, err_f64 = [], []
    with mp.workdps(40):
        for i in range(n):
            for j in range(n):
                v, *_, gs = ref(mp.mpf(x0a) + i * mp.mpf(dx0), mp.mpf(x1a) + j * mp.mpf(dx1))
                err_dd.append(abs(float((mp.mpf(dd_eps[i, j]) - gs / v**2) / (gs / v**2))))
                v, *_, gs = ref(mp.mpf(x0a + i * dx0), mp.mpf(x1a + j * dx1))
                err_f64.append(abs(float((mp.mpf(f64_eps[i, j]) - gs / v**2) / (gs / v**2))))
    assert np.median(err_dd) * 100 <= np.median(err_f64), (np.median(err_dd), np.median(err_f64))


def _assert_close_to_tf64(got, want, v00):
    """At least 99 % of the finite values within rtol 1e-10 (ε_H: 1e-6), NaN
    masks identical except where V_vv is 0 (ROADMAP C4)."""
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g).ravel(), np.asarray(w).ravel()
        c4 = v00.ravel() == 0
        assert np.array_equal(np.isnan(g)[~c4], np.isnan(w)[~c4]), k
        finite = np.isfinite(g) & np.isfinite(w) & (w != 0)
        assert finite.mean() > 0.5
        rtol = 1e-6 if (len(got) == 6 and k == 2) else 1e-10
        share = np.mean(np.abs(g[finite] - w[finite]) <= rtol * np.abs(w[finite]))
        assert share >= 0.99, (k, share)


def test_egno_dd_matches_jax_tf64(egno):
    jax_art, art, args = egno
    jal = inflatox_tpu.consistency_conditions.GeneralisedAL(jax_art, validate_basis=False)
    want = jal.complete_analysis(args, *EGNO_EXTENT, 16, 16, progress=False, engine="pallas_tf64")
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    got = al.complete_analysis(args, *EGNO_EXTENT, 16, 16, progress=False, precision="dd")
    v00 = scan_torch(art, "hesse", args, EGNO_EXTENT, (16, 16), "cpu", "dd")[0].numpy()
    _assert_close_to_tf64(got, want, v00)


@pytest.mark.parametrize("kind", ["complete_analysis_ot", "consistency_ot",
                                  "consistency_rapidturn_ot", "epsilon_v_ot"])
def test_egno_dd_ot_matches_jax_tf64(egno, kind):
    """On tests/test_tf32.py's trajectory (kernel B5b's plain version)."""
    jax_art, art, args = egno
    rng = np.random.default_rng(5)
    traj = np.stack([rng.uniform(0.46, 0.50, 64), rng.uniform(0.1, 3.0, 64)], 1)
    jal = inflatox_tpu.consistency_conditions.GeneralisedAL(jax_art, validate_basis=False)
    want = getattr(jal, kind)(args, traj, progress=False, engine="pallas_tf64")
    got = getattr(GeneralisedAL(art, device="cpu", validate_basis=False), kind)(
        args, traj, progress=False, precision="dd")
    v00 = to_f64(art.dd_fns()["hesse"]((DD(_f64(traj[:, 0]), 0.0), DD(_f64(traj[:, 1]), 0.0)),
                                       _f64(args))[0]).numpy()
    if kind != "complete_analysis_ot":
        got, want = [got], [want]
    _assert_close_to_tf64(got, want, v00)


# --------------------------------------------------------------------------- #
# the kernels' headers, compiled with the host C++ compiler                    #
# --------------------------------------------------------------------------- #

_HARNESS = r"""
#include <stdint.h>
#include "inflx_model.h"
""" + WHOLE_FUNCTIONS + r"""#include "anguelova.cuh"
#if INFLX_PRECISION == 2
typedef dd coord_t;
typedef double real_t;
static coord_t point(double v) { return dd_c(v); }
#else
#if INFLX_PRECISION == 1
typedef float real_t;
#else
typedef double real_t;
#endif
typedef real_t coord_t;
static coord_t point(double v) { return (real_t)v; }
#endif

extern "C" void eval_points(int64_t n, const double* x0, const double* x1,
                            const double* pin, double* out) {
  coord_t p[INFLX_NP + 1];
  for (int t = 0; t < INFLX_NP; ++t) p[t] = point(pin[t]);
  for (int64_t i = 0; i < n; ++i) {
    const coord_t x[2] = {point(x0[i]), point(x1[i])};
    double* o = out + 14 * i;
    real_t h[4], g[2];
    f_hesse(x, p, h);
    f_grad(x, p, g);
    o[0] = f_V(x, p); o[5] = f_gsq(x, p); o[6] = g[0]; o[7] = g[1];
    for (int k = 0; k < 4; ++k) o[1 + k] = h[k];
    real_t r[6];
    inflx_tail_complete((real_t)o[0], (real_t)o[1], (real_t)o[3], (real_t)o[4],
                        (real_t)o[5], r);
    for (int k = 0; k < 6; ++k) o[8 + k] = r[k];
  }
}
"""


def _host_build(header, workdir):
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (workdir / "inflx_model.h").write_text(header)
    (workdir / "harness.cpp").write_text(_HARNESS)
    lib = workdir / "libharness.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(workdir), "-I", str(CSRC), "-o", str(lib), str(workdir / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    ptr = ctypes.POINTER(ctypes.c_double)
    dll.eval_points.argtypes = [ctypes.c_int64, ptr, ptr, ptr, ptr]
    return dll


def _run_harness(dll, x0, x1, args):
    out = np.zeros((x0.size, 14))
    p = np.ascontiguousarray(args, dtype=np.float64)
    ptr = ctypes.POINTER(ctypes.c_double)
    dll.eval_points(x0.size, *(a.ctypes.data_as(ptr) for a in (x0, x1, p, out)))
    return out


def test_host_compiled_dd_header_is_bit_identical_to_ops_dd(egno, tmp_path):
    _, art, args = egno
    dll = _host_build(art.cuda_source("dd"), tmp_path)
    rng = np.random.default_rng(3)
    x0, x1 = rng.uniform(0.46, 0.50, 64), rng.uniform(0.0, np.pi, 64)
    out = _run_harness(dll, x0, x1, args)
    fns = art.dd_fns()
    xs, p = (DD(_f64(x0), 0.0), DD(_f64(x1), 0.0)), _f64(args)
    want = [fns["potential"](xs, p), *fns["hesse"](xs, p), fns["grad_square"](xs, p),
            *fns["grad"](xs, p)]
    for k, w in enumerate(want):
        np.testing.assert_array_equal(out[:, k], np.broadcast_to(to_f64(w).numpy(), (64,)))


def test_host_compiled_f32_header_matches_torch_f32(doc, tmp_path):
    from inflatox_torch.ops.anguelova import complete_analysis_op

    _, art, args = doc
    dll = _host_build(art.cuda_source("f32"), tmp_path)
    rng = np.random.default_rng(4)
    x0 = rng.uniform(0.5, 2.5, 64).astype(np.float32).astype(np.float64)
    x1 = rng.uniform(0.25, 3.0, 64).astype(np.float32).astype(np.float64)
    out = _run_harness(dll, x0, x1, np.float32(args).astype(np.float64))
    xs = (torch.from_numpy(x0).float(), torch.from_numpy(x1).float())
    p = torch.from_numpy(args).float()
    h = art.hesse_tuple(xs, p)
    model = [art.potential(xs, p), *h, art.grad_square(xs, p), *art._grad(xs, p)]
    model = [torch.as_tensor(v, dtype=torch.float32).expand(64) for v in model]
    tail = complete_analysis_op(model[0], model[1], model[3], model[4], model[5])
    for k, w in enumerate([*model, *tail]):
        np.testing.assert_allclose(out[:, k], w.double().numpy(), rtol=8 * 2.0**-23, atol=0)


# --------------------------------------------------------------------------- #
# precision rules                                                              #
# --------------------------------------------------------------------------- #


def test_precision_resolution():
    assert resolve_precision() == "f64"
    assert resolve_precision(None, torch.float32) == "f32"
    assert resolve_precision(None, np.float32) == "f32"
    assert resolve_precision("dd", torch.float64) == "dd"
    for bad in (("f32", torch.float64), ("dd", np.float32), ("f16", None)):
        with pytest.raises(ValueError):
            resolve_precision(*bad)


def test_f32_is_not_offered_on_trajectories(doc):
    _, art, args = doc
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    pts = np.array([[1.0, 1.0], [2.0, 0.5]])
    with pytest.raises(ValueError, match="f32"):
        al.complete_analysis_ot(args, pts, progress=False, precision="f32")
    with pytest.raises(ValueError, match='precision="dd"'):
        al.consistency(args, *DOC_EXTENT, 4, 4, progress=False, engine="pallas_tf64")
