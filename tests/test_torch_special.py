"""The port's special functions (``inflatox_torch.lowering.special``, the
plain version of kernel B8) and the models that call them, on the CPU.

Tolerances, each with its reason:

* against scipy: the JAX package's own tolerances (``tests/test_special.py``
  and the erf/Γ/polygamma/hypergeometric tests of
  ``tests/test_df32_special.py``), with the fixes of the reference's faults
  (C1, C2, C11, C12) held to mpmath or scipy instead of the JAX package;
* against the JAX package's ``special.py``: within 1e-12, relative to an
  amplitude floor of 1e-3 of each curve's largest value (as
  ``tests/test_special.py:58-60``), the same algorithms in the same f64;
  polygamma of order ≥ 1 excepted, whose XLA:CPU implementation in the JAX
  package is off at negative arguments by up to 4.5e-3 relative (C13): it
  is held to scipy at 1e-12;
* kernel B8's source built with the host C++ compiler
  (``csrc/special_eval.cu``, ``-ffp-contract=off``) against the plain version
  on the CPU: bit for bit where a function is arithmetic only; elsewhere the
  host's libm and torch's CPU functions part in the last bits (on the card
  both are CUDA's): f64 within 1e-13, f32 within 5e-5, each relative to an
  amplitude floor of 1e-3 of the largest value;
* f32 against f64 on the same arguments: 3e-5 (Steed's fractional routes
  1e-3), amplitude-floored.

The models that call these functions are tested in
``tests/test_torch_special_models.py``.
"""

import ctypes
import re
import shutil
import subprocess

import mpmath
import numpy as np
import pytest
import scipy.special as sps
import sympy
import torch

import inflatox_torch
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.lowering import special as sp
from inflatox_torch.ops import special_eval
from inflatox_torch.ops.build import CSRC
from inflatox_torch.ops.cuda_kernels import scan_torch
from inflatox_tpu.lowering import accmath as jam
from inflatox_tpu.lowering import special as jsp

def _z(lo, hi, n=25):
    return np.linspace(lo, hi, n)


def _t(values, dtype=torch.float64):
    return torch.tensor(np.asarray(values, dtype=np.float64), dtype=dtype)


def _np(value):
    return np.asarray(value)


# --------------------------------------------------------------------------- #
# tests/test_special.py, on the port, against scipy                            #
# --------------------------------------------------------------------------- #


def test_hyp0f1():
    z = _z(-20.0, 20.0)
    for b in (0.5, 1.0, 2.5, 7.0):
        np.testing.assert_allclose(_np(sp.hyp0f1(b, _t(z))), sps.hyp0f1(b, z), rtol=1e-10)


def test_hyp1f1():
    z = _z(-5.0, 5.0)
    np.testing.assert_allclose(_np(sp.hyp1f1(1.5, 2.5, _t(z))), sps.hyp1f1(1.5, 2.5, z),
                               rtol=1e-8)


def test_hyp2f1():
    z = _z(-0.8, 0.8)
    np.testing.assert_allclose(_np(sp.hyp2f1(0.5, 1.5, 2.5, _t(z))),
                               sps.hyp2f1(0.5, 1.5, 2.5, z), rtol=1e-8)


def test_besselj_integer_orders():
    z = _z(0.1, 30.0)
    for n in (0, 1, 5):
        np.testing.assert_allclose(_np(sp.besselj(n, _t(z))), sps.jv(n, z), rtol=1e-8,
                                   atol=1e-12)


def test_besselj_negative_order():
    z = _z(0.1, 10.0)
    np.testing.assert_allclose(_np(sp.besselj(-2, _t(z))), sps.jv(-2, z), rtol=1e-8,
                               atol=1e-12)


def _floored_rel(got, want):
    floor = 1e-3 * np.max(np.abs(want))
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), floor))


def test_besselj_fractional():
    z = _z(0.05, 40.0, 400)
    for nu in (0.1, 0.5, 1.3, 2.7, 4.6):
        assert _floored_rel(_np(sp.besselj(nu, _t(z))), sps.jv(nu, z)) < 1e-11, nu


def test_besselj_fractional_large_order_large_z():
    z = _z(41.0, 200.0, 60)
    amp = np.sqrt(2.0 / (np.pi * z))
    for nu in (8.5, 12.7, 20.45, 25.3, 29.9, -12.7):
        gj, gy = _np(sp.besselj(nu, _t(z))), _np(sp.bessely(nu, _t(z)))
        assert np.max(np.abs(gj - sps.jv(nu, z)) / amp) < 1e-11, nu
        assert np.max(np.abs(gy - sps.yv(nu, z)) / amp) < 1e-11, nu
    assert np.isnan(_np(sp.besselj(35.3, _t(z)))).all()
    assert np.isnan(_np(sp.bessely(-31.2, _t(z)))).all()


def test_sph_fractional_orders():
    z = _z(0.5, 40.0, 100)
    for nu in (2.3, 0.7, 12.6):
        want = np.sqrt(np.pi / (2 * z)) * sps.jv(nu + 0.5, z)
        got = _np(sp.sph_jn(nu, _t(z)))
        assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0 / z)) < 1e-11, nu
        want_y = np.sqrt(np.pi / (2 * z)) * sps.yv(nu + 0.5, z)
        got_y = _np(sp.sph_yn(nu, _t(z)))
        assert np.max(np.abs(got_y - want_y) / np.maximum(np.abs(want_y), 1.0 / z)) < 1e-11, nu
    assert np.isnan(_np(sp.sph_jn(35.3, _t(z)))).all()


def test_besseli():
    z = _z(0.1, 15.0)
    for n in (0, 1, 3):
        np.testing.assert_allclose(_np(sp.besseli(n, _t(z))), sps.iv(n, z), rtol=1e-7,
                                   atol=1e-12)
    np.testing.assert_allclose(_np(sp.besseli(0.5, _t(z))), sps.iv(0.5, z), rtol=1e-9,
                               atol=1e-12)


def test_bessely():
    z = _z(0.2, 40.0, 600)
    for n in (0, 1, 3, 5):
        np.testing.assert_allclose(_np(sp.bessely(n, _t(z))), sps.yv(n, z), rtol=2e-11,
                                   atol=1e-13)
    zf = _z(0.05, 40.0, 400)
    for nu in (0.1, 0.5, 1.3, 2.7):
        assert _floored_rel(_np(sp.bessely(nu, _t(zf))), sps.yv(nu, zf)) < 1e-11, nu


def test_bessely_domain():
    assert np.isnan(float(sp.bessely(0, -1.0)))


def test_besselk():
    z = _z(0.1, 40.0, 600)
    for nu in (0.1, 0.5, 1.25, 1.75, 3.6):
        np.testing.assert_allclose(_np(sp.besselk(nu, _t(z))), sps.kv(nu, z), rtol=5e-13,
                                   atol=0)
    for n in (0, 1, 2, 5):
        np.testing.assert_allclose(_np(sp.besselk(n, _t(z))), sps.kv(n, z), rtol=1e-13, atol=0)


def test_spherical():
    z = _z(0.2, 30.0, 400)
    for n in (0, 1, 2, 4, 8):
        np.testing.assert_allclose(_np(sp.sph_jn(n, _t(z))), sps.spherical_jn(n, z),
                                   rtol=5e-13, atol=1e-300)
        np.testing.assert_allclose(_np(sp.sph_yn(n, _t(z))), sps.spherical_yn(n, z),
                                   rtol=1e-10, atol=1e-13)
    assert float(sp.sph_jn(0, 0.0)) == 1.0
    assert float(sp.sph_jn(2, 0.0)) == 0.0
    assert np.isclose(float(sp.sph_jn(4, 0.2)), sps.spherical_jn(4, 0.2), rtol=1e-12)


def test_end_to_end_bessel_model():
    x, y, a = sympy.symbols("x y a")
    V = a * sympy.besselj(0, x) ** 2 + y**2 + 2
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], V, silent=True, simplify=False, assertions=False).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    v = al.calc_V(np.array([1.3, 0.4]), np.array([2.0]))
    assert np.isclose(v, 2.0 * sps.jv(0, 1.3) ** 2 + 0.16 + 2, rtol=1e-8)


def test_hyp1f1_certified_envelope():
    z = np.linspace(-20.0, 20.0, 161)
    worst = 0.0
    for a in (0.25, 0.5, 1.5, 2.0, 3.5):
        for b in (0.75, 1.5, 2.5, 4.0):
            want = sps.hyp1f1(a, b, z)
            got = _np(sp.hyp1f1(a, b, _t(z)))
            worst = max(worst, float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                                               1e-300))))
    assert worst < 5e-11, worst


def test_hyp2f1_certified_envelope():
    z = np.linspace(-0.95, 0.95, 191)
    worst = 0.0
    for a, b, c in [(0.5, 1.5, 2.5), (0.25, 0.75, 1.25), (1.0, 2.0, 3.5), (2.5, 0.5, 3.0)]:
        want = sps.hyp2f1(a, b, c, z)
        got = _np(sp.hyp2f1(a, b, c, _t(z)))
        worst = max(worst, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300))))
    assert worst < 5e-11, worst


def test_out_of_domain_warns_once_at_point_api(capsys):
    """One [Inflatox Warning] per function at the point surface; none in a
    scan (the JAX package's case: under jax.jit; the port's: a CPU grid
    scan, which runs under suppress_domain_warnings)."""
    sp._DOMAIN_WARNED.discard("hyp2f1")
    assert np.isnan(float(sp.hyp2f1(0.5, 1.5, 2.5, 1.5)))
    err = capsys.readouterr().err
    assert "Inflatox Warning" in err and "hyp2f1" in err
    sp.hyp2f1(0.5, 1.5, 2.5, 2.0)
    assert "hyp2f1" not in capsys.readouterr().err
    sp._DOMAIN_WARNED.discard("hyp1f1")
    sp.hyp1f1(0.5, 1.5, 3.0)
    assert "hyp1f1" not in capsys.readouterr().err
    sp._DOMAIN_WARNED.discard("hyp1f1")
    with sp.suppress_domain_warnings():
        assert np.isnan(float(sp.hyp1f1(0.5, 1.5, 400.0)))
    assert "hyp1f1" not in capsys.readouterr().err
    # a CPU grid scan that crosses the domain stays silent
    x, y = sympy.symbols("x y")
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], sympy.hyper((0.5, 1.5), (2.5,), x) + y**2 + 2,
        silent=True, simplify=False, assertions=False).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    sp._DOMAIN_WARNED.discard("hyp2f1")
    maps = scan_torch(art, "potential", np.zeros(0), (0.5, 1.5, 0.0, 1.0), (4, 3), "cpu")
    assert np.isnan(maps[0, -1].numpy()).all() and np.isfinite(maps[0, 0].numpy()).all()
    assert "hyp2f1" not in capsys.readouterr().err


# --------------------------------------------------------------------------- #
# erf, erfc, Γ, lgamma, polygamma and the hypergeometric family               #
# (tests/test_df32_special.py:370-463), against scipy                          #
# --------------------------------------------------------------------------- #


def _gamma_points():
    x = np.concatenate([np.linspace(0.05, 33.0, 500), np.linspace(-7.95, -0.05, 159)])
    return x[np.abs(x - np.round(x)) > 0.04]


def test_erf_erfc():
    x = np.linspace(-6.0, 6.0, 801)
    assert _floored_rel(_np(sp.erf(_t(x))), sps.erf(x)) < 2e-13
    xp = np.linspace(-6.0, 7.5, 801)
    assert np.max(np.abs(_np(sp.erfc(_t(xp))) - sps.erfc(xp)) / sps.erfc(xp)) < 1e-12
    tail = _np(sp.erfc(_t([8.0, 8.7, 11.0])))
    np.testing.assert_allclose(tail, sps.erfc([8.0, 8.7, 11.0]), rtol=1e-13)


def test_gamma_lgamma():
    x = _gamma_points()
    g = _np(sp.gamma(_t(x)))
    assert np.max(np.abs(g - sps.gamma(x)) / np.abs(sps.gamma(x))) < 2e-12
    want = np.log(np.abs(sps.gamma(x)))
    gl = _np(sp.lgamma(_t(x)))
    assert np.max(np.abs(gl - want) / np.maximum(np.abs(want), 1e-2)) < 1e-11


def test_polygamma():
    x = _gamma_points()
    for n in (0, 1, 2, 3):
        got = _np(sp.polygamma(n, _t(x)))
        want = sps.polygamma(n, x)
        assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-2)) < 1e-12, n
    assert np.isnan(float(sp.polygamma(1, -40.5)))
    np.testing.assert_allclose(_np(sp.polygamma(0, _t([0.5, 7.0]))), sps.digamma([0.5, 7.0]),
                               rtol=1e-14)


def test_hyp1f1_wide():
    z = np.linspace(-55.0, 55.0, 301)
    for a, b in [(0.5, 1.5), (2.0, 3.0), (-1.5, 2.5)]:
        want = sps.hyp1f1(a, b, z)
        got = _np(sp.hyp1f1(a, b, _t(z)))
        assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-250)) < 1e-12, (a, b)


def test_hyp2f1_wide():
    z = np.linspace(-0.85, 0.85, 301)
    for a, b, c in [(0.5, 1.5, 2.5), (1.0, 2.0, 3.5), (-0.5, 0.75, 1.25)]:
        want = sps.hyp2f1(a, b, c, z)
        got = _np(sp.hyp2f1(a, b, c, _t(z)))
        assert np.max(np.abs(got - want) / np.abs(want)) < 1e-12, (a, b, c)


def test_hyp2f0_matches_jax():
    z = np.linspace(-0.02, 0.02, 81)
    for a, b in [(0.5, 1.0), (1.5, 2.0)]:
        want = _np(jsp.hyp2f0(a, b, z))
        got = _np(sp.hyp2f0(a, b, _t(z)))
        assert np.max(np.abs(got - want) / np.abs(want)) < 1e-12


def test_hyp_envelope_guards():
    assert np.isnan(float(sp.hyp1f1(0.5, 1.5, 400.0)))
    assert np.isnan(_np(sp.hyp2f1(0.5, 1.5, 2.5, _t([1.0, -1.2])))).all()


# --------------------------------------------------------------------------- #
# against the JAX package's special.py                                         #
# --------------------------------------------------------------------------- #

_JAX_CASES = [
    ("besselj", n) for n in (0, 1, 5, -2, 0.3, 2.5, 12.7, 29.9, -12.7)
] + [("bessely", n) for n in (0, 1, 5, -2, 0.3, 12.7, -12.7)] + [
    ("besseli", n) for n in (0, 1, 5, -2, 0.3, 2.5)
] + [("besselk", n) for n in (0, 1, 5, -2, 0.3, 2.5, 12.7, -12.7)] + [
    ("sph_jn", n) for n in (0, 1, 2, 5, 8, 2.3)
] + [("sph_yn", n) for n in (0, 1, 2, 5, 8, 2.3)]


@pytest.mark.parametrize("name,order", _JAX_CASES, ids=[f"{n}-{o}" for n, o in _JAX_CASES])
def test_bessel_matches_jax_special(name, order):
    """Integer-order J only to z = 20: beyond, the JAX package's 50-step
    Miller recurrence parts from scipy (5e-9 at z = 30, O(1) at z = 50: C15),
    and the port's J_n is held to 40-digit mpmath instead
    (test_c15_integer_order_j_matches_mpmath)."""
    if name == "besseli":
        z = np.linspace(0.05, 15.0, 120)
    elif name == "besselj" and isinstance(order, int):
        z = np.linspace(0.05, 20.0, 240)
    else:
        z = np.linspace(0.05, 60.0, 240)
    got = _np(getattr(sp, name)(order, _t(z)))
    want = _np(getattr(jsp, name)(order, z))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert _floored_rel(got[fin], want[fin]) < 1e-12


def test_hyp_and_gamma_family_match_jax():
    z = np.linspace(-20.0, 20.0, 161)
    for a, b in [(0.5, 1.5), (2.0, 3.0)]:
        assert _floored_rel(_np(sp.hyp1f1(a, b, _t(z))), _np(jsp.hyp1f1(a, b, z))) < 1e-12
    assert _floored_rel(_np(sp.hyp0f1(2.5, _t(z))), _np(jsp.hyp0f1(2.5, z))) < 1e-12
    z2 = np.linspace(-0.95, 0.95, 191)
    assert _floored_rel(_np(sp.hyp2f1(0.5, 1.5, 2.5, _t(z2))),
                        _np(jsp.hyp2f1(0.5, 1.5, 2.5, z2))) < 1e-12
    x = _gamma_points()
    for fn in ("erf", "erfc", "lgamma", "gamma"):
        assert _floored_rel(_np(getattr(sp, fn)(_t(x))), _np(getattr(jam, fn)(x))) < 1e-12, fn
    assert _floored_rel(_np(sp.polygamma(0, _t(x))), _np(jam.polygamma(0, x))) < 1e-12


def test_jax_polygamma_is_the_faulty_one():
    """C13: the JAX package's polygamma of order ≥ 1 (XLA:CPU's) parts from
    scipy at negative arguments, by 6.7e-6 relative at x = −7.85 for ψ′;
    the port's holds 1e-12 there (test_polygamma)."""
    x = np.array([-7.85])
    assert abs(_np(jam.polygamma(1, x))[0] / sps.polygamma(1, x)[0] - 1.0) > 1e-7
    assert abs(float(sp.polygamma(1, _t(x))[0]) / sps.polygamma(1, x)[0] - 1.0) < 1e-13


# --------------------------------------------------------------------------- #
# the reference's faults: C1, C12 (mpmath), C11 (scipy in f32)                 #
# --------------------------------------------------------------------------- #


def test_c1_order_30_5_matches_mpmath():
    z = np.linspace(40.5, 300.0, 24)
    amp = np.sqrt(2.0 / (np.pi * z))
    with mpmath.workdps(40):
        for nu in (30.5, -30.5):
            wj = np.array([float(mpmath.besselj(nu, mpmath.mpf(v))) for v in z])
            wy = np.array([float(mpmath.bessely(nu, mpmath.mpf(v))) for v in z])
            assert np.max(np.abs(_np(sp.besselj(nu, _t(z))) - wj) / amp) < 1e-11, nu
            assert np.max(np.abs(_np(sp.bessely(nu, _t(z))) - wy) / amp) < 1e-11, nu
        # the JAX package's 30 upward steps give order 29.5 there (C1)
        ref = _np(jsp.besselj(30.5, np.array([50.0])))
        assert abs(ref[0] - float(mpmath.besselj(30.5, 50))) > 1e-3
        zk = np.linspace(2.5, 60.0, 12)
        wk = np.array([float(mpmath.besselk(30.5, mpmath.mpf(v))) for v in zk])
    np.testing.assert_allclose(_np(sp.besselk(30.5, _t(zk))), wk, rtol=1e-12)  # C12
    assert np.isnan(_np(sp.besselk(31.2, _t(zk)))).all()


def test_c11_f32_integer_order_j_is_finite():
    z = np.linspace(0.01, 30.0, 600).astype(np.float32)
    for n in (0, 1, 2, -1, 5):
        got = sp.besselj(n, torch.from_numpy(z))
        assert got.dtype == torch.float32 and torch.isfinite(got).all(), n
        assert np.max(np.abs(got.double().numpy() - sps.jv(n, z.astype(np.float64)))) < 1e-5, n
    # the JAX package's f32 J_n is NaN on [0.5, 3] (C11)
    assert np.isnan(_np(jsp.besselj(0, np.linspace(0.5, 3.0, 8).astype(np.float32)))).all()


_ORDER01 = [(name, n, mp_fn, (0.05, 60.0)) for name, mp_fn in (
    ("besselj", mpmath.besselj), ("bessely", mpmath.bessely), ("besselk", mpmath.besselk))
    for n in (0, 1)]


@pytest.mark.parametrize("name,n,mp_fn,rng", _ORDER01, ids=[f"{a}{b}" for a, b, _, _ in _ORDER01])
def test_order01_routes_match_mpmath(name, n, mp_fn, rng):
    """J₀, J₁, Y₀, Y₁, K₀ and K₁ (Cephes' rational and Chebyshev forms) in
    f64 against 40-digit mpmath, both sides of each branch (5 for J and Y, 2
    for K) and J₁ at negative z: within 1e-14 relative, or 1e-15 absolute
    near a zero of J or Y."""
    z = np.concatenate([np.linspace(*rng, 397), [2.0, 5.0, np.nextafter(5.0, 6.0)]])
    if name == "besselj" and n == 1:
        z = np.concatenate([z, -z[::7]])
    with mpmath.workdps(40):
        want = np.array([float(mp_fn(n, mpmath.mpf(float(v)))) for v in z])
    got = _np(getattr(sp, name)(n, _t(z)))
    floor = 1e-15 if name != "besselk" else 0.0
    err = np.abs(got - want)
    assert np.all(err <= np.maximum(1e-14 * np.abs(want), floor)), float(
        np.max(err / np.maximum(1e-14 * np.abs(want), 1e-300)))


@pytest.mark.parametrize("name,n", [(a, b) for a, b, _, _ in _ORDER01],
                         ids=[f"{a}{b}" for a, b, _, _ in _ORDER01])
def test_order01_routes_f32_match_scipy(name, n):
    """The same routes in f32 (B2, B7b take this code in float) against
    scipy on the f32 arguments: within 1e-5 relative (J and Y: relative to
    a floor of 0.1, so 1e-6 absolute near their zeros, where f32's rounding
    of the phase x − π/4 is what is left)."""
    z = np.linspace(0.05, 40.0, 500).astype(np.float32)
    got = getattr(sp, name)(n, torch.from_numpy(z))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = {"besselj": sps.jv, "bessely": sps.yv, "besselk": sps.kv}[name](n, z.astype(np.float64))
    floor = 0.0 if name == "besselk" else 0.1
    err = np.abs(got.double().numpy() - want)
    assert np.all(err <= 1e-5 * np.maximum(np.abs(want), floor))


def test_c15_integer_order_j_matches_mpmath():
    """C15: the JAX package's integer-order J_n (JAX 0.9's 50-step Miller
    recurrence) parts from 40-digit mpmath beyond z ≈ 25: J₀ by 4.5e-10 at
    z = 30, 3.9e-6 at 40 and 0.16 at 55; the port's J_n (J₀, J₁ rational,
    upward where |z| > |n|, Miller below) holds 1e-14 relative or 1e-15
    absolute out to z = 100."""
    z = np.linspace(0.05, 100.0, 240)
    with mpmath.workdps(40):
        for n in (0, 1, 2, 5, -2):
            want = np.array([float(mpmath.besselj(n, mpmath.mpf(float(v)))) for v in z])
            err = np.abs(_np(sp.besselj(n, _t(z))) - want)
            assert np.all(err <= np.maximum(1e-14 * np.abs(want), 1e-15)), n
        ref = _np(jsp.besselj(0, np.array([30.0, 40.0, 55.0])))
        want = np.array([float(mpmath.besselj(0, v)) for v in (30, 40, 55)])
        assert np.all(np.abs(ref - want) > [1e-10, 1e-6, 0.1])


def test_f32_special_functions_match_f64():
    """f32 against f64 on the same (f32) arguments: 3e-5, floored; the
    fractional J/Y routes 1e-3 (Steed's continued fractions lose about three
    digits of f32's seven); all finite, K_ν included (C12)."""
    z = np.linspace(0.05, 30.0, 300)
    z32 = torch.from_numpy(z.astype(np.float32))
    z64 = z32.double()
    for fn, order, tol in (("besselj", 0.3, 1e-3), ("sph_yn", 2.3, 1e-3), ("bessely", 1, 3e-5),
                           ("besselk", 2.5, 3e-5), ("besselk", 0.3, 3e-5),
                           ("besselk", 1, 3e-5), ("besseli", 3, 3e-5), ("sph_jn", 4, 3e-5)):
        got = getattr(sp, fn)(order, z32)
        want = getattr(sp, fn)(order, z64).numpy()
        assert got.dtype == torch.float32 and torch.isfinite(got).all(), (fn, order)
        assert _floored_rel(got.double().numpy(), want) < tol, (fn, order)


# --------------------------------------------------------------------------- #
# kernel B8's source, host-built, against the plain version                    #
# --------------------------------------------------------------------------- #

_EVAL_PARAMS = {"besselj_nu": (0.3,), "bessely_nu": (12.7,), "besseli_nu": (2.5,),
                "besselk_nu": (-12.7,), "sph_jn_nu": (2.3,), "sph_yn_nu": (2.3,),
                "hyp0f1": (2.5,), "hyp1f1": (0.5, 1.5), "hyp2f1": (0.5, 1.5, 2.5),
                "hyp2f0": (0.5, 1.0)}
#: each instance's argument range: both sides of every route's branch and of
#: its domain's edge, and the series' early and late exits
_EVAL_DOMAIN = {"hyp0f1": (-60.0, 60.0), "hyp1f1": (-320.0, 320.0), "hyp2f1": (-1.02, 1.02),
                "hyp2f0": (-0.02, 0.02), "erf": (-6.0, 6.0), "erfc": (-6.0, 7.0),
                "lgamma": (-7.9, 30.0), "gamma": (-7.9, 30.0), "besselj_nu": (-5.0, 300.0),
                "bessely_nu": (-5.0, 300.0), "besseli_nu": (-5.0, 20.0),
                "besselk_nu": (-5.0, 60.0), "besseli_0": (-20.0, 20.0),
                "besseli_1": (-20.0, 20.0)}
#: the branch points of each instance's routes (J/Y's rational form to 5, K's
#: Chebyshev series to 2, I's to 8, Steed's Temme/CF2 at 2 and its
#: asymptotics beyond 40, J_n's Miller/upward at n, 1F1's direct/Kummer at 0
#: and its domain at ±300, 2F1's at ±1, ψ's at −32 and 16)
_EVAL_EDGES = {"besselj": (5.0, 2.0), "bessely": (5.0,), "besselk": (2.0,), "besseli": (8.0,),
               "sph": (2.0, 40.0, 8.0), "hyp1f1": (0.0, 300.0, -300.0),
               "hyp2f1": (1.0, -1.0, 0.99), "polygamma": (-32.0, 16.0, 0.0)}
#: where an instance's route is arithmetic only (+ − × ÷, no library call):
#: there the host build and the plain version agree bit for bit (√ counts as
#: a library call: torch's CPU sqrt, in its AVX-512 build, rounds about 0.7 %
#: of arguments one ulp away from the correctly rounded root)
_ARITHMETIC_ROUTE = {"besselj_0": lambda z: np.abs(z) <= 5.0,
                     "besselj_1": lambda z: np.abs(z) <= 5.0,
                     "besselj_5": lambda z: np.abs(z) <= 5.0,
                     "besselj_m2": lambda z: np.abs(z) <= 2.0,
                     "hyp1f1": lambda z: (z >= 0.0) & (z <= 300.0)}
for _name in ("hyp0f1", "hyp2f1", "hyp2f0", "polygamma_1", "polygamma_2", "polygamma_3"):
    _ARITHMETIC_ROUTE[_name] = lambda z: np.ones(z.shape, dtype=bool)


@pytest.fixture(scope="module")
def host_b8(tmp_path_factory):
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib = tmp_path_factory.mktemp("b8") / "libspecial_eval.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-x", "c++", "-I", str(CSRC), "-o", str(lib),
                    str(CSRC / "special_eval.cu")], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def test_special_eval_instances_are_the_sources():
    src = (CSRC / "special_eval.cu").read_text()
    names = re.findall(r"^\s*X\((\w+), ", src, re.MULTILINE)
    assert names == list(special_eval.INSTANCES)


def _eval_arguments(name, dtype, rng):
    """3000 uniform arguments of the instance's range, each branch point and
    its two neighbours, NaN, ±0 and ±inf."""
    lo, hi = _EVAL_DOMAIN.get(name, (-7.9, 30.0) if name.startswith("polygamma")
                              else (0.01, 60.0))
    edges = [e for key, es in _EVAL_EDGES.items() if name.startswith(key) for e in es]
    if name.startswith(("besselj_", "sph_jn_")) and name[-1].isdigit():
        edges.append(float(name[-1]))
    z = rng.uniform(lo, hi, 3000).astype(dtype)
    near = [np.nextafter(dtype(e), dtype(d)) for e in edges for d in (-np.inf, np.inf)]
    special = np.array(edges + near + [np.nan, 0.0, -0.0, np.inf, -np.inf], dtype=dtype)
    return np.concatenate([z, special])


@pytest.mark.parametrize("name", list(special_eval.INSTANCES))
def test_host_built_b8_matches_the_plain_version(host_b8, name):
    """B8's source on the host against the plain version on the CPU, over
    every route of the instance (both sides of each branch, each series'
    early and full-length exits, NaN, ±0, ±inf): identical NaN, ±inf and
    signed-zero masks; bit for bit where the argument's route is arithmetic
    only; elsewhere within the host libm's last bits."""
    rng = np.random.default_rng(3)
    params = _EVAL_PARAMS.get(name, ())
    p = params + (0.0,) * (4 - len(params))
    fn = getattr(host_b8, f"inflx_sf_{name}_host")
    fn.argtypes = [ctypes.c_int] + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int64]
    for dtype, rtol in ((np.float64, 1e-13), (np.float32, 5e-5)):
        z = _eval_arguments(name, dtype, rng)
        out = np.empty_like(z)
        fn(int(dtype == np.float32), *p, z.ctypes.data, out.ctypes.data, z.size)
        want = special_eval.special_eval_cuda(name, torch.from_numpy(z), params).numpy()
        assert np.array_equal(np.isnan(out), np.isnan(want)), dtype
        assert np.array_equal(np.isinf(out) & (out > 0), np.isinf(want) & (want > 0)), dtype
        assert np.array_equal(np.isinf(out) & (out < 0), np.isinf(want) & (want < 0)), dtype
        zero = (out == 0) & (want == 0)
        assert np.array_equal(np.signbit(out[zero]), np.signbit(want[zero])), dtype
        exact = _ARITHMETIC_ROUTE.get(name, lambda v: np.zeros(v.shape, dtype=bool))(z)
        np.testing.assert_array_equal(out[exact], want[exact])
        fin = np.isfinite(want)
        assert _floored_rel(out[fin].astype(np.float64), want[fin].astype(np.float64)) < rtol


def test_operation_counts():
    """The operations each argument's route needs (``route_operations``, the
    bound of a kernel that calls B8), on the routes kernel B8 takes: J₀ is
    one rational form (27 operations to |z| = 5, 65 beyond with its sin, cos
    and sqrt), K₁ one Chebyshev series (and I₁ below 2); the power series
    stop where their sums settle, so 2F1 on S1's |z| ≤ 0.36 needs a few
    dozen terms of its 700 and 1F1 takes the direct or the Kummer series,
    never both, each far short of its 420 terms on |z| ≤ 20."""
    z = torch.linspace(0.05, 60.0, 301, dtype=torch.float64)
    assert bool((sp.operation_count("erf", z) == 1).all())
    whole = sp.operation_count("besselj", z, 0)
    assert bool((whole[z <= 5.0] == 27).all()) and bool((whole[z > 5.0] == 65).all())
    frac = sp.operation_count("besselj", z, 0.3)
    assert frac.double().mean() > 4 * whole.double().mean()
    assert int(sp.operation_count("besselk", z, 1).max()) < 150
    h = torch.linspace(-0.36, 0.36, 301, dtype=torch.float64)
    assert int(sp.operation_count("hyp2f1", h, 0.5, 1.5, 2.5).max()) < 40 * 9
    # near |z| = 1 the ratios tend to |z| > 0.99: all 700 terms, no exit tested
    far = sp.operation_count("hyp2f1", torch.tensor([-0.995, 0.995], dtype=torch.float64),
                             0.5, 1.5, 2.5)
    assert bool((far >= 700 * 9).all()) and bool((far < 700 * 10).all())
    k = sp.operation_count("hyp1f1", torch.linspace(-20.0, 20.0, 301, dtype=torch.float64),
                           -1.5, 2.5)
    assert 0 < int(k.min()) <= int(k.max()) < 420 * 2


def test_route_operations_count_the_selected_side():
    z = torch.tensor([-2.5, -1.5, 0.5, 2.0], dtype=torch.float64)
    # a model function: only the special functions' own operations count, and
    # only on the side each select takes (Γ = exp(lgamma), negated where Γ < 0)
    out, counts = sp.route_operations(
        lambda t: torch.where(t > 0, sp.gamma(t) * t, sp.erf(t * 2.0)) + t, z)
    assert torch.equal(out, torch.where(z > 0, torch.exp(torch.lgamma(z)) * z,
                                        torch.erf(z * 2.0)) + z)
    assert counts.tolist() == [1, 1, 2, 2]
    assert sp.operation_count("gamma", z).tolist() == [3, 2, 2, 2]
    # the tracer changes no value
    y = torch.linspace(0.1, 80.0, 500, dtype=torch.float64)
    assert torch.equal(sp.route_operations(sp.bessely, 12.7, y)[0], sp.bessely(12.7, y))
