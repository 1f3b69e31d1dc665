"""Special functions of lowered model expressions, in plain PyTorch.

The counterpart of ``inflatox_tpu/lowering/special.py`` and of the special
functions of ``inflatox_tpu/lowering/accmath.py`` (erf, erfc, lgamma, gamma,
polygamma): the sympy heads that the reference hands to GSL
(``compiler.py:158-212`` of the reference) — Bessel J/Y/I/K, spherical j/y,
the hypergeometric family 0F1/1F1/2F1/2F0 — and the gamma family.  Every
function is dtype-generic (float64 and float32) and elementwise over
broadcastable tensors or Python numbers; the orders of the Bessel functions
dispatch on :func:`_is_static_int` as in the JAX package.

This module is also the plain version of kernel B8
(``inflatox_torch/csrc/special.cuh``), which repeats it operation for
operation inside the grid, point and solver kernels.  So it keeps to a few
rules that make each line mean one thing on every device:

* loops keep the JAX package's fixed trip counts, as Python loops over
  tensors; each ``jnp.where`` is a ``torch.where`` (the kernel computes both
  sides too);
* the only library functions are elementwise ones that CUDA's libm has
  under the same name (``exp``, ``log``, ``sqrt``, ``sin``, ``cos``,
  ``sinh``, ``cosh``, ``lgamma``, ``erf``, ``erfc``, ``floor``, ``rint``,
  ``fmod``, ``abs``), never ``torch.special``;
* a tensor is never divided by a Python number: on CUDA that multiplies by
  the number's reciprocal, on the CPU it divides.  Such a divisor is made a
  tensor first (:func:`_k`), and ``1.0 / t`` is the only division of a number
  by a tensor;
* Python numbers combine in Python (float64) and are rounded to the working
  type once, where they meet a tensor; ``torch.minimum``-like clamps are
  ``torch.where`` selects that keep NaN.

Differences from the JAX package, each on purpose:

* **C1.** Beyond z = 40 the fractional J_ν/Y_ν recur upward from the reduced
  order in 31 steps (the JAX package's 30 returned J_{29.5} for ν = 30.5);
  |ν| > 30.5 is NaN with a one-time warning.  The fractional K_ν had the same
  30-step loop (K_{29.5} for ν = 30.5 at z ≥ 2): it recurs 31 steps as well,
  and |ν| > 30.5 is NaN there too.
* **C2.** Fractional spherical orders are NaN beyond |ν| = 29.5, the JAX
  compiler's gate (``compiler.py:287``).
* **C11.** ``jax.scipy.special.bessel_jn``'s Miller recurrence (50 steps from
  1e-16, JAX 0.9's ``_bessel_jn``) overflows float32 for z ≳ 0.5, so J_n was
  NaN in f32.  :func:`bessel_jn` is the same recurrence with an exact
  power-of-two rescaling whenever a value grows past a bound (2^64 in f32,
  2^500 in f64): f64 values are those of JAX wherever JAX is finite.  The
  spherical Miller recurrence of :func:`sph_jn` is rescaled the same way.
* ``gammaln`` (:func:`lgamma`), ``erf``, ``erfc`` are the libm functions; ``i0``/``i1`` are
  exp(|x|)·i0e(x) with the Cephes Chebyshev series that XLA's
  ``bessel_i0e``/``bessel_i1e`` evaluate; digamma and polygamma are the
  recurrence to x ≥ 16 and the asymptotic (Bernoulli) series, for x > −32
  (NaN with a one-time warning below).
* ``series_budget`` is the TPU's and has no counterpart.

Out-of-domain arguments return NaN and warn once per function and process
(:func:`_warn_once_out_of_domain`), unless inside
:func:`suppress_domain_warnings` — the grid, point and solver paths are, as
the JAX package's jitted scans cannot warn.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import sys
import weakref
from fractions import Fraction

import numpy as np
import torch

__all__ = [
    "hyp0f1", "hyp1f1", "hyp2f1", "hyp2f0",
    "besselj", "bessely", "besseli", "besselk", "sph_jn", "sph_yn",
    "bessel_jn", "i0", "i1",
    "erf", "erfc", "lgamma", "gamma", "polygamma",
    "suppress_domain_warnings", "operation_count", "route_operations",
]

_SERIES_ITERS = 96
_HYP1F1_ZMAX = 300.0
_STEED_ITERS = 100
_STEED_MAX_NL = 30
_STEED_XMIN = 2.0
_STEED_ZMAX = 40.0
_FRAC_MAX = 30.5  # the largest |ν| of the fractional J/Y/K routes
_SPH_FRAC_MAX = 29.5  # the largest fractional spherical |ν| (C2)
_CF2_ITERS = 60
_JN_ITERS = 50  # jax.scipy.special.bessel_jn's n_iter
_EULER_GAMMA = 0.57721566490153286060651209008240243
_PI = math.pi


# --------------------------------------------------------------------------- #
# out-of-domain warnings                                                      #
# --------------------------------------------------------------------------- #

_DOMAIN_WARNED: set = set()
_WARN_SUPPRESS: contextvars.ContextVar = contextvars.ContextVar(
    "special_domain_warn_suppress", default=False
)


@contextlib.contextmanager
def suppress_domain_warnings():
    """Silence the one-time out-of-domain warnings (the grid, point and
    solver paths evaluate whole grids, whose NaN the callers report)."""
    tok = _WARN_SUPPRESS.set(True)
    try:
        yield
    finally:
        _WARN_SUPPRESS.reset(tok)


def _warn_once_out_of_domain(name: str, bad, detail: str) -> None:
    if name in _DOMAIN_WARNED or _WARN_SUPPRESS.get():
        return
    if bool(torch.any(bad)):
        _DOMAIN_WARNED.add(name)
        from ..utils.logging import log_warn  # noqa: PLC0415

        log_warn(
            f"{name}: {detail} — returning NaN.  (The reference's GSL "
            "aborts through its error handler here, err.rs:83-103; this "
            "warning is emitted once per process.)"
        )


# --------------------------------------------------------------------------- #
# helpers                                                                     #
# --------------------------------------------------------------------------- #


def _tensors(*vals):
    """The values as broadcast tensors of one working type: float32 if
    every tensor among them is float32, else float64 (Python numbers take
    the tensors' type, as JAX's weak types do)."""
    ts = [v for v in vals if torch.is_tensor(v)]
    if ts and all(t.dtype == torch.float32 for t in ts):
        dtype = torch.float32
    else:
        dtype = torch.float64
    device = ts[0].device if ts else torch.device("cpu")
    out = [torch.as_tensor(v, dtype=dtype, device=device) for v in vals]
    return torch.broadcast_tensors(*out)


def _k(like, value):
    """The Python number ``value`` as a tensor like ``like``, so that a
    division by it is a true division on every device."""
    return torch.full_like(like, float(value))


def _minc(x, c: float):
    """min(x, c) keeping NaN (``jnp.minimum``)."""
    return torch.where(x > c, torch.full_like(x, c), x)


def _maxc(x, c: float):
    """max(x, c) keeping NaN (``jnp.maximum``)."""
    return torch.where(x < c, torch.full_like(x, c), x)


def _is_static_int(nu) -> bool:
    """True if ``nu`` is an integral Python/numpy/sympy number (not a
    tensor), which selects the integer-order routes, as the reference's GSL
    printer does at codegen time (compiler.py:184-190)."""
    if isinstance(nu, (bool, torch.Tensor)):
        return False
    try:
        return float(nu) == int(nu)
    except (TypeError, ValueError, OverflowError):
        return False


def _chbevl(x, coeffs):
    """Cephes' Chebyshev sum, as ``jax._src.lax.special``'s
    ``evaluate_chebyshev_polynomial``."""
    b0 = torch.zeros_like(x)
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for c in coeffs:
        b2 = b1
        b1 = b0
        b0 = x * b1 - b2 + float(c)
    return 0.5 * (b0 - b2)


def _cheb_eval(c, t):
    """Clenshaw evaluation of a Chebyshev series (coefficients low → high)."""
    d = torch.zeros_like(t)
    dd = torch.zeros_like(t)
    for ck in c[:0:-1]:
        d, dd = 2.0 * t * d - dd + float(ck), d
    return t * d - dd + float(c[0])


# --------------------------------------------------------------------------- #
# gamma family (accmath.py:222-268 of the JAX package)                        #
# --------------------------------------------------------------------------- #


def erf(x):
    """erf, the libm function."""
    (x,) = _tensors(x)
    return torch.erf(x)


def erfc(x):
    """erfc, the libm function."""
    (x,) = _tensors(x)
    return torch.erfc(x)


def lgamma(x):
    """ln|Γ(x)|, the libm function (``gammaln``)."""
    (x,) = _tensors(x)
    return torch.lgamma(x)


def gamma(x):
    """Γ(x) as sign·exp(lgamma), the sign from floor parity (Γ < 0 exactly
    on (−(2k+1), −2k)), as the JAX package's ``accmath.gamma``."""
    (x,) = _tensors(x)
    mag = torch.exp(torch.lgamma(x))
    neg = (x < 0.0) & (torch.fmod(torch.floor(x), 2.0) != 0.0)
    return torch.where(neg, -mag, mag)


_PSI_SHIFT = 48  # recurrence steps: x + 48 ≥ 16 for every x > −32
_PSI_X0 = 16.0
_PSI_TERMS = 12


def _bernoulli(n: int) -> Fraction:
    a = [Fraction(0)] * (n + 1)
    for m in range(n + 1):
        a[m] = Fraction(1, m + 1)
        for j in range(m, 0, -1):
            a[j - 1] = j * (a[j - 1] - a[j])
    return a[0] if n != 1 else Fraction(-1, 2)


def _psi_coeffs(n: int) -> list:
    """The asymptotic series' coefficients c_k (k = 1..12) of ψ⁽ⁿ⁾:
    ψ(x) ≈ ln x − 1/(2x) − Σ c_k x^(−2k), c_k = B_2k/(2k), and for n ≥ 1
    ψ⁽ⁿ⁾(x) ≈ (−1)^(n+1) x^(−n) [(n−1)! + n!/(2x) + Σ c_k x^(−2k)],
    c_k = B_2k (2k+n−1)!/(2k)!, each rounded once to f64."""
    out = []
    for k in range(1, _PSI_TERMS + 1):
        b = _bernoulli(2 * k)
        if n == 0:
            out.append(float(b / (2 * k)))
        else:
            out.append(float(b * math.factorial(2 * k + n - 1) / math.factorial(2 * k)))
    return out


def polygamma(n: int, x):
    """ψ⁽ⁿ⁾(x) for a non-negative integer n (n = 0: digamma): the recurrence
    ψ⁽ⁿ⁾(x) = ψ⁽ⁿ⁾(x+1) − (−1)ⁿ n!/x^(n+1), 48 masked steps up to x ≥ 16,
    then the asymptotic series (12 Bernoulli terms, ≲1e-16 at x = 16).
    Valid for x > −32; below, NaN and a one-time warning."""
    n = int(n)
    if n < 0:
        raise ValueError(f"polygamma order must be a non-negative integer, got {n}")
    (x,) = _tensors(x)
    coeffs = _psi_coeffs(n)
    sign = 1.0 if n % 2 == 1 else -1.0  # (−1)^(n+1)
    fact = float(math.factorial(n))
    xs = x
    acc = torch.zeros_like(x)
    for _ in range(_PSI_SHIFT):
        step = xs < _PSI_X0
        t = torch.ones_like(x) / _ipow(xs, n + 1)
        acc = torch.where(step, acc + t, acc)
        xs = torch.where(step, xs + 1.0, xs)
    w = torch.ones_like(x) / (xs * xs)
    ser = torch.zeros_like(x)
    for c in reversed(coeffs):
        ser = (ser + c) * w
    if n == 0:
        asym = torch.log(xs) - 0.5 * (torch.ones_like(x) / xs) - ser
        out = asym - acc
    else:
        head = float(math.factorial(n - 1)) + (0.5 * fact) * (torch.ones_like(x) / xs)
        asym = sign * ((head + ser) / _ipow(xs, n))
        out = asym + (sign * fact) * acc
    bad = x <= (_PSI_X0 - _PSI_SHIFT)
    _warn_once_out_of_domain(
        "polygamma", bad,
        f"x <= {_PSI_X0 - _PSI_SHIFT:g} is beyond the recurrence's fixed budget",
    )
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def _ipow(b, n: int):
    """b**n for an integer n ≥ 1 by repeated squaring (the lowering's
    ``_ipow``, the kernel's ``inflx_powi``)."""
    acc = None
    while True:
        if n & 1:
            acc = b if acc is None else acc * b
        n >>= 1
        if not n:
            return acc
        b = b * b


# --------------------------------------------------------------------------- #
# hypergeometric family                                                       #
# --------------------------------------------------------------------------- #


def hyp0f1(b, z):
    """₀F₁(; b; z): the power series Σ zⁿ/((b)ₙ n!), 96 terms."""
    b, z = _tensors(b, z)
    term = torch.ones_like(z)
    acc = torch.ones_like(z)
    for n in range(_SERIES_ITERS):
        nf = float(n)
        term = term * z / ((b + nf) * _k(z, nf + 1.0))
        acc = acc + term
    return acc


def _hyp1f1_series(a, b, z, iters=420):
    term = torch.ones_like(z)
    acc = torch.ones_like(z)
    for n in range(iters):
        nf = float(n)
        term = term * (a + nf) * z / ((b + nf) * _k(z, nf + 1.0))
        acc = acc + term
    return acc


def hyp1f1(a, b, z):
    """₁F₁(a; b; z): the power series for z ≥ 0 and Kummer's transformation
    e^z ₁F₁(b−a; b; −z) for z < 0, 420 terms; |z| > 300 is NaN."""
    a, b, z = _tensors(a, b, z)
    zp = torch.abs(z)
    zc = _minc(zp, _HYP1F1_ZMAX)
    direct = _hyp1f1_series(a, b, zc)
    kummer = torch.exp(z) * _hyp1f1_series(b - a, b, zc)
    out = torch.where(z >= 0.0, direct, kummer)
    bad = zp > _HYP1F1_ZMAX
    _warn_once_out_of_domain(
        "hyp1f1", bad, f"|z| > {_HYP1F1_ZMAX:g} exceeds the static series budget",
    )
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def hyp2f1(a, b, c, z):
    """₂F₁(a, b; c; z) for |z| < 1: the power series, 700 terms; |z| ≥ 1 is
    NaN (map the argument in, as GSL's callers must)."""
    a, b, c, z = _tensors(a, b, c, z)
    term = torch.ones_like(z)
    acc = torch.ones_like(z)
    for n in range(700):
        nf = float(n)
        term = term * (a + nf) * (b + nf) * z / ((c + nf) * _k(z, nf + 1.0))
        acc = acc + term
    bad = torch.abs(z) >= 1.0
    _warn_once_out_of_domain(
        "hyp2f1", bad,
        "|z| >= 1 is outside the series' convergence domain (map the "
        "argument in via the standard transformations, like GSL's "
        "gsl_sf_hyperg_2F1 callers must)",
    )
    return torch.where(bad, torch.full_like(acc, float("nan")), acc)


def hyp2f0(a, b, z):
    """₂F₀(a, b; ; z): the divergent asymptotic series, summed until its
    terms start to grow (96 steps)."""
    a, b, z = _tensors(a, b, z)
    term = torch.ones_like(z)
    acc = torch.ones_like(z)
    growing = torch.zeros_like(z, dtype=torch.bool)
    for n in range(_SERIES_ITERS):
        nf = float(n)
        new_term = term * (a + nf) * (b + nf) * z / _k(z, nf + 1.0)
        growing = growing | (torch.abs(new_term) > torch.abs(term))
        acc = torch.where(growing, acc, acc + new_term)
        term = new_term
    return acc


# --------------------------------------------------------------------------- #
# integer-order J_n, I_0, I_1 (jax.scipy.special's counterparts)              #
# --------------------------------------------------------------------------- #


def _rescale_bound(dtype):
    """(bound, factor) of the Miller recurrences' exact rescaling."""
    if dtype == torch.float32:
        return 2.0 ** 64, 2.0 ** -64
    return 2.0 ** 500, 2.0 ** -500


def bessel_jn(n: int, z):
    """J_n(z) for an integer n ≥ 0: JAX 0.9's ``_bessel_jn`` (Miller's
    backward recurrence over 51 orders from 1e-16, normalised by
    J_0 + 2ΣJ_2k = 1), with an exact power-of-two rescaling when a value
    passes 2^64 (f32) or 2^500 (f64), so that it cannot overflow (C11)."""
    (z,) = _tensors(z)
    bound, factor = _rescale_bound(z.dtype)
    f0 = torch.zeros_like(z)
    f1 = torch.full_like(z, 1e-16)
    bs = torch.zeros_like(z)
    fv = torch.zeros_like(z)
    f = f1
    for k in range(_JN_ITERS, -1, -1):
        f = f1 * (2.0 * (k + 1.0)) / z - f0
        if k % 2 == 0:
            bs = bs + 2.0 * f
        if k == n:
            fv = f
        big = torch.abs(f) > bound
        s = torch.where(big, torch.full_like(z, factor), torch.ones_like(z))
        f = f * s
        f0 = f1 * s
        f1 = f
        bs = bs * s
        fv = fv * s
    return fv / (bs - f)


_I0E_A = np.array([
    -4.41534164647933937950E-18, 3.33079451882223809783E-17,
    -2.43127984654795469359E-16, 1.71539128555513303061E-15,
    -1.16853328779934516808E-14, 7.67618549860493561688E-14,
    -4.85644678311192946090E-13, 2.95505266312963983461E-12,
    -1.72682629144155570723E-11, 9.67580903537323691224E-11,
    -5.18979560163526290666E-10, 2.65982372468238665035E-9,
    -1.30002500998624804212E-8, 6.04699502254191894932E-8,
    -2.67079385394061173391E-7, 1.11738753912010371815E-6,
    -4.41673835845875056359E-6, 1.64484480707288970893E-5,
    -5.75419501008210370398E-5, 1.88502885095841655729E-4,
    -5.76375574538582365885E-4, 1.63947561694133579842E-3,
    -4.32430999505057594430E-3, 1.05464603945949983183E-2,
    -2.37374148058994688156E-2, 4.93052842396707084878E-2,
    -9.49010970480476444210E-2, 1.71620901522208775349E-1,
    -3.04682672343198398683E-1, 6.76795274409476084995E-1,
])
_I0E_B = np.array([
    -7.23318048787475395456E-18, -4.83050448594418207126E-18,
    4.46562142029675999901E-17, 3.46122286769746109310E-17,
    -2.82762398051658348494E-16, -3.42548561967721913462E-16,
    1.77256013305652638360E-15, 3.81168066935262242075E-15,
    -9.55484669882830764870E-15, -4.15056934728722208663E-14,
    1.54008621752140982691E-14, 3.85277838274214270114E-13,
    7.18012445138366623367E-13, -1.79417853150680611778E-12,
    -1.32158118404477131188E-11, -3.14991652796324136454E-11,
    1.18891471078464383424E-11, 4.94060238822496958910E-10,
    3.39623202570838634515E-9, 2.26666899049817806459E-8,
    2.04891858946906374183E-7, 2.89137052083475648297E-6,
    6.88975834691682398426E-5, 3.36911647825569408990E-3,
    8.04490411014108831608E-1,
])
_I1E_A = np.array([
    2.77791411276104639959E-18, -2.11142121435816608115E-17,
    1.55363195773620046921E-16, -1.10559694773538630805E-15,
    7.60068429473540693410E-15, -5.04218550472791168711E-14,
    3.22379336594557470981E-13, -1.98397439776494371520E-12,
    1.17361862988909016308E-11, -6.66348972350202774223E-11,
    3.62559028155211703701E-10, -1.88724975172282928790E-9,
    9.38153738649577178388E-9, -4.44505912879632808065E-8,
    2.00329475355213526229E-7, -8.56872026469545474066E-7,
    3.47025130813767847674E-6, -1.32731636560394358279E-5,
    4.78156510755005422638E-5, -1.61760815825896745588E-4,
    5.12285956168575772895E-4, -1.51357245063125314899E-3,
    4.15642294431288815669E-3, -1.05640848946261981558E-2,
    2.47264490306265168283E-2, -5.29459812080949914269E-2,
    1.02643658689847095384E-1, -1.76416518357834055153E-1,
    2.52587186443633654823E-1,
])
_I1E_B = np.array([
    7.51729631084210481353E-18, 4.41434832307170791151E-18,
    -4.65030536848935832153E-17, -3.20952592199342395980E-17,
    2.96262899764595013876E-16, 3.30820231092092828324E-16,
    -1.88035477551078244854E-15, -3.81440307243700780478E-15,
    1.04202769841288027642E-14, 4.27244001671195135429E-14,
    -2.10154184277266431302E-14, -4.08355111109219731823E-13,
    -7.19855177624590851209E-13, 2.03562854414708950722E-12,
    1.41258074366137813316E-11, 3.25260358301548823856E-11,
    -1.89749581235054123450E-11, -5.58974346219658380687E-10,
    -3.83538038596423702205E-9, -2.63146884688951950684E-8,
    -2.51223623787020892529E-7, -3.88256480887769039346E-6,
    -1.10588938762623716291E-4, -9.76109749136146840777E-3,
    7.78576235018280120474E-1,
])
#: the float32 series are the f64 ones' last terms (Cephes' i0f/i1f)
_F32_TERMS = {"i0e_a": 18, "i0e_b": 7, "i1e_a": 17, "i1e_b": 7}


def _tables(dtype, name, table):
    return table[-_F32_TERMS[name]:] if dtype == torch.float32 else table


def _ie(x, a, b, first):
    """Cephes' exponentially scaled I_0 (``first``) or I_1 on |x|."""
    ax = torch.abs(x)
    le = _chbevl(0.5 * ax - 2.0, a)
    if not first:
        le = le * ax
    gt = _chbevl(_k(ax, 32.0) / ax - 2.0, b) / torch.sqrt(ax)
    return torch.where(ax <= 8.0, le, gt)


def i0(x):
    """I_0(x) = exp(|x|)·i0e(x)."""
    (x,) = _tensors(x)
    a = _tables(x.dtype, "i0e_a", _I0E_A)
    b = _tables(x.dtype, "i0e_b", _I0E_B)
    return torch.exp(torch.abs(x)) * _ie(x, a, b, True)


def i1(x):
    """I_1(x) = exp(|x|)·i1e(x), odd in x."""
    (x,) = _tensors(x)
    a = _tables(x.dtype, "i1e_a", _I1E_A)
    b = _tables(x.dtype, "i1e_b", _I1E_B)
    e = _ie(x, a, b, False)
    e = torch.where(x < 0.0, -e, e)
    return torch.exp(torch.abs(x)) * e


# --------------------------------------------------------------------------- #
# Bessel family                                                               #
# --------------------------------------------------------------------------- #


def _bessel_j_int(n: int, z):
    sign = 1.0
    if n < 0:  # J_{-n} = (-1)^n J_n
        sign = (-1.0) ** (-n)
        n = -n
    out = bessel_jn(n, z)
    return out if sign == 1.0 else -out


def _bessel_frac(nu, z, modified: bool):
    """J_ν or I_ν by the 0F1 form (z/2)^ν/Γ(ν+1) ₀F₁(ν+1; ∓z²/4), z ≥ 0;
    the sign of Γ(ν+1) from floor parity."""
    nu, z = _tensors(nu, z)
    q = z * z * 0.25
    arg = q if modified else -q
    x1 = nu + 1.0
    one = torch.ones_like(z)
    sgn = torch.where(
        x1 > 0.0, one,
        torch.where(torch.fmod(torch.floor(x1), 2.0) == 0.0, one, -one),
    )
    pref = sgn * torch.exp(nu * torch.log(z * 0.5) - torch.lgamma(x1))
    return pref * hyp0f1(x1, arg)


_TEMME_G1 = np.array([
    -0.5710113401855841, -1.97551434264295e-17, 0.00651651126707368,
    -1.9461688077422866e-17, 0.0003087090173085056, -1.9637573943002206e-17,
    -3.4706269649151143e-06, -1.39082417974295e-17, 6.943766421246031e-09,
    -1.621927686259548e-17, 3.677951441937119e-11, -1.1051165107663382e-17,
    -1.356340297563193e-13, -7.138982946540495e-18, -3.5327647554267563e-17
])
_TEMME_G2 = np.array([
    0.921870293650453, 3.523462454814079e-17, -0.0768528408447866,
    5.2912295582844394e-17, 0.0012719271366546513, 5.4734676185828735e-17,
    -4.9717367041385e-06, 2.377817426824363e-17, -3.312611969802513e-08,
    9.312654661450359e-17, 2.4230963292765556e-10, 2.9257568727534474e-17,
    -1.701486781673822e-13, 4.44840869628458e-17, -1.4628228722797227e-15
])


def _bessjy_steed(nu, x):
    """(J_ν(x), Y_ν(x)) for real ν ≥ 0, x > 0: Steed's method (CF1, Temme's
    series below x = 2, the complex CF2 above), as the JAX package's."""
    nu, x = _tensors(nu, x)
    tiny = 1e-30
    xs = torch.where(x > 0.0, x, torch.ones_like(x))
    nl = torch.where(
        xs < _STEED_XMIN,
        torch.floor(nu + 0.5),
        _maxc(torch.floor(nu - xs + 1.5), 0.0),
    )
    nl = _minc(_maxc(nl, 0.0), float(_STEED_MAX_NL))
    xmu = nu - nl
    xmu2 = xmu * xmu
    xi = 1.0 / xs
    xi2 = 2.0 * xi

    # CF1: h = J'_ν/J_ν, the sign of J_ν in isign
    h0 = _maxc(nu * xi, tiny)
    b, c, d, h = xi2 * nu, h0, torch.zeros_like(xs), h0
    isign = torch.ones_like(xs)
    done = torch.zeros_like(xs, dtype=torch.bool)
    for _ in range(1, _STEED_ITERS):
        b2 = b + xi2
        d2 = b2 - d
        d2 = torch.where(torch.abs(d2) < tiny, torch.full_like(d2, tiny), d2)
        c2 = b2 - 1.0 / c
        c2 = torch.where(torch.abs(c2) < tiny, torch.full_like(c2, tiny), c2)
        d2 = 1.0 / d2
        dl = c2 * d2
        h2 = h * dl
        isign = torch.where((d2 < 0.0) & ~done, -isign, isign)
        conv = torch.abs(dl - 1.0) < 1e-16
        b = torch.where(done, b, b2)
        c = torch.where(done, c, c2)
        d = torch.where(done, d, d2)
        h = torch.where(done, h, h2)
        done = done | conv

    # downward recurrence, nl masked steps
    rjl = isign * tiny
    rjpl = h * rjl
    rjl1 = rjl
    fact = nu * xi
    for i in range(_STEED_MAX_NL):
        step = nl > float(i)
        rjtemp = fact * rjl + rjpl
        fact2 = fact - xi
        rjpl2 = fact2 * rjtemp - rjl
        rjl = torch.where(step, rjtemp, rjl)
        rjpl = torch.where(step, rjpl2, rjpl)
        fact = torch.where(step, fact2, fact)
    rjl = torch.where(rjl == 0.0, torch.full_like(rjl, tiny), rjl)
    f = rjpl / rjl

    # small x: Temme's series
    one = torch.ones_like(xs)
    xc = _minc(xs, _STEED_XMIN)
    x2 = 0.5 * xc
    pimu = _PI * xmu
    fact_t = torch.where(torch.abs(pimu) < 1e-15, one, pimu / torch.sin(pimu))
    dd = -torch.log(x2)
    e = xmu * dd
    fact2_t = torch.where(torch.abs(e) < 1e-15, one, torch.sinh(e) / e)
    tg = 2.0 * xmu
    gam1 = _cheb_eval(_TEMME_G1, tg)
    gam2 = _cheb_eval(_TEMME_G2, tg)
    ff = (2.0 / _PI) * fact_t * (gam1 * torch.cosh(e) + gam2 * fact2_t * dd)
    ee = torch.exp(e)
    gampl = gam2 - xmu * gam1
    gammi = gam2 + xmu * gam1
    pt = ee / (gampl * _PI)
    qt = 1.0 / (ee * _PI * gammi)
    pimu2 = 0.5 * pimu
    fact3 = torch.where(torch.abs(pimu2) < 1e-15, one, torch.sin(pimu2) / pimu2)
    rr = _PI * pimu2 * fact3 * fact3
    dd2 = -x2 * x2
    cc = torch.ones_like(xs)
    ssum = ff + rr * qt
    ssum1 = pt
    done = torch.zeros_like(xs, dtype=torch.bool)
    for i in range(1, _STEED_ITERS):
        fi = float(i)
        ff2 = (fi * ff + pt + qt) / (fi * fi - xmu2)
        cc2 = cc * dd2 / _k(xs, fi)
        pt2 = pt / (fi - xmu)
        qt2 = qt / (fi + xmu)
        dl = cc2 * (ff2 + rr * qt2)
        ssum2 = ssum + dl
        dl1 = cc2 * pt2 - fi * dl
        ssum12 = ssum1 + dl1
        conv = torch.abs(dl) < (1.0 + torch.abs(ssum2)) * 1e-17
        ff = torch.where(done, ff, ff2)
        cc = torch.where(done, cc, cc2)
        pt = torch.where(done, pt, pt2)
        qt = torch.where(done, qt, qt2)
        ssum = torch.where(done, ssum, ssum2)
        ssum1 = torch.where(done, ssum1, ssum12)
        done = done | conv
    rymu_s = -ssum
    ry1_s = -ssum1 * (_k(xc, 2.0) / xc)
    rymup_s = xmu / xc * rymu_s - ry1_s
    w_small = _k(xc, 2.0) / (_PI * xc)
    rjmu_s = w_small / (rymup_s - f * rymu_s)

    # large x: the complex CF2
    xb = _maxc(xs, _STEED_XMIN)
    xib = 1.0 / xb
    a = 0.25 - xmu2
    pc = -0.5 * xib
    qc = torch.ones_like(xs)
    br = 2.0 * xb
    bi = torch.full_like(xs, 2.0)
    fact_c = a * xib / (pc * pc + qc * qc)
    cr = br + qc * fact_c
    ci = bi + pc * fact_c
    den0 = br * br + bi * bi
    dr = br / den0
    di = -bi / den0
    dlr = cr * dr - ci * di
    dli = cr * di + ci * dr
    temp = pc * dlr - qc * dli
    qc = pc * dli + qc * dlr
    pc = temp
    done = torch.zeros_like(xs, dtype=torch.bool)
    for i in range(2, _STEED_ITERS):
        fi = float(i)
        a2 = a + 2.0 * (fi - 1.0)
        bi2 = bi + 2.0
        dr2 = a2 * dr + br
        di2 = a2 * di + bi2
        small = (torch.abs(dr2) + torch.abs(di2)) < tiny
        dr2 = torch.where(small, torch.full_like(dr2, tiny), dr2)
        fact = a2 / (cr * cr + ci * ci)
        cr2 = br + cr * fact
        ci2 = bi2 - ci * fact
        smallc = (torch.abs(cr2) + torch.abs(ci2)) < tiny
        cr2 = torch.where(smallc, torch.full_like(cr2, tiny), cr2)
        den = dr2 * dr2 + di2 * di2
        dr3 = dr2 / den
        di3 = -di2 / den
        dlr = cr2 * dr3 - ci2 * di3
        dli = cr2 * di3 + ci2 * dr3
        temp = pc * dlr - qc * dli
        qc2 = pc * dli + qc * dlr
        pc2 = temp
        conv = (torch.abs(dlr - 1.0) + torch.abs(dli)) < 1e-16
        a = torch.where(done, a, a2)
        bi = torch.where(done, bi, bi2)
        cr = torch.where(done, cr, cr2)
        ci = torch.where(done, ci, ci2)
        dr = torch.where(done, dr, dr3)
        di = torch.where(done, di, di3)
        pc = torch.where(done, pc, pc2)
        qc = torch.where(done, qc, qc2)
        done = done | conv
    gam = (pc - f) / qc
    w_big = _k(xb, 2.0) / (_PI * xb)
    rjmu_b = torch.sqrt(torch.abs(w_big / ((pc - f) * gam + qc)))
    rjmu_b = torch.where(rjl >= 0.0, rjmu_b, -rjmu_b)
    rymu_b = rjmu_b * gam
    rymup_b = rymu_b * (pc + qc / gam)
    ry1_b = xmu * xib * rymu_b - rymup_b

    small_mask = xs < _STEED_XMIN
    rjmu = torch.where(small_mask, rjmu_s, rjmu_b)
    rymu = torch.where(small_mask, rymu_s, rymu_b)
    ry1 = torch.where(small_mask, ry1_s, ry1_b)
    rj = rjl1 * (rjmu / rjl)
    for i in range(_STEED_MAX_NL):
        step = nl > float(i)
        rytemp = (xmu + float(i) + 1.0) * xi2 * ry1 - rymu
        rymu, ry1 = torch.where(step, ry1, rymu), torch.where(step, rytemp, ry1)
    bad = x <= 0.0
    nan = torch.full_like(rj, float("nan"))
    return torch.where(bad, nan, rj), torch.where(bad, nan, rymu)


_ASYM_TERMS = 16


def _jy_asymptotic(nu, z, kind):
    """J_ν (``kind="j"``) or Y_ν for large z: Hankel's modulus/phase
    expansion (A&S 9.2.5-9.2.10), summed until the terms stop shrinking."""
    nu, z = _tensors(nu, z)
    mu = 4.0 * nu * nu
    zi = 1.0 / (8.0 * z)
    p = torch.ones_like(z)
    q = (mu - 1.0) * zi
    term_p = torch.ones_like(z)
    term_q = q
    stop_p = torch.zeros_like(z, dtype=torch.bool)
    stop_q = torch.zeros_like(z, dtype=torch.bool)
    for k in range(1, _ASYM_TERMS):
        new_p = (-term_p * (mu - float((4 * k - 3) ** 2)) * (mu - float((4 * k - 1) ** 2))
                 / _k(z, (2 * k - 1) * (2 * k)) * zi * zi)
        stop_p = stop_p | (torch.abs(new_p) >= torch.abs(term_p))
        p = torch.where(stop_p, p, p + new_p)
        term_p = new_p
        new_q = (-term_q * (mu - float((4 * k - 1) ** 2)) * (mu - float((4 * k + 1) ** 2))
                 / _k(z, (2 * k) * (2 * k + 1)) * zi * zi)
        stop_q = stop_q | (torch.abs(new_q) >= torch.abs(term_q))
        q = torch.where(stop_q, q, q + new_q)
        term_q = new_q
    chi = z - (0.5 * nu + 0.25) * _PI
    amp = torch.sqrt(_k(z, 2.0) / (_PI * z))
    if kind == "j":
        return amp * (p * torch.cos(chi) - q * torch.sin(chi))
    return amp * (p * torch.sin(chi) + q * torch.cos(chi))


def _sincospi(r):
    """(sin πr, cos πr), exact at half-integer r."""
    q = torch.round(2.0 * r) * 0.5
    u = (r - q) * _PI
    su, cu = torch.sin(u), torch.cos(u)
    k = torch.round(2.0 * q).to(torch.int32) & 3
    zero, one = torch.zeros_like(r), torch.ones_like(r)
    sq = torch.where(k == 0, zero, torch.where(k == 1, one, torch.where(k == 2, zero, -one)))
    cq = torch.where(k == 0, one, torch.where(k == 1, zero, torch.where(k == 2, -one, zero)))
    return sq * cu + cq * su, cq * cu - sq * su


def _bessjy_frac(nu, z):
    """(J_ν, Y_ν) for a real ν with |ν| ≤ 30.5, z > 0: Steed for z ≤ 40,
    beyond it Hankel's asymptotics (orders above 8 at the reduced order
    |μ| ≤ ½ and recurred upward, 31 masked steps: C1), negative orders by
    the reflection formulas."""
    nu, z = _tensors(nu, z)
    anu = torch.abs(nu)
    js, ys = _bessjy_steed(anu, _minc(z, _STEED_ZMAX))
    zb = _maxc(z, _STEED_ZMAX)
    ja = _jy_asymptotic(anu, zb, "j")
    ya = _jy_asymptotic(anu, zb, "y")
    nl = torch.floor(anu + 0.5)
    mu = anu - nl
    jmu = _jy_asymptotic(mu, zb, "j")
    jmu1 = _jy_asymptotic(mu + 1.0, zb, "j")
    ymu = _jy_asymptotic(mu, zb, "y")
    ymu1 = _jy_asymptotic(mu + 1.0, zb, "y")
    xi2 = _k(zb, 2.0) / zb
    jk, jk1, yk, yk1 = jmu, jmu1, ymu, ymu1
    for i in range(_STEED_MAX_NL + 1):
        step = nl > float(i)
        fac = (mu + float(i) + 1.0) * xi2
        jn = fac * jk1 - jk
        yn = fac * yk1 - yk
        jk, jk1 = torch.where(step, jk1, jk), torch.where(step, jn, jk1)
        yk, yk1 = torch.where(step, yk1, yk), torch.where(step, yn, yk1)
    hi_order = anu > 8.0
    ja = torch.where(hi_order, jk, ja)
    ya = torch.where(hi_order, yk, ya)
    big = z > _STEED_ZMAX
    j = torch.where(big, ja, js)
    y = torch.where(big, ya, ys)
    sn, c = _sincospi(anu)
    j_neg = j * c - y * sn
    y_neg = j * sn + y * c
    neg = nu < 0.0
    j = torch.where(neg, j_neg, j)
    y = torch.where(neg, y_neg, y)
    bad = anu > _FRAC_MAX
    _warn_once_out_of_domain(
        "fractional Bessel order", bad,
        "J_ν/Y_ν fractional orders are supported for |ν| ≤ 30.5 (the Steed "
        "order-reduction budget); larger fractional orders have no "
        "full-accuracy path here",
    )
    nan = torch.full_like(j, float("nan"))
    return torch.where(bad, nan, j), torch.where(bad, nan, y)


def besselj(nu, z):
    """Bessel function of the first kind J_ν(z): integer ν (a Python or
    sympy number) for any real z, fractional ν for z ≥ 0."""
    if _is_static_int(nu):
        return _bessel_j_int(int(nu), z)
    return _bessjy_frac(nu, z)[0]


def besseli(nu, z):
    """Modified Bessel function of the first kind I_ν(z)."""
    if _is_static_int(nu):
        n = abs(int(nu))  # I_{-n} = I_n
        if n == 0:
            return i0(z)
        if n == 1:
            return i1(z)
        (z,) = _tensors(z)
        one = torch.ones_like(z)
        sgn = torch.where(z < 0.0, one * ((-1.0) ** n), one)
        return sgn * _bessel_frac(float(n), torch.abs(z), modified=True)
    return _bessel_frac(nu, z, modified=True)


def _bessel_y0y1_small(n: int, z):
    """Y₀/Y₁ power series for small z (A&S 9.1.13/9.1.16)."""
    q = z * z * 0.25
    logz2 = torch.log(z * 0.5)
    term = torch.ones_like(z)
    if n == 0:
        acc = torch.zeros_like(z)
        hk = torch.zeros_like(z)
        for k in range(1, 32):
            kf = float(k)
            term = term * (-q) / _k(z, kf * kf)
            hk = hk + 1.0 / kf
            acc = acc + (-term) * hk
        return (2.0 / _PI) * ((logz2 + _EULER_GAMMA) * bessel_jn(0, z) + acc)
    acc = torch.ones_like(z)
    hk = torch.zeros_like(z)
    hk1 = torch.ones_like(z)
    for k in range(1, 32):
        kf = float(k)
        term = term * (-q) / _k(z, kf * (kf + 1.0))
        hk = hk + 1.0 / kf
        hk1 = hk1 + 1.0 / (kf + 1.0)
        acc = acc + term * (hk + hk1)
    return (2.0 / _PI) * ((logz2 + _EULER_GAMMA) * bessel_jn(1, z) - 1.0 / z
                          - (z * 0.25) * acc)


_K0_MID = np.array([
    1.2028286465790197, -0.030591787719553676, 0.0014210722375637287,
    -0.00010388158100365775, 9.762067788423225e-06, -1.082086296879005e-06,
    1.351201646484709e-07, -1.8482595638611766e-08, 2.7186252388337763e-09,
    -4.2445766658763436e-10, 6.967483660813012e-11, -1.1937916743473208e-11,
    2.122964169369167e-12, -3.900234424279417e-13, 7.379256178071285e-14,
    -1.4358723953495275e-14, 2.906948152039217e-15, -5.661300575341757e-16,
    1.4790247649295895e-16, -3.7292984407056944e-17, 4.079690562390755e-17,
    -3.755188669435943e-17, 5.87983431477737e-17
])
_K0_BIG = np.array([
    1.243990650868462, -0.009174852691025803, 0.0001444550931774185,
    -4.013614175529894e-06, 1.5678318100587383e-07, -7.770110513915755e-09,
    4.6111815781408603e-10, -3.158599198997939e-11, 2.4349281259007275e-12,
    -2.0746853963234516e-13, 1.9171836557903002e-14, -2.0445114343506195e-15,
    1.5179938710645071e-16, -6.182631040969e-17, -4.816035433020208e-17,
    -1.0835900161805395e-17, -3.281931876688869e-17, -1.2518526181642369e-17,
    -1.3017455987150712e-17
])
_K1_MID = np.array([
    1.4189885893618182, 0.10612301366130722, -0.002702099638238477,
    0.0001642748476195546, -1.4066859038775309e-05, 1.4728630269748668e-06,
    -1.7689408145186164e-07, 2.3517081640480202e-08, -3.3843113374756892e-09,
    5.192772802632103e-10, -8.403627294281494e-11, 1.422843705030357e-11,
    -2.505033636540474e-12, 4.561081594257689e-13, -8.583800390419009e-14,
    1.6395736411563473e-14, -3.560270024145593e-15, 6.186397753261234e-16,
    -3.2426039306575127e-16, -4.652819950330459e-17, -1.6261072401069936e-16,
    -2.6902548683153138e-17, -2.0969558484027402e-16
])
_K1_BIG = np.array([
    1.2818965417186945, 0.028328878130496924, -0.0002475370673908294,
    5.771972451393736e-06, -2.0689392218267664e-07, 9.7399832458936e-09,
    -5.585338401432265e-10, 3.732975526333097e-11, -2.8252565097005837e-12,
    2.3701095737069585e-13, -2.1914146235882745e-14, 1.9954495011791e-15,
    -3.436372385782436e-16, -8.202562152366134e-17, -9.82720080779848e-17,
    -6.961783446547556e-17, -4.983764228948445e-17, -3.7631602816937714e-17,
    -3.798734762107494e-17
])
_P0_CHEB = np.array([
    0.9983508529003942, -0.001622326525375695, 2.5659898108143426e-05,
    -1.074733530416572e-06, 7.695166556043232e-08, -7.791256341956166e-09,
    1.0076739103231815e-09, -1.5658349022456687e-10, 2.8088380309445716e-11,
    -5.658276572807053e-12, 1.2545846649486519e-12, -3.018157851826075e-13,
    7.770335308276474e-14, -2.1400656843957792e-14, 6.0866911665685924e-15,
    -1.9175618638796704e-15, 5.223191128158126e-16, -2.582061101890892e-16,
    3.812008134199594e-18, -7.203990078083427e-17, -4.557691178921068e-17,
    -7.223706440208404e-17, -2.4180592802364897e-17, -3.5987873804036357e-17,
    -2.354118526106635e-17, -3.087215181110812e-18, 3.0030154289718896e-19
])
_Q0_CHEB = np.array([
    -0.9868477858880368, 0.012759549508489528, -0.0003688766783741065,
    2.158470606690122e-05, -1.9316120103761817e-06, 2.304153571648965e-07,
    -3.3875070735292195e-08, 5.843684649743781e-09, -1.1445219177974879e-09,
    2.4865775839813145e-10, -5.891333657551081e-11, 1.5026430945397446e-11,
    -4.084478611649733e-12, 1.1740431677796777e-12, -3.543196004136144e-13,
    1.1190546422688331e-13, -3.6596652104615294e-14, 1.2563723156020945e-14,
    -4.314441346685688e-15, 1.6441712130040167e-15, -5.2741677897999485e-16,
    2.921798175429053e-16, -3.892383191730539e-17, 6.579633017216143e-17,
    2.2880739233840472e-17, 2.3189038055029087e-18, 1.2657498054430783e-17
])
_P1_CHEB = np.array([
    1.0027803045717265, 0.0027451765837570277, -3.37240456836456e-05,
    1.3039465877996387e-06, -8.977362126121733e-08, 8.879041215404142e-09,
    -1.1304764437260006e-09, 1.7368451938885874e-10, -3.088836293566369e-11,
    6.179620070343051e-12, -1.3628285303321794e-12, 3.260649624431963e-13,
    -8.390493153679579e-14, 2.2715949868341296e-14, -6.649476182587768e-15,
    1.905978001484501e-15, -6.998943698090866e-16, 1.1415812995042947e-16,
    -1.394877549346043e-16, -5.089708752991405e-17, -6.315774200223593e-17,
    -3.747835943704532e-17, -6.557383948286377e-17, -5.336819161384358e-17,
    -1.4614448608232376e-17, -7.277419269263228e-17, -4.1262536705884326e-18
])
_Q1_CHEB = np.array([
    2.981372314582739, -0.018139154448572267, 0.0004604727250432597,
    -2.5533947079856635e-05, 2.2187784778197517e-06, -2.5977194735365343e-07,
    3.769713746371197e-08, -6.440505408154428e-09, 1.251985974947473e-09,
    -2.7037085655414845e-10, 6.37399269324142e-11, -1.618963561913587e-11,
    4.384894552402446e-12, -1.2564827497987848e-12, 3.7812825146302015e-13,
    -1.1914928855413263e-13, 3.8782919129101206e-14, -1.3391579376625813e-14,
    4.495570412283071e-15, -1.7262176941126247e-15, 5.114991046295202e-16,
    -2.684317911813195e-16, 2.385651056346922e-17, -1.0554732655592933e-16,
    2.0011870922808886e-17, -1.0545496332212484e-18, -1.5345237860883502e-17
])
_K_MID_LO, _K_MID_HI = 1.0 / 8.0, 1.0 / 1.5
_PQ_V_HI = (8.0 / 4.5) ** 2


def _besselk01_cheb(n: int, z):
    """K_0/K_1 for z ≥ 1.5: the scaled Chebyshev fits (≤3e-15)."""
    u = 1.0 / z
    t_mid = ((2.0 * _minc(_maxc(u, _K_MID_LO), _K_MID_HI) - (_K_MID_LO + _K_MID_HI))
             / _k(z, _K_MID_HI - _K_MID_LO))
    t_big = 16.0 * _minc(_maxc(u, 0.0), _K_MID_LO) - 1.0
    mid = _cheb_eval(_K0_MID if n == 0 else _K1_MID, t_mid)
    big = _cheb_eval(_K0_BIG if n == 0 else _K1_BIG, t_big)
    scaled = torch.where(z > 8.0, big, mid)
    return scaled * torch.exp(-z) / torch.sqrt(z)


def _bessely01_cheb(n: int, z):
    """Y_0/Y_1 for z ≥ 4.5: the modulus/phase Chebyshev fits (≤4e-15)."""
    r = _k(z, 8.0) / z
    v = _minc(_maxc(r * r, 0.0), _PQ_V_HI)
    t = (2.0 * v - _PQ_V_HI) / _k(z, _PQ_V_HI)
    p = _cheb_eval(_P0_CHEB if n == 0 else _P1_CHEB, t)
    q = _cheb_eval(_Q0_CHEB if n == 0 else _Q1_CHEB, t) / (8.0 * z)
    chi = z - (0.5 * n + 0.25) * _PI
    amp = torch.sqrt(_k(z, 2.0) / (_PI * z))
    return amp * (p * torch.sin(chi) + q * torch.cos(chi))


def _y01(n: int, zs):
    return torch.where(zs < 4.5, _bessel_y0y1_small(n, _minc(zs, 4.5)),
                       _bessely01_cheb(n, _maxc(zs, 4.5)))


def bessely(nu, z):
    """Bessel function of the second kind Y_ν(z), z > 0: integer orders by
    the log series below 4.5, the Chebyshev fits above and forward
    recurrence; fractional orders by :func:`_bessjy_frac`."""
    if _is_static_int(nu):
        n = int(nu)
        sign = 1.0
        if n < 0:
            sign = (-1.0) ** (-n)
            n = -n
        (z,) = _tensors(z)
        zs = torch.where(z > 0.0, z, torch.ones_like(z))
        out = _y01(0, zs)
        if n > 0:
            prev, cur = out, _y01(1, zs)
            for k in range(1, n):
                prev, cur = cur, (_k(zs, 2.0 * k) / zs) * cur - prev
            out = cur
        if sign != 1.0:
            out = -out
        return torch.where(z > 0.0, out, torch.full_like(out, float("nan")))
    return _bessjy_frac(nu, z)[1]


def _besselk_int_small(n: int, z):
    """K₀/K₁ power series for small z (A&S 9.6.11)."""
    q = z * z * 0.25
    logz2 = torch.log(z * 0.5)
    term = torch.ones_like(z)
    if n == 0:
        acc = torch.zeros_like(z)
        hk = torch.zeros_like(z)
        for k in range(1, 40):
            kf = float(k)
            term = term * q / _k(z, kf * kf)
            hk = hk + 1.0 / kf
            acc = acc + term * hk
        return -(logz2 + _EULER_GAMMA) * i0(z) + acc
    acc = torch.full_like(z, -2.0 * _EULER_GAMMA + 1.0)
    hk = torch.zeros_like(z)
    hk1 = torch.ones_like(z)
    for k in range(1, 40):
        kf = float(k)
        term = term * q / _k(z, kf * (kf + 1.0))
        hk = hk + 1.0 / kf
        hk1 = hk1 + 1.0 / (kf + 1.0)
        acc = acc + term * (-2.0 * _EULER_GAMMA + hk + hk1)
    return 1.0 / z + logz2 * i1(z) - (z * 0.25) * acc


def _k01(n: int, zs):
    return torch.where(zs < 1.5, _besselk_int_small(n, _minc(zs, 1.5)),
                       _besselk01_cheb(n, _maxc(zs, 1.5)))


def besselk(nu, z):
    """Modified Bessel function of the second kind K_ν(z), z > 0: integer
    orders by the series below 1.5, the Chebyshev fits above and upward
    recurrence; fractional orders by :func:`_besselk_frac`."""
    if _is_static_int(nu):
        n = abs(int(nu))  # K_{-ν} = K_ν
        (z,) = _tensors(z)
        zs = torch.where(z > 0.0, z, torch.ones_like(z))
        out = _k01(0, zs)
        if n > 0:
            prev, cur = out, _k01(1, zs)
            for k in range(1, n):
                prev, cur = cur, prev + (_k(zs, 2.0 * k) / zs) * cur
            out = cur
        return torch.where(z > 0.0, out, torch.full_like(out, float("nan")))
    return _besselk_frac(nu, z)


def _besselk_frac(nu, z):
    """Fractional K_ν: π(I_{−ν} − I_ν)/(2 sin νπ) below z = 2, Steed's CF2
    from z = 2; |ν| > 30.5 is NaN."""
    nu, z = _tensors(nu, z)
    anu = torch.abs(nu)
    zs_small = _minc(z, 2.0)
    ip = _bessel_frac(-anu, zs_small, modified=True)
    im = _bessel_frac(anu, zs_small, modified=True)
    small = _PI * (ip - im) / (2.0 * torch.sin(_PI * anu))
    big = _besselk_frac_cf2(anu, _maxc(z, 2.0))
    out = torch.where(z < 2.0, small, big)
    bad = anu > _FRAC_MAX
    _warn_once_out_of_domain(
        "fractional Bessel order", bad,
        "K_ν fractional orders are supported for |ν| ≤ 30.5",
    )
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def _besselk_frac_cf2(nu, x):
    """K_ν(x), x ≥ 2, by Steed/Thompson-Barnett's CF2 at the reduced order
    μ = ν − round(ν), recurred upward (31 masked steps).  The fraction's
    state freezes once its increments fall below 1e-17 (f32: 1e-8) of the
    sums: the JAX package runs all 59 steps, whose coefficient c grows past
    float32's range (K_ν was NaN in f32 for z ≥ 2)."""
    nl = torch.floor(nu + 0.5)
    xmu = nu - nl
    a1 = 0.25 - xmu * xmu
    xi = 1.0 / x
    b0 = 2.0 * (1.0 + x)
    d0 = 1.0 / b0
    a, b, c, d, h, delh, q = -a1, b0, a1, d0, d0, d0, a1
    q1, q2 = torch.zeros_like(x), torch.ones_like(x)
    ss = 1.0 + a1 * d0
    eps = 1e-8 if x.dtype == torch.float32 else 1e-17
    done = torch.zeros_like(x, dtype=torch.bool)
    for i in range(2, _CF2_ITERS + 1):
        fi = float(i)
        a2 = a - 2.0 * (fi - 1.0)
        c2 = -a2 * c / _k(x, fi)
        qnew = (q1 - b * q2) / a2
        q3 = q + c2 * qnew
        b2 = b + 2.0
        d2 = 1.0 / (b2 + a2 * d)
        delh2 = (b2 * d2 - 1.0) * delh
        h2 = h + delh2
        ss2 = ss + q3 * delh2
        conv = (torch.abs(q3 * delh2) < eps * torch.abs(ss2)) & (
            torch.abs(delh2) < eps * torch.abs(h2))
        a, c = torch.where(done, a, a2), torch.where(done, c, c2)
        q1, q2 = torch.where(done, q1, q2), torch.where(done, q2, qnew)
        q, b, d = torch.where(done, q, q3), torch.where(done, b, b2), torch.where(done, d, d2)
        delh, h = torch.where(done, delh, delh2), torch.where(done, h, h2)
        ss = torch.where(done, ss, ss2)
        done = done | conv
    h = a1 * h
    rkmu = torch.sqrt(_k(x, _PI) / (2.0 * x)) * torch.exp(-x) / ss
    rk1 = rkmu * (xmu + x + 0.5 - h) * xi
    for i in range(_STEED_MAX_NL + 1):
        step = nl > float(i)
        ktemp = (xmu + float(i) + 1.0) * 2.0 * xi * rk1 + rkmu
        rkmu, rk1 = torch.where(step, rk1, rkmu), torch.where(step, ktemp, rk1)
    return rkmu


# --------------------------------------------------------------------------- #
# spherical Bessel functions                                                  #
# --------------------------------------------------------------------------- #


def _sph_frac_bad(nu: float) -> bool:
    """True (and the one-time warning) for a fractional spherical order
    beyond |ν| = 29.5 (C2)."""
    bad = abs(nu) > _SPH_FRAC_MAX
    if bad:
        _warn_once_out_of_domain(
            "fractional spherical Bessel order", torch.tensor(True),
            f"fractional spherical orders are supported for |ν| ≤ {_SPH_FRAC_MAX}",
        )
    return bad


def sph_jn(n, z):
    """Spherical Bessel function j_n(z).  Integer orders: upward recurrence
    where z > n, Miller's downward recurrence from order n+28 (rescaled
    exactly when it grows, as :func:`bessel_jn`) below, normalised against
    j₀ and j₁.  Fractional orders: √(π/2z)·J_{ν+½}(z), |ν| ≤ 29.5 (C2)."""
    (z,) = _tensors(z)
    if not _is_static_int(n):
        nu = float(n)
        zs = torch.where(z == 0.0, torch.ones_like(z), z)
        out = torch.sqrt(_k(zs, _PI) / (2.0 * zs)) * besselj(nu + 0.5, zs)
        out = torch.where(z < 0.0, torch.full_like(out, float("nan")), out)
        out = torch.where(z == 0.0, torch.full_like(out, 0.0 if nu > 0 else float("nan")), out)
        if _sph_frac_bad(nu):
            out = torch.full_like(out, float("nan"))
        return out
    n = int(n)
    zs = torch.where(z == 0.0, torch.ones_like(z), z)
    j0 = torch.sin(zs) / zs
    if n == 0:
        return torch.where(z == 0.0, torch.ones_like(z), j0)
    j1 = torch.sin(zs) / (zs * zs) - torch.cos(zs) / zs
    if n == 1:
        return torch.where(z == 0.0, torch.zeros_like(z), j1)
    up_prev, up_cur = j0, j1
    for k in range(1, n):
        up_prev, up_cur = up_cur, (_k(zs, 2.0 * k + 1.0) / zs) * up_cur - up_prev
    bound, factor = (2.0 ** 40, 2.0 ** -40) if z.dtype == torch.float32 else (2.0 ** 400,
                                                                                 2.0 ** -400)
    fp = torch.zeros_like(zs)
    fc = torch.full_like(zs, 1e-30)
    f_n = torch.zeros_like(zs)
    f0 = torch.zeros_like(zs)
    f1 = torch.zeros_like(zs)
    zm = _minc(zs, float(n))
    j0m = torch.sin(zm) / zm
    j1m = torch.sin(zm) / (zm * zm) - torch.cos(zm) / zm
    for k in range(n + 28, 0, -1):
        fp, fc = fc, (_k(zm, 2.0 * k + 1.0) / zm) * fc - fp
        s = torch.where(torch.abs(fc) > bound, torch.full_like(zm, factor), torch.ones_like(zm))
        fc = fc * s
        fp = fp * s
        f_n = f_n * s
        f1 = f1 * s
        if k - 1 == n:
            f_n = fc
        if k - 1 == 1:
            f1 = fc
        if k - 1 == 0:
            f0 = fc
    scale = (j0m * f0 + j1m * f1) / (f0 * f0 + f1 * f1)
    down = f_n * scale
    out = torch.where(zs > float(n), up_cur, down)
    return torch.where(z == 0.0, torch.zeros_like(z), out)


def sph_yn(n, z):
    """Spherical Bessel function y_n(z), z > 0: closed forms and upward
    recurrence; fractional orders √(π/2z)·Y_{ν+½}(z), |ν| ≤ 29.5 (C2)."""
    (z,) = _tensors(z)
    if not _is_static_int(n):
        nu = float(n)
        zs = torch.where(z <= 0.0, torch.ones_like(z), z)
        out = torch.sqrt(_k(zs, _PI) / (2.0 * zs)) * bessely(nu + 0.5, zs)
        out = torch.where(z > 0.0, out, torch.full_like(out, float("nan")))
        if _sph_frac_bad(nu):
            out = torch.full_like(out, float("nan"))
        return out
    n = int(n)
    zs = torch.where(z == 0.0, torch.ones_like(z), z)
    out = -torch.cos(zs) / zs
    if n != 0:
        cur, prev = -torch.cos(zs) / (zs * zs) - torch.sin(zs) / zs, out
        for k in range(1, n):
            prev, cur = cur, (_k(zs, 2.0 * k + 1.0) / zs) * cur - prev
        out = cur
    return torch.where(z > 0.0, out, torch.full_like(out, float("nan")))


# --------------------------------------------------------------------------- #
# operation counts (the bound of kernel B8)                                   #
# --------------------------------------------------------------------------- #

_ARITH = {"add", "sub", "mul", "div", "rsub", "true_divide", "neg", "__add__", "__radd__",
          "__sub__", "__rsub__", "__mul__", "__rmul__", "__truediv__", "__rtruediv__",
          "__neg__"}
_CALLS = {"exp", "log", "sqrt", "sin", "cos", "sinh", "cosh", "lgamma", "erf", "erfc"}
_FILLS = {"ones_like", "zeros_like", "full_like", "empty_like", "full"}  # shape only


class _Route(torch.overrides.TorchFunctionMode):
    """Records the dataflow of the torch operations run under it: one node
    per operation, its inputs (the nodes of its tensor arguments), whether
    it is one of B8's operations (:data:`_ARITH`, :data:`_CALLS`, run
    inside this module) and, for ``torch.where``, its condition."""

    def __init__(self):
        super().__init__()
        self.counted, self.inputs, self.select = [], [], {}
        self.nodes = {}  # id(tensor) → (weak reference to it, its node)

    def node(self, value):
        entry = self.nodes.get(id(value)) if torch.is_tensor(value) else None
        return entry[1] if entry is not None and entry[0]() is value else None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not any(torch.is_tensor(o) for o in outs):
            return out
        name = getattr(func, "__name__", "")
        k = len(self.counted)
        operands = [] if name in _FILLS else [*args, *(kwargs or {}).values()]
        flat = [t for a in operands for t in (a if isinstance(a, (tuple, list)) else (a,))]
        self.inputs.append([n for n in map(self.node, flat) if n is not None])
        self.counted.append((name in _ARITH or name in _CALLS) and _inside_this_module())
        if func is torch.where and len(args) == 3 and torch.is_tensor(args[0]):
            cond, a, b = args
            self.select[k] = (cond, self.node(cond), self.node(a), self.node(b))
        for o in outs:
            if torch.is_tensor(o):
                self.nodes[id(o)] = (weakref.ref(o), k)
        return out

    def per_element(self, outs, shape) -> torch.Tensor:
        """For each element of ``shape``, the counted operations that the
        outputs ``outs`` need there: from the outputs back through every
        operation's inputs, and through a ``torch.where`` only into the
        side that the element's condition selects."""
        need = {}

        def add(k, mask):
            if k is not None:
                need[k] = need[k] | mask if k in need else mask

        device = next(o.device for o in outs if torch.is_tensor(o))
        counts = torch.zeros(shape, dtype=torch.int64, device=device)
        for o in outs:
            add(self.node(o), torch.ones(shape, dtype=torch.bool, device=device))
        for k in range(len(self.counted) - 1, -1, -1):
            mask = need.pop(k, None)
            if mask is None:
                continue
            if self.counted[k]:
                counts += mask
            if k in self.select:
                cond, kc, ka, kb = self.select[k]
                cond = torch.broadcast_to(cond, shape)
                add(kc, mask)
                add(ka, mask & cond)
                add(kb, mask & ~cond)
            else:
                for i in self.inputs[k]:
                    add(i, mask)
        return counts


def _inside_this_module() -> bool:
    """True when the operation being recorded was called from a function of
    this module (a special function), not from its caller."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_globals is globals() and frame.f_code not in _TRACER_CODES:
            return True
        frame = frame.f_back
    return False


def route_operations(fn, *inputs):
    """``(fn(*inputs), counts)``: counts[i] is the number of arithmetic
    operations (+ − × ÷, negation) and libm calls (exp, log, sqrt, sin,
    cos, sinh, cosh, lgamma, erf, erfc) that element i of the result needs,
    over the broadcast shape of ``fn``'s tensor outputs.  A ``torch.where``
    needs its condition and only the side that selects the element, so a
    route that an argument does not take, and the steps of a fixed loop
    that a converged argument only carries, count nothing.  Only the
    operations of this module's special functions count (``fn`` may be a
    model function that calls them).  Kernel B8
    computes both sides of every select; this is what the arguments need,
    the operations of the bound of a kernel that calls B8."""
    route = _Route()
    with route:
        out = fn(*inputs)
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,)) if torch.is_tensor(o)]
    if not outs:
        return out, torch.zeros((), dtype=torch.int64)
    shape = torch.broadcast_shapes(*(o.shape for o in outs))
    return out, route.per_element(outs, shape)


def operation_count(name: str, z, *params) -> torch.Tensor:
    """For each argument in the tensor ``z``, the operations that one
    evaluation of the special function ``name`` with its static ``params``
    (orders, hypergeometric parameters) needs there
    (:func:`route_operations`)."""
    with suppress_domain_warnings():
        return route_operations(globals()[name], *params, z)[1]


_TRACER_CODES = {route_operations.__code__, operation_count.__code__,
                 _Route.__torch_function__.__code__}
