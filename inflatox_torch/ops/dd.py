"""Double-double arithmetic on pairs of float64 tensors.

The counterpart of ``inflatox_tpu/lowering/tf32.py`` (the JAX package's
triple-f32 numbers, about 71 bits, for EGNO-class cancellation; see
docs/numerics.md §8).  Hopper has native f64, so the extended-precision
engine of the port carries each value as an unevaluated sum ``hi + lo`` of
two f64 numbers (about 106 bits): the model functions are evaluated in it,
demoted to f64, and handed to the plain f64 analysis tail.

Every algorithm here is written out operation by operation, in the order of
``csrc/dd.cuh``, which kernel B4 (the double-double grid scan) and kernel
B5b (the same at given points) include.  Each operation is an IEEE f64
``+ - * /`` or ``sqrt`` that rounds once, and TwoProd's error term is exact
on both sides (Dekker's split here, ``__fma_rn`` on the card), so the two
give the same bits wherever the few f64 library calls agree (the seed of
``log``, and the functions demoted to f64).

* ring operations: TwoSum, TwoProd, add, sub, mul, div, sqrt, integer
  powers by repeated squaring (the torch lowering's ``_ipow``);
* ``exp``: k·ln2 reduction with a two-word ln2, then a degree-22 Taylor
  polynomial (|r| ≤ ln2/2, next term below 2⁻¹⁰⁹);
* ``log``: one Newton step on ``exp`` from the f64 ``log`` of the head;
* ``pow(x, y) = exp(y·log|x|)`` with C's rules for a zero or negative base:
  a negative base with an integral exponent gives the signed power, as the
  port's f64 path does (ROADMAP C5);
* every other function (trigonometric, hyperbolic, inverse) is demoted: it
  is evaluated in f64 on ``hi + lo``, as ``tf32._via_df`` does in the JAX
  package.

Limits: Dekker's split overflows above about 1e300 (the card's FMA does
not), so values beyond that part from the kernel's; products whose error
term is subnormal are not exact on either side.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

__all__ = ["DD", "EXP_DEGREE", "EXP_COEFFS", "LN2", "as_dd", "dd_abs", "dd_exp", "dd_ipow",
           "dd_log", "dd_max", "dd_min", "dd_pow", "dd_sqrt", "to_f64", "two_prod", "two_sum"]

_SPLIT = 134217729.0  # 2^27 + 1, Dekker's splitter
_INV_LN2 = 1.4426950408889634


def _dd_const(value: Fraction) -> tuple:
    hi = float(value)
    return hi, float(value - Fraction(hi))


#: ln 2 as two f64 words
LN2 = (0.6931471805599453, 2.3190468138462996e-17)
#: degree of exp's Taylor polynomial, and its coefficients 1/n! as two words
EXP_DEGREE = 22
EXP_COEFFS = tuple(_dd_const(Fraction(1, math.factorial(n))) for n in range(EXP_DEGREE + 1))


def _t(value, like=None) -> torch.Tensor:
    if torch.is_tensor(value):
        return value
    device = like.device if torch.is_tensor(like) else None
    return torch.tensor(float(value), dtype=torch.float64, device=device)


def two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """TwoSum for |a| ≥ |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e) with p = fl(a·b) and p + e = a·b exactly (Dekker's split;
    the card computes e as fma(a, b, −p), the same number)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


class DD:
    """A double-double number, elementwise over float64 tensors (or Python
    floats for constants): value = hi + lo, |lo| ≤ ulp(hi)/2."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=0.0):
        self.hi = hi
        self.lo = lo

    # ring operations; a Python number or f64 tensor operand is a DD with
    # lo = 0, and the operand order is kept (csrc/dd.cuh writes the calls
    # in the order of the lowered source)
    def __add__(self, other):
        return _add(self, as_dd(other))

    def __radd__(self, other):
        return _add(as_dd(other), self)

    def __sub__(self, other):
        return _add(self, -as_dd(other))

    def __rsub__(self, other):
        return _add(as_dd(other), -self)

    def __mul__(self, other):
        return _mul(self, as_dd(other))

    def __rmul__(self, other):
        return _mul(as_dd(other), self)

    def __truediv__(self, other):
        return _div(self, as_dd(other))

    def __rtruediv__(self, other):
        return _div(as_dd(other), self)

    def __neg__(self):
        return DD(-self.hi, -self.lo)

    def __pos__(self):
        return self


def as_dd(value) -> DD:
    if isinstance(value, DD):
        return value
    if torch.is_tensor(value):
        return DD(value, 0.0)
    return DD(float(value), 0.0)


def to_f64(a: DD):
    """The f64 nearest a normalised double-double: hi + lo."""
    return a.hi + a.lo


def _add(a: DD, b: DD) -> DD:
    s1, s2 = two_sum(a.hi, b.hi)
    t1, t2 = two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    return DD(*_quick_two_sum(s1, s2))


def _mul(a: DD, b: DD) -> DD:
    p1, p2 = two_prod(a.hi, b.hi)
    p2 = p2 + (a.hi * b.lo + a.lo * b.hi)
    return DD(*_quick_two_sum(p1, p2))


def _mul_d(a: DD, b) -> DD:
    """a · b for an f64 b."""
    p1, p2 = two_prod(a.hi, b)
    p2 = p2 + a.lo * b
    return DD(*_quick_two_sum(p1, p2))


def _div(a: DD, b: DD) -> DD:
    """Three quotient digits, each correcting the remainder of the last."""
    q1 = _t(a.hi, b.hi) / b.hi
    r = _add(a, -_mul_d(b, q1))
    q2 = r.hi / b.hi
    r = _add(r, -_mul_d(b, q2))
    q3 = r.hi / b.hi
    q1, q2 = _quick_two_sum(q1, q2)
    s, e = two_sum(q1, q3)
    e = e + q2
    return DD(*_quick_two_sum(s, e))


def _where(cond, a, b):
    return torch.where(cond, _t(a, cond).to(cond.device), _t(b, cond).to(cond.device))


def _select(cond, a: DD, b: DD) -> DD:
    return DD(_where(cond, a.hi, b.hi), _where(cond, a.lo, b.lo))


def dd_sqrt(a) -> DD:
    """√a from the f64 reciprocal square root of the head, one correction."""
    a = as_dd(a)
    hi = _t(a.hi)
    positive = hi > 0
    h = _where(positive, hi, 1.0)
    x = 1.0 / torch.sqrt(h)
    ax = h * x
    p, e = two_prod(ax, ax)
    rem = _add(DD(h, _where(positive, a.lo, 0.0)), DD(-p, -e))
    s, t = two_sum(ax, rem.hi * (x * 0.5))
    # sqrt(0) = 0, sqrt(x < 0) = NaN, sqrt(+inf) = inf, NaN stays
    special = torch.sqrt(hi)
    return DD(_where(positive & (hi < math.inf), s, special),
              _where(positive & (hi < math.inf), t, 0.0))


def _pow2(k):
    """2**k for an integral f64 tensor k in [-1022, 1023], built exactly."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def dd_exp(a) -> DD:
    a = as_dd(a)
    hi = _t(a.hi)
    ok = (hi >= -745.0) & (hi <= 709.79)
    x = _select(ok, a, DD(0.0, 0.0))
    k = torch.round(x.hi * _INV_LN2)
    r = _add(x, -_mul(DD(*LN2), DD(k, 0.0)))
    acc = DD(*EXP_COEFFS[EXP_DEGREE])
    for n in range(EXP_DEGREE - 1, -1, -1):
        acc = _add(_mul(acc, r), DD(*EXP_COEFFS[n]))
    k1 = torch.floor(k * 0.5)
    s1, s2 = _pow2(k1), _pow2(k - k1)
    out = DD(acc.hi * s1 * s2, acc.lo * s1 * s2)
    special = torch.exp(hi)  # beyond the range: inf above, 0 below, NaN stays
    return DD(_where(ok, out.hi, special), _where(ok, out.lo, 0.0))


def dd_log(a) -> DD:
    """log a = y + (a·e^(−y) − 1), y the f64 log of the head."""
    a = as_dd(a)
    hi = _t(a.hi)
    ok = (hi > 0) & (hi < math.inf)
    x = _select(ok, a, DD(1.0, 0.0))
    y = torch.log(x.hi)
    t = _add(_mul(x, dd_exp(DD(-y, 0.0))), DD(-1.0, 0.0))
    out = _add(DD(y, 0.0), t)
    special = torch.log(hi)  # 0 → -inf, < 0 → NaN, inf → inf, NaN → NaN
    return DD(_where(ok, out.hi, special), _where(ok, out.lo, 0.0))


def dd_pow(x, y) -> DD:
    """x**y = exp(y·log|x|), with C pow's rules: y = 0 or x = 1 (both
    words) gives 1; a
    zero base gives 0, 1 or inf by the sign of y; a negative base gives the
    signed power for an integral y and NaN otherwise."""
    x, y = as_dd(x), as_dd(y)
    device = next((v.device for v in (x.hi, y.hi) if torch.is_tensor(v)), None)
    xh, yh = (_t(v).to(device) for v in (x.hi, y.hi))
    xh, yh = torch.broadcast_tensors(xh, yh)
    xl, yl = (_t(v).to(device) for v in (x.lo, y.lo))
    integral = (torch.floor(yh) == yh) & (torch.floor(yl) == yl)
    odd = integral & ((torch.fmod(yh.abs(), 2.0) + torch.fmod(yl.abs(), 2.0)) == 1.0)
    negative = xh < 0
    base = _select(negative, -x, x)
    out = dd_exp(_mul(y, dd_log(base)))
    flip = negative & odd
    out = DD(_where(flip, -out.hi, out.hi), _where(flip, -out.lo, out.lo))
    nan = torch.full_like(xh, math.nan)
    out = _select(negative & ~integral, DD(nan, 0.0), out)
    zero_case = torch.where(yh > 0, 0.0, torch.where(yh == 0, 1.0, torch.full_like(yh, math.inf)))
    out = _select(xh == 0, DD(zero_case, 0.0), out)
    return _select((yh == 0) | ((xh == 1) & (xl == 0)), DD(torch.ones_like(xh), 0.0), out)


def dd_ipow(base, n: int) -> DD:
    """base**n for an integer n by repeated squaring (the torch lowering's
    ``_ipow``, product for product); 1/base**|n| for n < 0."""
    base = as_dd(base)
    if n < 0:
        return _div(DD(1.0, 0.0), dd_ipow(base, -n))
    if n == 0:
        return DD(1.0, 0.0)
    acc = None
    while True:
        if n & 1:
            acc = base if acc is None else _mul(acc, base)
        n >>= 1
        if not n:
            return acc
        base = _mul(base, base)


def dd_abs(a) -> DD:
    a = as_dd(a)
    neg = _t(a.hi) < 0
    return DD(_where(neg, -a.hi, a.hi), _where(neg, -a.lo, a.lo))


def _gt(a: DD, b: DD):
    ah, bh = _t(a.hi), _t(b.hi, a.hi)
    return (ah > bh) | ((ah == bh) & (_t(a.lo, ah) > _t(b.lo, ah)))


def dd_max(a, b) -> DD:
    """NaN-propagating, as torch.maximum."""
    a, b = as_dd(a), as_dd(b)
    return _select(torch.isnan(_t(a.hi)) | _gt(a, b), a, b)


def dd_min(a, b) -> DD:
    a, b = as_dd(a), as_dd(b)
    return _select(torch.isnan(_t(a.hi)) | _gt(b, a), a, b)
