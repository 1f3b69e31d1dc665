// Double-double arithmetic for kernels B4 and B5b (the extended-precision
// grid and point scans): a value is the unevaluated sum hi + lo of two f64
// numbers, about 106 bits.
//
// Replaces the triple-f32 arithmetic of the TPU kernels _kernel_tf and
// _kernel_tf_ot (inflatox_tpu/lowering/tf32.py, about 71 bits), which exist
// for EGNO-class models: their projected Hesse cancels about 3e8, so every
// 48- or 53-bit evaluation, the reference's own f64 included, loses 7-8
// digits (docs/numerics.md §8).  Hopper has f64 and FMA, so two f64 words
// replace three f32 words.
//
// Every function repeats inflatox_torch/ops/dd.py operation for operation,
// so the kernels and their plain PyTorch version give the same bits wherever
// the few f64 library calls agree (the seed of dd_log; the functions the
// model header demotes to f64).  The error-free transforms must not be
// contracted or reassociated: sums and products are __dadd_rn/__dsub_rn/
// __dmul_rn, which nvcc never fuses, and TwoProd's error is __fma_rn(a, b,
// -p), exact, as Dekker's split in ops/dd.py is.  Off the card (the CPU
// tests build this header with the host compiler and -ffp-contract=off)
// they are the plain operators and C's fma.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifndef INFLX_FN
#ifdef __CUDACC__
#define INFLX_FN __device__ __forceinline__
#else
#define INFLX_FN static inline
#endif
#endif

// the long transcendentals are called, not inlined into every use
#ifdef __CUDACC__
#define INFLX_DD_CALL __device__ __noinline__
#else
#define INFLX_DD_CALL static
#endif

struct dd {
  double hi, lo;
};

#ifdef __CUDACC__
INFLX_FN double dd_fadd(double a, double b) { return __dadd_rn(a, b); }
INFLX_FN double dd_fsub(double a, double b) { return __dsub_rn(a, b); }
INFLX_FN double dd_fmul(double a, double b) { return __dmul_rn(a, b); }
INFLX_FN double dd_fma(double a, double b, double c) { return __fma_rn(a, b, c); }
INFLX_FN double dd_from_bits(long long bits) { return __longlong_as_double(bits); }
#else
INFLX_FN double dd_fadd(double a, double b) { return a + b; }
INFLX_FN double dd_fsub(double a, double b) { return a - b; }
INFLX_FN double dd_fmul(double a, double b) { return a * b; }
INFLX_FN double dd_fma(double a, double b, double c) { return fma(a, b, c); }
INFLX_FN double dd_from_bits(long long bits) {
  double d;
  memcpy(&d, &bits, sizeof d);
  return d;
}
#endif

INFLX_FN dd dd_make(double hi, double lo) {
  dd r;
  r.hi = hi;
  r.lo = lo;
  return r;
}
INFLX_FN dd dd_c(double v) { return dd_make(v, 0.0); }
// the f64 nearest a normalised double-double
INFLX_FN double dd_to_f64(dd a) { return dd_fadd(a.hi, a.lo); }
INFLX_FN dd dd_neg(dd a) { return dd_make(-a.hi, -a.lo); }

// s = fl(a + b), s + e = a + b exactly (Knuth)
INFLX_FN dd dd_two_sum(double a, double b) {
  const double s = dd_fadd(a, b);
  const double bb = dd_fsub(s, a);
  return dd_make(s, dd_fadd(dd_fsub(a, dd_fsub(s, bb)), dd_fsub(b, bb)));
}
// the same for |a| >= |b| (Dekker)
INFLX_FN dd dd_quick_two_sum(double a, double b) {
  const double s = dd_fadd(a, b);
  return dd_make(s, dd_fsub(b, dd_fsub(s, a)));
}
// p = fl(a b), p + e = a b exactly
INFLX_FN dd dd_two_prod(double a, double b) {
  const double p = dd_fmul(a, b);
  return dd_make(p, dd_fma(a, b, -p));
}

INFLX_FN dd dd_add(dd a, dd b) {
  dd s = dd_two_sum(a.hi, b.hi);
  const dd t = dd_two_sum(a.lo, b.lo);
  s = dd_quick_two_sum(s.hi, dd_fadd(s.lo, t.hi));
  return dd_quick_two_sum(s.hi, dd_fadd(s.lo, t.lo));
}
INFLX_FN dd dd_sub(dd a, dd b) { return dd_add(a, dd_neg(b)); }

INFLX_FN dd dd_mul(dd a, dd b) {
  const dd p = dd_two_prod(a.hi, b.hi);
  return dd_quick_two_sum(p.hi, dd_fadd(p.lo, dd_fadd(dd_fmul(a.hi, b.lo), dd_fmul(a.lo, b.hi))));
}
// a * b for an f64 b
INFLX_FN dd dd_mul_d(dd a, double b) {
  const dd p = dd_two_prod(a.hi, b);
  return dd_quick_two_sum(p.hi, dd_fadd(p.lo, dd_fmul(a.lo, b)));
}

// three quotient digits, each correcting the remainder of the last
INFLX_FN dd dd_div(dd a, dd b) {
  const double q1 = a.hi / b.hi;
  dd r = dd_add(a, dd_neg(dd_mul_d(b, q1)));
  const double q2 = r.hi / b.hi;
  r = dd_add(r, dd_neg(dd_mul_d(b, q2)));
  const double q3 = r.hi / b.hi;
  const dd q = dd_quick_two_sum(q1, q2);
  const dd s = dd_two_sum(q.hi, q3);
  return dd_quick_two_sum(s.hi, dd_fadd(s.lo, q.lo));
}

// sqrt from the f64 reciprocal square root of the head, one correction
INFLX_FN dd dd_sqrt(dd a) {
  const double hi = a.hi;
  const bool positive = hi > 0.0;
  const double h = positive ? hi : 1.0;
  const double x = 1.0 / sqrt(h);
  const double ax = dd_fmul(h, x);
  const dd p = dd_two_prod(ax, ax);
  const dd rem = dd_add(dd_make(h, positive ? a.lo : 0.0), dd_make(-p.hi, -p.lo));
  const dd s = dd_two_sum(ax, dd_fmul(rem.hi, dd_fmul(x, 0.5)));
  if (positive && hi < INFINITY) return s;
  return dd_c(sqrt(hi));  // 0, NaN below 0, inf, NaN
}

// 2**k for an integral k in [-1022, 1023], built exactly
INFLX_FN double dd_pow2(double k) {
  return dd_from_bits(((long long)k + 1023) << 52);
}

#define INFLX_DD_EXP_DEGREE 22
// 1/n! as two words (inflatox_torch.ops.dd.EXP_COEFFS)
#ifdef __CUDACC__
__constant__
#endif
static const double dd_exp_coeffs[INFLX_DD_EXP_DEGREE + 1][2] = {
    {0x1.0000000000000p+0, 0x0.0p+0},  // 1/0!
    {0x1.0000000000000p+0, 0x0.0p+0},  // 1/1!
    {0x1.0000000000000p-1, 0x0.0p+0},  // 1/2!
    {0x1.5555555555555p-3, 0x1.5555555555555p-57},  // 1/3!
    {0x1.5555555555555p-5, 0x1.5555555555555p-59},  // 1/4!
    {0x1.1111111111111p-7, 0x1.1111111111111p-63},  // 1/5!
    {0x1.6c16c16c16c17p-10, -0x1.f49f49f49f49fp-65},  // 1/6!
    {0x1.a01a01a01a01ap-13, 0x1.a01a01a01a01ap-73},  // 1/7!
    {0x1.a01a01a01a01ap-16, 0x1.a01a01a01a01ap-76},  // 1/8!
    {0x1.71de3a556c734p-19, -0x1.c154f8ddc6c00p-73},  // 1/9!
    {0x1.27e4fb7789f5cp-22, 0x1.cbbc05b4fa99ap-76},  // 1/10!
    {0x1.ae64567f544e4p-26, -0x1.c062e06d1f209p-80},  // 1/11!
    {0x1.1eed8eff8d898p-29, -0x1.2aec959e14c06p-83},  // 1/12!
    {0x1.6124613a86d09p-33, 0x1.f28e0cc748ebep-87},  // 1/13!
    {0x1.93974a8c07c9dp-37, 0x1.05d6f8a2efd1fp-92},  // 1/14!
    {0x1.ae7f3e733b81fp-41, 0x1.1d8656b0ee8cbp-97},  // 1/15!
    {0x1.ae7f3e733b81fp-45, 0x1.1d8656b0ee8cbp-101},  // 1/16!
    {0x1.952c77030ad4ap-49, 0x1.ac981465ddc6cp-103},  // 1/17!
    {0x1.6827863b97d97p-53, 0x1.eec01221a8b0bp-107},  // 1/18!
    {0x1.2f49b46814157p-57, 0x1.2650f61dbdcb4p-112},  // 1/19!
    {0x1.e542ba4020225p-62, 0x1.ea72b4afe3c2fp-120},  // 1/20!
    {0x1.71b8ef6dcf572p-66, -0x1.d043ae40c4647p-120},  // 1/21!
    {0x1.0ce396db7f853p-70, -0x1.aebcdbd20331cp-124},  // 1/22!
};

// e^a: a - k ln2 (ln2 in two words), Taylor to degree 22 (|r| <= ln2/2),
// times 2^k in two exact steps
INFLX_DD_CALL dd dd_exp(dd a) {
  const double hi = a.hi;
  const bool ok = hi >= -745.0 && hi <= 709.79;
  if (!ok) return dd_c(exp(hi));  // inf above, 0 below, NaN stays
  const double k = rint(dd_fmul(hi, 1.4426950408889634));
  const dd r = dd_add(a, dd_neg(dd_mul(dd_make(0x1.62e42fefa39efp-1, 0x1.abc9e3b39803fp-56),
                                       dd_c(k))));
  dd acc = dd_make(dd_exp_coeffs[INFLX_DD_EXP_DEGREE][0], dd_exp_coeffs[INFLX_DD_EXP_DEGREE][1]);
  for (int n = INFLX_DD_EXP_DEGREE - 1; n >= 0; --n)
    acc = dd_add(dd_mul(acc, r), dd_make(dd_exp_coeffs[n][0], dd_exp_coeffs[n][1]));
  const double k1 = floor(dd_fmul(k, 0.5));
  const double s1 = dd_pow2(k1), s2 = dd_pow2(dd_fsub(k, k1));
  return dd_make(dd_fmul(dd_fmul(acc.hi, s1), s2), dd_fmul(dd_fmul(acc.lo, s1), s2));
}

// log a = y + (a e^-y - 1), y the f64 log of the head (one Newton step)
INFLX_DD_CALL dd dd_log(dd a) {
  const double hi = a.hi;
  if (!(hi > 0.0 && hi < INFINITY)) return dd_c(log(hi));  // -inf, NaN, inf
  const double y = log(hi);
  const dd t = dd_add(dd_mul(a, dd_exp(dd_c(-y))), dd_c(-1.0));
  return dd_add(dd_c(y), t);
}

// x**y = exp(y log|x|) with C pow's rules: y = 0 or x = 1 (both words) gives 1; a zero
// base gives 0, 1 or inf by the sign of y; a negative base gives the signed
// power for an integral y and NaN otherwise
INFLX_DD_CALL dd dd_pow(dd x, dd y) {
  const double xh = x.hi, yh = y.hi, yl = y.lo;
  if (yh == 0.0 || (xh == 1.0 && x.lo == 0.0)) return dd_c(1.0);
  if (xh == 0.0) return dd_c(yh > 0.0 ? 0.0 : (yh == 0.0 ? 1.0 : INFINITY));
  const bool integral = floor(yh) == yh && floor(yl) == yl;
  const bool negative = xh < 0.0;
  if (negative && !integral) return dd_c(NAN);
  const bool odd = integral && dd_fadd(fmod(fabs(yh), 2.0), fmod(fabs(yl), 2.0)) == 1.0;
  const dd out = dd_exp(dd_mul(y, dd_log(negative ? dd_neg(x) : x)));
  return (negative && odd) ? dd_neg(out) : out;
}

// b**N by repeated squaring, the torch lowering's _ipow product for product
// (from the lowest set bit of N, each bit's square times the product so far,
// b squared between bits), unrolled at compile time; 1/b**|N| for N < 0
template <int N, bool HAVE>
INFLX_FN dd dd_powi_bits(dd acc, dd b) {
  if constexpr ((N & 1) != 0) acc = HAVE ? dd_mul(acc, b) : b;
  if constexpr ((N >> 1) == 0) {
    return acc;
  } else {
    return dd_powi_bits<(N >> 1), (HAVE || (N & 1) != 0)>(acc, dd_mul(b, b));
  }
}
template <int N>
INFLX_FN dd dd_powi(dd b) {
  if constexpr (N == 0) {
    return dd_c(1.0);
  } else if constexpr (N < 0) {
    return dd_div(dd_c(1.0), dd_powi_bits<-N, false>(b, b));
  } else {
    return dd_powi_bits<N, false>(b, b);
  }
}

INFLX_FN dd dd_abs(dd a) { return a.hi < 0.0 ? dd_neg(a) : a; }
INFLX_FN bool dd_gt(dd a, dd b) { return a.hi > b.hi || (a.hi == b.hi && a.lo > b.lo); }
// a Piecewise's comparisons and select (ops/dd.py's DD comparisons, dd_where)
INFLX_FN bool dd_eq(dd a, dd b) { return a.hi == b.hi && a.lo == b.lo; }
INFLX_FN bool dd_ne(dd a, dd b) { return !dd_eq(a, b) && a.hi == a.hi && b.hi == b.hi; }
INFLX_FN bool dd_lt(dd a, dd b) { return dd_gt(b, a); }
INFLX_FN bool dd_ge(dd a, dd b) { return dd_gt(a, b) || dd_eq(a, b); }
INFLX_FN bool dd_le(dd a, dd b) { return dd_gt(b, a) || dd_eq(a, b); }
INFLX_FN dd dd_where(bool c, dd a, dd b) { return c ? a : b; }
// NaN-propagating, as torch.maximum/torch.minimum
INFLX_FN dd dd_max(dd a, dd b) { return (a.hi != a.hi || dd_gt(a, b)) ? a : b; }
INFLX_FN dd dd_min(dd a, dd b) { return (a.hi != a.hi || dd_gt(b, a)) ? a : b; }
