// Kernel B8: the special functions of a model, as __device__ code inside the
// grid (B1, B2, B7a, B7b), point (B5a) and solver (B6) kernels.
//
// B8 replaces inflatox_tpu/lowering/df32_special.py, which the JAX package
// traces into its Pallas kernels (_kernel_df, _kernel_edf, their batch and
// _ot variants, under a call memo; the solver through solver_df32_fns) and
// evaluates in double-f32 pairs: hyp0f1, besselj, bessely, besseli, besselk,
// sph_jn, sph_yn, erf, erfc, lgamma, gamma, polygamma, hyp1f1, hyp2f1,
// hyp2f0.  Hopper has IEEE f64, so the pairs are not carried over: B8 is the
// plain version, inflatox_torch/lowering/special.py, repeated operation for
// operation in the working type T (double for B1, B5a, B6, B7a; float for
// B2, B7b): the same sums and products in the same order, the same f64
// constants rounded once to T.  The generated model header
// (lowering/cuda_codegen.py) calls the inflx_* entries at the end of this
// file; its hash-consing computes a call that repeats once, as the TPU's
// call memo did.
//
// How the routes are chosen.  Each torch.where of the plain version between
// two routes is a branch here on the same condition, and only the side that
// the argument takes is computed: a NaN argument fails every comparison and
// so takes the same side as the plain version's select.  The plain version
// clamps each side's argument into its range (special.py's _minc/_maxc,
// which keep NaN); on the side an argument takes, the clamp returns it as it
// is, so the branch passes the argument itself.  Each loop that the plain version freezes under a mask
// (Steed's three fractions and their recurrences, the fractional K's CF2,
// the asymptotic sums, hyp2f0, polygamma's shift) is left where the mask
// sets: the frozen steps changed nothing.  The power series of 0F1, 1F1 and
// 2F1 stop where series_exit() shows that no later term can change the sum
// (the plain version freezes its sum there, special.py's _series_settled).
// The order-0 and order-1 Bessel functions J, Y and K are Cephes' rational
// and Chebyshev forms (the algorithms of torch.special), one division or a
// short Chebyshev sum an argument; integer |n| >= 2 recurs from them (J_n:
// upward where |z| > |n|, else the Miller recurrence).  So B8 stays bit for
// bit its plain version.
//
// Rounding: every + - * goes through isf::add_/sub_/mul_, which are
// __dadd_rn/__fadd_rn and friends on the card (never fused into an FMA,
// whether the library is built with -fmad=false, as the grid scan is, or
// with contraction on, as the solver is) and the plain operators elsewhere
// (the CPU tests build this header with the host compiler and
// -ffp-contract=off).  Division and negation are never contracted.  The
// library functions are CUDA's libm under torch's names (exp, log, sqrt,
// sin, cos, sinh, cosh, lgamma, erf, erfc, floor, rint, fmod, fabs), so the
// kernel and its plain version agree to the last bit wherever the libm
// compiles alike in both (scripts/probe_special_libm.py measures that).
//
// What bounds it: latency.  A call is a chain of dependent operations, from
// 1 (erf) to a few thousand (a fractional-order J or Y near its turning
// point; route_operations() in special.py counts each argument's), and the
// callers give one thread an argument (B5a, B6) or one lane a row or column
// (the grid stages).  The heavy routes (Steed's method, the 0F1 series, the
// fractional J/Y/K, the hypergeometric series) are __noinline__, so a model
// that calls them at many sites compiles each once per kernel instance.
#pragma once
#include <math.h>

#ifndef INFLX_FN
#ifdef __CUDACC__
#define INFLX_FN __device__ __forceinline__
#else
#define INFLX_FN static inline
#endif
#endif

#ifdef __CUDACC__
#define ISF_FN __device__ __forceinline__
#define ISF_HEAVY __device__ __noinline__
#define ISF_TABLE static __device__ const double
#else
#define ISF_FN inline
#define ISF_HEAVY inline
#define ISF_TABLE static const double
#endif

namespace isf {

#ifdef __CUDACC__
ISF_FN double add_(double a, double b) { return __dadd_rn(a, b); }
ISF_FN double sub_(double a, double b) { return __dsub_rn(a, b); }
ISF_FN double mul_(double a, double b) { return __dmul_rn(a, b); }
ISF_FN float add_(float a, float b) { return __fadd_rn(a, b); }
ISF_FN float sub_(float a, float b) { return __fsub_rn(a, b); }
ISF_FN float mul_(float a, float b) { return __fmul_rn(a, b); }
#else
template <typename T>
ISF_FN T add_(T a, T b) { return a + b; }
template <typename T>
ISF_FN T sub_(T a, T b) { return a - b; }
template <typename T>
ISF_FN T mul_(T a, T b) { return a * b; }
#endif

#define ISF_LIBM(name)                                              \
  ISF_FN double name##_(double x) { return ::name(x); }            \
  ISF_FN float name##_(float x) { return ::name##f(x); }
ISF_LIBM(exp)
ISF_LIBM(log)
ISF_LIBM(sqrt)
ISF_LIBM(sin)
ISF_LIBM(cos)
ISF_LIBM(sinh)
ISF_LIBM(cosh)
ISF_LIBM(lgamma)
ISF_LIBM(erf)
ISF_LIBM(erfc)
ISF_LIBM(floor)
ISF_LIBM(rint)
#undef ISF_LIBM
ISF_FN double fabs_(double x) { return ::fabs(x); }
ISF_FN float fabs_(float x) { return ::fabsf(x); }
ISF_FN double fmod_(double x, double y) { return ::fmod(x, y); }
ISF_FN float fmod_(float x, float y) { return ::fmodf(x, y); }

// A value of working type T, as a tensor of the plain version: + - * round
// once, unfused; a double operand is a Python number, rounded to T once.
template <typename T>
struct R {
  T v;
  ISF_FN R() : v(T(0)) {}
  ISF_FN R(double x) : v(static_cast<T>(x)) {}
  static ISF_FN R of(T x) {
    R r;
    r.v = x;
    return r;
  }
  friend ISF_FN R operator+(R a, R b) { return of(add_(a.v, b.v)); }
  friend ISF_FN R operator-(R a, R b) { return of(sub_(a.v, b.v)); }
  friend ISF_FN R operator*(R a, R b) { return of(mul_(a.v, b.v)); }
  friend ISF_FN R operator/(R a, R b) { return of(a.v / b.v); }
  friend ISF_FN R operator-(R a) { return of(-a.v); }
  friend ISF_FN bool operator<(R a, R b) { return a.v < b.v; }
  friend ISF_FN bool operator<=(R a, R b) { return a.v <= b.v; }
  friend ISF_FN bool operator>(R a, R b) { return a.v > b.v; }
  friend ISF_FN bool operator>=(R a, R b) { return a.v >= b.v; }
  friend ISF_FN bool operator==(R a, R b) { return a.v == b.v; }
  friend ISF_FN bool operator!=(R a, R b) { return a.v != b.v; }
};

#define ISF_UNARY(name)                                             \
  template <typename T>                                             \
  ISF_FN R<T> name(R<T> a) { return R<T>::of(name##_(a.v)); }
ISF_UNARY(exp)
ISF_UNARY(log)
ISF_UNARY(sqrt)
ISF_UNARY(sin)
ISF_UNARY(cos)
ISF_UNARY(sinh)
ISF_UNARY(cosh)
ISF_UNARY(lgamma)
ISF_UNARY(erf)
ISF_UNARY(erfc)
ISF_UNARY(floor)
ISF_UNARY(fabs)
#undef ISF_UNARY

// min/max against a number, keeping NaN (special.py's _minc/_maxc)
template <typename T>
ISF_FN R<T> minc(R<T> x, double c) { return x > R<T>(c) ? R<T>(c) : x; }
template <typename T>
ISF_FN R<T> maxc(R<T> x, double c) { return x < R<T>(c) ? R<T>(c) : x; }
template <typename T>
ISF_FN R<T> nan_of() { return R<T>(NAN); }

// b**N, N >= 1, by repeated squaring (special.py's _ipow)
template <int N, bool HAVE, typename T>
ISF_FN R<T> powi_bits(R<T> acc, R<T> b) {
  if constexpr ((N & 1) != 0) {
    if constexpr (HAVE) {
      acc = acc * b;
    } else {
      acc = b;
    }
  }
  if constexpr ((N >> 1) == 0) {
    return acc;
  } else {
    return powi_bits<(N >> 1), (HAVE || (N & 1) != 0)>(acc, b * b);
  }
}
template <int N, typename T>
ISF_FN R<T> powi(R<T> b) { return powi_bits<N, false>(b, b); }

// Cephes' Chebyshev sum over c[first..n-1] (special.py's _chbevl)
template <typename T, int NC>
ISF_FN R<T> chbevl(R<T> x, const double (&c)[NC], int first) {
  R<T> b0 = 0.0, b1 = 0.0, b2 = 0.0;
  for (int i = first; i < NC; ++i) {
    b2 = b1;
    b1 = b0;
    b0 = x * b1 - b2 + R<T>(c[i]);
  }
  return R<T>(0.5) * (b0 - b2);
}
// Clenshaw's sum, coefficients low to high (special.py's _cheb_eval)
template <typename T, int NC>
ISF_FN R<T> cheb_eval(const double (&c)[NC], R<T> t) {
  R<T> d = 0.0, dd = 0.0;
  for (int k = NC - 1; k >= 1; --k) {
    const R<T> dn = R<T>(2.0) * t * d - dd + R<T>(c[k]);
    dd = d;
    d = dn;
  }
  return t * d - dd + R<T>(c[0]);
}

// Cephes' polevl (Horner's rule from c[0]) and p1evl (an implied leading 1)
template <typename T, int NC>
ISF_FN R<T> polevl(R<T> x, const double (&c)[NC]) {
  R<T> a = c[0];
  for (int i = 1; i < NC; ++i) a = a * x + R<T>(c[i]);
  return a;
}
template <typename T, int NC>
ISF_FN R<T> p1evl(R<T> x, const double (&c)[NC]) {
  R<T> a = x + R<T>(c[0]);
  for (int i = 1; i < NC; ++i) a = a * x + R<T>(c[i]);
  return a;
}

template <typename T>
ISF_FN R<T> maxv(R<T> a, R<T> b) { return a > b ? a : b; }

static constexpr double kPi = 3.141592653589793;

// --------------------------------------------------------------------------
// gamma family
// --------------------------------------------------------------------------

template <typename T>
ISF_FN R<T> gamma(R<T> x) {
  const R<T> mag = exp(lgamma(x));
  const bool neg = (x < R<T>(0.0)) && (fmod_(floor(x).v, T(2.0)) != T(0.0));
  return neg ? -mag : mag;
}

// ψ^(n) asymptotic coefficients c_1..c_12 (special.py's _psi_coeffs), n ≤ 8
ISF_TABLE kPsiCoef[9][12] = {
    {0.08333333333333333, -0.008333333333333333, 0.003968253968253968, -0.004166666666666667, 0.007575757575757576, -0.021092796092796094, 0.08333333333333333, -0.4432598039215686, 3.0539543302701198, -26.456212121212122, 281.46014492753625, -3607.5105463980462},
    {0.16666666666666666, -0.03333333333333333, 0.023809523809523808, -0.03333333333333333, 0.07575757575757576, -0.2531135531135531, 1.1666666666666667, -7.092156862745098, 54.971177944862156, -529.1242424242424, 6192.123188405797, -86580.25311355312},
    {0.5, -0.16666666666666666, 0.16666666666666666, -0.3, 0.8333333333333334, -3.2904761904761903, 17.5, -120.56666666666666, 1044.452380952381, -11111.60909090909, 142418.83333333334, -2164506.327838828},
    {2.0, -1.0, 1.3333333333333333, -3.0, 10.0, -46.06666666666667, 280.0, -2170.2, 20889.04761904762, -244455.4, 3418052.0, -56277164.52380952},
    {10.0, -7.0, 12.0, -33.0, 130.0, -691.0, 4760.0, -41233.8, 438670.0, -5622474.2, 85451300.0, -1519483442.142857},
    {60.0, -56.0, 120.0, -396.0, 1820.0, -11056.0, 85680.0, -824676.0, 9650740.0, -134939380.8, 2221733800.0, -42545536380.0},
    {420.0, -504.0, 1320.0, -5148.0, 27300.0, -187952.0, 1627920.0, -17318196.0, 221967020.0, -3373484520.0, 59986812600.0, -1233820555020.0},
    {3360.0, -5040.0, 15840.0, -72072.0, 436800.0, -3383136.0, 32558400.0, -381000312.0, 5327208480.0, -87710597520.0, 1679630752800.0, -37014616650600.0},
    {30240.0, -55440.0, 205920.0, -1081080.0, 7425600.0, -64279584.0, 683726400.0, -8763007176.0, 133180212000.0, -2368186133040.0, 48709291831200.0, -1147453116168600.0},
};
static constexpr int kPsiMaxOrder = 8;

template <int N>
struct factorial {
  static constexpr double v = N * factorial<N - 1>::v;
};
template <>
struct factorial<0> {
  static constexpr double v = 1.0;
};

template <int N, typename T>
ISF_FN R<T> polygamma(R<T> x) {
  static_assert(N >= 0 && N <= kPsiMaxOrder, "polygamma order outside 0..8");
  typedef R<T> V;
  if (x <= V(-32.0)) return nan_of<T>();
  const double sign = (N % 2 == 1) ? 1.0 : -1.0;
  const double fact = factorial<N>::v;
  V xs = x, acc = 0.0;
  for (int i = 0; i < 48; ++i) {  // up to x >= 16; the plain version's step
    if (!(xs < V(16.0))) break;
    acc = acc + V(1.0) / powi<N + 1>(xs);
    xs = xs + V(1.0);
  }
  const V w = V(1.0) / (xs * xs);
  V ser = 0.0;
  for (int k = 11; k >= 0; --k) ser = (ser + V(kPsiCoef[N][k])) * w;
  if constexpr (N == 0) {
    const V asym = log(xs) - V(0.5) * (V(1.0) / xs) - ser;
    return asym - acc;
  } else {
    const V head = V(factorial<(N > 0 ? N - 1 : 0)>::v) + V(0.5 * fact) * (V(1.0) / xs);
    const V asym = V(sign) * ((head + ser) / powi<N>(xs));
    return asym + V(sign * fact) * acc;
  }
}

// --------------------------------------------------------------------------
// hypergeometric family
// --------------------------------------------------------------------------

// The exit of a power series acc = Σ t_n (special.py's _series_settled),
// after the step that computed the term t and acc2 = acc + t.  ok says that
// every later ratio |t_{m+1}/t_m| is below kRatio (each series below proves
// its bound), so the computed terms shrink from here on: with five roundings
// a step the computed ratio is below kRatio (1 + 2^-23)^5 < 1 in f32 and f64.
// If t also rounds away from acc on either side (acc2 == acc and
// acc - t == acc), then so does every later term t', because acc + t' lies
// between acc - |t| and acc + |t|, and rounding to nearest is monotone: acc
// never changes again, and leaving the loop gives the full series' value bit
// for bit.  acc != 0 keeps the sign of a zero sum as the full loop leaves it;
// a NaN sum never compares equal, an infinite one with a finite t stays.
static constexpr double kRatio = 0.99;
template <typename T>
ISF_FN bool series_exit(bool ok, R<T> acc, R<T> acc2, R<T> t) {
  return ok && acc2 == acc && acc - t == acc && acc != R<T>(0.0);
}

// 0F1: t_{m+1}/t_m = z / ((b+m)(m+1)).  Once B = b+n+1 > 0, every later
// factor has (b+m)(m+1) >= B (n+2), so |z| < kRatio B (n+2) bounds them all.
template <typename T>
ISF_HEAVY R<T> hyp0f1(R<T> b, R<T> z) {
  typedef R<T> V;
  V term = 1.0, acc = 1.0;
  const V az = fabs(z);
  bool ok = false;
  for (int n = 0; n < 96; ++n) {
    const double nf = n;
    term = term * z / ((b + V(nf)) * V(nf + 1.0));
    const V acc2 = acc + term;
    if (!ok) {
      const V bb = b + V(nf + 1.0);
      ok = bb > V(0.0) && az < bb * V(kRatio * (nf + 2.0));
    }
    if (series_exit(ok, acc, acc2, term)) break;
    acc = acc2;
  }
  return acc;
}

// 1F1's series on z >= 0: t_{m+1}/t_m = (a+m) z / ((b+m)(m+1)).  Once
// A = a+n+1 and B = b+n+1 are positive, (a+m)/(b+m) is monotone in m and
// tends to 1, so it is at most max(A, B)/B for every later m, and 1/(m+1) at
// most 1/(n+2): z max(A, B) < kRatio B (n+2) bounds every later ratio.
template <typename T>
ISF_FN R<T> hyp1f1_series(R<T> a, R<T> b, R<T> z) {
  typedef R<T> V;
  V term = 1.0, acc = 1.0;
  bool ok = false;
  for (int n = 0; n < 420; ++n) {
    const double nf = n;
    term = term * (a + V(nf)) * z / ((b + V(nf)) * V(nf + 1.0));
    const V acc2 = acc + term;
    if (!ok) {
      const V aa = a + V(nf + 1.0), bb = b + V(nf + 1.0);
      ok = aa > V(0.0) && bb > V(0.0) && z * maxv(aa, bb) < bb * V(kRatio * (nf + 2.0));
    }
    if (series_exit(ok, acc, acc2, term)) break;
    acc = acc2;
  }
  return acc;
}

// the direct series for z >= 0, Kummer's e^z 1F1(b-a; b; -z) below
template <typename T>
ISF_HEAVY R<T> hyp1f1(R<T> a, R<T> b, R<T> z) {
  const R<T> zp = fabs(z);
  if (zp > R<T>(300.0)) return nan_of<T>();
  if (z >= R<T>(0.0)) return hyp1f1_series(a, b, zp);
  return exp(z) * hyp1f1_series(b - a, b, zp);
}

// 2F1: t_{m+1}/t_m = (a+m)(b+m) z / ((c+m)(m+1)).  Once A = a+n+1, B = b+n+1
// and C = c+n+1 are positive, (a+m)/(c+m) <= max(A, C)/C and
// (b+m)/(m+1) <= max(B, n+2)/(n+2) for every later m (each monotone, tending
// to 1): |z| max(A, C) max(B, n+2) < kRatio C (n+2) bounds every later ratio.
template <typename T>
ISF_HEAVY R<T> hyp2f1(R<T> a, R<T> b, R<T> c, R<T> z) {
  typedef R<T> V;
  if (fabs(z) >= V(1.0)) return nan_of<T>();
  V term = 1.0, acc = 1.0;
  const V az = fabs(z);
  const bool may = az < V(kRatio);  // else the ratios tend to |z| >= kRatio
  bool ok = false;
  for (int n = 0; n < 700; ++n) {
    const double nf = n;
    term = term * (a + V(nf)) * (b + V(nf)) * z / ((c + V(nf)) * V(nf + 1.0));
    const V acc2 = acc + term;
    if (may && !ok) {
      const V aa = a + V(nf + 1.0), bb = b + V(nf + 1.0), cc = c + V(nf + 1.0);
      ok = aa > V(0.0) && bb > V(0.0) && cc > V(0.0) &&
           az * maxv(aa, cc) * maxv(bb, V(nf + 2.0)) < cc * V(kRatio * (nf + 2.0));
    }
    if (series_exit(ok, acc, acc2, term)) break;
    acc = acc2;
  }
  return acc;
}

// summed until the terms start to grow (the plain version's growing mask)
template <typename T>
ISF_HEAVY R<T> hyp2f0(R<T> a, R<T> b, R<T> z) {
  R<T> term = 1.0, acc = 1.0;
  for (int n = 0; n < 96; ++n) {
    const double nf = n;
    const R<T> new_term = term * (a + R<T>(nf)) * (b + R<T>(nf)) * z / R<T>(nf + 1.0);
    if (fabs(new_term) > fabs(term)) break;
    acc = acc + new_term;
    term = new_term;
  }
  return acc;
}

// --------------------------------------------------------------------------
// integer-order J_n (Miller, rescaled), I_0, I_1
// --------------------------------------------------------------------------

template <int N, typename T>
ISF_FN R<T> bessel_jn(R<T> z) {
  typedef R<T> V;
  const double bound = sizeof(T) == 4 ? 0x1p64 : 0x1p500;
  const double factor = sizeof(T) == 4 ? 0x1p-64 : 0x1p-500;
  V f0 = 0.0, f1 = 1e-16, bs = 0.0, fv = 0.0, f = f1;
  for (int k = 50; k >= 0; --k) {
    f = f1 * V(2.0 * (k + 1.0)) / z - f0;
    if (k % 2 == 0) bs = bs + V(2.0) * f;
    if (k == N) fv = f;
    const V s = fabs(f) > V(bound) ? V(factor) : V(1.0);
    f = f * s;
    f0 = f1 * s;
    f1 = f;
    bs = bs * s;
    fv = fv * s;
  }
  return fv / (bs - f);
}

ISF_TABLE kI0eA[30] = {
    -4.41534164647933937950E-18, 3.33079451882223809783E-17, -2.43127984654795469359E-16,
    1.71539128555513303061E-15,  -1.16853328779934516808E-14, 7.67618549860493561688E-14,
    -4.85644678311192946090E-13, 2.95505266312963983461E-12, -1.72682629144155570723E-11,
    9.67580903537323691224E-11,  -5.18979560163526290666E-10, 2.65982372468238665035E-9,
    -1.30002500998624804212E-8,  6.04699502254191894932E-8,  -2.67079385394061173391E-7,
    1.11738753912010371815E-6,   -4.41673835845875056359E-6, 1.64484480707288970893E-5,
    -5.75419501008210370398E-5,  1.88502885095841655729E-4,  -5.76375574538582365885E-4,
    1.63947561694133579842E-3,   -4.32430999505057594430E-3, 1.05464603945949983183E-2,
    -2.37374148058994688156E-2,  4.93052842396707084878E-2,  -9.49010970480476444210E-2,
    1.71620901522208775349E-1,   -3.04682672343198398683E-1, 6.76795274409476084995E-1};
ISF_TABLE kI0eB[25] = {
    -7.23318048787475395456E-18, -4.83050448594418207126E-18, 4.46562142029675999901E-17,
    3.46122286769746109310E-17,  -2.82762398051658348494E-16, -3.42548561967721913462E-16,
    1.77256013305652638360E-15,  3.81168066935262242075E-15,  -9.55484669882830764870E-15,
    -4.15056934728722208663E-14, 1.54008621752140982691E-14,  3.85277838274214270114E-13,
    7.18012445138366623367E-13,  -1.79417853150680611778E-12, -1.32158118404477131188E-11,
    -3.14991652796324136454E-11, 1.18891471078464383424E-11,  4.94060238822496958910E-10,
    3.39623202570838634515E-9,   2.26666899049817806459E-8,   2.04891858946906374183E-7,
    2.89137052083475648297E-6,   6.88975834691682398426E-5,   3.36911647825569408990E-3,
    8.04490411014108831608E-1};
ISF_TABLE kI1eA[29] = {
    2.77791411276104639959E-18, -2.11142121435816608115E-17, 1.55363195773620046921E-16,
    -1.10559694773538630805E-15, 7.60068429473540693410E-15, -5.04218550472791168711E-14,
    3.22379336594557470981E-13, -1.98397439776494371520E-12, 1.17361862988909016308E-11,
    -6.66348972350202774223E-11, 3.62559028155211703701E-10, -1.88724975172282928790E-9,
    9.38153738649577178388E-9,  -4.44505912879632808065E-8, 2.00329475355213526229E-7,
    -8.56872026469545474066E-7, 3.47025130813767847674E-6,  -1.32731636560394358279E-5,
    4.78156510755005422638E-5,  -1.61760815825896745588E-4, 5.12285956168575772895E-4,
    -1.51357245063125314899E-3, 4.15642294431288815669E-3,  -1.05640848946261981558E-2,
    2.47264490306265168283E-2,  -5.29459812080949914269E-2, 1.02643658689847095384E-1,
    -1.76416518357834055153E-1, 2.52587186443633654823E-1};
ISF_TABLE kI1eB[25] = {
    7.51729631084210481353E-18,  4.41434832307170791151E-18,  -4.65030536848935832153E-17,
    -3.20952592199342395980E-17, 2.96262899764595013876E-16,  3.30820231092092828324E-16,
    -1.88035477551078244854E-15, -3.81440307243700780478E-15, 1.04202769841288027642E-14,
    4.27244001671195135429E-14,  -2.10154184277266431302E-14, -4.08355111109219731823E-13,
    -7.19855177624590851209E-13, 2.03562854414708950722E-12,  1.41258074366137813316E-11,
    3.25260358301548823856E-11,  -1.89749581235054123450E-11, -5.58974346219658380687E-10,
    -3.83538038596423702205E-9,  -2.63146884688951950684E-8,  -2.51223623787020892529E-7,
    -3.88256480887769039346E-6,  -1.10588938762623716291E-4,  -9.76109749136146840777E-3,
    7.78576235018280120474E-1};

// exp(-|x|) I_0(x) (FIRST) or exp(-|x|) I_1(|x|); float uses Cephes' shorter
// f32 series, the last terms of the f64 ones
template <bool FIRST, typename T, int NA, int NB>
ISF_FN R<T> ie(R<T> x, const double (&a)[NA], const double (&b)[NB], int na32, int nb32) {
  const bool f32 = sizeof(T) == 4;
  const R<T> ax = fabs(x);
  if (ax <= R<T>(8.0)) {
    const R<T> le = chbevl(R<T>(0.5) * ax - R<T>(2.0), a, f32 ? NA - na32 : 0);
    return FIRST ? le : le * ax;
  }
  return chbevl(R<T>(32.0) / ax - R<T>(2.0), b, f32 ? NB - nb32 : 0) / sqrt(ax);
}

template <typename T>
ISF_FN R<T> i0(R<T> x) { return exp(fabs(x)) * ie<true>(x, kI0eA, kI0eB, 18, 7); }

template <typename T>
ISF_FN R<T> i1(R<T> x) {
  R<T> e = ie<false>(x, kI1eA, kI1eB, 17, 7);
  e = x < R<T>(0.0) ? -e : e;
  return exp(fabs(x)) * e;
}

// --------------------------------------------------------------------------
// order 0 and 1: Cephes' j0.c, j1.c, k0.c and k1.c (special.py's _j0 ... _k1)
// --------------------------------------------------------------------------

ISF_TABLE kJ0RP[4] = {-4.79443220978201773821E9, 1.95617491946556577543E12,
                      -2.49248344360967716204E14, 9.70862251047306323952E15};
ISF_TABLE kJ0RQ[8] = {4.99563147152651017219E2,  1.73785401676374683123E5,
                      4.84409658339962045305E7,  1.11855537045356834862E10,
                      2.11277520115489217587E12, 3.10518229857422583814E14,
                      3.18121955943204943306E16, 1.71086294081043136091E18};
static constexpr double kJ0DR1 = 5.78318596294678452118E0, kJ0DR2 = 3.04712623436620863991E1;
ISF_TABLE kJ1RP[4] = {-8.99971225705559398224E8, 4.52228297998194034323E11,
                      -7.27494245221818276015E13, 3.68295732863852883286E15};
ISF_TABLE kJ1RQ[8] = {6.20836478118054335476E2,  2.56987256757748830383E5,
                      8.35146791431949253037E7,  2.21511595479792499675E10,
                      4.74914122079991414898E12, 7.84369607876235854894E14,
                      8.95222336184627338078E16, 5.32278620332680085395E18};
static constexpr double kJ1Z1 = 1.46819706421238932572E1, kJ1Z2 = 4.92184563216946036703E1;
ISF_TABLE kY0YP[8] = {1.55924367855235737965E4,   -1.46639295903971606143E7,
                      5.43526477051876500413E9,   -9.82136065717911466409E11,
                      8.75906394395366999549E13,  -3.46628303384729719441E15,
                      4.42733268572569800351E16,  -1.84950800436986690637E16};
ISF_TABLE kY0YQ[7] = {1.04128353664259848412E3,  6.26107330137134956842E5,
                      2.68919633393814121987E8,  8.64002487103935000337E10,
                      2.02979612750105546709E13, 3.17157752842975028269E15,
                      2.50596256172653059228E17};
ISF_TABLE kY1YP[6] = {1.26320474790178026440E9,  -6.47355876379160291031E11,
                      1.14509511541823727583E14, -8.12770255501325109621E15,
                      2.02439475713594898196E17, -7.78877196265950026825E17};
ISF_TABLE kY1YQ[8] = {5.94301592346128195359E2,  2.35564092943068577943E5,
                      7.34811944459721705660E7,  1.87601316108706159478E10,
                      3.88231277496238566008E12, 6.20557727146953693363E14,
                      6.87141087355300489866E16, 3.97270608116560655612E18};
// the modulus and phase forms above 5, order 0 and 1 (QQ: p1evl's)
ISF_TABLE kJYPP[2][7] = {
    {7.96936729297347051624E-4, 8.28352392107440799803E-2, 1.23953371646414299388E0,
     5.44725003058768775090E0, 8.74716500199817011941E0, 5.30324038235394892183E0,
     9.99999999999999997821E-1},
    {7.62125616208173112003E-4, 7.31397056940917570436E-2, 1.12719608129684925192E0,
     5.11207951146807644818E0, 8.42404590141772420927E0, 5.21451598682361504063E0,
     1.00000000000000000254E0}};
ISF_TABLE kJYPQ[2][7] = {
    {9.24408810558863637013E-4, 8.56288474354474431428E-2, 1.25352743901058953537E0,
     5.47097740330417105182E0, 8.76190883237069594232E0, 5.30605288235394617618E0,
     1.00000000000000000218E0},
    {5.71323128072548699714E-4, 6.88455908754495404082E-2, 1.10514232634061696926E0,
     5.07386386128601488557E0, 8.39985554327604159757E0, 5.20982848682361821619E0,
     9.99999999999999997461E-1}};
ISF_TABLE kJYQP[2][8] = {
    {-1.13663838898469149931E-2, -1.28252718670509318512E0, -1.95539544257735972385E1,
     -9.32060152123768231369E1, -1.77681167980488050595E2, -1.47077505154951170175E2,
     -5.14105326766599330220E1, -6.05014350600728481186E0},
    {5.10862594750176621635E-2, 4.98213872951233449420E0, 7.58238284132545283818E1,
     3.66779609360150777800E2, 7.10856304998926107277E2, 5.97489612400613639965E2,
     2.11688757100572135698E2, 2.52070205858023719784E1}};
ISF_TABLE kJYQQ[2][7] = {
    {6.43178256118178023184E1, 8.56430025976980587198E2, 3.88240183605401609683E3,
     7.24046774195652478189E3, 5.93072701187316984827E3, 2.06209331660327847417E3,
     2.42005740240291393179E2},
    {7.42373277035675149943E1, 1.05644886038262816351E3, 4.98641058337653607651E3,
     9.56231892404756170795E3, 7.99704160447350683650E3, 2.82619278517639096600E3,
     3.36093607810698293419E2}};
ISF_TABLE kJYPhase[2] = {7.85398163397448309616E-1, 2.35619449019234492885E0};  // π/4, 3π/4
static constexpr double kSq2OPi = 7.9788456080286535587989E-1;  // √(2/π)
static constexpr double kTwoOPi = 6.36619772367581343075535E-1;  // 2/π
ISF_TABLE kK0A[10] = {1.37446543561352307156E-16, 4.25981614279661018399E-14,
                      1.03496952576338420167E-11, 1.90451637722020886025E-9,
                      2.53479107902614945675E-7,  2.28621210311945178607E-5,
                      1.26461541144692592338E-3,  3.59799365153615016266E-2,
                      3.44289899924628486886E-1,  -5.35327393233902768720E-1};
ISF_TABLE kK0B[25] = {
    5.30043377268626276149E-18,  -1.64758043015242134646E-17, 5.21039150503902756861E-17,
    -1.67823109680541210385E-16, 5.51205597852431940784E-16,  -1.84859337734377901440E-15,
    6.34007647740507060557E-15,  -2.22751332699166985548E-14, 8.03289077536357521100E-14,
    -2.98009692317273043925E-13, 1.14034058820847496303E-12,  -4.51459788337394416547E-12,
    1.85594911495471785253E-11,  -7.95748924447710747776E-11, 3.57739728140030116597E-10,
    -1.69753450938905987466E-9,  8.57403401741422608519E-9,   -4.66048989768794782956E-8,
    2.76681363944501510342E-7,   -1.83175552271911948767E-6,  1.39498137188764993662E-5,
    -1.28495495816278026384E-4,  1.56988388573005337491E-3,   -3.14481013119645005427E-2,
    2.44030308206595545468E0};
ISF_TABLE kK1A[11] = {-7.02386347938628759343E-18, -2.42744985051936593393E-15,
                      -6.66690169419932900609E-13, -1.41148839263352776110E-10,
                      -2.21338763073472585583E-8,  -2.43340614156596823496E-6,
                      -1.73028895751305206302E-4,  -6.97572385963986435018E-3,
                      -1.22611180822657148235E-1,  -3.53155960776544875667E-1,
                      1.52530022733894777053E0};
ISF_TABLE kK1B[25] = {
    -5.75674448366501715755E-18, 1.79405087314755922667E-17,  -5.68946255844285935196E-17,
    1.83809354436663880070E-16,  -6.05704724837331885336E-16, 2.03870316562433424052E-15,
    -7.01983709041831346144E-15, 2.47715442448130437068E-14,  -8.97670518232499435011E-14,
    3.34841966607842919884E-13,  -1.28917396095102890680E-12, 5.13963967348173025100E-12,
    -2.12996783842756842877E-11, 9.21831518760500529508E-11,  -4.19035475934189648750E-10,
    2.01504975519703286596E-9,   -1.03457624656780970260E-8,  5.74108412545004946722E-8,
    -3.50196060308781257119E-7,  2.40648494783721712015E-6,   -1.93619797416608296024E-5,
    1.95215518471351631108E-4,   -2.85781685962277938680E-3,  1.03923736576817238437E-1,
    2.72062619048444266945E0};

// J_0 for |x| <= 5: (x² - j01²)(x² - j02²) P(x²)/Q(x²)
template <typename T>
ISF_FN R<T> j0_small(R<T> x) {
  typedef R<T> V;
  const V z = x * x;
  return (z - V(kJ0DR1)) * (z - V(kJ0DR2)) * polevl(z, kJ0RP) / p1evl(z, kJ0RQ);
}

// J_1 for |x| <= 5, odd in x
template <typename T>
ISF_FN R<T> j1_small(R<T> x) {
  typedef R<T> V;
  const V z = x * x;
  return polevl(z, kJ1RP) / p1evl(z, kJ1RQ) * x * (z - V(kJ1Z1)) * (z - V(kJ1Z2));
}

// J_N (J) or Y_N, N = 0, 1, for x > 5: √(2/(πx)) (P cos ξ - (5/x) Q sin ξ)
template <int N, bool J, typename T>
ISF_FN R<T> jy01_big(R<T> x) {
  typedef R<T> V;
  const V w = V(5.0) / x;
  const V z = w * w;
  V p = polevl(z, kJYPP[N]) / polevl(z, kJYPQ[N]);
  const V q = polevl(z, kJYQP[N]) / p1evl(z, kJYQQ[N]);
  const V xn = x - V(kJYPhase[N]);
  if constexpr (J) {
    p = p * cos(xn) - w * q * sin(xn);
  } else {
    p = p * sin(xn) + w * q * cos(xn);
  }
  return p * V(kSq2OPi) / sqrt(x);
}

template <typename T>
ISF_FN R<T> bessel_j0(R<T> x) {
  const R<T> ax = fabs(x);
  if (ax <= R<T>(5.0)) return j0_small(ax);
  return jy01_big<0, true>(ax);
}

template <typename T>
ISF_FN R<T> bessel_j1(R<T> x) {
  const R<T> ax = fabs(x);
  if (ax <= R<T>(5.0)) return j1_small(x);
  const R<T> big = jy01_big<1, true>(ax);
  return x < R<T>(0.0) ? -big : big;
}

// Y_0, Y_1 for x > 0
template <typename T>
ISF_FN R<T> bessel_y0(R<T> x) {
  typedef R<T> V;
  if (x <= V(5.0)) {
    const V z = x * x;
    return polevl(z, kY0YP) / p1evl(z, kY0YQ) + V(kTwoOPi) * log(x) * j0_small(x);
  }
  return jy01_big<0, false>(x);
}

template <typename T>
ISF_FN R<T> bessel_y1(R<T> x) {
  typedef R<T> V;
  if (x <= V(5.0)) {
    const V z = x * x;
    return x * (polevl(z, kY1YP) / p1evl(z, kY1YQ)) +
           V(kTwoOPi) * (j1_small(x) * log(x) - V(1.0) / x);
  }
  return jy01_big<1, false>(x);
}

// K_0, K_1 for x > 0
template <typename T>
ISF_FN R<T> bessel_k0(R<T> x) {
  typedef R<T> V;
  if (x <= V(2.0)) return chbevl(x * x - V(2.0), kK0A, 0) - log(V(0.5) * x) * i0(x);
  return exp(-x) * chbevl(V(8.0) / x - V(2.0), kK0B, 0) / sqrt(x);
}

template <typename T>
ISF_FN R<T> bessel_k1(R<T> x) {
  typedef R<T> V;
  if (x <= V(2.0)) return log(V(0.5) * x) * i1(x) + chbevl(x * x - V(2.0), kK1A, 0) / x;
  return exp(-x) * chbevl(V(8.0) / x - V(2.0), kK1B, 0) / sqrt(x);
}

// --------------------------------------------------------------------------
// Bessel family
// --------------------------------------------------------------------------

// J_N, a static integer order: |N| >= 2 upward from J_0, J_1 where |z| > |N|
// (stable: k < |z| at every step), else JAX's Miller recurrence
template <int N, typename T>
ISF_FN R<T> bessel_j_int(R<T> z) {
  typedef R<T> V;
  constexpr int n = N < 0 ? -N : N;
  V out;
  if constexpr (n == 0) {
    out = bessel_j0(z);
  } else if constexpr (n == 1) {
    out = bessel_j1(z);
  } else {
    if (fabs(z) > V((double)n)) {
      V prev = bessel_j0(z), cur = bessel_j1(z);
      for (int k = 1; k < n; ++k) {
        const V next = (V(2.0 * k) / z) * cur - prev;
        prev = cur;
        cur = next;
      }
      out = cur;
    } else {
      out = bessel_jn<n>(z);
    }
  }
  if constexpr (N < 0 && (n % 2) == 1) {
    return -out;
  } else {
    return out;
  }
}

// J_ν or I_ν by the 0F1 form, z >= 0
template <typename T>
ISF_HEAVY R<T> bessel_frac(R<T> nu, R<T> z, bool modified) {
  typedef R<T> V;
  const V q = z * z * V(0.25);
  const V arg = modified ? q : -q;
  const V x1 = nu + V(1.0);
  const V sgn = x1 > V(0.0) ? V(1.0)
                            : (fmod_(floor(x1).v, T(2.0)) == T(0.0) ? V(1.0) : V(-1.0));
  const V pref = sgn * exp(nu * log(z * V(0.5)) - lgamma(x1));
  return pref * hyp0f1(x1, arg);
}

ISF_TABLE kTemmeG1[15] = {
    -0.5710113401855841, -1.97551434264295e-17, 0.00651651126707368,
    -1.9461688077422866e-17, 0.0003087090173085056, -1.9637573943002206e-17,
    -3.4706269649151143e-06, -1.39082417974295e-17, 6.943766421246031e-09,
    -1.621927686259548e-17, 3.677951441937119e-11, -1.1051165107663382e-17,
    -1.356340297563193e-13, -7.138982946540495e-18, -3.5327647554267563e-17};
ISF_TABLE kTemmeG2[15] = {
    0.921870293650453, 3.523462454814079e-17, -0.0768528408447866,
    5.2912295582844394e-17, 0.0012719271366546513, 5.4734676185828735e-17,
    -4.9717367041385e-06, 2.377817426824363e-17, -3.312611969802513e-08,
    9.312654661450359e-17, 2.4230963292765556e-10, 2.9257568727534474e-17,
    -1.701486781673822e-13, 4.44840869628458e-17, -1.4628228722797227e-15};

template <typename T>
struct JY {
  R<T> j, y;
};

// (J_ν(x), Y_ν(x)), ν >= 0, x > 0: Steed's method (special.py's
// _bessjy_steed); Y_ν's upward recurrence only when need_y
template <typename T>
ISF_HEAVY JY<T> bessjy_steed(R<T> nu, R<T> x, bool need_y) {
  typedef R<T> V;
  if (x <= V(0.0)) return {nan_of<T>(), nan_of<T>()};
  const double tiny = 1e-30;
  const V xs = x > V(0.0) ? x : V(1.0);
  V nl = xs < V(2.0) ? floor(nu + V(0.5)) : maxc(floor(nu - xs + V(1.5)), 0.0);
  nl = minc(maxc(nl, 0.0), 30.0);
  const V xmu = nu - nl;
  const V xmu2 = xmu * xmu;
  const V xi = V(1.0) / xs;
  const V xi2 = V(2.0) * xi;

  // CF1, left where it converges (the plain version's done)
  const V h0 = maxc(nu * xi, tiny);
  V b = xi2 * nu, c = h0, d = 0.0, h = h0, isign = 1.0;
  for (int i = 1; i < 100; ++i) {
    b = b + xi2;
    V d2 = b - d;
    d2 = fabs(d2) < V(tiny) ? V(tiny) : d2;
    V c2 = b - V(1.0) / c;
    c2 = fabs(c2) < V(tiny) ? V(tiny) : c2;
    d = V(1.0) / d2;
    c = c2;
    const V dl = c * d;
    h = h * dl;
    isign = d < V(0.0) ? -isign : isign;
    if (fabs(dl - V(1.0)) < V(1e-16)) break;
  }

  // downward recurrence, nl steps
  V rjl = isign * V(tiny);
  V rjpl = h * rjl;
  const V rjl1 = rjl;
  V fact = nu * xi;
  for (int i = 0; i < 30; ++i) {
    if (!(nl > V((double)i))) break;
    const V rjtemp = fact * rjl + rjpl;
    fact = fact - xi;
    rjpl = fact * rjtemp - rjl;
    rjl = rjtemp;
  }
  rjl = rjl == V(0.0) ? V(tiny) : rjl;
  const V f = rjpl / rjl;

  V rjmu, rymu = 0.0, ry1 = 0.0;
  if (xs < V(2.0)) {
    // small x: Temme's series
    const V x2 = V(0.5) * xs;
    const V pimu = V(kPi) * xmu;
    const V fact_t = fabs(pimu) < V(1e-15) ? V(1.0) : pimu / sin(pimu);
    const V dd = -log(x2);
    const V e = xmu * dd;
    const V fact2_t = fabs(e) < V(1e-15) ? V(1.0) : sinh(e) / e;
    const V tg = V(2.0) * xmu;
    const V gam1 = cheb_eval(kTemmeG1, tg);
    const V gam2 = cheb_eval(kTemmeG2, tg);
    V ff = V(2.0 / kPi) * fact_t * (gam1 * cosh(e) + gam2 * fact2_t * dd);
    const V ee = exp(e);
    const V gampl = gam2 - xmu * gam1;
    const V gammi = gam2 + xmu * gam1;
    V pt = ee / (gampl * V(kPi));
    V qt = V(1.0) / (ee * V(kPi) * gammi);
    const V pimu2 = V(0.5) * pimu;
    const V fact3 = fabs(pimu2) < V(1e-15) ? V(1.0) : sin(pimu2) / pimu2;
    const V rr = V(kPi) * pimu2 * fact3 * fact3;
    const V dd2 = -x2 * x2;
    V cc = 1.0;
    V ssum = ff + rr * qt;
    V ssum1 = pt;
    for (int i = 1; i < 100; ++i) {
      const double fi = i;
      ff = (V(fi) * ff + pt + qt) / (V(fi * fi) - xmu2);
      cc = cc * dd2 / V(fi);
      pt = pt / (V(fi) - xmu);
      qt = qt / (V(fi) + xmu);
      const V dl = cc * (ff + rr * qt);
      ssum = ssum + dl;
      const V dl1 = cc * pt - V(fi) * dl;
      ssum1 = ssum1 + dl1;
      if (fabs(dl) < (V(1.0) + fabs(ssum)) * V(1e-17)) break;
    }
    rymu = -ssum;
    ry1 = -ssum1 * (V(2.0) / xs);
    const V rymup = xmu / xs * rymu - ry1;
    const V w_small = V(2.0) / (V(kPi) * xs);
    rjmu = w_small / (rymup - f * rymu);
  } else {
    // large x: the complex CF2
    const V xib = V(1.0) / xs;
    V a = V(0.25) - xmu2;
    V pc = V(-0.5) * xib;
    V qc = 1.0;
    const V br = V(2.0) * xs;
    V bi = 2.0;
    const V fact_c = a * xib / (pc * pc + qc * qc);
    V cr = br + qc * fact_c;
    V ci = bi + pc * fact_c;
    const V den0 = br * br + bi * bi;
    V dr = br / den0;
    V di = -bi / den0;
    V dlr = cr * dr - ci * di;
    V dli = cr * di + ci * dr;
    V temp = pc * dlr - qc * dli;
    qc = pc * dli + qc * dlr;
    pc = temp;
    for (int i = 2; i < 100; ++i) {
      const double fi = i;
      a = a + V(2.0 * (fi - 1.0));
      bi = bi + V(2.0);
      V dr2 = a * dr + br;
      const V di2 = a * di + bi;
      dr2 = (fabs(dr2) + fabs(di2)) < V(tiny) ? V(tiny) : dr2;
      const V fct = a / (cr * cr + ci * ci);
      cr = br + cr * fct;
      ci = bi - ci * fct;
      cr = (fabs(cr) + fabs(ci)) < V(tiny) ? V(tiny) : cr;
      const V den = dr2 * dr2 + di2 * di2;
      dr = dr2 / den;
      di = -di2 / den;
      dlr = cr * dr - ci * di;
      dli = cr * di + ci * dr;
      temp = pc * dlr - qc * dli;
      qc = pc * dli + qc * dlr;
      pc = temp;
      if ((fabs(dlr - V(1.0)) + fabs(dli)) < V(1e-16)) break;
    }
    const V gam = (pc - f) / qc;
    const V w_big = V(2.0) / (V(kPi) * xs);
    rjmu = sqrt(fabs(w_big / ((pc - f) * gam + qc)));
    rjmu = rjl >= V(0.0) ? rjmu : -rjmu;
    if (need_y) {
      rymu = rjmu * gam;
      const V rymup = rymu * (pc + qc / gam);
      ry1 = xmu * xib * rymu - rymup;
    }
  }
  const V rj = rjl1 * (rjmu / rjl);
  if (need_y) {
    for (int i = 0; i < 30; ++i) {
      if (!(nl > V((double)i))) break;
      const V rytemp = (xmu + V((double)i) + V(1.0)) * xi2 * ry1 - rymu;
      rymu = ry1;
      ry1 = rytemp;
    }
  }
  return {rj, rymu};
}

// J_ν (J) or Y_ν for large z: Hankel's expansion (special.py's
// _jy_asymptotic), each sum left where its terms stop shrinking
template <bool J, typename T>
ISF_FN R<T> jy_asymptotic(R<T> nu, R<T> z) {
  typedef R<T> V;
  const V mu = V(4.0) * nu * nu;
  const V zi = V(1.0) / (V(8.0) * z);
  V p = 1.0;
  V q = (mu - V(1.0)) * zi;
  V term_p = 1.0;
  V term_q = q;
  bool stop_p = false, stop_q = false;
  for (int k = 1; k < 16; ++k) {
    if (stop_p && stop_q) break;
    const double c1 = (double)((4 * k - 3) * (4 * k - 3)), c2 = (double)((4 * k - 1) * (4 * k - 1));
    const double c3 = (double)((4 * k + 1) * (4 * k + 1));
    if (!stop_p) {
      const V new_p = -term_p * (mu - V(c1)) * (mu - V(c2)) /
                      V((double)((2 * k - 1) * (2 * k))) * zi * zi;
      stop_p = fabs(new_p) >= fabs(term_p);
      if (!stop_p) p = p + new_p;
      term_p = new_p;
    }
    if (!stop_q) {
      const V new_q = -term_q * (mu - V(c2)) * (mu - V(c3)) /
                      V((double)((2 * k) * (2 * k + 1))) * zi * zi;
      stop_q = fabs(new_q) >= fabs(term_q);
      if (!stop_q) q = q + new_q;
      term_q = new_q;
    }
  }
  const V chi = z - (V(0.5) * nu + V(0.25)) * V(kPi);
  const V amp = sqrt(V(2.0) / (V(kPi) * z));
  if constexpr (J) {
    return amp * (p * cos(chi) - q * sin(chi));
  } else {
    return amp * (p * sin(chi) + q * cos(chi));
  }
}

// (sin πr, cos πr), exact at half-integer r
template <typename T>
ISF_FN JY<T> sincospi(R<T> r) {
  typedef R<T> V;
  const V q = V::of(rint_((V(2.0) * r).v)) * V(0.5);
  const V u = (r - q) * V(kPi);
  const V su = sin(u), cu = cos(u);
  const int k = ((int)rint_((V(2.0) * q).v)) & 3;
  const V sq = k == 0 ? V(0.0) : (k == 1 ? V(1.0) : (k == 2 ? V(0.0) : V(-1.0)));
  const V cq = k == 0 ? V(1.0) : (k == 1 ? V(0.0) : (k == 2 ? V(-1.0) : V(0.0)));
  return {sq * cu + cq * su, cq * cu - sq * su};
}

// (J_ν, Y_ν), |ν| <= 30.5, z > 0 (special.py's _bessjy_frac): Steed's method
// to z = 40, Hankel's expansion beyond (above order 8 at the reduced order,
// recurred upward); J alone (want_j), Y alone or both, the other computed
// only where a negative order's reflection needs it
template <typename T>
ISF_HEAVY JY<T> bessjy_frac(R<T> nu, R<T> z, bool want_j, bool want_y) {
  typedef R<T> V;
  const V anu = fabs(nu);
  if (anu > V(30.5)) return {nan_of<T>(), nan_of<T>()};
  const bool neg = nu < V(0.0);
  const bool need_j = want_j || neg, need_y = want_y || neg;
  V j = 0.0, y = 0.0;
  if (z > V(40.0)) {
    if (anu > V(8.0)) {
      const V nl = floor(anu + V(0.5));
      const V mu = anu - nl;
      V jk = 0.0, jk1 = 0.0, yk = 0.0, yk1 = 0.0;
      if (need_j) {
        jk = jy_asymptotic<true>(mu, z);
        jk1 = jy_asymptotic<true>(mu + V(1.0), z);
      }
      if (need_y) {
        yk = jy_asymptotic<false>(mu, z);
        yk1 = jy_asymptotic<false>(mu + V(1.0), z);
      }
      const V xi2 = V(2.0) / z;
      for (int i = 0; i < 31; ++i) {
        if (!(nl > V((double)i))) break;
        const V fac = (mu + V((double)i) + V(1.0)) * xi2;
        if (need_j) {
          const V jn = fac * jk1 - jk;
          jk = jk1;
          jk1 = jn;
        }
        if (need_y) {
          const V yn = fac * yk1 - yk;
          yk = yk1;
          yk1 = yn;
        }
      }
      j = jk;
      y = yk;
    } else {
      if (need_j) j = jy_asymptotic<true>(anu, z);
      if (need_y) y = jy_asymptotic<false>(anu, z);
    }
  } else {
    const JY<T> s = bessjy_steed(anu, z, need_y);
    j = s.j;
    y = s.y;
  }
  if (neg) {
    const JY<T> sc = sincospi(anu);
    const V j_neg = j * sc.y - y * sc.j;
    const V y_neg = j * sc.j + y * sc.y;
    j = j_neg;
    y = y_neg;
  }
  return {j, y};
}

// Y_N, a static integer order, z > 0: Y_0, Y_1 and the upward recurrence
template <int N, typename T>
ISF_FN R<T> bessely_int(R<T> z) {
  typedef R<T> V;
  constexpr int n = N < 0 ? -N : N;
  if (!(z > V(0.0))) return nan_of<T>();
  V out;
  if constexpr (n == 1) {
    out = bessel_y1(z);
  } else {
    out = bessel_y0(z);
    if constexpr (n > 1) {
      V prev = out, cur = bessel_y1(z);
      for (int k = 1; k < n; ++k) {
        const V next = (V(2.0 * k) / z) * cur - prev;
        prev = cur;
        cur = next;
      }
      out = cur;
    }
  }
  if constexpr (N < 0 && (n % 2) == 1) out = -out;
  return out;
}

// K_N, a static integer order, z > 0: K_0, K_1 and the upward recurrence
template <int N, typename T>
ISF_FN R<T> besselk_int(R<T> z) {
  typedef R<T> V;
  constexpr int n = N < 0 ? -N : N;
  if (!(z > V(0.0))) return nan_of<T>();
  if constexpr (n == 1) {
    return bessel_k1(z);
  } else {
    V out = bessel_k0(z);
    if constexpr (n > 1) {
      V prev = out, cur = bessel_k1(z);
      for (int k = 1; k < n; ++k) {
        const V next = prev + (V(2.0 * k) / z) * cur;
        prev = cur;
        cur = next;
      }
      out = cur;
    }
    return out;
  }
}

// K_ν, x >= 2: Steed/Thompson-Barnett's CF2 (special.py's _besselk_frac_cf2),
// left where it converges, recurred upward nl steps
template <typename T>
ISF_FN R<T> besselk_frac_cf2(R<T> nu, R<T> x) {
  typedef R<T> V;
  const V nl = floor(nu + V(0.5));
  const V xmu = nu - nl;
  const V a1 = V(0.25) - xmu * xmu;
  const V xi = V(1.0) / x;
  const V b0 = V(2.0) * (V(1.0) + x);
  const V d0 = V(1.0) / b0;
  V a = -a1, b = b0, c = a1, d = d0, h = d0, delh = d0, q = a1;
  V q1 = 0.0, q2 = 1.0;
  V ss = V(1.0) + a1 * d0;
  const V eps = sizeof(T) == 4 ? V(1e-8) : V(1e-17);
  for (int i = 2; i < 61; ++i) {
    const double fi = i;
    a = a - V(2.0 * (fi - 1.0));
    c = -a * c / V(fi);
    const V qnew = (q1 - b * q2) / a;
    q1 = q2;
    q2 = qnew;
    q = q + c * qnew;
    b = b + V(2.0);
    d = V(1.0) / (b + a * d);
    delh = (b * d - V(1.0)) * delh;
    h = h + delh;
    ss = ss + q * delh;
    if ((fabs(q * delh) < eps * fabs(ss)) && (fabs(delh) < eps * fabs(h))) break;
  }
  h = a1 * h;
  V rkmu = sqrt(V(kPi) / (V(2.0) * x)) * exp(-x) / ss;
  V rk1 = rkmu * (xmu + x + V(0.5) - h) * xi;
  for (int i = 0; i < 31; ++i) {
    if (!(nl > V((double)i))) break;
    const V ktemp = (xmu + V((double)i) + V(1.0)) * V(2.0) * xi * rk1 + rkmu;
    rkmu = rk1;
    rk1 = ktemp;
  }
  return rkmu;
}

// K_ν: π(I_{-ν} - I_ν)/(2 sin νπ) below z = 2, the CF2 from z = 2
template <typename T>
ISF_HEAVY R<T> besselk_frac(R<T> nu, R<T> z) {
  typedef R<T> V;
  const V anu = fabs(nu);
  if (anu > V(30.5)) return nan_of<T>();
  if (z < V(2.0)) {
    const V ip = bessel_frac(-anu, z, true);
    const V im = bessel_frac(anu, z, true);
    return V(kPi) * (ip - im) / (V(2.0) * sin(V(kPi) * anu));
  }
  return besselk_frac_cf2(anu, z);
}

template <int N, typename T>
ISF_FN R<T> besseli_int(R<T> z) {
  typedef R<T> V;
  constexpr int n = N < 0 ? -N : N;
  if constexpr (n == 0) {
    return i0(z);
  } else if constexpr (n == 1) {
    return i1(z);
  } else {
    const V sgn = z < V(0.0) ? V((n % 2) ? -1.0 : 1.0) : V(1.0);
    return sgn * bessel_frac(V((double)n), fabs(z), true);
  }
}

// spherical j_n, integer n (special.py's sph_jn): upward where z > n,
// Miller's downward recurrence normalised against j_0 and j_1 below
template <int N, typename T>
ISF_FN R<T> sph_jn_int(R<T> z) {
  typedef R<T> V;
  const V zs = z == V(0.0) ? V(1.0) : z;
  if constexpr (N == 0) {
    return z == V(0.0) ? V(1.0) : sin(zs) / zs;
  } else if constexpr (N == 1) {
    return z == V(0.0) ? V(0.0) : sin(zs) / (zs * zs) - cos(zs) / zs;
  } else {
    if (z == V(0.0)) return V(0.0);
    if (zs > V((double)N)) {
      V up_prev = sin(zs) / zs, up_cur = sin(zs) / (zs * zs) - cos(zs) / zs;
      for (int k = 1; k < N; ++k) {
        const V next = (V(2.0 * k + 1.0) / zs) * up_cur - up_prev;
        up_prev = up_cur;
        up_cur = next;
      }
      return up_cur;
    }
    const double bound = sizeof(T) == 4 ? 0x1p40 : 0x1p400;
    const double factor = sizeof(T) == 4 ? 0x1p-40 : 0x1p-400;
    V fp = 0.0, fc = 1e-30, f_n = 0.0, f0 = 0.0, f1 = 0.0;
    const V j0m = sin(zs) / zs;
    const V j1m = sin(zs) / (zs * zs) - cos(zs) / zs;
    for (int k = N + 28; k >= 1; --k) {
      const V fn = (V(2.0 * k + 1.0) / zs) * fc - fp;
      fp = fc;
      fc = fn;
      const V s = fabs(fc) > V(bound) ? V(factor) : V(1.0);
      fc = fc * s;
      fp = fp * s;
      f_n = f_n * s;
      f1 = f1 * s;
      if (k - 1 == N) f_n = fc;
      if (k - 1 == 1) f1 = fc;
      if (k - 1 == 0) f0 = fc;
    }
    const V scale = (j0m * f0 + j1m * f1) / (f0 * f0 + f1 * f1);
    return f_n * scale;
  }
}

template <int N, typename T>
ISF_FN R<T> sph_yn_int(R<T> z) {
  typedef R<T> V;
  const V zs = z == V(0.0) ? V(1.0) : z;
  V out = -cos(zs) / zs;
  if constexpr (N != 0) {
    V cur = -cos(zs) / (zs * zs) - sin(zs) / zs, prev = out;
    for (int k = 1; k < N; ++k) {
      const V next = (V(2.0 * k + 1.0) / zs) * cur - prev;
      prev = cur;
      cur = next;
    }
    out = cur;
  }
  return z > V(0.0) ? out : nan_of<T>();
}

// √(π/2z)·c_{ν+½}(z) for a fractional spherical order ν, given the cylinder
// function's value cyl at zs; J: j_ν's zero and negative-z rules, else y_ν's
template <bool J, typename T>
ISF_FN R<T> sph_frac_finish(double nu, R<T> z, R<T> zs, R<T> cyl) {
  typedef R<T> V;
  V out = sqrt(V(kPi) / (V(2.0) * zs)) * cyl;
  if constexpr (J) {
    out = z < V(0.0) ? nan_of<T>() : out;
    out = z == V(0.0) ? (nu > 0 ? V(0.0) : nan_of<T>()) : out;
  } else {
    out = z > V(0.0) ? out : nan_of<T>();
  }
  return (nu > 29.5 || nu < -29.5) ? nan_of<T>() : out;
}

template <typename T>
ISF_FN R<T> sph_zs(R<T> z, bool j) {
  if (j) return z == R<T>(0.0) ? R<T>(1.0) : z;
  return z <= R<T>(0.0) ? R<T>(1.0) : z;
}

}  // namespace isf


// --------------------------------------------------------------------------
// Entries called by the generated model headers.  T is double or float, given
// explicitly; N is a static integer order; other orders are values of T
// (special.py's _is_static_int decides, in lowering/cuda_codegen.py).
// --------------------------------------------------------------------------

template <typename T, int N>
INFLX_FN T inflx_besselj_int(T z) { return isf::bessel_j_int<N>(isf::R<T>::of(z)).v; }
template <typename T>
INFLX_FN T inflx_besselj(T nu, T z) {
  return isf::bessjy_frac(isf::R<T>::of(nu), isf::R<T>::of(z), true, false).j.v;
}
template <typename T, int N>
INFLX_FN T inflx_bessely_int(T z) { return isf::bessely_int<N>(isf::R<T>::of(z)).v; }
template <typename T>
INFLX_FN T inflx_bessely(T nu, T z) {
  return isf::bessjy_frac(isf::R<T>::of(nu), isf::R<T>::of(z), false, true).y.v;
}
template <typename T, int N>
INFLX_FN T inflx_besseli_int(T z) { return isf::besseli_int<N>(isf::R<T>::of(z)).v; }
template <typename T>
INFLX_FN T inflx_besseli(T nu, T z) {
  return isf::bessel_frac(isf::R<T>::of(nu), isf::R<T>::of(z), true).v;
}
template <typename T, int N>
INFLX_FN T inflx_besselk_int(T z) { return isf::besselk_int<N>(isf::R<T>::of(z)).v; }
template <typename T>
INFLX_FN T inflx_besselk(T nu, T z) {
  return isf::besselk_frac(isf::R<T>::of(nu), isf::R<T>::of(z)).v;
}
template <typename T, int N>
INFLX_FN T inflx_sph_jn_int(T z) { return isf::sph_jn_int<N>(isf::R<T>::of(z)).v; }
template <typename T, int N>
INFLX_FN T inflx_sph_yn_int(T z) { return isf::sph_yn_int<N>(isf::R<T>::of(z)).v; }
// fractional spherical order ν (a number): ν + ½ not an integer ...
template <typename T>
INFLX_FN T inflx_sph_jn_frac(double nu, T z) {
  const isf::R<T> zv = isf::R<T>::of(z), zs = isf::sph_zs(zv, true);
  return isf::sph_frac_finish<true>(nu, zv, zs, isf::bessjy_frac(isf::R<T>(nu + 0.5), zs, true, false).j).v;
}
template <typename T>
INFLX_FN T inflx_sph_yn_frac(double nu, T z) {
  const isf::R<T> zv = isf::R<T>::of(z), zs = isf::sph_zs(zv, false);
  return isf::sph_frac_finish<false>(nu, zv, zs, isf::bessjy_frac(isf::R<T>(nu + 0.5), zs, false, true).y).v;
}
// ... and ν + ½ = M, an integer (the integer-order J_M/Y_M)
template <typename T, int M>
INFLX_FN T inflx_sph_jn_half(T z) {
  const isf::R<T> zv = isf::R<T>::of(z), zs = isf::sph_zs(zv, true);
  return isf::sph_frac_finish<true>(M - 0.5, zv, zs, isf::bessel_j_int<M>(zs)).v;
}
template <typename T, int M>
INFLX_FN T inflx_sph_yn_half(T z) {
  const isf::R<T> zv = isf::R<T>::of(z), zs = isf::sph_zs(zv, false);
  return isf::sph_frac_finish<false>(M - 0.5, zv, zs, isf::bessely_int<M>(zs)).v;
}
template <typename T>
INFLX_FN T inflx_hyp0f1(T b, T z) { return isf::hyp0f1(isf::R<T>::of(b), isf::R<T>::of(z)).v; }
template <typename T>
INFLX_FN T inflx_hyp1f1(T a, T b, T z) {
  return isf::hyp1f1(isf::R<T>::of(a), isf::R<T>::of(b), isf::R<T>::of(z)).v;
}
template <typename T>
INFLX_FN T inflx_hyp2f1(T a, T b, T c, T z) {
  return isf::hyp2f1(isf::R<T>::of(a), isf::R<T>::of(b), isf::R<T>::of(c), isf::R<T>::of(z)).v;
}
template <typename T>
INFLX_FN T inflx_hyp2f0(T a, T b, T z) {
  return isf::hyp2f0(isf::R<T>::of(a), isf::R<T>::of(b), isf::R<T>::of(z)).v;
}
template <typename T>
INFLX_FN T inflx_erf(T x) { return isf::erf_(x); }
template <typename T>
INFLX_FN T inflx_erfc(T x) { return isf::erfc_(x); }
template <typename T>
INFLX_FN T inflx_lgamma(T x) { return isf::lgamma_(x); }
template <typename T>
INFLX_FN T inflx_gamma(T x) { return isf::gamma(isf::R<T>::of(x)).v; }
template <typename T, int N>
INFLX_FN T inflx_polygamma(T x) { return isf::polygamma<N>(isf::R<T>::of(x)).v; }

