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
// B2, B7b): the same fixed trip counts, the same sums and products in the
// same order, the same f64 constants rounded once to T, and every
// torch.where a select between the same two values (both computed, as the
// plain version computes them).  The generated model header
// (lowering/cuda_codegen.py) calls the inflx_* entries at the end of this
// file; its hash-consing computes a call that repeats once, as the TPU's
// call memo did.
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
// What bounds it: operations.  The kernel computes both sides of every
// select and every step of the fixed loops: from 1 (erf) to about 8,800
// (a fractional-order J or Y) f64 operations a call.  An argument needs
// only its own route and the loop steps before it converges, from 1 to
// about 3,800 (operation_count() in special.py); the difference is the
// kernel's own overhead.  The heavy routes (Steed's method, the 0F1 series, the fractional K, the
// hypergeometric series) are __noinline__, so a model that calls them at
// many sites compiles each once per kernel instance.
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

// torch.where
template <typename T>
ISF_FN R<T> sel(bool c, R<T> a, R<T> b) { return c ? a : b; }
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

static constexpr double kPi = 3.141592653589793;
static constexpr double kEulerGamma = 0.5772156649015329;

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
  const double sign = (N % 2 == 1) ? 1.0 : -1.0;
  const double fact = factorial<N>::v;
  V xs = x, acc = 0.0;
  for (int i = 0; i < 48; ++i) {
    const bool step = xs < V(16.0);
    const V t = V(1.0) / powi<N + 1>(xs);
    acc = step ? acc + t : acc;
    xs = step ? xs + V(1.0) : xs;
  }
  const V w = V(1.0) / (xs * xs);
  V ser = 0.0;
  for (int k = 11; k >= 0; --k) ser = (ser + V(kPsiCoef[N][k])) * w;
  V out;
  if constexpr (N == 0) {
    const V asym = log(xs) - V(0.5) * (V(1.0) / xs) - ser;
    out = asym - acc;
  } else {
    const V head = V(factorial<(N > 0 ? N - 1 : 0)>::v) + V(0.5 * fact) * (V(1.0) / xs);
    const V asym = V(sign) * ((head + ser) / powi<N>(xs));
    out = asym + V(sign * fact) * acc;
  }
  return x <= V(-32.0) ? nan_of<T>() : out;
}

// --------------------------------------------------------------------------
// hypergeometric family
// --------------------------------------------------------------------------

template <typename T>
ISF_HEAVY R<T> hyp0f1(R<T> b, R<T> z) {
  R<T> term = 1.0, acc = 1.0;
  for (int n = 0; n < 96; ++n) {
    const double nf = n;
    term = term * z / ((b + R<T>(nf)) * R<T>(nf + 1.0));
    acc = acc + term;
  }
  return acc;
}

template <typename T>
ISF_FN R<T> hyp1f1_series(R<T> a, R<T> b, R<T> z) {
  R<T> term = 1.0, acc = 1.0;
  for (int n = 0; n < 420; ++n) {
    const double nf = n;
    term = term * (a + R<T>(nf)) * z / ((b + R<T>(nf)) * R<T>(nf + 1.0));
    acc = acc + term;
  }
  return acc;
}

template <typename T>
ISF_HEAVY R<T> hyp1f1(R<T> a, R<T> b, R<T> z) {
  const R<T> zp = fabs(z);
  const R<T> zc = minc(zp, 300.0);
  const R<T> direct = hyp1f1_series(a, b, zc);
  const R<T> kummer = exp(z) * hyp1f1_series(b - a, b, zc);
  const R<T> out = z >= R<T>(0.0) ? direct : kummer;
  return zp > R<T>(300.0) ? nan_of<T>() : out;
}

template <typename T>
ISF_HEAVY R<T> hyp2f1(R<T> a, R<T> b, R<T> c, R<T> z) {
  R<T> term = 1.0, acc = 1.0;
  for (int n = 0; n < 700; ++n) {
    const double nf = n;
    term = term * (a + R<T>(nf)) * (b + R<T>(nf)) * z / ((c + R<T>(nf)) * R<T>(nf + 1.0));
    acc = acc + term;
  }
  return fabs(z) >= R<T>(1.0) ? nan_of<T>() : acc;
}

template <typename T>
ISF_HEAVY R<T> hyp2f0(R<T> a, R<T> b, R<T> z) {
  R<T> term = 1.0, acc = 1.0;
  bool growing = false;
  for (int n = 0; n < 96; ++n) {
    const double nf = n;
    const R<T> new_term = term * (a + R<T>(nf)) * (b + R<T>(nf)) * z / R<T>(nf + 1.0);
    growing = growing || (fabs(new_term) > fabs(term));
    acc = growing ? acc : acc + new_term;
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
  R<T> le = chbevl(R<T>(0.5) * ax - R<T>(2.0), a, f32 ? NA - na32 : 0);
  if (!FIRST) le = le * ax;
  const R<T> gt = chbevl(R<T>(32.0) / ax - R<T>(2.0), b, f32 ? NB - nb32 : 0) / sqrt(ax);
  return ax <= R<T>(8.0) ? le : gt;
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
// Bessel family
// --------------------------------------------------------------------------

template <int N, typename T>
ISF_FN R<T> bessel_j_int(R<T> z) {
  constexpr int n = N < 0 ? -N : N;
  const R<T> out = bessel_jn<n>(z);
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

// (J_ν(x), Y_ν(x)), ν >= 0, x > 0: Steed's method (special.py's _bessjy_steed)
template <typename T>
ISF_HEAVY JY<T> bessjy_steed(R<T> nu, R<T> x) {
  typedef R<T> V;
  const double tiny = 1e-30;
  const V xs = x > V(0.0) ? x : V(1.0);
  V nl = xs < V(2.0) ? floor(nu + V(0.5)) : maxc(floor(nu - xs + V(1.5)), 0.0);
  nl = minc(maxc(nl, 0.0), 30.0);
  const V xmu = nu - nl;
  const V xmu2 = xmu * xmu;
  const V xi = V(1.0) / xs;
  const V xi2 = V(2.0) * xi;

  // CF1
  const V h0 = maxc(nu * xi, tiny);
  V b = xi2 * nu, c = h0, d = 0.0, h = h0, isign = 1.0;
  bool done = false;
  for (int i = 1; i < 100; ++i) {
    const V b2 = b + xi2;
    V d2 = b2 - d;
    d2 = fabs(d2) < V(tiny) ? V(tiny) : d2;
    V c2 = b2 - V(1.0) / c;
    c2 = fabs(c2) < V(tiny) ? V(tiny) : c2;
    d2 = V(1.0) / d2;
    const V dl = c2 * d2;
    const V h2 = h * dl;
    isign = (d2 < V(0.0)) && !done ? -isign : isign;
    const bool conv = fabs(dl - V(1.0)) < V(1e-16);
    b = done ? b : b2;
    c = done ? c : c2;
    d = done ? d : d2;
    h = done ? h : h2;
    done = done || conv;
  }

  // downward recurrence
  V rjl = isign * V(tiny);
  V rjpl = h * rjl;
  const V rjl1 = rjl;
  V fact = nu * xi;
  for (int i = 0; i < 30; ++i) {
    const bool step = nl > V((double)i);
    const V rjtemp = fact * rjl + rjpl;
    const V fact2 = fact - xi;
    const V rjpl2 = fact2 * rjtemp - rjl;
    rjl = step ? rjtemp : rjl;
    rjpl = step ? rjpl2 : rjpl;
    fact = step ? fact2 : fact;
  }
  rjl = rjl == V(0.0) ? V(tiny) : rjl;
  const V f = rjpl / rjl;

  // small x: Temme's series
  const V xc = minc(xs, 2.0);
  const V x2 = V(0.5) * xc;
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
  done = false;
  for (int i = 1; i < 100; ++i) {
    const double fi = i;
    const V ff2 = (V(fi) * ff + pt + qt) / (V(fi * fi) - xmu2);
    const V cc2 = cc * dd2 / V(fi);
    const V pt2 = pt / (V(fi) - xmu);
    const V qt2 = qt / (V(fi) + xmu);
    const V dl = cc2 * (ff2 + rr * qt2);
    const V ssum2 = ssum + dl;
    const V dl1 = cc2 * pt2 - V(fi) * dl;
    const V ssum12 = ssum1 + dl1;
    const bool conv = fabs(dl) < (V(1.0) + fabs(ssum2)) * V(1e-17);
    ff = done ? ff : ff2;
    cc = done ? cc : cc2;
    pt = done ? pt : pt2;
    qt = done ? qt : qt2;
    ssum = done ? ssum : ssum2;
    ssum1 = done ? ssum1 : ssum12;
    done = done || conv;
  }
  const V rymu_s = -ssum;
  const V ry1_s = -ssum1 * (V(2.0) / xc);
  const V rymup_s = xmu / xc * rymu_s - ry1_s;
  const V w_small = V(2.0) / (V(kPi) * xc);
  const V rjmu_s = w_small / (rymup_s - f * rymu_s);

  // large x: the complex CF2
  const V xb = maxc(xs, 2.0);
  const V xib = V(1.0) / xb;
  V a = V(0.25) - xmu2;
  V pc = V(-0.5) * xib;
  V qc = 1.0;
  const V br = V(2.0) * xb;
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
  done = false;
  for (int i = 2; i < 100; ++i) {
    const double fi = i;
    const V a2 = a + V(2.0 * (fi - 1.0));
    const V bi2 = bi + V(2.0);
    V dr2 = a2 * dr + br;
    const V di2 = a2 * di + bi2;
    const bool small = (fabs(dr2) + fabs(di2)) < V(tiny);
    dr2 = small ? V(tiny) : dr2;
    const V fct = a2 / (cr * cr + ci * ci);
    V cr2 = br + cr * fct;
    const V ci2 = bi2 - ci * fct;
    const bool smallc = (fabs(cr2) + fabs(ci2)) < V(tiny);
    cr2 = smallc ? V(tiny) : cr2;
    const V den = dr2 * dr2 + di2 * di2;
    const V dr3 = dr2 / den;
    const V di3 = -di2 / den;
    dlr = cr2 * dr3 - ci2 * di3;
    dli = cr2 * di3 + ci2 * dr3;
    temp = pc * dlr - qc * dli;
    const V qc2 = pc * dli + qc * dlr;
    const V pc2 = temp;
    const bool conv = (fabs(dlr - V(1.0)) + fabs(dli)) < V(1e-16);
    a = done ? a : a2;
    bi = done ? bi : bi2;
    cr = done ? cr : cr2;
    ci = done ? ci : ci2;
    dr = done ? dr : dr3;
    di = done ? di : di3;
    pc = done ? pc : pc2;
    qc = done ? qc : qc2;
    done = done || conv;
  }
  const V gam = (pc - f) / qc;
  const V w_big = V(2.0) / (V(kPi) * xb);
  V rjmu_b = sqrt(fabs(w_big / ((pc - f) * gam + qc)));
  rjmu_b = rjl >= V(0.0) ? rjmu_b : -rjmu_b;
  const V rymu_b = rjmu_b * gam;
  const V rymup_b = rymu_b * (pc + qc / gam);
  const V ry1_b = xmu * xib * rymu_b - rymup_b;

  const bool small_mask = xs < V(2.0);
  const V rjmu = small_mask ? rjmu_s : rjmu_b;
  V rymu = small_mask ? rymu_s : rymu_b;
  V ry1 = small_mask ? ry1_s : ry1_b;
  const V rj = rjl1 * (rjmu / rjl);
  for (int i = 0; i < 30; ++i) {
    const bool step = nl > V((double)i);
    const V rytemp = (xmu + V((double)i) + V(1.0)) * xi2 * ry1 - rymu;
    const V rymu2 = step ? ry1 : rymu;
    ry1 = step ? rytemp : ry1;
    rymu = rymu2;
  }
  const bool bad = x <= V(0.0);
  return {bad ? nan_of<T>() : rj, bad ? nan_of<T>() : rymu};
}

// J_ν (J) or Y_ν for large z: Hankel's expansion (special.py's _jy_asymptotic)
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
    const double c1 = (double)((4 * k - 3) * (4 * k - 3)), c2 = (double)((4 * k - 1) * (4 * k - 1));
    const double c3 = (double)((4 * k + 1) * (4 * k + 1));
    const V new_p = -term_p * (mu - V(c1)) * (mu - V(c2)) / V((double)((2 * k - 1) * (2 * k))) *
                    zi * zi;
    stop_p = stop_p || (fabs(new_p) >= fabs(term_p));
    p = stop_p ? p : p + new_p;
    term_p = new_p;
    const V new_q = -term_q * (mu - V(c2)) * (mu - V(c3)) / V((double)((2 * k) * (2 * k + 1))) *
                    zi * zi;
    stop_q = stop_q || (fabs(new_q) >= fabs(term_q));
    q = stop_q ? q : q + new_q;
    term_q = new_q;
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

// (J_ν, Y_ν), |ν| <= 30.5, z > 0 (special.py's _bessjy_frac)
template <typename T>
ISF_HEAVY JY<T> bessjy_frac(R<T> nu, R<T> z) {
  typedef R<T> V;
  const V anu = fabs(nu);
  const JY<T> s = bessjy_steed(anu, minc(z, 40.0));
  const V zb = maxc(z, 40.0);
  V ja = jy_asymptotic<true>(anu, zb);
  V ya = jy_asymptotic<false>(anu, zb);
  const V nl = floor(anu + V(0.5));
  const V mu = anu - nl;
  V jk = jy_asymptotic<true>(mu, zb);
  V jk1 = jy_asymptotic<true>(mu + V(1.0), zb);
  V yk = jy_asymptotic<false>(mu, zb);
  V yk1 = jy_asymptotic<false>(mu + V(1.0), zb);
  const V xi2 = V(2.0) / zb;
  for (int i = 0; i < 31; ++i) {
    const bool step = nl > V((double)i);
    const V fac = (mu + V((double)i) + V(1.0)) * xi2;
    const V jn = fac * jk1 - jk;
    const V yn = fac * yk1 - yk;
    const V jk2 = step ? jk1 : jk;
    jk1 = step ? jn : jk1;
    jk = jk2;
    const V yk2 = step ? yk1 : yk;
    yk1 = step ? yn : yk1;
    yk = yk2;
  }
  const bool hi_order = anu > V(8.0);
  ja = hi_order ? jk : ja;
  ya = hi_order ? yk : ya;
  const bool big = z > V(40.0);
  V j = big ? ja : s.j;
  V y = big ? ya : s.y;
  const JY<T> sc = sincospi(anu);
  const V j_neg = j * sc.y - y * sc.j;
  const V y_neg = j * sc.j + y * sc.y;
  const bool neg = nu < V(0.0);
  j = neg ? j_neg : j;
  y = neg ? y_neg : y;
  const bool bad = anu > V(30.5);
  return {bad ? nan_of<T>() : j, bad ? nan_of<T>() : y};
}

template <typename T>
ISF_FN R<T> bessel_y0y1_small0(R<T> z) {
  typedef R<T> V;
  const V q = z * z * V(0.25);
  const V logz2 = log(z * V(0.5));
  V term = 1.0, acc = 0.0, hk = 0.0;
  for (int k = 1; k < 32; ++k) {
    const double kf = k;
    term = term * (-q) / V(kf * kf);
    hk = hk + V(1.0 / kf);
    acc = acc + (-term) * hk;
  }
  return V(2.0 / kPi) * ((logz2 + V(kEulerGamma)) * bessel_jn<0>(z) + acc);
}

template <typename T>
ISF_FN R<T> bessel_y0y1_small1(R<T> z) {
  typedef R<T> V;
  const V q = z * z * V(0.25);
  const V logz2 = log(z * V(0.5));
  V term = 1.0, acc = 1.0, hk = 0.0, hk1 = 1.0;
  for (int k = 1; k < 32; ++k) {
    const double kf = k;
    term = term * (-q) / V(kf * (kf + 1.0));
    hk = hk + V(1.0 / kf);
    hk1 = hk1 + V(1.0 / (kf + 1.0));
    acc = acc + term * (hk + hk1);
  }
  return V(2.0 / kPi) * ((logz2 + V(kEulerGamma)) * bessel_jn<1>(z) - V(1.0) / z -
                         (z * V(0.25)) * acc);
}

ISF_TABLE kK0Mid[23] = {
    1.2028286465790197, -0.030591787719553676, 0.0014210722375637287,
    -0.00010388158100365775, 9.762067788423225e-06, -1.082086296879005e-06,
    1.351201646484709e-07, -1.8482595638611766e-08, 2.7186252388337763e-09,
    -4.2445766658763436e-10, 6.967483660813012e-11, -1.1937916743473208e-11,
    2.122964169369167e-12, -3.900234424279417e-13, 7.379256178071285e-14,
    -1.4358723953495275e-14, 2.906948152039217e-15, -5.661300575341757e-16,
    1.4790247649295895e-16, -3.7292984407056944e-17, 4.079690562390755e-17,
    -3.755188669435943e-17, 5.87983431477737e-17};
ISF_TABLE kK0Big[19] = {
    1.243990650868462, -0.009174852691025803, 0.0001444550931774185,
    -4.013614175529894e-06, 1.5678318100587383e-07, -7.770110513915755e-09,
    4.6111815781408603e-10, -3.158599198997939e-11, 2.4349281259007275e-12,
    -2.0746853963234516e-13, 1.9171836557903002e-14, -2.0445114343506195e-15,
    1.5179938710645071e-16, -6.182631040969e-17, -4.816035433020208e-17,
    -1.0835900161805395e-17, -3.281931876688869e-17, -1.2518526181642369e-17,
    -1.3017455987150712e-17};
ISF_TABLE kK1Mid[23] = {
    1.4189885893618182, 0.10612301366130722, -0.002702099638238477,
    0.0001642748476195546, -1.4066859038775309e-05, 1.4728630269748668e-06,
    -1.7689408145186164e-07, 2.3517081640480202e-08, -3.3843113374756892e-09,
    5.192772802632103e-10, -8.403627294281494e-11, 1.422843705030357e-11,
    -2.505033636540474e-12, 4.561081594257689e-13, -8.583800390419009e-14,
    1.6395736411563473e-14, -3.560270024145593e-15, 6.186397753261234e-16,
    -3.2426039306575127e-16, -4.652819950330459e-17, -1.6261072401069936e-16,
    -2.6902548683153138e-17, -2.0969558484027402e-16};
ISF_TABLE kK1Big[19] = {
    1.2818965417186945, 0.028328878130496924, -0.0002475370673908294,
    5.771972451393736e-06, -2.0689392218267664e-07, 9.7399832458936e-09,
    -5.585338401432265e-10, 3.732975526333097e-11, -2.8252565097005837e-12,
    2.3701095737069585e-13, -2.1914146235882745e-14, 1.9954495011791e-15,
    -3.436372385782436e-16, -8.202562152366134e-17, -9.82720080779848e-17,
    -6.961783446547556e-17, -4.983764228948445e-17, -3.7631602816937714e-17,
    -3.798734762107494e-17};
ISF_TABLE kP0Cheb[27] = {
    0.9983508529003942, -0.001622326525375695, 2.5659898108143426e-05,
    -1.074733530416572e-06, 7.695166556043232e-08, -7.791256341956166e-09,
    1.0076739103231815e-09, -1.5658349022456687e-10, 2.8088380309445716e-11,
    -5.658276572807053e-12, 1.2545846649486519e-12, -3.018157851826075e-13,
    7.770335308276474e-14, -2.1400656843957792e-14, 6.0866911665685924e-15,
    -1.9175618638796704e-15, 5.223191128158126e-16, -2.582061101890892e-16,
    3.812008134199594e-18, -7.203990078083427e-17, -4.557691178921068e-17,
    -7.223706440208404e-17, -2.4180592802364897e-17, -3.5987873804036357e-17,
    -2.354118526106635e-17, -3.087215181110812e-18, 3.0030154289718896e-19};
ISF_TABLE kQ0Cheb[27] = {
    -0.9868477858880368, 0.012759549508489528, -0.0003688766783741065,
    2.158470606690122e-05, -1.9316120103761817e-06, 2.304153571648965e-07,
    -3.3875070735292195e-08, 5.843684649743781e-09, -1.1445219177974879e-09,
    2.4865775839813145e-10, -5.891333657551081e-11, 1.5026430945397446e-11,
    -4.084478611649733e-12, 1.1740431677796777e-12, -3.543196004136144e-13,
    1.1190546422688331e-13, -3.6596652104615294e-14, 1.2563723156020945e-14,
    -4.314441346685688e-15, 1.6441712130040167e-15, -5.2741677897999485e-16,
    2.921798175429053e-16, -3.892383191730539e-17, 6.579633017216143e-17,
    2.2880739233840472e-17, 2.3189038055029087e-18, 1.2657498054430783e-17};
ISF_TABLE kP1Cheb[27] = {
    1.0027803045717265, 0.0027451765837570277, -3.37240456836456e-05,
    1.3039465877996387e-06, -8.977362126121733e-08, 8.879041215404142e-09,
    -1.1304764437260006e-09, 1.7368451938885874e-10, -3.088836293566369e-11,
    6.179620070343051e-12, -1.3628285303321794e-12, 3.260649624431963e-13,
    -8.390493153679579e-14, 2.2715949868341296e-14, -6.649476182587768e-15,
    1.905978001484501e-15, -6.998943698090866e-16, 1.1415812995042947e-16,
    -1.394877549346043e-16, -5.089708752991405e-17, -6.315774200223593e-17,
    -3.747835943704532e-17, -6.557383948286377e-17, -5.336819161384358e-17,
    -1.4614448608232376e-17, -7.277419269263228e-17, -4.1262536705884326e-18};
ISF_TABLE kQ1Cheb[27] = {
    2.981372314582739, -0.018139154448572267, 0.0004604727250432597,
    -2.5533947079856635e-05, 2.2187784778197517e-06, -2.5977194735365343e-07,
    3.769713746371197e-08, -6.440505408154428e-09, 1.251985974947473e-09,
    -2.7037085655414845e-10, 6.37399269324142e-11, -1.618963561913587e-11,
    4.384894552402446e-12, -1.2564827497987848e-12, 3.7812825146302015e-13,
    -1.1914928855413263e-13, 3.8782919129101206e-14, -1.3391579376625813e-14,
    4.495570412283071e-15, -1.7262176941126247e-15, 5.114991046295202e-16,
    -2.684317911813195e-16, 2.385651056346922e-17, -1.0554732655592933e-16,
    2.0011870922808886e-17, -1.0545496332212484e-18, -1.5345237860883502e-17};

static constexpr double kKMidLo = 1.0 / 8.0, kKMidHi = 1.0 / 1.5;
static constexpr double kPqVHi = (8.0 / 4.5) * (8.0 / 4.5);

template <int N, typename T>
ISF_FN R<T> besselk01_cheb(R<T> z) {
  typedef R<T> V;
  const V u = V(1.0) / z;
  const V t_mid = (V(2.0) * minc(maxc(u, kKMidLo), kKMidHi) - V(kKMidLo + kKMidHi)) /
                  V(kKMidHi - kKMidLo);
  const V t_big = V(16.0) * minc(maxc(u, 0.0), kKMidLo) - V(1.0);
  const V mid = N == 0 ? cheb_eval(kK0Mid, t_mid) : cheb_eval(kK1Mid, t_mid);
  const V big = N == 0 ? cheb_eval(kK0Big, t_big) : cheb_eval(kK1Big, t_big);
  const V scaled = z > V(8.0) ? big : mid;
  return scaled * exp(-z) / sqrt(z);
}

template <int N, typename T>
ISF_FN R<T> bessely01_cheb(R<T> z) {
  typedef R<T> V;
  const V r = V(8.0) / z;
  const V v = minc(maxc(r * r, 0.0), kPqVHi);
  const V t = (V(2.0) * v - V(kPqVHi)) / V(kPqVHi);
  const V p = N == 0 ? cheb_eval(kP0Cheb, t) : cheb_eval(kP1Cheb, t);
  const V q = (N == 0 ? cheb_eval(kQ0Cheb, t) : cheb_eval(kQ1Cheb, t)) / (V(8.0) * z);
  const V chi = z - V((0.5 * N + 0.25) * kPi);
  const V amp = sqrt(V(2.0) / (V(kPi) * z));
  return amp * (p * sin(chi) + q * cos(chi));
}

template <int N, typename T>
ISF_FN R<T> y01(R<T> zs) {
  const R<T> small = N == 0 ? bessel_y0y1_small0(minc(zs, 4.5)) : bessel_y0y1_small1(minc(zs, 4.5));
  const R<T> big = bessely01_cheb<N>(maxc(zs, 4.5));
  return zs < R<T>(4.5) ? small : big;
}

template <int N, typename T>
ISF_FN R<T> bessely_int(R<T> z) {
  typedef R<T> V;
  constexpr int n = N < 0 ? -N : N;
  const V zs = z > V(0.0) ? z : V(1.0);
  V out = y01<0>(zs);
  if constexpr (n > 0) {
    V prev = out, cur = y01<1>(zs);
    for (int k = 1; k < n; ++k) {
      const V next = (V(2.0 * k) / zs) * cur - prev;
      prev = cur;
      cur = next;
    }
    out = cur;
  }
  if constexpr (N < 0 && (n % 2) == 1) out = -out;
  return z > V(0.0) ? out : nan_of<T>();
}

template <typename T>
ISF_FN R<T> besselk_int_small0(R<T> z) {
  typedef R<T> V;
  const V q = z * z * V(0.25);
  const V logz2 = log(z * V(0.5));
  V term = 1.0, acc = 0.0, hk = 0.0;
  for (int k = 1; k < 40; ++k) {
    const double kf = k;
    term = term * q / V(kf * kf);
    hk = hk + V(1.0 / kf);
    acc = acc + term * hk;
  }
  return -(logz2 + V(kEulerGamma)) * i0(z) + acc;
}

template <typename T>
ISF_FN R<T> besselk_int_small1(R<T> z) {
  typedef R<T> V;
  const V q = z * z * V(0.25);
  const V logz2 = log(z * V(0.5));
  V term = 1.0, acc = -2.0 * kEulerGamma + 1.0, hk = 0.0, hk1 = 1.0;
  for (int k = 1; k < 40; ++k) {
    const double kf = k;
    term = term * q / V(kf * (kf + 1.0));
    hk = hk + V(1.0 / kf);
    hk1 = hk1 + V(1.0 / (kf + 1.0));
    acc = acc + term * (V(-2.0 * kEulerGamma) + hk + hk1);
  }
  return V(1.0) / z + logz2 * i1(z) - (z * V(0.25)) * acc;
}

template <int N, typename T>
ISF_FN R<T> k01(R<T> zs) {
  const R<T> small = N == 0 ? besselk_int_small0(minc(zs, 1.5)) : besselk_int_small1(minc(zs, 1.5));
  const R<T> big = besselk01_cheb<N>(maxc(zs, 1.5));
  return zs < R<T>(1.5) ? small : big;
}

template <int N, typename T>
ISF_FN R<T> besselk_int(R<T> z) {
  typedef R<T> V;
  constexpr int n = N < 0 ? -N : N;
  const V zs = z > V(0.0) ? z : V(1.0);
  V out = k01<0>(zs);
  if constexpr (n > 0) {
    V prev = out, cur = k01<1>(zs);
    for (int k = 1; k < n; ++k) {
      const V next = prev + (V(2.0 * k) / zs) * cur;
      prev = cur;
      cur = next;
    }
    out = cur;
  }
  return z > V(0.0) ? out : nan_of<T>();
}

// K_ν, x >= 2: Steed/Thompson-Barnett's CF2 (special.py's _besselk_frac_cf2)
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
  bool done = false;
  for (int i = 2; i < 61; ++i) {
    const double fi = i;
    const V a2 = a - V(2.0 * (fi - 1.0));
    const V c2 = -a2 * c / V(fi);
    const V qnew = (q1 - b * q2) / a2;
    const V q3 = q + c2 * qnew;
    const V b2 = b + V(2.0);
    const V d2 = V(1.0) / (b2 + a2 * d);
    const V delh2 = (b2 * d2 - V(1.0)) * delh;
    const V h2 = h + delh2;
    const V ss2 = ss + q3 * delh2;
    const bool conv = (fabs(q3 * delh2) < eps * fabs(ss2)) && (fabs(delh2) < eps * fabs(h2));
    a = done ? a : a2;
    c = done ? c : c2;
    const V q1n = done ? q1 : q2;
    q2 = done ? q2 : qnew;
    q1 = q1n;
    q = done ? q : q3;
    b = done ? b : b2;
    d = done ? d : d2;
    delh = done ? delh : delh2;
    h = done ? h : h2;
    ss = done ? ss : ss2;
    done = done || conv;
  }
  h = a1 * h;
  V rkmu = sqrt(V(kPi) / (V(2.0) * x)) * exp(-x) / ss;
  V rk1 = rkmu * (xmu + x + V(0.5) - h) * xi;
  for (int i = 0; i < 31; ++i) {
    const bool step = nl > V((double)i);
    const V ktemp = (xmu + V((double)i) + V(1.0)) * V(2.0) * xi * rk1 + rkmu;
    const V rkmu2 = step ? rk1 : rkmu;
    rk1 = step ? ktemp : rk1;
    rkmu = rkmu2;
  }
  return rkmu;
}

template <typename T>
ISF_HEAVY R<T> besselk_frac(R<T> nu, R<T> z) {
  typedef R<T> V;
  const V anu = fabs(nu);
  const V zs_small = minc(z, 2.0);
  const V ip = bessel_frac(-anu, zs_small, true);
  const V im = bessel_frac(anu, zs_small, true);
  const V small = V(kPi) * (ip - im) / (V(2.0) * sin(V(kPi) * anu));
  const V big = besselk_frac_cf2(anu, maxc(z, 2.0));
  const V out = z < V(2.0) ? small : big;
  return anu > V(30.5) ? nan_of<T>() : out;
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

// spherical j_n, integer n (special.py's sph_jn)
template <int N, typename T>
ISF_FN R<T> sph_jn_int(R<T> z) {
  typedef R<T> V;
  const V zs = z == V(0.0) ? V(1.0) : z;
  const V j0 = sin(zs) / zs;
  if constexpr (N == 0) {
    return z == V(0.0) ? V(1.0) : j0;
  } else {
    const V j1 = sin(zs) / (zs * zs) - cos(zs) / zs;
    if constexpr (N == 1) {
      return z == V(0.0) ? V(0.0) : j1;
    } else {
      V up_prev = j0, up_cur = j1;
      for (int k = 1; k < N; ++k) {
        const V next = (V(2.0 * k + 1.0) / zs) * up_cur - up_prev;
        up_prev = up_cur;
        up_cur = next;
      }
      const double bound = sizeof(T) == 4 ? 0x1p40 : 0x1p400;
      const double factor = sizeof(T) == 4 ? 0x1p-40 : 0x1p-400;
      V fp = 0.0, fc = 1e-30, f_n = 0.0, f0 = 0.0, f1 = 0.0;
      const V zm = minc(zs, (double)N);
      const V j0m = sin(zm) / zm;
      const V j1m = sin(zm) / (zm * zm) - cos(zm) / zm;
      for (int k = N + 28; k >= 1; --k) {
        const V fn = (V(2.0 * k + 1.0) / zm) * fc - fp;
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
      const V down = f_n * scale;
      const V out = zs > V((double)N) ? up_cur : down;
      return z == V(0.0) ? V(0.0) : out;
    }
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
  return isf::bessjy_frac(isf::R<T>::of(nu), isf::R<T>::of(z)).j.v;
}
template <typename T, int N>
INFLX_FN T inflx_bessely_int(T z) { return isf::bessely_int<N>(isf::R<T>::of(z)).v; }
template <typename T>
INFLX_FN T inflx_bessely(T nu, T z) {
  return isf::bessjy_frac(isf::R<T>::of(nu), isf::R<T>::of(z)).y.v;
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
  return isf::sph_frac_finish<true>(nu, zv, zs, isf::bessjy_frac(isf::R<T>(nu + 0.5), zs).j).v;
}
template <typename T>
INFLX_FN T inflx_sph_yn_frac(double nu, T z) {
  const isf::R<T> zv = isf::R<T>::of(z), zs = isf::sph_zs(zv, false);
  return isf::sph_frac_finish<false>(nu, zv, zs, isf::bessjy_frac(isf::R<T>(nu + 0.5), zs).y).v;
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
