"""C code generation for the port's native CPU backend.

The port's copy of ``inflatox_tpu/native/codegen.py``: for the same model
and symbol registry it emits the same C translation unit, text for text,
apart from the header comment that names the generator.  That source is the
IEEE-f64 oracle the kernels are held to and the CPU denominator of their
speed (compiled by :mod:`inflatox_torch.native.backend`).

Design (deliberately different from the reference's one-symbol-per-function
dlopen ABI, dylib.rs:32-42): a single translation unit exposing **fused scan
drivers** — each grid scan is one exported function computing every output
quantity per point in one pass, parallelized with OpenMP `parallel for`.
Point-math formulas match ops/anguelova.py (and thus anguelova.rs:99-171).
"""

from __future__ import annotations

import sympy
from sympy.printing.c import C99CodePrinter

from ..lowering.registry import SymbolRegistry
from ..symbolic import InflationModel

__all__ = ["generate_c_source"]


class _NativePrinter(C99CodePrinter):
    """C printer mapping model symbols through the shared SymbolRegistry, so
    parameter ordering is identical across the torch and native backends."""

    def __init__(self, registry: SymbolRegistry):
        super().__init__()
        self._registry = registry

    def _print_Symbol(self, expr):
        slot = self._registry.slot(expr)
        if slot is None:
            name = str(expr)
            if name.startswith("cse"):
                return name
            raise KeyError(f"unregistered symbol {expr}")
        kind, i = slot
        kind = {"x": "x", "xdot": "xd", "args": "p"}[kind]
        return f"{kind}[{i}]"

    # the reference's GSL printer makes the hypergeometric family and
    # erf/gamma first-class in its C hot path (compiler.py:158-212); libm
    # covers erf/tgamma/lgamma, the rest come from _SPECIALS_SRC helpers
    def _print_hyper(self, expr):
        ap, bq = expr.ap, expr.bq
        z = self._print(expr.argument)
        ps = [self._print(v) for v in (*ap, *bq)]
        name = {(0, 1): "inflx_hyp0f1", (1, 1): "inflx_hyp1f1",
                (2, 1): "inflx_hyp2f1", (2, 0): "inflx_hyp2f0"}.get(
                    (len(ap), len(bq)))
        if name is None:
            raise NotImplementedError(
                f"hypergeometric {len(ap)}F{len(bq)} has no native-C "
                "implementation (supported: 0F1, 1F1, 2F1, 2F0 — the "
                "reference's GSL surface)"
            )
        return f"{name}({', '.join(ps)}, {z})"

    def _print_polygamma(self, expr):
        n, z = expr.args
        if n == 0:
            return f"inflx_digamma({self._print(z)})"
        if n == 1:
            return f"inflx_trigamma({self._print(z)})"
        raise NotImplementedError(
            f"polygamma order {n} has no native-C implementation"
        )


_PRELUDE = """\
// Generated by inflatox_torch.native.codegen — fused CPU scan backend.
#include <math.h>
#include <stdint.h>
#ifdef _OPENMP
#include <omp.h>
#endif

// strict -std=c17 hides the POSIX math constants; define full-precision
// fallbacks (the reference ships low-precision ones, compiler.py:74-88 —
// a potential parity hazard we avoid)
#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif
#ifndef M_E
#define M_E 2.71828182845904523536
#endif
#ifndef M_LN2
#define M_LN2 0.69314718055994530942
#endif
#ifndef M_LN10
#define M_LN10 2.30258509299404568402
#endif
#ifndef M_LOG2E
#define M_LOG2E 1.44269504088896340736
#endif
#ifndef M_LOG10E
#define M_LOG10E 0.43429448190325182765
#endif
#ifndef M_SQRT2
#define M_SQRT2 1.41421356237309504880
#endif

#define EXPORT __attribute__((visibility("default")))

// ---- special functions (the reference's GSL printer family) ----------------
// Same algorithm choices as the JAX engines (lowering/special.py): direct /
// Kummer-transformed series for 1F1, |z| < 1 series for 2F1, smallest-term
// truncation for the asymptotic 2F0, shifted Stirling for psi/psi'.  libm
// provides erf/erfc/tgamma/lgamma.

static double inflx_hyp0f1(double b, double z) {
  double term = 1.0, acc = 1.0;
  for (int n = 0; n < 500; ++n) {
    term *= z / ((b + n) * (n + 1.0));
    acc += term;
    if (fabs(term) < 1e-17 * fabs(acc)) return acc;
  }
  return NAN;
}

static double inflx_hyp1f1_series(double a, double b, double z) {
  double term = 1.0, acc = 1.0;
  for (int n = 0; n < 1000; ++n) {
    term *= (a + n) * z / ((b + n) * (n + 1.0));
    acc += term;
    if (fabs(term) < 1e-17 * fabs(acc)) return acc;
  }
  return NAN;
}

static double inflx_hyp1f1(double a, double b, double z) {
  // Kummer transformation for z < 0 keeps every series term positive
  if (z < 0.0) return exp(z) * inflx_hyp1f1_series(b - a, b, -z);
  return inflx_hyp1f1_series(a, b, z);
}

static double inflx_hyp2f1(double a, double b, double c, double z) {
  if (fabs(z) >= 1.0) return NAN;  // series domain (GSL callers transform)
  double term = 1.0, acc = 1.0;
  for (int n = 0; n < 4000; ++n) {
    term *= (a + n) * (b + n) * z / ((c + n) * (n + 1.0));
    acc += term;
    if (fabs(term) < 1e-17 * fabs(acc)) return acc;
  }
  return NAN;
}

static double inflx_hyp2f0(double a, double b, double z) {
  // divergent asymptotic series: truncate at the smallest term
  double term = 1.0, acc = 1.0;
  for (int n = 0; n < 64; ++n) {
    const double next = term * (a + n) * (b + n) * z / (n + 1.0);
    if (fabs(next) >= fabs(term)) break;
    acc += next;
    term = next;
    if (fabs(term) < 1e-17 * fabs(acc)) break;
  }
  return acc;
}

static double inflx_digamma_big(double x) {  // x >= 10
  const double v = 1.0 / (x * x);
  // B_2k/(2k) x^{-2k}, k = 1..7
  double s = ((((((1.0 / 12.0) * v - 691.0 / 32760.0) * v + 1.0 / 132.0) * v
                - 1.0 / 240.0) * v + 1.0 / 252.0) * v - 1.0 / 120.0) * v
             + 1.0 / 12.0;
  return log(x) - 0.5 / x - s * v;
}

static double inflx_digamma(double x) {
  if (x <= 0.0) {  // reflection: psi(x) = psi(1-x) - pi*cot(pi*x)
    const double r = x - floor(x);
    if (r == 0.0) return NAN;
    return inflx_digamma(1.0 - x) - M_PI / tan(M_PI * r);
  }
  double acc = 0.0;
  while (x < 10.0) { acc -= 1.0 / x; x += 1.0; }
  return inflx_digamma_big(x) + acc;
}

static double inflx_trigamma_big(double x) {  // x >= 10
  const double v = 1.0 / (x * x);
  // 1/x + 1/(2x^2) + sum B_2k x^{-2k-1}
  double s = ((((((7.0 / 6.0) * v - 691.0 / 2730.0) * v + 5.0 / 66.0) * v
                - 1.0 / 30.0) * v + 1.0 / 42.0) * v - 1.0 / 30.0) * v
             + 1.0 / 6.0;
  return 1.0 / x + 0.5 * v + s * v / x;
}

static double inflx_trigamma(double x) {
  if (x <= 0.0) {  // psi1(x) = -psi1(1-x) + pi^2/sin^2(pi*x)
    const double r = x - floor(x);
    if (r == 0.0) return NAN;
    const double sp = sin(M_PI * r);
    return -inflx_trigamma(1.0 - x) + M_PI * M_PI / (sp * sp);
  }
  double acc = 0.0;
  while (x < 10.0) { acc += 1.0 / (x * x); x += 1.0; }
  return inflx_trigamma_big(x) + acc;
}
"""


def _emit_scalar_fn(name: str, expr, printer, use_xdot: bool = False, cse: bool = True) -> str:
    sig_x = "const double* restrict x"
    sig_xd = ", const double* restrict xd" if use_xdot else ""
    head = f"static inline double {name}({sig_x}{sig_xd}, const double* restrict p)"
    body = ""
    if cse:
        pairs, (reduced,) = sympy.cse(
            [sympy.sympify(expr)],
            symbols=(sympy.Symbol(f"cse{i}") for i in range(100000)),
            order="none",
            list=True,
        )
        for sym, definition in pairs:
            body += f"  const double {sym} = {printer.doprint(definition)};\n"
        expr = reduced
    body += f"  return {printer.doprint(sympy.sympify(expr))};\n"
    return f"{head} {{\n{body}}}\n\n"


def generate_c_source(model: InflationModel, registry: SymbolRegistry) -> str:
    """Emit the full C translation unit for a 2-field model."""
    if model.dim != 2:
        raise ValueError("the native scan backend supports 2-field models")
    printer = _NativePrinter(registry)

    src = _PRELUDE
    src += _emit_scalar_fn("f_V", model.potential, printer)
    for a in range(2):
        for b in range(2):
            src += _emit_scalar_fn(f"f_h{a}{b}", model.hesse_cmp[a][b], printer)
    src += _emit_scalar_fn("f_gsq", model.gradient_square, printer)
    grad = [sympy.diff(model.potential, f) for f in model.coordinates]
    src += _emit_scalar_fn("f_dV0", grad[0], printer)
    src += _emit_scalar_fn("f_dV1", grad[1], printer)

    # equations of motion (for CPU background solves / cross-checks)
    for a in range(2):
        src += _emit_scalar_fn(f"f_eom{a}", model.eom_fields[a], printer, use_xdot=True)
    src += _emit_scalar_fn("f_eomh", model.eom_h, printer, use_xdot=True)
    src += _emit_scalar_fn("f_eomhdot", model.eom_hdot, printer, use_xdot=True)

    src += r"""
// ---- fused point op (formulas: ops/anguelova.py == anguelova.rs:103-135) --
static inline void point_complete(const double* restrict x,
                                  const double* restrict p,
                                  double* restrict out6) {
  const double v   = f_V(x, p);
  const double v00 = f_h00(x, p);
  const double v10 = f_h10(x, p);
  const double v11 = f_h11(x, p);
  const double gsq = f_gsq(x, p);

  const double lhs = v11 / v;
  const double r00_10 = v00 / v10;
  const double r10_00 = v10 / v00;
  const double rhs = 3.0 + 3.0 * r00_10 * r00_10 + (v00 / v) * r10_00 * r10_00;
  double consistency = fabs(lhs - rhs) / (fabs(lhs) + fabs(rhs));
  if (consistency > 1.0) consistency = 1.0;

  const double eps_v = gsq / (v * v);
  const double vtt = (v00 * v10 * v10 + v11 * v00 * v00 - 2.0 * v00 * v10 * v10)
                     / (v00 * v00 + v10 * v10);
  const double vt2 = eps_v / (1.0 + r00_10 * r00_10);
  const double eps_h = 3.0 * (eps_v - vt2) / (eps_v + fabs(vtt) / v - vt2);
  const double delta = atan(fabs(r10_00));
  const double omega = sqrt((vtt / v) * (3.0 - eps_h));
  const double eta_par = omega * tan(delta) - 3.0;

  out6[0] = consistency;
  out6[1] = eps_v;
  out6[2] = eps_h;
  out6[3] = eta_par;
  out6[4] = delta;
  out6[5] = omega;
}

// ---- reference-style evaluation --------------------------------------------
// The reference evaluates every pixel through 5 dlopen'd function pointers
// (anguelova.rs:103-135 via hesse_bindings.rs); volatile pointers reproduce
// that call-indirection cost (no inlining, no cross-call vectorization) so
// the "32-core Rust reference" baseline of BASELINE.json can be measured
// faithfully on this machine.
typedef double (*inflx_fn2)(const double* restrict, const double* restrict);
static inflx_fn2 volatile g_V   = f_V;
static inflx_fn2 volatile g_h00 = f_h00;
static inflx_fn2 volatile g_h10 = f_h10;
static inflx_fn2 volatile g_h11 = f_h11;
static inflx_fn2 volatile g_gsq = f_gsq;

static void point_complete_refstyle(const double* restrict x,
                                    const double* restrict p,
                                    double* restrict out6) {
  const double v   = g_V(x, p);
  const double v00 = g_h00(x, p);
  const double v10 = g_h10(x, p);
  const double v11 = g_h11(x, p);
  const double gsq = g_gsq(x, p);
  const double lhs = v11 / v;
  const double r00_10 = v00 / v10;
  const double r10_00 = v10 / v00;
  const double rhs = 3.0 + 3.0 * r00_10 * r00_10 + (v00 / v) * r10_00 * r10_00;
  double consistency = fabs(lhs - rhs) / (fabs(lhs) + fabs(rhs));
  if (consistency > 1.0) consistency = 1.0;
  const double eps_v = gsq / (v * v);
  const double vtt = (v00 * v10 * v10 + v11 * v00 * v00 - 2.0 * v00 * v10 * v10)
                     / (v00 * v00 + v10 * v10);
  const double vt2 = eps_v / (1.0 + r00_10 * r00_10);
  const double eps_h = 3.0 * (eps_v - vt2) / (eps_v + fabs(vtt) / v - vt2);
  const double delta = atan(fabs(r10_00));
  const double omega = sqrt((vtt / v) * (3.0 - eps_h));
  out6[0] = consistency;
  out6[1] = eps_v;
  out6[2] = eps_h;
  out6[3] = omega * tan(delta) - 3.0;
  out6[4] = delta;
  out6[5] = omega;
}

EXPORT void inflx_complete_analysis_refstyle(const double* p, double* out,
                                             double x0a, double x0b,
                                             double x1a, double x1b,
                                             int64_t n0, int64_t n1,
                                             int threads) {
  const double d0 = (x0b - x0a) / (double)n0;
  const double d1 = (x1b - x1a) / (double)n1;
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n0; ++i) {
    double x[2];
    x[0] = x0a + (double)i * d0;
    for (int64_t j = 0; j < n1; ++j) {
      x[1] = x1a + (double)j * d1;
      point_complete_refstyle(x, p, out + (i * n1 + j) * 6);
    }
  }
}

// ---- exported drivers ------------------------------------------------------
// Grid convention: x_i = start + i*(stop-start)/N (endpoint-exclusive),
// matching anguelova.rs:84-94.

EXPORT void inflx_complete_analysis(const double* p, double* out,
                                    double x0a, double x0b,
                                    double x1a, double x1b,
                                    int64_t n0, int64_t n1, int threads) {
  const double d0 = (x0b - x0a) / (double)n0;
  const double d1 = (x1b - x1a) / (double)n1;
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n0; ++i) {
    double x[2];
    x[0] = x0a + (double)i * d0;
    for (int64_t j = 0; j < n1; ++j) {
      x[1] = x1a + (double)j * d1;
      point_complete(x, p, out + (i * n1 + j) * 6);
    }
  }
}

EXPORT void inflx_complete_analysis_ot(const double* p, const double* traj,
                                       double* out, int64_t n, int threads) {
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    point_complete(traj + 2 * i, p, out + 6 * i);
  }
}

EXPORT void inflx_potential_grid(const double* p, double* out,
                                 double x0a, double x0b,
                                 double x1a, double x1b,
                                 int64_t n0, int64_t n1, int threads) {
  const double d0 = (x0b - x0a) / (double)n0;
  const double d1 = (x1b - x1a) / (double)n1;
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n0; ++i) {
    double x[2];
    x[0] = x0a + (double)i * d0;
    for (int64_t j = 0; j < n1; ++j) {
      x[1] = x1a + (double)j * d1;
      out[i * n1 + j] = f_V(x, p);
    }
  }
}

EXPORT void inflx_point_eval(const double* x, const double* p, double* out6) {
  out6[0] = f_V(x, p);
  out6[1] = f_h00(x, p);
  out6[2] = f_h01(x, p);
  out6[3] = f_h10(x, p);
  out6[4] = f_h11(x, p);
  out6[5] = f_gsq(x, p);
}

EXPORT void inflx_grad(const double* x, const double* p, double* out2) {
  out2[0] = f_dV0(x, p);
  out2[1] = f_dV1(x, p);
}

EXPORT void inflx_eom_eval(const double* x, const double* xd, const double* p,
                           double* out4) {
  out4[0] = f_eom0(x, xd, p);
  out4[1] = f_eom1(x, xd, p);
  out4[2] = f_eomh(x, xd, p);
  out4[3] = f_eomhdot(x, xd, p);
}

// ---- reference-style rapid-turn scan (BASELINE cfg3) -----------------------
// consistency_rapidturn_only (anguelova.rs:143-154): 4 indirect calls/px,
// lhs = V_ww/V, rhs = 3 (V_vw/V_vv)², out = ||lhs|-|rhs||/(|lhs|+|rhs|).
static double point_rapidturn_refstyle(const double* restrict x,
                                       const double* restrict p) {
  const double v   = g_V(x, p);
  const double v00 = g_h00(x, p);
  const double v10 = g_h10(x, p);
  const double v11 = g_h11(x, p);
  const double lhs = v11 / v;
  const double r = v10 / v00;
  const double rhs = 3.0 * r * r;
  double c = fabs(fabs(lhs) - fabs(rhs)) / (fabs(lhs) + fabs(rhs));
  if (c > 1.0) c = 1.0;
  return c;
}

EXPORT void inflx_consistency_rapidturn_refstyle(const double* p, double* out,
                                                 double x0a, double x0b,
                                                 double x1a, double x1b,
                                                 int64_t n0, int64_t n1,
                                                 int threads) {
  const double d0 = (x0b - x0a) / (double)n0;
  const double d1 = (x1b - x1a) / (double)n1;
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n0; ++i) {
    double x[2];
    x[0] = x0a + (double)i * d0;
    for (int64_t j = 0; j < n1; ++j) {
      x[1] = x1a + (double)j * d1;
      out[i * n1 + j] = point_rapidturn_refstyle(x, p);
    }
  }
}

// ---- reference-style background solver (BASELINE cfg5b) --------------------
// RKF45 with the semantics of inflatox_tpu/background.py (which fixes the
// reference's tableau bugs, SURVEY.md §2.2): state y = (φ0, φ1, χ0, χ1, H),
// start dt = 1e-10, accept when err/max_err <= 1.1, dt *= clip((max_err /
// err)^(1/7), 0.1, 5).  EoM evaluation goes through volatile function
// pointers — the reference calls dlopen'd eom{i} per stage
// (background_solver.rs:50-59).  Sequential in time per trajectory; OpenMP
// across trajectories (the reference's API is one-trajectory-per-call; a
// 32-core user would run 32 at once).
typedef double (*inflx_fn3)(const double* restrict, const double* restrict,
                            const double* restrict);
static inflx_fn3 volatile g_eom0 = f_eom0;
static inflx_fn3 volatile g_eom1 = f_eom1;
static inflx_fn3 volatile g_eomh = f_eomh;
static inflx_fn3 volatile g_eomhdot = f_eomhdot;

static void solver_deriv(const double* restrict y, const double* restrict p,
                         double* restrict dy) {
  const double x[2]  = {y[0], y[1]};
  const double xd[2] = {y[2], y[3]};
  dy[0] = y[2];
  dy[1] = y[3];
  dy[2] = -g_eom0(x, xd, p) - 3.0 * y[4] * y[2];
  dy[3] = -g_eom1(x, xd, p) - 3.0 * y[4] * y[3];
  dy[4] = g_eomhdot(x, xd, p);
}

static const double RKF_A[6][6] = {
  {0, 0, 0, 0, 0, 0},
  {1.0 / 4.0, 0, 0, 0, 0, 0},
  {3.0 / 32.0, 9.0 / 32.0, 0, 0, 0, 0},
  {1932.0 / 2197.0, -7200.0 / 2197.0, 7296.0 / 2197.0, 0, 0, 0},
  {439.0 / 216.0, -8.0, 3680.0 / 513.0, -845.0 / 4104.0, 0, 0},
  {-8.0 / 27.0, 2.0, -3544.0 / 2565.0, 1859.0 / 4104.0, -11.0 / 40.0, 0},
};
static const double RKF_B5[6] = {16.0 / 135.0, 0.0, 6656.0 / 12825.0,
                                 28561.0 / 56430.0, -9.0 / 50.0, 2.0 / 55.0};
static const double RKF_B4[6] = {25.0 / 216.0, 0.0, 1408.0 / 2565.0,
                                 2197.0 / 4104.0, -1.0 / 5.0, 0.0};

EXPORT void inflx_solve_eom_rkf(const double* p, const double* inits,
                                double* out, int64_t n_traj, int64_t steps,
                                double max_err, int threads) {
  // inits: (n_traj, 4) = φ0, φ1, χ0, χ1; out: (n_traj, steps, 6) rows of
  // (φ0, φ1, χ0, χ1, H, t) — the layout of background.solve_eom with
  // return_time
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#endif
#pragma omp parallel for schedule(dynamic)
  for (int64_t tr = 0; tr < n_traj; ++tr) {
    double y[5];
    const double* ic = inits + 4 * tr;
    y[0] = ic[0]; y[1] = ic[1]; y[2] = ic[2]; y[3] = ic[3];
    {
      const double x[2] = {y[0], y[1]};
      const double xd[2] = {y[2], y[3]};
      y[4] = g_eomh(x, xd, p);
    }
    double* rows = out + tr * steps * 6;
    rows[0] = y[0]; rows[1] = y[1]; rows[2] = y[2]; rows[3] = y[3];
    rows[4] = y[4]; rows[5] = 0.0;
    double dt = 1e-10, t = 0.0;
    for (int64_t s = 1; s < steps; ++s) {
      for (;;) {
        double k[6][5], yn[5], hi[5], lo[5];
        for (int n = 0; n < 6; ++n) {
          for (int c = 0; c < 5; ++c) {
            double acc = y[c];
            for (int m = 0; m < n; ++m)
              if (RKF_A[n][m] != 0.0) acc += dt * RKF_A[n][m] * k[m][c];
            yn[c] = acc;
          }
          solver_deriv(yn, p, k[n]);
        }
        double err2 = 0.0;
        for (int c = 0; c < 5; ++c) {
          double acch = y[c], accl = y[c];
          for (int n = 0; n < 6; ++n) {
            if (RKF_B5[n] != 0.0) acch += dt * RKF_B5[n] * k[n][c];
            if (RKF_B4[n] != 0.0) accl += dt * RKF_B4[n] * k[n][c];
          }
          hi[c] = acch; lo[c] = accl;
          const double d = acch - accl;
          err2 += d * d;
        }
        const double err = sqrt(err2);
        double q = (err > 0.0)
                       ? pow(max_err / fmax(err, 1e-300), 1.0 / 7.0)
                       : 5.0;
        if (q < 0.1) q = 0.1;
        if (q > 5.0) q = 5.0;
        if (!isfinite(err)) q = 0.1;
        const int accept = (err / max_err <= 1.1) || (dt <= 1e-250);
        if (accept) {
          for (int c = 0; c < 5; ++c) y[c] = hi[c];
          t += dt;
          dt *= q;
          break;
        }
        dt *= q;
      }
      double* row = rows + s * 6;
      row[0] = y[0]; row[1] = y[1]; row[2] = y[2]; row[3] = y[3];
      row[4] = y[4]; row[5] = t;
    }
  }
}
"""
    return src
