// Kernel B6's per-trajectory integrator: adaptive embedded Runge-Kutta on
// the background state y = [φ_0..φ_{n-1}, χ_0..χ_{n-1}, H] in plain f64.
//
// The semantics are those of the plain version (ops/cuda_solver.py,
// solve_torch) and of inflatox_tpu/background.py's while-loop solver:
//
//   φ' = χ,  χ'_a = -eom_a - (3H)·χ_a,  H' = eom_hdot
//
// row 0 holds the initial state with H = eom_h(φ0, χ0) and t = 0; each later
// row holds the state after one accepted step.  Step control, in f64:
// dt starts at 1e-10; err = sqrt(Σ_c (hi_c - lo_c)²), summed left to right;
// q = clip(((1/max(err, 1e-300))·max_err)^(1/(s+1)), 0.1, 5), 5 when
// err = 0, 0.1 when err is not finite; accept when err·(1/max_err) <= 1.1,
// dt <= 1e-250 or dt is not finite; dt ← dt·q after accepts and rejects.
//
// One flat loop runs all of a trajectory's attempts, with the row counter
// in a register: an accepted attempt stores its row and the next attempt
// starts at once, so the lanes of a warp no longer wait at every row for
// the lane that needs the most attempts there.  The first stage of an
// attempt depends on y alone: after a reject y is unchanged and its slope
// k0 is reused, bit for bit; after an accept k0 = f(y) was computed before
// the controller's pow, in the same straight-line code, so that the two
// chains overlap (on a reject that slope is dropped).  Step doubling's
// first half step starts from the same y, so RK4 takes its k0 too.
//
// The attempt loop has no cap (the TPU kernel's 8-attempt cap exists only
// because its lanes run in lock-step).  It ends: a reject has
// err > 1.1·max_err, so q <= 1.1^(-1/(s+1)) (0.9865 for rkf, 0.9811 for
// rk4), and 0.1 when err is not finite, so dt falls to the 1e-250 floor
// within a bounded number of rejects (about 240 on a non-finite state).
// Accepting a non-finite dt is a divergence from the JAX package, whose
// loop never ends there (dt overflows after hundreds of zero-error rows at
// a fixed point, and inf·0.1 stays inf).
//
// Every sum and product is written in the plain version's order (stage
// inputs y + (dt·a)·k accumulated over ascending m, the error norm left to
// right, division by a scalar as multiplication by its reciprocal) and goes
// through inflx_math.cuh, which nvcc never fuses, so the kernel rounds as
// the plain version does on the card.
//
// Functions are INFLX_FN (__device__ __forceinline__ under nvcc, static
// inline elsewhere): the CPU tests build this header with the host's C++
// compiler.  The including file first includes the generated model header
// (CompiledModel.cuda_solver_source: INFLX_NF, f_eom_h, and inflx_deriv,
// which gives the velocities, the n EoM terms and Ḣ from one body).
#pragma once
#include <math.h>
#include <stdint.h>

#include "inflx_math.cuh"

#define INFLX_NY (2 * INFLX_NF + 1)

enum { INFLX_RKF45 = 0, INFLX_RK4 = 1 };

// Attribution hooks: INFLX_STAMP(part, value) ends a part of an attempt
// once `value`, its last result, exists.  They expand to nothing unless the
// including file defines INFLX_STAMP (scripts/probe_solver_chain.py builds
// instrumented copies of the library that way).
#ifndef INFLX_STAMP
#define INFLX_STAMP(part, value)
#endif
enum {
  INFLX_PART_DERIV,    // a stage's derivative
  INFLX_PART_COMBINE,  // a stage input, or the hi/lo solutions
  INFLX_PART_NORM,     // the error norm and its sqrt
  INFLX_PART_RECIP,    // (1/max(err, 1e-300))·max_err
  INFLX_PART_POW,      // the controller's pow and clamps
  INFLX_PART_ACCEPT,   // the accept test, state, t and dt updates
  INFLX_PART_STORE,    // the row store
  INFLX_N_PARTS
};

// y' for the state y: φ' = χ, χ'_a = -eom_a - (3H)·χ_a, H' = Ḣ
INFLX_FN void inflx_slope(const double* y, const double* p, double* k) {
  double d[INFLX_NY];
  inflx_deriv(y, y + INFLX_NF, p, d);
#pragma unroll
  for (int a = 0; a < INFLX_NF; ++a) {
    k[a] = d[a];
    k[INFLX_NF + a] =
        inflx_sub(-d[INFLX_NF + a], inflx_mul(inflx_mul(3.0, y[2 * INFLX_NF]), y[INFLX_NF + a]));
  }
  k[2 * INFLX_NF] = d[2 * INFLX_NF];
}

// One explicit Runge-Kutta step with S stages from y, whose slope k0 is
// given: stage inputs y + Σ_m (dt·A[n][m])·k_m, hi = y + Σ_n (dt·bh[n])·k_n
// and, when LO, lo = y + Σ_n (dt·bl[n])·k_n; zero coefficients are skipped.
template <int S, bool LO>
INFLX_FN void inflx_rk_step(const double (&A)[S][S], const double (&bh)[S],
                            const double (&bl)[S], const double* y, const double* k0,
                            double dt, const double* p, double* hi, double* lo) {
  double k[S][INFLX_NY];
  double yn[INFLX_NY];
#pragma unroll
  for (int c = 0; c < INFLX_NY; ++c) k[0][c] = k0[c];
#pragma unroll
  for (int n = 1; n < S; ++n) {
#pragma unroll
    for (int c = 0; c < INFLX_NY; ++c) {
      double acc = y[c];
#pragma unroll
      for (int m = 0; m < n; ++m)
        if (A[n][m] != 0.0) acc = inflx_add(acc, inflx_mul(inflx_mul(dt, A[n][m]), k[m][c]));
      yn[c] = acc;
    }
    INFLX_STAMP(INFLX_PART_COMBINE, yn[INFLX_NY - 1]);
    inflx_slope(yn, p, k[n]);
    INFLX_STAMP(INFLX_PART_DERIV, k[n][INFLX_NY - 1]);
  }
#pragma unroll
  for (int c = 0; c < INFLX_NY; ++c) {
    double acch = y[c];
    double accl = y[c];
#pragma unroll
    for (int n = 0; n < S; ++n) {
      if (bh[n] != 0.0) acch = inflx_add(acch, inflx_mul(inflx_mul(dt, bh[n]), k[n][c]));
      if (LO && bl[n] != 0.0) accl = inflx_add(accl, inflx_mul(inflx_mul(dt, bl[n]), k[n][c]));
    }
    hi[c] = acch;
    if (LO) lo[c] = accl;
  }
  INFLX_STAMP(INFLX_PART_COMBINE, hi[INFLX_NY - 1]);
}

// Fehlberg 4(5): (5th-order, 4th-order) solutions
INFLX_FN void inflx_embedded_rkf45(const double* y, const double* k0, double dt,
                                   const double* p, double* hi, double* lo) {
  const double A[6][6] = {
      {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
      {1.0 / 4.0, 0.0, 0.0, 0.0, 0.0, 0.0},
      {3.0 / 32.0, 9.0 / 32.0, 0.0, 0.0, 0.0, 0.0},
      {1932.0 / 2197.0, -7200.0 / 2197.0, 7296.0 / 2197.0, 0.0, 0.0, 0.0},
      {439.0 / 216.0, -8.0, 3680.0 / 513.0, -845.0 / 4104.0, 0.0, 0.0},
      {-8.0 / 27.0, 2.0, -3544.0 / 2565.0, 1859.0 / 4104.0, -11.0 / 40.0, 0.0},
  };
  const double b5[6] = {16.0 / 135.0, 0.0, 6656.0 / 12825.0,
                        28561.0 / 56430.0, -9.0 / 50.0, 2.0 / 55.0};
  const double b4[6] = {25.0 / 216.0, 0.0, 1408.0 / 2565.0,
                        2197.0 / 4104.0, -1.0 / 5.0, 0.0};
  inflx_rk_step<6, true>(A, b5, b4, y, k0, dt, p, hi, lo);
}

// classical RK4 with step doubling: (two half steps, one full step); the
// full step and the first half step share y's slope k0
INFLX_FN void inflx_embedded_rk4(const double* y, const double* k0, double dt,
                                 const double* p, double* hi, double* lo) {
  const double A[4][4] = {
      {0.0, 0.0, 0.0, 0.0},
      {0.5, 0.0, 0.0, 0.0},
      {0.0, 0.5, 0.0, 0.0},
      {0.0, 0.0, 1.0, 0.0},
  };
  const double b[4] = {1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0};
  double half[INFLX_NY], k0_half[INFLX_NY];
  inflx_rk_step<4, false>(A, b, b, y, k0, dt, p, lo, nullptr);
  inflx_rk_step<4, false>(A, b, b, y, k0, inflx_mul(dt, 0.5), p, half, nullptr);
  inflx_slope(half, p, k0_half);
  INFLX_STAMP(INFLX_PART_DERIV, k0_half[INFLX_NY - 1]);
  inflx_rk_step<4, false>(A, b, b, half, k0_half, inflx_mul(dt, 0.5), p, hi, nullptr);
}

// Row s of a trajectory: [y, t], element c at row[c * comp_stride].
INFLX_FN void inflx_store_row(double* row, int64_t comp_stride, const double* y, double t) {
#pragma unroll
  for (int c = 0; c < INFLX_NY; ++c) row[c * comp_stride] = y[c];
  row[INFLX_NY * comp_stride] = t;
}

// One whole trajectory: `steps` rows of [y, t] written to out, element c of
// row s at out[s * row_stride + c * comp_stride].  With COUNT it returns the
// number of attempts it made (accepted and rejected) and stores the rejected
// ones in *rejects, else it returns 0 and leaves rejects alone.
template <int METHOD, bool COUNT = false>
INFLX_FN int64_t inflx_solve_trajectory(const double* x0, const double* xd0,
                                        const double* p, int64_t steps,
                                        double max_err, double inv_max_err,
                                        double* out, int64_t row_stride,
                                        int64_t comp_stride,
                                        int64_t* rejects = nullptr) {
  const int stages = METHOD == INFLX_RKF45 ? 6 : 4;
  const double exponent = 1.0 / (stages + 1);
  double y[INFLX_NY];
#pragma unroll
  for (int a = 0; a < INFLX_NF; ++a) {
    y[a] = x0[a];
    y[INFLX_NF + a] = xd0[a];
  }
  y[2 * INFLX_NF] = f_eom_h(y, y + INFLX_NF, p);
  double dt = 1e-10;
  double t = 0.0;
  double k0[INFLX_NY];
  inflx_slope(y, p, k0);
  inflx_store_row(out, comp_stride, y, t);
  int64_t attempts = 0, rejected = 0;
  for (int64_t s = 1; s < steps;) {
    double hi[INFLX_NY], lo[INFLX_NY], k0_next[INFLX_NY];
    if (COUNT) ++attempts;
    if (METHOD == INFLX_RKF45) {
      inflx_embedded_rkf45(y, k0, dt, p, hi, lo);
    } else {
      inflx_embedded_rk4(y, k0, dt, p, hi, lo);
    }
    double d = inflx_sub(hi[0], lo[0]);
    double e2 = inflx_mul(d, d);
#pragma unroll
    for (int c = 1; c < INFLX_NY; ++c) {
      d = inflx_sub(hi[c], lo[c]);
      e2 = inflx_add(e2, inflx_mul(d, d));
    }
    const double err = sqrt(e2);
    INFLX_STAMP(INFLX_PART_NORM, err);
    // the next attempt's first stage if this one is accepted, ahead of the
    // controller (neither waits for the other)
    inflx_slope(hi, p, k0_next);
    INFLX_STAMP(INFLX_PART_DERIV, k0_next[INFLX_NY - 1]);
    // q without a branch (the same value where err = 0 or is not finite
    // as with the branches of the step control above)
    const double ratio = inflx_mul(1.0 / (err > 1e-300 ? err : 1e-300), max_err);
    INFLX_STAMP(INFLX_PART_RECIP, ratio);
    double q = pow(ratio, exponent);
    q = q < 0.1 ? 0.1 : q;
    q = q > 5.0 ? 5.0 : q;
    q = err > 0.0 ? q : 5.0;
    q = isfinite(err) ? q : 0.1;
    INFLX_STAMP(INFLX_PART_POW, q);
    const bool accept =
        (inflx_mul(err, inv_max_err) <= 1.1) || (dt <= 1e-250) || !isfinite(dt);
    if (accept) {
#pragma unroll
      for (int c = 0; c < INFLX_NY; ++c) {
        y[c] = hi[c];
        k0[c] = k0_next[c];
      }
      t = inflx_add(t, dt);
    }
    dt = inflx_mul(dt, q);
    INFLX_STAMP(INFLX_PART_ACCEPT, dt);
    if (accept) {
      inflx_store_row(out + s * row_stride, comp_stride, y, t);
      ++s;
      INFLX_STAMP(INFLX_PART_STORE, t);
    } else if (COUNT) {
      ++rejected;
    }
  }
  if (COUNT) *rejects = rejected;
  return attempts;
}
