// Point tail of the (generalised) Anguelova-Lazaroiu analysis, one grid
// point at a time: the formulas of inflatox_torch/ops/anguelova.py (the
// plain-f64 ops of inflatox_tpu/ops/anguelova.py:45-113 and the native C
// oracle, inflatox_tpu/native/codegen.py:253-284), written in the same
// operation order as the torch version so both round alike.
//
// Replicated quirks (part of the parity contract):
//  * complete_analysis's eps_V has no 1/2; the standalone epsilon_v has it;
//  * complete_analysis's consistency uses |L-R|, the standalone conditions
//    ||L|-|R||;
//  * the ratio metric is clamped to <= 1 with `c > 1.0 ? 1.0 : c`, which
//    keeps NaN (fmin would drop it);
//  * eta_par = omega * tan_delta - 3, using tan_delta directly.
#pragma once
#include <math.h>

#ifndef INFLX_FN
#ifdef __CUDACC__
#define INFLX_FN __device__ __forceinline__
#else
#define INFLX_FN static inline
#endif
#endif

INFLX_FN double inflx_clamp1(double c) { return c > 1.0 ? 1.0 : c; }

// |num| / (|lhs| + |rhs|), clamped to <= 1, NaN kept
INFLX_FN double inflx_ratio_metric(double num, double lhs, double rhs) {
  return inflx_clamp1(fabs(num) / (fabs(lhs) + fabs(rhs)));
}

// out[0..5] = consistency, eps_V, eps_H, eta_par, delta, omega
INFLX_FN void inflx_tail_complete(double v, double v00, double v10,
                                  double v11, double gsq, double* out) {
  const double lhs = v11 / v;
  const double q0010 = v00 / v10;
  const double q1000 = v10 / v00;
  const double rhs = (3.0 + 3.0 * (q0010 * q0010)) + (v00 / v) * (q1000 * q1000);
  out[0] = inflx_ratio_metric(lhs - rhs, lhs, rhs);

  const double eps_v = gsq / (v * v);
  out[1] = eps_v;

  const double v10s = v10 * v10;
  const double v00s = v00 * v00;
  const double vtt = ((v00 * v10s + v11 * v00s) - (2.0 * v00) * v10s) / (v00s + v10s);
  const double vt2 = eps_v / (1.0 + q0010 * q0010);
  const double eps_h = (3.0 * (eps_v - vt2)) / ((eps_v + fabs(vtt) / v) - vt2);
  out[2] = eps_h;

  const double tan_delta = fabs(q1000);
  const double omega = sqrt((vtt / v) * (3.0 - eps_h));
  out[3] = omega * tan_delta - 3.0;
  out[4] = atan(tan_delta);
  out[5] = omega;
}

// generalised condition: L = V_ww/V - 3, R = 3 (V_vv/V_vw)^2 + (V_vv/V)(V_vw/V_vv)^2
INFLX_FN double inflx_tail_consistency(double v, double v00, double v10,
                                       double v11) {
  const double lhs = v11 / v - 3.0;
  const double q0010 = v00 / v10;
  const double q1000 = v10 / v00;
  const double rhs = 3.0 * (q0010 * q0010) + (v00 / v) * (q1000 * q1000);
  return inflx_ratio_metric(fabs(lhs) - fabs(rhs), lhs, rhs);
}

// original rapid-turn condition: L = V_ww/V, R = 3 (V_vw/V_vv)^2
INFLX_FN double inflx_tail_consistency_rapidturn(double v, double v00,
                                                 double v10, double v11) {
  const double lhs = v11 / v;
  const double q1000 = v10 / v00;
  const double rhs = 3.0 * (q1000 * q1000);
  return inflx_ratio_metric(fabs(lhs) - fabs(rhs), lhs, rhs);
}

// eps_V = 1/2 |grad V|^2 / V^2 (the 1/2 IS present here)
INFLX_FN double inflx_tail_epsilon_v(double v, double gsq) {
  return (0.5 * gsq) / (v * v);
}
