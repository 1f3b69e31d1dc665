// Point tail of the (generalised) Anguelova-Lazaroiu analysis, one grid
// point at a time: the formulas of inflatox_torch/ops/anguelova.py (the
// plain-f64 ops of inflatox_tpu/ops/anguelova.py:45-113 and the native C
// oracle, inflatox_tpu/native/codegen.py:253-284), written in the same
// operation order as the torch version so both round alike.
//
// Templated on the type of the analysis: double for kernels B1, B4 and B5,
// float for kernel B2 (every literal is a T, so float code stays float).
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

template <typename T>
INFLX_FN T inflx_clamp1(T c) { return c > T(1) ? T(1) : c; }

// |num| / (|lhs| + |rhs|), clamped to <= 1, NaN kept
template <typename T>
INFLX_FN T inflx_ratio_metric(T num, T lhs, T rhs) {
  return inflx_clamp1(fabs(num) / (fabs(lhs) + fabs(rhs)));
}

// out[0..5] = consistency, eps_V, eps_H, eta_par, delta, omega
template <typename T>
INFLX_FN void inflx_tail_complete(T v, T v00, T v10, T v11, T gsq, T* out) {
  const T lhs = v11 / v;
  const T q0010 = v00 / v10;
  const T q1000 = v10 / v00;
  const T rhs = (T(3) + T(3) * (q0010 * q0010)) + (v00 / v) * (q1000 * q1000);
  out[0] = inflx_ratio_metric(lhs - rhs, lhs, rhs);

  const T eps_v = gsq / (v * v);
  out[1] = eps_v;

  const T v10s = v10 * v10;
  const T v00s = v00 * v00;
  const T vtt = ((v00 * v10s + v11 * v00s) - (T(2) * v00) * v10s) / (v00s + v10s);
  const T vt2 = eps_v / (T(1) + q0010 * q0010);
  const T eps_h = (T(3) * (eps_v - vt2)) / ((eps_v + fabs(vtt) / v) - vt2);
  out[2] = eps_h;

  const T tan_delta = fabs(q1000);
  const T omega = sqrt((vtt / v) * (T(3) - eps_h));
  out[3] = omega * tan_delta - T(3);
  out[4] = atan(tan_delta);
  out[5] = omega;
}

// generalised condition: L = V_ww/V - 3, R = 3 (V_vv/V_vw)^2 + (V_vv/V)(V_vw/V_vv)^2
template <typename T>
INFLX_FN T inflx_tail_consistency(T v, T v00, T v10, T v11) {
  const T lhs = v11 / v - T(3);
  const T q0010 = v00 / v10;
  const T q1000 = v10 / v00;
  const T rhs = T(3) * (q0010 * q0010) + (v00 / v) * (q1000 * q1000);
  return inflx_ratio_metric(fabs(lhs) - fabs(rhs), lhs, rhs);
}

// original rapid-turn condition: L = V_ww/V, R = 3 (V_vw/V_vv)^2
template <typename T>
INFLX_FN T inflx_tail_consistency_rapidturn(T v, T v00, T v10, T v11) {
  const T lhs = v11 / v;
  const T q1000 = v10 / v00;
  const T rhs = T(3) * (q1000 * q1000);
  return inflx_ratio_metric(fabs(lhs) - fabs(rhs), lhs, rhs);
}

// eps_V = 1/2 |grad V|^2 / V^2 (the 1/2 IS present here)
template <typename T>
INFLX_FN T inflx_tail_epsilon_v(T v, T gsq) {
  return (T(0.5) * gsq) / (v * v);
}
