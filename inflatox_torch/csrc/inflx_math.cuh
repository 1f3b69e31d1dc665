// Round-to-nearest f64 arithmetic that no compiler fuses, for the solver
// library (kernel B6).
//
// The kernel repeats its plain PyTorch version's operations in the same
// order, and each torch operation rounds once.  nvcc builds the solver with
// its default FMA contraction on, because CUDA's pow (called in every
// attempt) then compiles exactly as it does inside torch.pow (with
// -fmad=false it differs in a few of 16.8 million inputs on an H100:
// scripts/probe_torch_pow_fmad.py).  So
// the solver's own sums and products go through these functions: __dadd_rn,
// __dsub_rn and __dmul_rn are never merged into an FMA.  Division, sqrt and
// negation are never contracted.
// Elsewhere (the CPU tests build the headers with the host C++ compiler and
// -ffp-contract=off) they are the plain operators.
//
// inflx_div_fast(a, b, &ok) is a / b on the card as one straight sequence:
// the reciprocal's approximation (rcp.approx), two Newton steps, the
// quotient and one remainder correction.  While both exponents lie in
// [-500, 500] (nothing overflows, underflows or is subnormal) that is the
// correctly rounded quotient, the operator's result bit for bit
// (scripts/probe_solver_chain.py checks it against a / b on 2 x 2^32 random
// pairs); outside that range it clears ok, and the caller computes with the
// operator instead.  The operator ends in a range check and a branch to its
// slow path, which cuts the code at every division: on an H100 one division
// took 111 cycles of a dependent chain and two independent ones 223, where
// this sequence takes 71 and lets independent divisions overlap.  Off the
// card it is the operator.
#pragma once
#include <math.h>

#ifndef INFLX_FN
#ifdef __CUDACC__
#define INFLX_FN __device__ __forceinline__
#else
#define INFLX_FN static inline
#endif
#endif
// code kept out of line: a fallback that the hot path only branches to
#ifndef INFLX_COLD
#ifdef __CUDACC__
#define INFLX_COLD __device__ __noinline__
#else
#define INFLX_COLD static
#endif
#endif

#ifdef __CUDACC__
INFLX_FN double inflx_add(double a, double b) { return __dadd_rn(a, b); }
INFLX_FN double inflx_sub(double a, double b) { return __dsub_rn(a, b); }
INFLX_FN double inflx_mul(double a, double b) { return __dmul_rn(a, b); }
INFLX_FN double inflx_div_fast(double a, double b, bool* ok) {
  const unsigned ea = ((unsigned)__double2hiint(a) >> 20) & 0x7ffu;
  const unsigned eb = ((unsigned)__double2hiint(b) >> 20) & 0x7ffu;
  *ok = *ok & (ea - 523u <= 1000u) & (eb - 523u <= 1000u);
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(b));
  double e = __fma_rn(-b, y, 1.0);
  y = __fma_rn(y, e, y);
  e = __fma_rn(-b, y, 1.0);
  y = __fma_rn(y, e, y);
  const double q = __dmul_rn(a, y);
  return __fma_rn(__fma_rn(-b, q, a), y, q);
}
#else
INFLX_FN double inflx_add(double a, double b) { return a + b; }
INFLX_FN double inflx_sub(double a, double b) { return a - b; }
INFLX_FN double inflx_mul(double a, double b) { return a * b; }
INFLX_FN double inflx_div_fast(double a, double b, bool* ok) {
  (void)ok;
  return a / b;
}
#endif
