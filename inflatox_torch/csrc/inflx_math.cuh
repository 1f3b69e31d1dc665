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
INFLX_FN double inflx_add(double a, double b) { return __dadd_rn(a, b); }
INFLX_FN double inflx_sub(double a, double b) { return __dsub_rn(a, b); }
INFLX_FN double inflx_mul(double a, double b) { return __dmul_rn(a, b); }
#else
INFLX_FN double inflx_add(double a, double b) { return a + b; }
INFLX_FN double inflx_sub(double a, double b) { return a - b; }
INFLX_FN double inflx_mul(double a, double b) { return a * b; }
#endif
