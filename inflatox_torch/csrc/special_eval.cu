// Kernel B8 (csrc/special.cuh) alone: each special function, at fixed orders
// or with run-time parameters, evaluated over a vector of arguments, one
// thread per argument.  This library serves chip_smoke.py and the card-only
// tests, which hold B8 against its plain version
// (inflatox_torch/lowering/special.py) and time it; the model kernels call
// special.cuh's functions inline and never this library.
//
// One extern "C" entry per function instance, in f64 or f32:
//
//   int inflx_sf_<name>(int f32, double p0, double p1, double p2, double p3,
//                       const void* z, void* out, int64_t n, void* stream)
//
// p0..p3 are the run-time order ν and the hypergeometric parameters a, b, c
// (rounded once to the working type, as the plain version's Python numbers
// are); the return value is the launch's cudaError_t.  Built with
// -fmad=false, as the grid-scan library.  Off the card (the CPU tests build
// this file with the host C++ compiler and -ffp-contract=off) each entry is a
// loop on the host, inflx_sf_<name>_host, without the stream.
#include <stdint.h>

#include "special.cuh"

// (name, expression of x of type T; the parameters p0..p3 as T in n0..n3)
#define INFLX_SF_INSTANCES(X)                          \
  X(besselj_0, (inflx_besselj_int<T, 0>(x)))           \
  X(besselj_1, (inflx_besselj_int<T, 1>(x)))           \
  X(besselj_5, (inflx_besselj_int<T, 5>(x)))           \
  X(besselj_m2, (inflx_besselj_int<T, -2>(x)))         \
  X(besselj_nu, (inflx_besselj<T>(n0, x)))             \
  X(bessely_0, (inflx_bessely_int<T, 0>(x)))           \
  X(bessely_1, (inflx_bessely_int<T, 1>(x)))           \
  X(bessely_5, (inflx_bessely_int<T, 5>(x)))           \
  X(bessely_m2, (inflx_bessely_int<T, -2>(x)))         \
  X(bessely_nu, (inflx_bessely<T>(n0, x)))             \
  X(besseli_0, (inflx_besseli_int<T, 0>(x)))           \
  X(besseli_1, (inflx_besseli_int<T, 1>(x)))           \
  X(besseli_5, (inflx_besseli_int<T, 5>(x)))           \
  X(besseli_m2, (inflx_besseli_int<T, -2>(x)))         \
  X(besseli_nu, (inflx_besseli<T>(n0, x)))             \
  X(besselk_0, (inflx_besselk_int<T, 0>(x)))           \
  X(besselk_1, (inflx_besselk_int<T, 1>(x)))           \
  X(besselk_5, (inflx_besselk_int<T, 5>(x)))           \
  X(besselk_m2, (inflx_besselk_int<T, -2>(x)))         \
  X(besselk_nu, (inflx_besselk<T>(n0, x)))             \
  X(sph_jn_0, (inflx_sph_jn_int<T, 0>(x)))             \
  X(sph_jn_1, (inflx_sph_jn_int<T, 1>(x)))             \
  X(sph_jn_2, (inflx_sph_jn_int<T, 2>(x)))             \
  X(sph_jn_3, (inflx_sph_jn_int<T, 3>(x)))             \
  X(sph_jn_4, (inflx_sph_jn_int<T, 4>(x)))             \
  X(sph_jn_5, (inflx_sph_jn_int<T, 5>(x)))             \
  X(sph_jn_6, (inflx_sph_jn_int<T, 6>(x)))             \
  X(sph_jn_7, (inflx_sph_jn_int<T, 7>(x)))             \
  X(sph_jn_8, (inflx_sph_jn_int<T, 8>(x)))             \
  X(sph_jn_nu, (inflx_sph_jn_frac<T>(p0, x)))          \
  X(sph_jn_half3, (inflx_sph_jn_half<T, 3>(x)))        \
  X(sph_yn_0, (inflx_sph_yn_int<T, 0>(x)))             \
  X(sph_yn_1, (inflx_sph_yn_int<T, 1>(x)))             \
  X(sph_yn_2, (inflx_sph_yn_int<T, 2>(x)))             \
  X(sph_yn_3, (inflx_sph_yn_int<T, 3>(x)))             \
  X(sph_yn_4, (inflx_sph_yn_int<T, 4>(x)))             \
  X(sph_yn_5, (inflx_sph_yn_int<T, 5>(x)))             \
  X(sph_yn_6, (inflx_sph_yn_int<T, 6>(x)))             \
  X(sph_yn_7, (inflx_sph_yn_int<T, 7>(x)))             \
  X(sph_yn_8, (inflx_sph_yn_int<T, 8>(x)))             \
  X(sph_yn_nu, (inflx_sph_yn_frac<T>(p0, x)))          \
  X(sph_yn_half3, (inflx_sph_yn_half<T, 3>(x)))        \
  X(hyp0f1, (inflx_hyp0f1<T>(n0, x)))                  \
  X(hyp1f1, (inflx_hyp1f1<T>(n0, n1, x)))              \
  X(hyp2f1, (inflx_hyp2f1<T>(n0, n1, n2, x)))          \
  X(hyp2f0, (inflx_hyp2f0<T>(n0, n1, x)))              \
  X(erf, (inflx_erf<T>(x)))                            \
  X(erfc, (inflx_erfc<T>(x)))                          \
  X(lgamma, (inflx_lgamma<T>(x)))                      \
  X(gamma, (inflx_gamma<T>(x)))                        \
  X(polygamma_0, (inflx_polygamma<T, 0>(x)))           \
  X(polygamma_1, (inflx_polygamma<T, 1>(x)))           \
  X(polygamma_2, (inflx_polygamma<T, 2>(x)))           \
  X(polygamma_3, (inflx_polygamma<T, 3>(x)))

#define INFLX_SF_FUNCTOR(name, expr)                                            \
  struct sf_##name {                                                            \
    template <typename T>                                                       \
    static ISF_FN T f(T x, double p0, double p1, double p2, double p3) {        \
      const T n0 = (T)p0, n1 = (T)p1, n2 = (T)p2;                               \
      (void)n0; (void)n1; (void)n2; (void)p0; (void)p1; (void)p2; (void)p3;     \
      return expr;                                                              \
    }                                                                           \
  };
INFLX_SF_INSTANCES(INFLX_SF_FUNCTOR)

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <typename F, typename T>
__global__ void inflx_sf_kernel(int64_t n, const T* __restrict__ z, T* __restrict__ out,
                                double p0, double p1, double p2, double p3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = F::f(z[i], p0, p1, p2, p3);
}

template <typename F, typename T>
static int inflx_sf_launch(double p0, double p1, double p2, double p3, const void* z, void* out,
                           int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  inflx_sf_kernel<F, T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      n, (const T*)z, (T*)out, p0, p1, p2, p3);
  return (int)cudaGetLastError();
}

#define INFLX_SF_ENTRY(name, expr)                                                        \
  extern "C" int inflx_sf_##name(int f32, double p0, double p1, double p2, double p3,     \
                                 const void* z, void* out, int64_t n, void* stream) {      \
    return f32 ? inflx_sf_launch<sf_##name, float>(p0, p1, p2, p3, z, out, n, stream)     \
               : inflx_sf_launch<sf_##name, double>(p0, p1, p2, p3, z, out, n, stream);   \
  }
INFLX_SF_INSTANCES(INFLX_SF_ENTRY)

extern "C" const char* inflx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#else
#define INFLX_SF_HOST(name, expr)                                                         \
  extern "C" void inflx_sf_##name##_host(int f32, double p0, double p1, double p2,       \
                                         double p3, const void* z, void* out, int64_t n) { \
    for (int64_t i = 0; i < n; ++i) {                                                     \
      if (f32)                                                                            \
        ((float*)out)[i] = sf_##name::f(((const float*)z)[i], p0, p1, p2, p3);            \
      else                                                                                \
        ((double*)out)[i] = sf_##name::f(((const double*)z)[i], p0, p1, p2, p3);          \
    }                                                                                     \
  }
INFLX_SF_INSTANCES(INFLX_SF_HOST)
#endif
