// Kernel B1: the native-f64 grid scan of the Anguelova-Lazaroiu analysis.
//
// Replaces the TPU kernel _kernel_df/_launch_df
// (inflatox_tpu/ops/pallas_kernels.py:388-533), which evaluates the model in
// double-f32 pairs because Mosaic has no f64.  Hopper has IEEE f64, so the
// (hi, lo) arithmetic, the strip-mining and tile heuristics (_auto_tile,
// _pick_strip) and the scalar prefetch are not carried over.
//
// One thread per grid point (i, j), j fastest, so each output plane is
// written coalesced.  Each thread derives its own coordinates, as the TPU
// kernel does from program_id + iota: the only input read is the parameter
// vector.  It evaluates the generated model functions (inflx_model.h), then
// the point tail (anguelova.cuh), and writes n_out f64 planes of (n0, n1).
//
// Coordinates are x = x0a + i*dx0 with explicit round-to-nearest add and
// multiply, so nvcc cannot contract them into an FMA: they are bit-equal to
// the torch grid (ops/grid.py).  dx0 = (x0b - x0a)/n0 comes from the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inflx_model.h"
#include "anguelova.cuh"

enum {
  KIND_COMPLETE_ANALYSIS = 0,
  KIND_CONSISTENCY = 1,
  KIND_CONSISTENCY_RAPIDTURN = 2,
  KIND_EPSILON_V = 3,
};

static const int kThreads = 256;
static const int64_t kMaxGridY = 65535;

template <int KIND>
__global__ void __launch_bounds__(kThreads)
grid_scan_kernel(const double* __restrict__ p, double* __restrict__ out,
                 double x0a, double dx0, double x1a, double dx1,
                 int64_t n0, int64_t n1) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n1) return;
  const int64_t plane = n0 * n1;
  double x[2];
  x[1] = __dadd_rn(x1a, __dmul_rn((double)j, dx1));
  for (int64_t i = blockIdx.y; i < n0; i += gridDim.y) {
    x[0] = __dadd_rn(x0a, __dmul_rn((double)i, dx0));
    double* o = out + i * n1 + j;
    const double v = f_V(x, p);
    if (KIND == KIND_EPSILON_V) {
      o[0] = inflx_tail_epsilon_v(v, f_gsq(x, p));
      continue;
    }
    const double v00 = f_h00(x, p);
    const double v10 = f_h10(x, p);
    const double v11 = f_h11(x, p);
    if (KIND == KIND_COMPLETE_ANALYSIS) {
      double r[6];
      inflx_tail_complete(v, v00, v10, v11, f_gsq(x, p), r);
#pragma unroll
      for (int k = 0; k < 6; ++k) o[k * plane] = r[k];
    } else if (KIND == KIND_CONSISTENCY) {
      o[0] = inflx_tail_consistency(v, v00, v10, v11);
    } else {
      o[0] = inflx_tail_consistency_rapidturn(v, v00, v10, v11);
    }
  }
}

extern "C" {

// Launch one scan on `stream`; returns cudaGetLastError() (0 on success).
// p: n_params f64 on the device; out: n_out * n0 * n1 f64 on the device.
int inflx_grid_scan(int kind, const void* p, void* out, double x0a,
                    double dx0, double x1a, double dx1, int64_t n0,
                    int64_t n1, void* stream) {
  if (n0 <= 0 || n1 <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const dim3 grid((unsigned)((n1 + kThreads - 1) / kThreads),
                  (unsigned)(n0 < kMaxGridY ? n0 : kMaxGridY));
  cudaStream_t s = (cudaStream_t)stream;
  const double* pp = (const double*)p;
  double* po = (double*)out;
  switch (kind) {
    case KIND_COMPLETE_ANALYSIS:
      grid_scan_kernel<KIND_COMPLETE_ANALYSIS><<<grid, block, 0, s>>>(
          pp, po, x0a, dx0, x1a, dx1, n0, n1);
      break;
    case KIND_CONSISTENCY:
      grid_scan_kernel<KIND_CONSISTENCY><<<grid, block, 0, s>>>(
          pp, po, x0a, dx0, x1a, dx1, n0, n1);
      break;
    case KIND_CONSISTENCY_RAPIDTURN:
      grid_scan_kernel<KIND_CONSISTENCY_RAPIDTURN><<<grid, block, 0, s>>>(
          pp, po, x0a, dx0, x1a, dx1, n0, n1);
      break;
    case KIND_EPSILON_V:
      grid_scan_kernel<KIND_EPSILON_V><<<grid, block, 0, s>>>(
          pp, po, x0a, dx0, x1a, dx1, n0, n1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* inflx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
