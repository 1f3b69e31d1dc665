// Kernel B6: the batched adaptive background-EoM solver in native f64.
//
// Replaces the TPU kernel _solver_kernel/_launch_solver
// (inflatox_tpu/ops/pallas_solver.py:173-435), which advances the state in
// double-f32 (hi, lo) pairs with an f32 step controller, in (8, 128) lane
// blocks whose row chunks run along a sequential grid axis with the state
// carried in VMEM scratch, and gives each row at most 8 masked attempts
// because its lanes run in lock-step.  Hopper has IEEE f64 and independent
// threads, so none of that is carried over: one thread integrates one
// trajectory, its state y[2n+1] and stage slopes in registers, and runs the
// row loop and the attempt loop itself (solver.cuh has the integrator and
// its step control, which are background.py's, and why the attempt loop
// needs no cap).  It is templated on the method: RKF45, and RK4 with step
// doubling.
//
// What bounds it: neither bytes nor the f64 rate.  At B = 4096, 2000 rows,
// n = 2 it writes 393 MB (0.12 ms at 3.35 TB/s) and does a few GFLOP, but
// every trajectory is a serial chain of rows × attempts × (stages of model
// evaluations with divisions, a sqrt and a pow), so the time is the latency
// of the longest chain.  Blocks of 32 threads spread 4096 trajectories over
// 128 SMs, one warp each; wider blocks would stack warps on fewer SMs.
// Threads of one warp that need different numbers of attempts wait for each
// other (divergence): that is correct and costs time.
//
// Output layout: (steps, 2n+2, B) with the trajectory index fastest, so a
// warp's 32 stores of one component land on 256 contiguous bytes; the
// wrapper returns (B, steps, 2n+1) rows and (B, steps) times as views.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inflx_model.h"
#include "solver.cuh"

static const int kThreads = 32;

template <int METHOD>
__global__ void __launch_bounds__(kThreads)
solve_kernel(const double* __restrict__ fields0,
             const double* __restrict__ derivs0, const double* __restrict__ p,
             int64_t p_stride, double* __restrict__ out, int64_t n_traj,
             int64_t steps, double max_err, double inv_max_err) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_traj) return;
  inflx_solve_trajectory<METHOD>(
      fields0 + b * INFLX_NF, derivs0 + b * INFLX_NF,
      p == nullptr ? p : p + b * p_stride, steps, max_err, inv_max_err,
      out + b, (int64_t)(INFLX_NY + 1) * n_traj, n_traj);
}

extern "C" {

// Launch one batched solve on `stream`; returns cudaGetLastError() (0 on
// success).  fields0, derivs0: (n_traj, INFLX_NF) f64; p: parameters, row b
// at p + b * p_stride (p_stride 0: shared); out: (steps, 2 INFLX_NF + 2,
// n_traj) f64, all on the device.
int inflx_solve(int method, const void* fields0, const void* derivs0,
                const void* p, int64_t p_stride, void* out, int64_t n_traj,
                int64_t steps, double max_err, double inv_max_err,
                void* stream) {
  if (n_traj <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const dim3 grid((unsigned)((n_traj + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  const double* f0 = (const double*)fields0;
  const double* d0 = (const double*)derivs0;
  const double* pp = (const double*)p;
  double* po = (double*)out;
  switch (method) {
    case INFLX_RKF45:
      solve_kernel<INFLX_RKF45><<<grid, block, 0, s>>>(
          f0, d0, pp, p_stride, po, n_traj, steps, max_err, inv_max_err);
      break;
    case INFLX_RK4:
      solve_kernel<INFLX_RK4><<<grid, block, 0, s>>>(
          f0, d0, pp, p_stride, po, n_traj, steps, max_err, inv_max_err);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int inflx_n_fields(void) { return INFLX_NF; }

const char* inflx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
