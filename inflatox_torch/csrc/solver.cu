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
//
// Work counter: given a `counts` pointer, inflx_solve launches the COUNT
// instance of the kernel, in which each thread keeps its attempts and its
// rejected attempts in registers and adds them at the end to counts[0]
// (attempts, summed over trajectories) and counts[2] (rejects, summed), and
// lane 0 of each warp adds (lanes that hold a trajectory) × (the most
// attempts any of them made) to counts[1]: what the warp's lock-step costs,
// so counts[0] / counts[1] is the share of lanes doing work, and counts[2] /
// counts[0] the share of attempts thrown away.  Without it, the instance
// that counts nothing runs, compiled as before the counter existed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inflx_model.h"
#include "solver.cuh"
#include "survey.cuh"

static const int kThreads = 32;

template <int METHOD, bool COUNT>
__global__ void __launch_bounds__(kThreads)
solve_kernel(const double* __restrict__ fields0,
             const double* __restrict__ derivs0, const double* __restrict__ p,
             int64_t p_stride, double* __restrict__ out, int64_t n_traj,
             int64_t steps, double max_err, double inv_max_err,
             unsigned long long* __restrict__ counts) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (!COUNT) {
    if (b >= n_traj) return;
    inflx_solve_trajectory<METHOD>(
        fields0 + b * INFLX_NF, derivs0 + b * INFLX_NF,
        p == nullptr ? p : p + b * p_stride, steps, max_err, inv_max_err,
        out + b, (int64_t)(INFLX_NY + 1) * n_traj, n_traj);
    return;
  }
  // every lane of the warp (a block) stays to the end, for the warp's max
  const bool live = b < n_traj;
  unsigned long long attempts = 0;
  if (live) {
    int64_t rejects = 0;
    attempts = (unsigned long long)inflx_solve_trajectory<METHOD, true>(
        fields0 + b * INFLX_NF, derivs0 + b * INFLX_NF,
        p == nullptr ? p : p + b * p_stride, steps, max_err, inv_max_err,
        out + b, (int64_t)(INFLX_NY + 1) * n_traj, n_traj, &rejects);
    atomicAdd(counts, attempts);
    atomicAdd(counts + 2, (unsigned long long)rejects);
  }
  const unsigned lanes = __ballot_sync(0xffffffffu, live);
  unsigned long long most = attempts;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, most, offset);
    most = other > most ? other : most;
  }
  if (threadIdx.x == 0) atomicAdd(counts + 1, (unsigned long long)__popc(lanes) * most);
}

extern "C" {

// Launch one batched solve on `stream`; returns cudaGetLastError() (0 on
// success).  fields0, derivs0: (n_traj, INFLX_NF) f64; p: parameters, row b
// at p + b * p_stride (p_stride 0: shared); out: (steps, 2 INFLX_NF + 2,
// n_traj) f64; counts: null (count nothing) or three u64 (attempts,
// lane_attempts, rejects) that the solve adds to; all on the device.
int inflx_solve(int method, const void* fields0, const void* derivs0,
                const void* p, int64_t p_stride, void* out, int64_t n_traj,
                int64_t steps, double max_err, double inv_max_err,
                void* stream, void* counts) {
  if (n_traj <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const dim3 grid((unsigned)((n_traj + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  const double* f0 = (const double*)fields0;
  const double* d0 = (const double*)derivs0;
  const double* pp = (const double*)p;
  double* po = (double*)out;
  unsigned long long* pc = (unsigned long long*)counts;
#define INFLX_SOLVE_LAUNCH(M, C)                                             \
  solve_kernel<M, C><<<grid, block, 0, s>>>(f0, d0, pp, p_stride, po, n_traj, \
                                           steps, max_err, inv_max_err, pc)
  switch (method) {
    case INFLX_RKF45:
      if (pc == nullptr) INFLX_SOLVE_LAUNCH(INFLX_RKF45, false);
      else INFLX_SOLVE_LAUNCH(INFLX_RKF45, true);
      break;
    case INFLX_RK4:
      if (pc == nullptr) INFLX_SOLVE_LAUNCH(INFLX_RK4, false);
      else INFLX_SOLVE_LAUNCH(INFLX_RK4, true);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef INFLX_SOLVE_LAUNCH
  return (int)cudaGetLastError();
}

// Launch kernel B9 (survey.cuh), the survey's reduction of one solve's
// rows, on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.  rows: (steps,
// 2 INFLX_NF + 2, n_traj) f64, inflx_solve's output; p, p_stride as for
// inflx_solve; out: (n_traj, INFLX_NF + 3) f64, per trajectory
// [N_inflation, H_end, x_end[INFLX_NF], N_span]; ended: (n_traj,) bytes;
// all on the device.  The block has kSurveyWarps staging warps where
// the ring of row tiles fits in shared memory, fewer for models with many
// fields, and kSurveyWarps again, reading in place, where it does not fit
// with one (any field count runs).
int inflx_survey_reduce(const void* rows, const void* p, int64_t p_stride,
                        int64_t n_traj, int64_t steps, void* out, void* ended,
                        void* stream) {
  if (n_traj <= 0 || steps < 2) return (int)cudaErrorInvalidValue;
  const size_t budget = 225 * 1024;  // of the 227 KB a block may have
  int W = kSurveyWarps;
  while (W > 1 && inflx_survey_smem(W, true) > budget) --W;
  const bool ring = inflx_survey_smem(W, true) <= budget;
  if (!ring) W = kSurveyWarps;
  const size_t bytes = inflx_survey_smem(W, ring);
  decltype(&survey_reduce_kernel<true>) kernel =
      ring ? &survey_reduce_kernel<true> : &survey_reduce_kernel<false>;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((n_traj + 31) / 32));
  kernel<<<grid, (W + 1) * 32, bytes, (cudaStream_t)stream>>>(
      (const double*)rows, (const double*)p, p_stride, n_traj, steps, (double*)out,
      (unsigned char*)ended);
  return (int)cudaGetLastError();
}

int inflx_n_fields(void) { return INFLX_NF; }

const char* inflx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
