// Kernels B1, B2 and B4: the grid scan of the Anguelova-Lazaroiu analysis
// in f64, f32 and double-double; kernels B5a and B5b: the same analysis at
// given field-space points, in f64 and double-double.
//
// One source, built once per (model, precision): the generated header
// (inflx_model.h) sets INFLX_PRECISION and defines the model functions in
// that precision.  Every library has the same C interface.
//
// B1 replaces the TPU kernel _kernel_df/_launch_df
// (inflatox_tpu/ops/pallas_kernels.py:388-533), which evaluates the model in
// double-f32 pairs because Mosaic has no f64.  Hopper has IEEE f64, so the
// (hi, lo) arithmetic, the strip-mining and tile heuristics (_auto_tile,
// _pick_strip) and the scalar prefetch are not carried over.
//
// B2 replaces the fp32 kernel _kernel/_launch (pallas_kernels.py:231-285):
// the same source in float.  Its coordinates are those of the TPU kernel,
// x0a + i*dx0 in f32 from f32 scalars, not f64 coordinates rounded.
//
// B4 replaces the triple-f32 kernel _kernel_tf/_launch_tf
// (pallas_kernels.py:1536-1615): coordinates x0a + i*dx0 in double-double
// (exact), the model in double-double (dd.cuh), demoted to f64, then the
// f64 tail; B4 is bound by its f64 operations (a double-double add is about
// twenty), not by its writes.
//
// The generated header splits each model function into three stages by
// what its values read: a row stage (x[0] and the parameters), a column
// stage (x[1] and the parameters) and a point stage (both), each value
// computed once with its operations in their order, so the split changes
// no bit.  A block covers kRows rows × 256 columns, j fastest, so each
// output plane is written coalesced.  Lane l of warp f computes the row
// stage of the kind's function f for the block's row l into shared memory;
// each thread keeps its column's column stage in registers; after a barrier
// each thread runs the point stage and the point tail (anguelova.cuh) on
// each of the block's rows and writes n_out planes of (n0, n1).  At EGNO's
// and D5's sizes that takes the r-only pow/log/sqrt and the θ-only cos/sin
// out of the per-point work (PERF.md).  Each thread derives its own
// coordinates, as the TPU kernel does from program_id + iota: the only
// input read is the parameter vector.  Coordinates are written with
// explicit round-to-nearest add and multiply, so nvcc cannot contract them
// into an FMA: they equal the plain version's bit for bit
// (inflatox_torch/ops/grid.py).  dx0 = (x0b - x0a)/n0 comes from the host.
//
// Kernels B7a, B7b and B7d are B1, B2 and B4 over a batch of S parameter
// sets (inflx_grid_scan_batch): the set is a third grid axis, and one
// launch scans every set of a parameter sweep.  They replace the TPU's
// batched kernels _kernel_df_batch, _kernel_f32_batch and _kernel_tf_batch
// with their launchers (inflatox_tpu/ops/pallas_kernels.py:536-676,
// 1689-1760), which prefetch an (S, n_scalars) row of (hi, lo) or triple
// f32 scalars for each set; _kernel_edf_batch (:678-770, the
// range-extended one) maps onto B7a, as B3 maps onto B1.  Set s reads
// parameter row s of a contiguous (S, INFLX_NP) array and writes its n_out
// planes at out + s * n_out * n0 * n1: the (S, n_out, n0, n1) layout that the
// JAX sweep returns.  Set s is blockIdx.z, so one launch takes at most 65535
// sets (gridDim.z's limit; the wrapper launches once per 65535), and every
// offset is int64.  The batch adds no arithmetic: each set is bit for bit
// the single scan of that set, and inflx_grid_scan is the batch of one.  A
// loop over the sets in the kernel (blockIdx.z striding) made the single
// scans of the byte-bound kinds up to a third slower (PERF.md).
// Bound as B1, B2, B4: the writes, or B4's f64 operations.
//
// Kernel B5a (points_scan_kernel) replaces the TPU's on-trajectory kernels
// _kernel_df_ot/_kernel_edf_ot/_launch_ot
// (inflatox_tpu/ops/pallas_kernels.py:1055-1160), which split each point
// into (hi, lo) f32 pairs padded with 1.0 into (32, 128) blocks and write
// f32 output pairs; B5b, the double-double build, replaces _kernel_tf_ot
// (:1101).  Here the points are exact f64: one thread per point i of a
// contiguous (n, 2) tensor reads x[2i], x[2i+1], evaluates the whole model
// functions (its points share nothing) and the tail, and writes n_out
// planes of (n,), coalesced.  B5a's
// bound is bytes: 16 bytes read and 8·n_out written per point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inflx_model.h"
#include "anguelova.cuh"

// INFLX_PRECISION: the ids of inflatox_torch.ops.cuda_kernels.PRECISIONS
#define INFLX_F64 0
#define INFLX_F32 1
#define INFLX_DD 2

enum {
  KIND_COMPLETE_ANALYSIS = 0,
  KIND_CONSISTENCY = 1,
  KIND_CONSISTENCY_RAPIDTURN = 2,
  KIND_EPSILON_V = 3,
  KIND_POTENTIAL = 4,
  KIND_HESSE = 5,
  KIND_GRADIENT = 6,
};

// real_t: parameters, model values, the tail and the outputs;
// coord_t: what the model functions take (coordinates and parameters)
#if INFLX_PRECISION == INFLX_F32
typedef float real_t;
typedef float coord_t;
__device__ __forceinline__ coord_t inflx_coord(double a, double d, int64_t i) {
  return __fadd_rn((float)a, __fmul_rn((float)i, (float)d));
}
#elif INFLX_PRECISION == INFLX_DD
typedef double real_t;
typedef dd coord_t;
__device__ __forceinline__ coord_t inflx_coord(double a, double d, int64_t i) {
  return dd_add(dd_c(a), dd_two_prod((double)i, d));
}
#else
typedef double real_t;
typedef double coord_t;
__device__ __forceinline__ coord_t inflx_coord(double a, double d, int64_t i) {
  return __dadd_rn(a, __dmul_rn((double)i, d));
}
#endif

__device__ __forceinline__ coord_t inflx_point(real_t v) {
#if INFLX_PRECISION == INFLX_DD
  return dd_c(v);
#else
  return v;
#endif
}

static const int kThreads = 256;
static const int64_t kMaxGridY = 65535;
// The most sets one inflx_grid_scan_batch launch takes (gridDim.z's limit).
static const int64_t kMaxSets = 65535;
// Rows of one block, at most 32 (one lane of a warp per row).
// scripts/probe_grid_stages.py measures other values with -DINFLX_ROWS.
#ifndef INFLX_ROWS
#define INFLX_ROWS 16
#endif
static const int kRows = INFLX_ROWS;
static_assert(kRows >= 1 && kRows <= 32, "INFLX_ROWS must be in 1..32");

// The model functions each kind evaluates.
__host__ __device__ constexpr bool inflx_uses_v(int kind) {
  return kind != KIND_HESSE && kind != KIND_GRADIENT;
}
__host__ __device__ constexpr bool inflx_uses_hesse(int kind) {
  return kind == KIND_COMPLETE_ANALYSIS || kind == KIND_CONSISTENCY ||
         kind == KIND_CONSISTENCY_RAPIDTURN || kind == KIND_HESSE;
}
__host__ __device__ constexpr bool inflx_uses_gsq(int kind) {
  return kind == KIND_COMPLETE_ANALYSIS || kind == KIND_EPSILON_V;
}
__host__ __device__ constexpr bool inflx_uses_grad(int kind) { return kind == KIND_GRADIENT; }

// Where each function's row values (r) and column values (c) sit in a
// kind's arrays: V, then the Hesse, |grad V|^2 and the gradient, each
// present only if the kind uses it.
template <int KIND>
struct inflx_layout {
  static constexpr int v_r = 0, v_c = 0;
  static constexpr int h_r = v_r + (inflx_uses_v(KIND) ? F_V_NR : 0);
  static constexpr int h_c = v_c + (inflx_uses_v(KIND) ? F_V_NC : 0);
  static constexpr int s_r = h_r + (inflx_uses_hesse(KIND) ? F_HESSE_NR : 0);
  static constexpr int s_c = h_c + (inflx_uses_hesse(KIND) ? F_HESSE_NC : 0);
  static constexpr int g_r = s_r + (inflx_uses_gsq(KIND) ? F_GSQ_NR : 0);
  static constexpr int g_c = s_c + (inflx_uses_gsq(KIND) ? F_GSQ_NC : 0);
  static constexpr int nr = g_r + (inflx_uses_grad(KIND) ? F_GRAD_NR : 0);
  static constexpr int nc = g_c + (inflx_uses_grad(KIND) ? F_GRAD_NC : 0);
  static constexpr int n_fns = inflx_uses_v(KIND) + inflx_uses_hesse(KIND) +
                               inflx_uses_gsq(KIND) + inflx_uses_grad(KIND);
};

// Row stage of the kind's function number f (in the layout's order), from
// x[0]: writes that function's row values to r.
template <int KIND>
__device__ __forceinline__ void inflx_row_stage(int f, const coord_t* x, const coord_t* p,
                                                coord_t* r) {
  typedef inflx_layout<KIND> L;
  int k = 0;
  if (inflx_uses_v(KIND)) {
    if (f == k) f_V_row(x, p, r + L::v_r);
    ++k;
  }
  if (inflx_uses_hesse(KIND)) {
    if (f == k) f_hesse_row(x, p, r + L::h_r);
    ++k;
  }
  if (inflx_uses_gsq(KIND)) {
    if (f == k) f_gsq_row(x, p, r + L::s_r);
    ++k;
  }
  if (inflx_uses_grad(KIND) && f == k) f_grad_row(x, p, r + L::g_r);
}

// Column stage of every function of the kind, from x[1].
template <int KIND>
__device__ __forceinline__ void inflx_col_stage(const coord_t* x, const coord_t* p,
                                                coord_t* c) {
  typedef inflx_layout<KIND> L;
  if (inflx_uses_v(KIND)) f_V_col(x, p, c + L::v_c);
  if (inflx_uses_hesse(KIND)) f_hesse_col(x, p, c + L::h_c);
  if (inflx_uses_gsq(KIND)) f_gsq_col(x, p, c + L::s_c);
  if (inflx_uses_grad(KIND)) f_grad_col(x, p, c + L::g_c);
}

// The model functions at one point: from the row values r and column
// values c of the kind's layout (the grid kernels), or whole (the point
// kernels, whose points share nothing).
template <int KIND>
struct inflx_staged {
  typedef inflx_layout<KIND> L;
  const coord_t *x, *p, *r, *c;
  __device__ __forceinline__ real_t V() const { return f_V_point(x, p, r + L::v_r, c + L::v_c); }
  __device__ __forceinline__ void hesse(real_t* h) const {
    f_hesse_point(x, p, r + L::h_r, c + L::h_c, h);
  }
  __device__ __forceinline__ real_t gsq() const {
    return f_gsq_point(x, p, r + L::s_r, c + L::s_c);
  }
  __device__ __forceinline__ void grad(real_t* g) const {
    f_grad_point(x, p, r + L::g_r, c + L::g_c, g);
  }
};
struct inflx_whole {
  const coord_t *x, *p;
  __device__ __forceinline__ real_t V() const { return f_V(x, p); }
  __device__ __forceinline__ void hesse(real_t* h) const { f_hesse(x, p, h); }
  __device__ __forceinline__ real_t gsq() const { return f_gsq(x, p); }
  __device__ __forceinline__ void grad(real_t* g) const { f_grad(x, p, g); }
};

// One kind at one point: writes o[k * plane] for the kind's n_out planes.
template <int KIND, typename M>
__device__ __forceinline__ void inflx_evaluate(const M& m, real_t* o, int64_t plane) {
  if (KIND == KIND_POTENTIAL) {
    o[0] = m.V();
    return;
  }
  if (KIND == KIND_GRADIENT) {
    real_t g[2];
    m.grad(g);
    o[0] = g[0];
    o[plane] = g[1];
    return;
  }
  real_t h[4];  // V_vv, V_vw, V_wv, V_ww
  if (KIND == KIND_HESSE) {
    m.hesse(h);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k * plane] = h[k];
    return;
  }
  const real_t v = m.V();
  if (KIND == KIND_EPSILON_V) {
    o[0] = inflx_tail_epsilon_v(v, m.gsq());
    return;
  }
  m.hesse(h);
  if (KIND == KIND_COMPLETE_ANALYSIS) {
    real_t t[6];
    inflx_tail_complete(v, h[0], h[2], h[3], m.gsq(), t);
#pragma unroll
    for (int k = 0; k < 6; ++k) o[k * plane] = t[k];
  } else if (KIND == KIND_CONSISTENCY) {
    o[0] = inflx_tail_consistency(v, h[0], h[2], h[3]);
  } else {
    o[0] = inflx_tail_consistency_rapidturn(v, h[0], h[2], h[3]);
  }
}

// The parameters as the model functions take them: the device vector
// itself, or (double-double) a per-thread copy with lo = 0.
#if INFLX_PRECISION == INFLX_DD
#define INFLX_PARAMS(p_in)                                           \
  coord_t p[INFLX_NP + 1];                                           \
  for (int t = 0; t < INFLX_NP; ++t) p[t] = dd_c(p_in[t]);
#else
#define INFLX_PARAMS(p_in) const real_t* __restrict__ p = p_in;
#endif

// Output planes of each kind (KINDS in inflatox_torch/ops/cuda_kernels.py).
__host__ __device__ constexpr int inflx_n_out(int kind) {
  return kind == KIND_COMPLETE_ANALYSIS ? 6
       : kind == KIND_HESSE             ? 4
       : kind == KIND_GRADIENT          ? 2
                                        : 1;
}

// A block covers kRows rows × kThreads columns.  Lane l of warp f computes
// the row stage of the kind's function f for the block's row l into shared
// memory; every thread keeps its column's column stage in registers; after
// the barrier each thread runs the point stage and the tail for its column
// on each of the block's rows, each row's planes stored coalesced.
// set_stride: n_out * n0 * n1, the distance between two sets' outputs.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
grid_scan_kernel(const real_t* __restrict__ p_sets, real_t* __restrict__ out,
                 double x0a, double dx0, double x1a, double dx1,
                 int64_t n0, int64_t n1, int64_t set_stride) {
  typedef inflx_layout<KIND> L;
  static_assert(L::n_fns * 32 <= kThreads, "a warp for each function's row stage");
  __shared__ coord_t rows[kRows][L::nr > 0 ? L::nr : 1];
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = n0 * n1;
  const unsigned s = blockIdx.z;  // the parameter set
  const real_t* p_in = p_sets + (size_t)s * INFLX_NP;
  INFLX_PARAMS(p_in)
  out += s * set_stride;
  coord_t x[2];
  x[1] = inflx_coord(x1a, dx1, j);
  coord_t c[L::nc > 0 ? L::nc : 1];
  inflx_col_stage<KIND>(x, p, c);
  const int lane = threadIdx.x % 32;
  for (int64_t i0 = (int64_t)blockIdx.y * kRows; i0 < n0; i0 += (int64_t)gridDim.y * kRows) {
    if (lane < kRows && i0 + lane < n0) {
      coord_t xr[2];
      xr[0] = inflx_coord(x0a, dx0, i0 + lane);
      xr[1] = x[1];
      inflx_row_stage<KIND>(threadIdx.x / 32, xr, p, rows[lane]);
    }
    __syncthreads();
    if (j < n1) {
      const int n_rows = n0 - i0 < kRows ? (int)(n0 - i0) : kRows;
      for (int k = 0; k < n_rows; ++k) {
        x[0] = inflx_coord(x0a, dx0, i0 + k);
        const inflx_staged<KIND> m = {x, p, rows[k], c};
        inflx_evaluate<KIND>(m, out + (i0 + k) * n1 + j, plane);
      }
    }
    __syncthreads();
  }
}

// One thread per point: the whole model functions.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
points_scan_kernel(const real_t* __restrict__ p_in, const real_t* __restrict__ pts,
                   real_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  INFLX_PARAMS(p_in)
  const coord_t x[2] = {inflx_point(pts[2 * i]), inflx_point(pts[2 * i + 1])};
  const inflx_whole m = {x, p};
  inflx_evaluate<KIND>(m, out + i, n);
}

#define INFLX_ANALYSIS_CASES(LAUNCH)                                   \
  case KIND_COMPLETE_ANALYSIS: LAUNCH(KIND_COMPLETE_ANALYSIS); break;  \
  case KIND_CONSISTENCY: LAUNCH(KIND_CONSISTENCY); break;              \
  case KIND_CONSISTENCY_RAPIDTURN: LAUNCH(KIND_CONSISTENCY_RAPIDTURN); break; \
  case KIND_EPSILON_V: LAUNCH(KIND_EPSILON_V); break;

extern "C" {

// The precision this library was built for (INFLX_PRECISION).
int inflx_precision() { return INFLX_PRECISION; }

// The most sets one inflx_grid_scan_batch call takes.
int64_t inflx_max_sets() { return kMaxSets; }

// Launch one scan of each of n_sets (1 .. inflx_max_sets()) parameter sets
// on `stream`; returns cudaGetLastError() (0 on success).  p: (n_sets,
// n_params) real_t on the device (null when n_params is 0); out: (n_sets,
// n_out, n0, n1) real_t on the device (real_t: float for f32, else double).
int inflx_grid_scan_batch(int kind, const void* p, void* out, double x0a,
                          double dx0, double x1a, double dx1, int64_t n0,
                          int64_t n1, int64_t n_sets, void* stream) {
  if (n0 <= 0 || n1 <= 0 || n_sets <= 0 || n_sets > kMaxSets)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const int64_t row_blocks = (n0 + kRows - 1) / kRows;
  const dim3 grid((unsigned)((n1 + kThreads - 1) / kThreads),
                  (unsigned)(row_blocks < kMaxGridY ? row_blocks : kMaxGridY),
                  (unsigned)n_sets);
  cudaStream_t s = (cudaStream_t)stream;
  const real_t* pp = (const real_t*)p;
  real_t* po = (real_t*)out;
#define INFLX_GRID(K)                                                     \
  grid_scan_kernel<K><<<grid, block, 0, s>>>(pp, po, x0a, dx0, x1a, dx1, \
                                             n0, n1, inflx_n_out(K) * n0 * n1)
  switch (kind) {
    INFLX_ANALYSIS_CASES(INFLX_GRID)
    case KIND_POTENTIAL: INFLX_GRID(KIND_POTENTIAL); break;
    case KIND_HESSE: INFLX_GRID(KIND_HESSE); break;
    case KIND_GRADIENT: INFLX_GRID(KIND_GRADIENT); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef INFLX_GRID
  return (int)cudaGetLastError();
}

// Launch one scan on `stream` (the batch of one); p: n_params real_t on the
// device; out: n_out * n0 * n1 real_t on the device.
int inflx_grid_scan(int kind, const void* p, void* out, double x0a,
                    double dx0, double x1a, double dx1, int64_t n0,
                    int64_t n1, void* stream) {
  return inflx_grid_scan_batch(kind, p, out, x0a, dx0, x1a, dx1, n0, n1, 1,
                               stream);
}

// Launch one point scan (the four analysis kinds) on `stream`; returns
// cudaGetLastError().  p: n_params real_t; pts: (n, 2) real_t; out:
// n_out * n real_t, all on the device.
int inflx_points_scan(int kind, const void* p, const void* pts, void* out,
                      int64_t n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  const real_t* pp = (const real_t*)p;
  const real_t* px = (const real_t*)pts;
  real_t* po = (real_t*)out;
#define INFLX_POINTS(K) points_scan_kernel<K><<<grid, block, 0, s>>>(pp, px, po, n)
  switch (kind) {
    INFLX_ANALYSIS_CASES(INFLX_POINTS)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef INFLX_POINTS
  return (int)cudaGetLastError();
}

const char* inflx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
