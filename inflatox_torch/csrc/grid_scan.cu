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
// A launch may scan rows row0 .. row0 + n0 - 1 of a larger grid
// (inflx_grid_scan_rows, a sharded scan's shard): row i's coordinate is
// x0a + (row0 + i)*dx0 with the whole grid's x0a and dx0, the same bits as
// that row of the whole scan (a local start x0a + row0*dx0 would round
// otherwise).
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
// contiguous (n, 2) tensor reads x[2i], x[2i+1], runs the header's fused
// point function of the kind (f_point_<kind>: V, the Hesse and |grad V|^2
// as the kind needs them, hash-consed together, so that each heavy call --
// kernel B8's out-of-line special-function routes, dd.cuh's exp, log and
// pow -- is made once a point however many model functions share it; then
// the tail) and writes n_out planes of (n,), coalesced.  Points share
// nothing, so the grid kernels' row and column stages do not apply.  B5a
// is bound by its operations on the special-function models (B8) and by
// its bytes otherwise (16 read and 8·n_out written per point); B5b by its
// double-double operations.  The launch shape follows the bound (below,
// INFLX_POINT_BLOCKS): warps in flight for the byte-bound models, at most
// 128 or 64 registers for double-double and B8.  The special-function
// models run the coherent kernel: each block sorts its tile of points by a
// coarse cell before it evaluates them, so that a warp takes neighbouring
// points, and with them the same B8 routes.

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
// Threads of a point-scan block, and the blocks that __launch_bounds__ asks
// to fit on one SM, by library (scripts/probe_grid_stages.py's trials with
// -DINFLX_POINT_THREADS and -DINFLX_POINT_BLOCKS; PERF.md): double-double,
// two blocks (at most 128 registers: 1.26x faster than one block at 255
// registers, spills included); f64 with special functions
// (INFLX_SPECIAL_FUNCTIONS, from the header), four (at most 64 registers);
// a byte-bound f64 model (INFLX_POINT_BYTE_BOUND, from the header: its
// operations a point below the card's operations per byte moved), five (at
// most 48 registers, 40 warps an SM in flight); otherwise the registers
// ptxas picks.
#ifndef INFLX_POINT_THREADS
#define INFLX_POINT_THREADS 256
#endif
#ifndef INFLX_POINT_BLOCKS
#if INFLX_PRECISION == INFLX_DD
#define INFLX_POINT_BLOCKS 2
#elif defined(INFLX_SPECIAL_FUNCTIONS)
#define INFLX_POINT_BLOCKS 4
#elif defined(INFLX_POINT_BYTE_BOUND)
#define INFLX_POINT_BLOCKS 5
#else
#define INFLX_POINT_BLOCKS 1
#endif
#endif
static const int kPointThreads = INFLX_POINT_THREADS;

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

// The model functions at one point, from the row values r and column values
// c of the kind's layout.
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
                 double x0a, double dx0, double x1a, double dx1, int64_t row0,
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
      xr[0] = inflx_coord(x0a, dx0, row0 + i0 + lane);
      xr[1] = x[1];
      inflx_row_stage<KIND>(threadIdx.x / 32, xr, p, rows[lane]);
    }
    __syncthreads();
    if (j < n1) {
      const int n_rows = n0 - i0 < kRows ? (int)(n0 - i0) : kRows;
      for (int k = 0; k < n_rows; ++k) {
        x[0] = inflx_coord(x0a, dx0, row0 + i0 + k);
        const inflx_staged<KIND> m = {x, p, rows[k], c};
        inflx_evaluate<KIND>(m, out + (i0 + k) * n1 + j, plane);
      }
    }
    __syncthreads();
  }
}

// One analysis kind at one point: the header's fused point function of the
// kind (its model values hash-consed together, each heavy call once, then
// the tail), out[0 .. inflx_n_out(KIND) - 1].
template <int KIND>
__device__ __forceinline__ void inflx_point_fn(const coord_t* x, const coord_t* p, real_t* o) {
  if constexpr (KIND == KIND_COMPLETE_ANALYSIS) {
    f_point_complete_analysis(x, p, o);
  } else if constexpr (KIND == KIND_CONSISTENCY) {
    f_point_consistency(x, p, o);
  } else if constexpr (KIND == KIND_CONSISTENCY_RAPIDTURN) {
    f_point_consistency_rapidturn(x, p, o);
  } else {
    f_point_epsilon_v(x, p, o);
  }
}

// One thread per point.
template <int KIND>
__global__ void __launch_bounds__(kPointThreads, INFLX_POINT_BLOCKS)
points_scan_kernel(const real_t* __restrict__ p_in, const real_t* __restrict__ pts,
                   real_t* __restrict__ out, int64_t n) {
  INFLX_PARAMS(p_in)
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const coord_t x[2] = {inflx_point(pts[2 * i]), inflx_point(pts[2 * i + 1])};
  real_t o[inflx_n_out(KIND)];
  inflx_point_fn<KIND>(x, p, o);
#pragma unroll
  for (int k = 0; k < inflx_n_out(KIND); ++k) out[k * n + i] = o[k];
}

#if INFLX_PRECISION == INFLX_F64 && defined(INFLX_SPECIAL_FUNCTIONS)
// The coherent point scan of the special-function models.  Kernel B8 takes
// one route per argument (a series, a continued fraction, a rational form,
// an asymptotic sum), so a warp whose lanes hold unrelated points runs the
// union of their routes.  A block takes a tile of kTilePoints consecutive
// points, sorts their indices in shared memory by a coarse cell of (x0, x1)
// over the tile's own finite bounding box -- a counting sort: histogram,
// exclusive scan, scatter; x0-major, kPointThreads / 8 cells on x0 and 8 on
// x1 -- and then thread t evaluates the tile's sorted points t,
// t + kPointThreads, ..., so that each warp takes neighbouring points.  Each
// point's arithmetic is unchanged, so are its bits; its outputs go back to
// its own place (the writes of a tile stay within its rows of each plane).
static const int kTileRounds = 4;  // points a thread evaluates
static const int kTilePoints = kTileRounds * kPointThreads;
static const int kCellsX1 = 8;
static const int kCellsX0 = kPointThreads / kCellsX1;
static_assert(kCellsX0 * kCellsX1 == kPointThreads && kCellsX0 > 0, "one bin a thread");

__device__ __forceinline__ unsigned long long inflx_order_key(double v) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}
__device__ __forceinline__ double inflx_order_value(unsigned long long k) {
  return __longlong_as_double((long long)((k >> 63) ? (k & 0x7fffffffffffffffull) : ~k));
}

// The cell of one coordinate among `cells`: 0 for NaN, ±inf at the edges,
// 0 everywhere when the bounds are empty or their width overflows.
__device__ __forceinline__ int inflx_cell(double v, unsigned long long lo_key,
                                          unsigned long long hi_key, int cells) {
  const double lo = inflx_order_value(lo_key), hi = inflx_order_value(hi_key);
  const double scale = hi > lo ? cells / (hi - lo) : 0.0;
  const double c = (v - lo) * (isfinite(scale) ? scale : 0.0);
  return c >= cells ? cells - 1 : (c >= 0.0 ? (int)c : 0);
}

template <int KIND>
__global__ void __launch_bounds__(kPointThreads, INFLX_POINT_BLOCKS)
points_coherent_kernel(const real_t* __restrict__ p_in, const real_t* __restrict__ pts,
                       real_t* __restrict__ out, int64_t n) {
  __shared__ double xs[2][kTilePoints];
  __shared__ unsigned short order[kTilePoints];
  __shared__ int bins[kPointThreads];
  __shared__ int warp_sums[kPointThreads / 32];
  __shared__ unsigned long long lo[2], hi[2];
  INFLX_PARAMS(p_in)
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int64_t base = (int64_t)blockIdx.x * kTilePoints;
  const int count = n - base < kTilePoints ? (int)(n - base) : kTilePoints;
  if (t < 2) {
    lo[t] = ~0ull;
    hi[t] = 0ull;
  }
  bins[t] = 0;
  __syncthreads();
  // the tile's points into shared memory, and their finite bounds
  unsigned long long l[2] = {~0ull, ~0ull}, h[2] = {0ull, 0ull};
  for (int k = t; k < count; k += kPointThreads) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const double v = pts[2 * (base + k) + a];
      xs[a][k] = v;
      if (isfinite(v)) {
        const unsigned long long key = inflx_order_key(v);
        l[a] = key < l[a] ? key : l[a];
        h[a] = key > h[a] ? key : h[a];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    for (int d = 16; d > 0; d /= 2) {
      const unsigned long long lo_d = __shfl_xor_sync(0xffffffffu, l[a], d);
      const unsigned long long hi_d = __shfl_xor_sync(0xffffffffu, h[a], d);
      l[a] = lo_d < l[a] ? lo_d : l[a];
      h[a] = hi_d > h[a] ? hi_d : h[a];
    }
    if (lane == 0) {
      atomicMin(&lo[a], l[a]);
      atomicMax(&hi[a], h[a]);
    }
  }
  __syncthreads();
  // histogram of the cells, x0-major
  int cell[kTileRounds];
#pragma unroll
  for (int j = 0; j < kTileRounds; ++j) {
    const int k = t + j * kPointThreads;
    if (k < count) {
      cell[j] = inflx_cell(xs[0][k], lo[0], hi[0], kCellsX0) * kCellsX1 +
                inflx_cell(xs[1][k], lo[1], hi[1], kCellsX1);
      atomicAdd(&bins[cell[j]], 1);
    }
  }
  __syncthreads();
  // exclusive scan of the bins, one a thread
  const int mine = bins[t];
  int inclusive = mine;
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, inclusive, d);
    if (lane >= d) inclusive += v;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  bins[t] = before + inclusive - mine;
  __syncthreads();
  // scatter: the tile's indices in cell order
#pragma unroll
  for (int j = 0; j < kTileRounds; ++j) {
    const int k = t + j * kPointThreads;
    if (k < count) order[atomicAdd(&bins[cell[j]], 1)] = (unsigned short)k;
  }
  __syncthreads();
  for (int s = t; s < count; s += kPointThreads) {
    const int k = order[s];
    const coord_t x[2] = {xs[0][k], xs[1][k]};
    real_t o[inflx_n_out(KIND)];
    inflx_point_fn<KIND>(x, p, o);
#pragma unroll
    for (int q = 0; q < inflx_n_out(KIND); ++q) out[q * n + base + k] = o[q];
  }
}
#endif

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

// Launch one scan of rows row0 .. row0 + n0 - 1 of the grid x0a + i*dx0,
// x1a + j*dx1 for each of n_sets (1 .. inflx_max_sets()) parameter sets on
// `stream`; returns cudaGetLastError() (0 on success).  p: (n_sets,
// n_params) real_t on the device (null when n_params is 0); out: (n_sets,
// n_out, n0, n1) real_t on the device (real_t: float for f32, else double).
int inflx_grid_scan_rows(int kind, const void* p, void* out, double x0a,
                         double dx0, double x1a, double dx1, int64_t row0,
                         int64_t n0, int64_t n1, int64_t n_sets, void* stream) {
  if (row0 < 0 || n0 <= 0 || n1 <= 0 || n_sets <= 0 || n_sets > kMaxSets)
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
                                             row0, n0, n1, inflx_n_out(K) * n0 * n1)
  switch (kind) {
#ifndef INFLX_POINTS_ONLY  // scripts/probe_grid_stages.py's point-kernel trials
    INFLX_ANALYSIS_CASES(INFLX_GRID)
    case KIND_POTENTIAL: INFLX_GRID(KIND_POTENTIAL); break;
    case KIND_HESSE: INFLX_GRID(KIND_HESSE); break;
    case KIND_GRADIENT: INFLX_GRID(KIND_GRADIENT); break;
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef INFLX_GRID
  return (int)cudaGetLastError();
}

// The whole grid (rows 0 .. n0 - 1) for each of n_sets parameter sets.
int inflx_grid_scan_batch(int kind, const void* p, void* out, double x0a,
                          double dx0, double x1a, double dx1, int64_t n0,
                          int64_t n1, int64_t n_sets, void* stream) {
  return inflx_grid_scan_rows(kind, p, out, x0a, dx0, x1a, dx1, 0, n0, n1,
                              n_sets, stream);
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
  const dim3 block(kPointThreads);
  const dim3 grid((unsigned)((n + kPointThreads - 1) / kPointThreads));
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

// The same through the coherent kernel (the f64 library of a model that
// calls special functions; any other library refuses it).
int inflx_points_scan_coherent(int kind, const void* p, const void* pts, void* out,
                               int64_t n, void* stream) {
#if INFLX_PRECISION == INFLX_F64 && defined(INFLX_SPECIAL_FUNCTIONS)
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kPointThreads);
  const dim3 grid((unsigned)((n + kTilePoints - 1) / kTilePoints));
  cudaStream_t s = (cudaStream_t)stream;
  const real_t* pp = (const real_t*)p;
  const real_t* px = (const real_t*)pts;
  real_t* po = (real_t*)out;
#define INFLX_POINTS(K) points_coherent_kernel<K><<<grid, block, 0, s>>>(pp, px, po, n)
  switch (kind) {
    INFLX_ANALYSIS_CASES(INFLX_POINTS)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef INFLX_POINTS
  return (int)cudaGetLastError();
#else
  (void)kind, (void)p, (void)pts, (void)out, (void)n, (void)stream;
  return (int)cudaErrorInvalidValue;
#endif
}

const char* inflx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
