// Kernel B9: the survey's per-trajectory reduction of kernel B6's rows, in
// native f64.
//
// It replaces no TPU kernel.  The JAX package reduces a survey's rows with
// jitted jnp (inflatox_tpu/background.py, _survey_reduce), which XLA fuses
// on the TPU.  The port's plain version of that reduction
// (ops/cuda_survey.py, survey_reduce_torch) is about 40 torch operations
// over (B, steps) arrays, each one kernel that reads or writes the whole
// array (about 2 ms a call at 4096 x 2000 on an H100); this kernel reads
// B6's rows once and writes only the summaries.
//
// What it computes, per trajectory, rounded as the plain version rounds it
// on the CPU (torch's CPU cumsum sums in order; every sum, product and
// quotient below is one IEEE operation, none fused):
//
//   Ḣ_s = -0.5 · G_ab χ^a χ^b (inflx_chi_sq: CompiledModel.inner_prod's
//         terms in its order), ε_s = (-Ḣ_s) / (H_s · H_s);
//   N_0 = 0, N_s = N_{s-1} + (0.5 · (H_s + H_{s-1})) · Δt
//                          + ((Δt · Δt) / 12) · (Ḣ_{s-1} - Ḣ_s);
//   start = the first row finite (ε finite, H > 0) with ε < 1; i = the first
//   finite row after it with ε >= 1; the crossing interpolated linearly in ε
//   between rows i-1 and i (frac = (1 - ε_{i-1}) / (ε_i - ε_{i-1}), 0 where
//   they are equal): N_inflation = N(crossing) - N_start, H_end, x_end; NaN
//   where the trajectory did not end; N_span = N at the last row.
//
// Where the metric calls a libm function, the card's libm may round a last
// bit otherwise than the host's, as everywhere in the port.
//
// What bounds it: bytes.  It reads every row and time once, B x steps x
// (2n + 2) x 8 bytes: 393 MB at 4096 x 2000, n = 2, which takes 0.117 ms at
// 3.35 TB/s.  It does about 30 f64 operations a row (0.25 GFLOP there).
//
// Design.  N is a running sum taken in order, so each trajectory's N is one
// serial chain, and 4096 trajectories make only 128 warps to carry 393 MB.
// A block takes 32 trajectories, one a lane, over all their rows, in tiles
// of T rows, with two kinds of warp:
//   * W staging warps copy tile j+2 from device memory into shared memory
//     with cp.async (in B6's layout, (steps, 2n+2, B), one component of one
//     row of 32 trajectories is 256 contiguous bytes), three tiles in a
//     ring, so that two tiles are in flight while the warps evaluate tile j:
//     each takes U consecutive rows of it (and the row before them again)
//     and writes each row's segment of the e-fold integral and its flags
//     (finite with ε < 1; finite with ε >= 1) to shared memory;
//   * one walking warp takes tile j-1's segments and flags in order, a lane
//     a trajectory: the running sum, the two first-row searches and the sums
//     at those rows, in registers, with selects and no branches.
// One barrier a tile; T = W x U.  The evaluation, not the copies, set the
// time: its two divisions a row are inflx_div_fast, which overlap, with
// the operator out of line where they leave its range, and there are many
// staging warps.  At the end the walking warp reads the two rows about the
// crossing again from device memory and writes the summaries.
//
// The ring holds 3 x T x (2n+2) x 32 doubles.  Where it does not fit in a
// block's shared memory even with one staging warp (n >= 74), the kernel is
// launched without it (kRing false): the same warps read their rows straight
// from device memory, where one component of one row of the 32 trajectories
// is still 256 contiguous bytes, and nothing else changes.
//
// The row functions below are INFLX_FN, so that the CPU tests build them
// with the host's C++ compiler; the kernel is CUDA only.  The including
// file first includes the generated model header (INFLX_NF, inflx_chi_sq)
// and solver.cuh (INFLX_NY).
#pragma once
#include <math.h>
#include <stdint.h>

#include "inflx_math.cuh"

enum { INFLX_SURVEY_BELOW = 1, INFLX_SURVEY_CROSS = 2 };

// a / b, correctly rounded: on the card inflx_div_fast (no branch, so that
// independent divisions overlap) with the operator out of line where an
// exponent lies outside its range (a zero numerator among them)
INFLX_COLD double inflx_survey_div_cold(double a, double b) { return a / b; }
INFLX_FN double inflx_survey_div(double a, double b) {
  bool ok = true;
  const double q = inflx_div_fast(a, b, &ok);
  return ok ? q : inflx_survey_div_cold(a, b);
}

// Ḣ and ε of one row y = [x, χ, H]
INFLX_FN void inflx_survey_eps(const double* y, const double* p, double* hdot,
                               double* eps) {
  const double hd = inflx_mul(-0.5, inflx_chi_sq(y, y + INFLX_NF, p));
  *hdot = hd;
  *eps = inflx_survey_div(-hd, inflx_mul(y[2 * INFLX_NF], y[2 * INFLX_NF]));
}

// finite (ε finite, H > 0) with ε < 1, finite with ε >= 1, or neither
INFLX_FN int inflx_survey_flags(double eps, double hub) {
  if (!(isfinite(eps) && hub > 0.0)) return 0;
  return eps < 1.0 ? INFLX_SURVEY_BELOW : INFLX_SURVEY_CROSS;
}

// the e-fold integral's segment from row s-1 (h0, t0, hd0) to row s
INFLX_FN double inflx_survey_seg(double h0, double t0, double hd0, double h1,
                                 double t1, double hd1) {
  const double dt = inflx_sub(t1, t0);
  return inflx_add(inflx_mul(inflx_mul(0.5, inflx_add(h1, h0)), dt),
                   inflx_mul(inflx_survey_div(inflx_mul(dt, dt), 12.0), inflx_sub(hd0, hd1)));
}

// One trajectory's walk over its rows in order.
struct inflx_survey_walk {
  double n;        // N at the row walked last
  double n_start;  // N at the first finite row with ε < 1
  double n_lo;     // N at rows i-1 and i, about the crossing
  double n_hi;
  int64_t i;       // the crossing row; -1 before it is found
  bool started;
};

INFLX_FN inflx_survey_walk inflx_survey_begin() {
  inflx_survey_walk w;
  w.n = 0.0;
  w.n_start = 0.0;
  w.n_lo = 0.0;
  w.n_hi = 0.0;
  w.i = -1;
  w.started = false;
  return w;
}

// row s, with its segment (0 at row 0, so that N_0 = 0 + 0 = 0) and flags;
// selects, no branches: the walking warp runs this once a row
INFLX_FN void inflx_survey_step(inflx_survey_walk* w, int64_t s, double seg, int flags) {
  const double prev = w->n;
  const double n = inflx_add(prev, seg);
  const bool start = !w->started && (flags & INFLX_SURVEY_BELOW);
  const bool cross = w->started && w->i < 0 && (flags & INFLX_SURVEY_CROSS);
  w->n = n;
  w->n_start = start ? n : w->n_start;
  w->started = w->started || start;
  w->n_lo = cross ? prev : w->n_lo;
  w->n_hi = cross ? n : w->n_hi;
  w->i = cross ? s : w->i;
}

// The summaries of a walked trajectory from rows i-1 (lo) and i (hi), read
// only where it ended: N_inflation, H_end, x_end (x_end[c * x_stride]).
INFLX_FN void inflx_survey_finish(const inflx_survey_walk* w, const double* lo,
                                  const double* hi, const double* p, double* n_inf,
                                  double* h_end, double* x_end, int64_t x_stride) {
  if (w->i < 0) {
    *n_inf = NAN;
    *h_end = NAN;
    for (int c = 0; c < INFLX_NF; ++c) x_end[c * x_stride] = NAN;
    return;
  }
  double hd, e0, e1;
  inflx_survey_eps(lo, p, &hd, &e0);
  inflx_survey_eps(hi, p, &hd, &e1);
  const double frac = e1 != e0 ? inflx_sub(1.0, e0) / inflx_sub(e1, e0) : 0.0;
  const double n = inflx_add(w->n_lo, inflx_mul(frac, inflx_sub(w->n_hi, w->n_lo)));
  *n_inf = inflx_sub(n, w->n_start);
  const int h = 2 * INFLX_NF;
  *h_end = inflx_add(lo[h], inflx_mul(frac, inflx_sub(hi[h], lo[h])));
  for (int c = 0; c < INFLX_NF; ++c)
    x_end[c * x_stride] = inflx_add(lo[c], inflx_mul(frac, inflx_sub(hi[c], lo[c])));
}

#ifdef __CUDACC__

// The ring's depth in tiles, rows a staging warp evaluates in a tile, and
// the most staging warps a block has (fewer for models with many fields,
// so that the ring fits in shared memory; all of them without the ring).
// Other values, timed at 4096 x 2000 rows of two fields on an H100: 15
// warps of 4 rows with a ring of two, 0.144 ms against these 0.146; 8 warps
// of 4 rows, 0.165; the same copies and walk with no evaluation, 0.130.
static const int kSurveyStages = 3;
static const int kSurveyRows = 2;
static const int kSurveyWarps = 16;

__device__ __forceinline__ void inflx_cp_async8(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void inflx_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void inflx_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes of shared memory for W staging warps, with the ring or without it
static inline size_t inflx_survey_smem(int W, bool ring) {
  const size_t T = (size_t)W * kSurveyRows;
  return 8 * ((ring ? kSurveyStages * T * (INFLX_NY + 1) * 32 : 0)  // the ring of row tiles
              + 2 * T * 32                                          // segments, two tiles
              + 2 * 3 * 32)                                         // a tile's last row
         + 2 * T * 32;                                              // flags, two tiles
}

// rows: (steps, 2n+2, n_traj) f64, component 2n+1 the time; p: parameters,
// row b at p + b * p_stride; out: (n_traj, n+3) f64 per trajectory
// [N_inflation, H_end, x_end[n], N_span]; ended: (n_traj,) bytes 0 or 1.
// The block has W staging warps and the walking warp, W * 32 + 32 threads;
// without the ring (kRing false) the staging warps read their rows from
// `rows` in place.
template <bool kRing>
__global__ void __launch_bounds__((kSurveyWarps + 1) * 32)
survey_reduce_kernel(const double* __restrict__ rows, const double* __restrict__ p,
                     int64_t p_stride, int64_t n_traj, int64_t steps,
                     double* __restrict__ out, unsigned char* __restrict__ ended) {
  const int C = INFLX_NY + 1;
  const int U = kSurveyRows;
  const int S = kSurveyStages;
  const int W = (int)(blockDim.x / 32) - 1;
  const int T = W * U;
  extern __shared__ double smem[];
  double* ring = smem;                            // [S][T][C][32], or none
  double* segs = ring + (kRing ? S * T * C * 32 : 0);  // [2][T][32]
  double* carry = segs + 2 * T * 32;              // [2][3][32]: H, t, Ḣ
  unsigned char* flags = (unsigned char*)(carry + 2 * 3 * 32);  // [2][T][32]

  const int warp = (int)(threadIdx.x / 32);
  const int lane = (int)(threadIdx.x % 32);
  const int64_t b = (int64_t)blockIdx.x * 32 + lane;
  const bool live = b < n_traj;
  const double* pb = p == nullptr ? p : p + (live ? b : 0) * p_stride;
  const double* own = rows + (live ? b : 0);  // this lane's trajectory in place
  const int64_t plane = (int64_t)C * n_traj;  // one row of every trajectory
  const int64_t n_tiles = (steps + T - 1) / T;

  // staging warps: tile j's rows into its slot of the ring, as one group
  auto stage = [&](int64_t j) {
    if (kRing && j < n_tiles && live) {
      double* dst = ring + (j % S) * T * C * 32 + lane;
      const double* src = rows + j * T * plane + b;
      const int n = (int)(j * T + T <= steps ? T : steps - j * T) * C;
      for (int q = warp; q < n; q += W) inflx_cp_async8(dst + q * 32, src + (q / C) * plane + (q % C) * n_traj);
    }
    inflx_cp_async_commit();
  };

  inflx_survey_walk w = inflx_survey_begin();
  if (kRing && warp < W) {
    for (int j = 0; j < S - 1; ++j) stage(j);
  }
  for (int64_t j = 0; j <= n_tiles; ++j) {
    if (kRing && warp < W) inflx_cp_async_wait<S - 2>();
    // tile j has landed; tile j-1's segments are written; every warp is
    // done with tile j-1's slot of the ring and tile j-2's segments
    __syncthreads();
    if (warp < W) {
      if (kRing) stage(j + S - 1);
      const int r0 = warp * U;
      const int64_t s0 = j * T + r0;
      if (j == n_tiles || s0 >= steps) continue;
      const int n_rows = (int)(s0 + U <= steps ? U : steps - s0);
      // component c of the tile's row r: in the ring, or in place
      const double* tile = ring + (j % S) * T * C * 32 + lane;
      auto at = [&](int r, int c) {
        return kRing ? tile[(r * C + c) * 32] : own[(j * T + r) * plane + c * n_traj];
      };
      double* seg_out = segs + (j & 1) * T * 32 + lane;
      unsigned char* flag_out = flags + (j & 1) * T * 32 + lane;
      // H, t and Ḣ of this warp's rows, and of the row before the first: in
      // this tile, or carried over from the last
      double h[U + 1], t[U + 1], hd[U + 1], eps[U + 1];
#pragma unroll
      for (int u = 0; u <= U; ++u) {
        const int r = r0 + u - 1;
        if (u > n_rows || (u == 0 && r0 == 0)) continue;
        double y[INFLX_NY];
#pragma unroll
        for (int c = 0; c < INFLX_NY; ++c) y[c] = at(r, c);
        t[u] = at(r, C - 1);
        h[u] = y[2 * INFLX_NF];
        inflx_survey_eps(y, pb, &hd[u], &eps[u]);
      }
      if (r0 == 0) {
        const double* from = carry + ((j - 1) & 1) * 3 * 32 + lane;
        const bool first = s0 == 0;  // row 0: no row before it, segment 0
        h[0] = first ? 0.0 : from[0];
        t[0] = first ? 0.0 : from[32];
        hd[0] = first ? 0.0 : from[64];
      }
#pragma unroll
      for (int u = 1; u <= U; ++u) {
        if (u > n_rows) continue;
        const int r = r0 + u - 1;
        seg_out[r * 32] = s0 + u - 1 == 0 ? 0.0
                                          : inflx_survey_seg(h[u - 1], t[u - 1], hd[u - 1],
                                                             h[u], t[u], hd[u]);
        flag_out[r * 32] = (unsigned char)inflx_survey_flags(eps[u], h[u]);
      }
      if (r0 + U == T && n_rows == U) {  // the tile's last row, for the next tile
        double* to = carry + (j & 1) * 3 * 32 + lane;
        to[0] = h[U];
        to[32] = t[U];
        to[64] = hd[U];
      }
    } else if (j > 0) {
      const int64_t k = j - 1;
      const double* seg_in = segs + (k & 1) * T * 32 + lane;
      const unsigned char* flag_in = flags + (k & 1) * T * 32 + lane;
      const int n_rows = (int)(k * T + T <= steps ? T : steps - k * T);
#pragma unroll 8
      for (int r = 0; r < n_rows; ++r)
        inflx_survey_step(&w, k * T + r, seg_in[r * 32], flag_in[r * 32]);
    }
  }
  if (warp < W || !live) return;
  double lo[INFLX_NY], hi[INFLX_NY];
  if (w.i >= 0) {
    for (int c = 0; c < INFLX_NY; ++c) {
      lo[c] = rows[(w.i - 1) * plane + c * n_traj + b];
      hi[c] = rows[w.i * plane + c * n_traj + b];
    }
  }
  double* o = out + b * (INFLX_NF + 3);
  inflx_survey_finish(&w, lo, hi, pb, o, o + 1, o + 2, 1);
  o[INFLX_NF + 2] = w.n;
  ended[b] = w.i >= 0 ? 1 : 0;
}

#endif  // __CUDACC__
