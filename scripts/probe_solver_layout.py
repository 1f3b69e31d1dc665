"""Does the output layout of kernel B6 (the background solver) matter?

    python scripts/probe_solver_layout.py

Needs one NVIDIA GPU and nvcc.  Builds ``inflatox_torch/csrc/solver.cuh`` for
hyperinflation with the solver library's flags into
``build/solver_layout_probe/``, as one kernel with two output layouts:

* ``traj_fastest`` — kernel B6's own, (steps, 2n+2, B) with the trajectory
  index fastest: a warp's 32 stores of one component cover 256 contiguous
  bytes;
* ``rows_direct`` — (B, steps, 2n+2): each thread writes its own rows, and
  neighbouring threads write steps·(2n+2)·8 bytes apart.

It runs the JAX package's bench cfg5d (4096 trajectories × 2000 rows,
RKF45, max_err 1e-6, initial fields uniform(1.5, 2.5)² from
``default_rng(0)``, zero velocities, mass 1), checks that both layouts hold
the numbers of ``solve_cuda``, and times them with CUDA events in turns
(traj_fastest, rows_direct, rows_direct, traj_fastest), three rounds.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import inflatox_torch  # noqa: E402
from inflatox_torch.ops.build import CSRC, NVCC_FLAGS, find_nvcc  # noqa: E402
from inflatox_torch.ops.cuda_solver import solve_cuda  # noqa: E402

BATCH, STEPS, MAX_ERR = 4096, 2000, 1e-6
N_TIMED = 20  # chained launches per window (~0.3 s)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "inflx_model.h"
#include "solver.cuh"

template <bool TRAJ_FASTEST>
__global__ void __launch_bounds__(32)
probe(const double* f0, const double* d0, const double* p, double* out,
      int64_t n, int64_t steps, double max_err, double inv_max_err) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  if (TRAJ_FASTEST) {
    inflx_solve_trajectory<INFLX_RKF45>(f0 + b * INFLX_NF, d0 + b * INFLX_NF, p,
        steps, max_err, inv_max_err, out + b, (int64_t)(INFLX_NY + 1) * n, n);
  } else {
    inflx_solve_trajectory<INFLX_RKF45>(f0 + b * INFLX_NF, d0 + b * INFLX_NF, p,
        steps, max_err, inv_max_err, out + b * steps * (INFLX_NY + 1), INFLX_NY + 1, 1);
  }
}

extern "C" int run(int traj_fastest, const void* f0, const void* d0, const void* p,
                   void* out, int64_t n, int64_t steps, double max_err,
                   double inv_max_err, void* stream) {
  const dim3 grid((unsigned)((n + 31) / 32)), block(32);
  cudaStream_t s = (cudaStream_t)stream;
  const double *pf = (const double*)f0, *pd = (const double*)d0, *pp = (const double*)p;
  if (traj_fastest) {
    probe<true><<<grid, block, 0, s>>>(pf, pd, pp, (double*)out, n, steps, max_err, inv_max_err);
  } else {
    probe<false><<<grid, block, 0, s>>>(pf, pd, pp, (double*)out, n, steps, max_err, inv_max_err);
  }
  return (int)cudaGetLastError();
}
"""


def window_ms(fn, n):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0])
    model, args = inflatox_torch.models.hyperinflation()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    out_dir = os.path.join(REPO, "build", "solver_layout_probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "inflx_model.h"), "w") as f:
        f.write(art.cuda_solver_source())
    src, lib_path = os.path.join(out_dir, "probe.cu"), os.path.join(out_dir, "probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", out_dir, "-I", str(CSRC), "-o", lib_path,
                    src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.run.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr, i64, i64, f64, f64, ptr]

    rng = np.random.default_rng(0)
    f0 = torch.tensor(np.stack([rng.uniform(1.5, 2.5, BATCH), rng.uniform(1.5, 2.5, BATCH)], 1),
                      device="cuda")
    d0 = torch.zeros_like(f0)
    p = torch.tensor(np.asarray(args, dtype=np.float64), device="cuda")
    ny = 2 * art.n_fields + 1
    outs = {"traj_fastest": torch.empty((STEPS, ny + 1, BATCH), dtype=torch.float64,
                                        device="cuda"),
            "rows_direct": torch.empty((BATCH, STEPS, ny + 1), dtype=torch.float64,
                                       device="cuda")}

    def launcher(name):
        def launch():
            err = lib.run(int(name == "traj_fastest"), f0.data_ptr(), d0.data_ptr(),
                          p.data_ptr(), outs[name].data_ptr(), BATCH, STEPS, MAX_ERR,
                          1.0 / MAX_ERR, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        return launch

    launch = {name: launcher(name) for name in outs}
    for fn in launch.values():
        fn()
    rows, times = solve_cuda(art, p, STEPS, f0, d0, MAX_ERR, "rkf")
    want = torch.cat([rows, times[..., None]], -1)
    for name, got in (("traj_fastest", outs["traj_fastest"].permute(2, 0, 1)),
                      ("rows_direct", outs["rows_direct"])):
        same = torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        print(f"{name}: equals solve_cuda's rows and times: {same}")
        assert same, name
    for round_ in range(3):
        a0 = window_ms(launch["traj_fastest"], N_TIMED)
        b0 = window_ms(launch["rows_direct"], N_TIMED)
        b1 = window_ms(launch["rows_direct"], N_TIMED)
        a1 = window_ms(launch["traj_fastest"], N_TIMED)
        print(f"round {round_}: traj_fastest {a0:.4f}, {a1:.4f} ms; rows_direct {b0:.4f}, "
              f"{b1:.4f} ms ({N_TIMED} chained launches per window, {BATCH}x{STEPS} RKF45)")


if __name__ == "__main__":
    main()
