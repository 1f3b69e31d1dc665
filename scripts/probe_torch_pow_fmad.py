"""Does CUDA's f64 pow, built by nvcc with and without FMA contraction,
round as torch.pow does on the card?

    python scripts/probe_torch_pow_fmad.py

Needs one NVIDIA GPU and nvcc.  Builds one tiny kernel twice (``-fmad=true``
and ``-fmad=false``) into ``build/pow_probe/`` and counts, for 16.8 M
inputs spread over 11 decades and the solver's two exponents (1/7 for
RKF45, 1/5 for RK4), the results that differ from ``torch.pow``.  This is
why the port's solver library (kernel B6) is built with nvcc's default
contraction and writes its own arithmetic with non-fusing intrinsics
(inflatox_torch/csrc/inflx_math.cuh).
"""

import ctypes
import os
import subprocess

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void k(const double* x, double* y, int64_t n, double e) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = pow(x[i], e);
}
extern "C" int run(const void* x, void* y, int64_t n, double e) {
  k<<<(unsigned)((n + 255) / 256), 256>>>((const double*)x, (double*)y, n, e);
  return (int)cudaDeviceSynchronize();
}
"""


def main():
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "build", "pow_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "pow.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    generator = torch.Generator(device="cuda").manual_seed(0)
    x = torch.exp(torch.empty(1 << 24, dtype=torch.float64, device="cuda")
                  .uniform_(-3, 8, generator=generator))
    print(torch.cuda.get_device_name(0))
    for fmad in ("true", "false"):
        lib_path = os.path.join(out_dir, f"pow_fmad_{fmad}.so")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        f"-fmad={fmad}", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                        src], check=True)
        lib = ctypes.CDLL(lib_path)
        lib.run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_double]
        for exponent in (1.0 / 7, 1.0 / 5):
            y = torch.empty_like(x)
            assert lib.run(x.data_ptr(), y.data_ptr(), x.numel(), exponent) == 0
            differ = (y != torch.pow(x, exponent)).sum().item()
            print(f"-fmad={fmad} exponent {exponent:.6f}: {differ} of {x.numel()} differ "
                  "from torch.pow")


if __name__ == "__main__":
    main()
