"""Do CUDA's f32 library functions, built by nvcc with and without FMA
contraction, round as torch's f32 operations do on the card?

    python scripts/probe_torch_f32_fmad.py

Needs one NVIDIA GPU and nvcc.  Builds one tiny kernel twice (``-fmad=true``
and ``-fmad=false``) into ``build/f32_probe/`` and counts, for 16.8 M f32
inputs spread over the range each function takes, the results that differ
from torch's: ``expf``, ``logf``, ``powf`` (exponents 1.5 and the tensor
exponent -3.7), ``atanf``, ``sqrtf``, ``sinf``, ``cosf``.  Kernel B2 (the f32
grid scan) is built with ``-fmad=false``, as kernel B1 is; this says which
of its library calls keep bit-identity with the plain f32 version.
"""

import ctypes
import os
import subprocess

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
__global__ void k(int fn, const float* x, float* y, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  switch (fn) {
    case 0: y[i] = exp(v); break;
    case 1: y[i] = log(v); break;
    case 2: y[i] = pow(v, 1.5f); break;
    case 3: y[i] = pow(v, -3.7f); break;
    case 4: y[i] = atan(v); break;
    case 5: y[i] = sqrt(v); break;
    case 6: y[i] = sin(v); break;
    default: y[i] = cos(v); break;
  }
}
extern "C" int run(int fn, const void* x, void* y, int64_t n) {
  k<<<(unsigned)((n + 255) / 256), 256>>>(fn, (const float*)x, (float*)y, n);
  return (int)cudaDeviceSynchronize();
}
"""


def main():
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "build", "f32_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "f32.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    generator = torch.Generator(device="cuda").manual_seed(0)
    n = 1 << 24
    wide = torch.exp(torch.empty(n, device="cuda").uniform_(-8, 8, generator=generator))
    signed = torch.empty(n, device="cuda").uniform_(-30, 30, generator=generator)
    cases = [  # (name, inputs, torch's result)
        ("exp", signed, torch.exp(signed)),
        ("log", wide, torch.log(wide)),
        ("pow(x, 1.5)", wide, torch.pow(wide, 1.5)),
        ("pow(x, t) t=-3.7", wide, torch.pow(wide, torch.full_like(wide, -3.7))),
        ("atan", signed, torch.atan(signed)),
        ("sqrt", wide, torch.sqrt(wide)),
        ("sin", signed, torch.sin(signed)),
        ("cos", signed, torch.cos(signed)),
    ]
    print(torch.cuda.get_device_name(0))
    for fmad in ("true", "false"):
        lib_path = os.path.join(out_dir, f"f32_fmad_{fmad}.so")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        f"-fmad={fmad}", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                        src], check=True)
        lib = ctypes.CDLL(lib_path)
        lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        for fn, (name, x, want) in enumerate(cases):
            y = torch.empty_like(x)
            assert lib.run(fn, x.data_ptr(), y.data_ptr(), n) == 0
            same = (y == want) | (torch.isnan(y) & torch.isnan(want))
            print(f"-fmad={fmad} {name}: {(~same).sum().item()} of {n} differ from torch")


if __name__ == "__main__":
    main()
