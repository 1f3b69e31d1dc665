"""Does CUDA's libm, built by nvcc with and without FMA contraction, round as
torch's elementwise functions do on the card?  The functions are those that
kernel B8 (inflatox_torch/csrc/special.cuh) and its plain version
(inflatox_torch/lowering/special.py) call: lgamma, erf, erfc, exp, log, sin,
cos, sinh, cosh, in f64 and f32.

    python scripts/probe_special_libm.py

Needs one NVIDIA GPU and nvcc.  Builds one small kernel per function twice
(``-fmad=true``, as the solver library is built, and ``-fmad=false``, as the
grid-scan and special-function libraries are) into
``build/special_libm_probe/`` and counts, for 16.8 M inputs per function and
type spread over its domain, the results that differ from torch's, and the
largest difference in units in the last place.  A B8 path that is not bit
for bit its plain version on the card is explained by a nonzero count here.
Prints one line per (function, type, flag) and a JSON summary; writes it to
``build/special_libm_probe/report.json`` too.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

FUNCTIONS = {  # name → (torch function, input range)
    "lgamma": (torch.lgamma, (-30.0, 60.0)),
    "erf": (torch.erf, (-6.0, 6.0)),
    "erfc": (torch.erfc, (-6.0, 27.0)),
    "exp": (torch.exp, (-700.0, 700.0)),
    "log": (torch.log, (1e-6, 1e6)),
    "sin": (torch.sin, (-100.0, 100.0)),
    "cos": (torch.cos, (-100.0, 100.0)),
    "sinh": (torch.sinh, (-40.0, 40.0)),
    "cosh": (torch.cosh, (-40.0, 40.0)),
}

SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#define K(name)                                                                   \
  __global__ void k_##name##_d(const double* x, double* y, int64_t n) {           \
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                   \
    if (i < n) y[i] = name(x[i]);                                                 \
  }                                                                               \
  __global__ void k_##name##_f(const float* x, float* y, int64_t n) {             \
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                   \
    if (i < n) y[i] = name##f(x[i]);                                              \
  }                                                                               \
  extern "C" int run_##name(int f32, const void* x, void* y, int64_t n) {         \
    unsigned b = (unsigned)((n + 255) / 256);                                     \
    if (f32) k_##name##_f<<<b, 256>>>((const float*)x, (float*)y, n);             \
    else k_##name##_d<<<b, 256>>>((const double*)x, (double*)y, n);              \
    return (int)cudaDeviceSynchronize();                                          \
  }
K(lgamma) K(erf) K(erfc) K(exp) K(log) K(sin) K(cos) K(sinh) K(cosh)
"""


def _ulps(a, b):
    """|a − b| in units in the last place of b (finite pairs only)."""
    both = torch.isfinite(a) & torch.isfinite(b)
    spacing = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) - b.abs()
    u = ((a - b).abs() / spacing)[both & (spacing > 0)]
    return u.max().item() if u.numel() else 0.0


def main():
    if not torch.cuda.is_available():
        print("probe_special_libm: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "build", "special_libm_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "libm.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    libs = {}
    for fmad in ("true", "false"):
        path = os.path.join(out_dir, f"libm_fmad_{fmad}.so")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        f"-fmad={fmad}", "-shared", "-Xcompiler", "-fPIC", "-o", path, src],
                       check=True)
        libs[fmad] = ctypes.CDLL(path)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.cuda.get_device_name(0)}; {card.strip()}; torch {torch.__version__}")
    generator = torch.Generator(device="cuda").manual_seed(0)
    report = []
    for name, (fn, (lo, hi)) in FUNCTIONS.items():
        for dtype in (torch.float64, torch.float32):
            x = torch.empty(1 << 24, dtype=torch.float64, device="cuda").uniform_(
                lo, hi, generator=generator).to(dtype)
            want = fn(x)
            for fmad, lib in libs.items():
                run = getattr(lib, f"run_{name}")
                run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
                y = torch.empty_like(x)
                assert run(int(dtype == torch.float32), x.data_ptr(), y.data_ptr(),
                           x.numel()) == 0
                same = (y == want) | (torch.isnan(y) & torch.isnan(want))
                differ = int((~same).sum().item())
                ulps = _ulps(y, want)
                report.append({"function": name, "dtype": str(dtype).split(".")[-1],
                               "fmad": fmad, "inputs": x.numel(), "differ": differ,
                               "max_ulps": ulps})
                print(f"{name} {str(dtype).split('.')[-1]} -fmad={fmad}: {differ} of "
                      f"{x.numel()} differ from torch.{name}, at most {ulps:.1f} ulp")
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
