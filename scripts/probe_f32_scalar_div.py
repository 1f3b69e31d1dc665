"""How does torch divide a float32 CUDA tensor by a Python number?

    python scripts/probe_f32_scalar_div.py

Needs one NVIDIA GPU.  Torch multiplies by the number's reciprocal there
(its CPU-scalar division path).  This probe counts, over 16.8 M float32
values and a few divisors, the results of ``t / s`` that equal each of three
candidates: ``t * f32(1/s)`` (the reciprocal formed in f64 and rounded to
f32 once), ``t * (1/f32(s))`` (formed in f32 from the rounded number) and
the true quotient ``t / f32(s)``.  The f32 model headers
(inflatox_torch/lowering/cuda_codegen.py) write what it reports.
"""

import math
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("probe_f32_scalar_div: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = torch.empty(1 << 24, dtype=torch.float32, device="cuda").uniform_(-4.0, 4.0,
                                                                          generator=gen)
    print(torch.cuda.get_device_name(0), torch.__version__)
    for s in (math.sqrt(math.pi), 3.0, 7.0, 0.1, 1.0 / 3.0, 12.5):
        got = t / s
        f64_rcp = t * torch.tensor(1.0 / s, dtype=torch.float32, device="cuda")
        f32_rcp = t * (1.0 / torch.tensor(s, dtype=torch.float32, device="cuda"))
        true = t / torch.tensor(s, dtype=torch.float32, device="cuda")
        print(f"t / {s!r}: equal to t * f32(1/s) {(got == f64_rcp).double().mean().item():.6f}, "
              f"to t * (1/f32(s)) {(got == f32_rcp).double().mean().item():.6f}, to the true "
              f"quotient {(got == true).double().mean().item():.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
