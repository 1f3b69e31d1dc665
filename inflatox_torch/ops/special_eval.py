"""Kernel B8 alone: each special function of ``csrc/special.cuh`` over a
vector of arguments (``csrc/special_eval.cu``), and its plain version.

B8 is the special functions as ``__device__`` code inside the grid, point and
solver kernels; those kernels call it inline and never this module.  This
wrapper runs one function instance (a function at a fixed order, or with
its run-time order and hypergeometric parameters ``p = (p0, p1, p2, p3)``)
on its own, so that ``chip_smoke.py`` and the card-only tests can hold B8
against :mod:`inflatox_torch.lowering.special` on the card and time it.

* :data:`INSTANCES` — instance name → its plain version ``f(z, p)``, in the
  order of ``INFLX_SF_INSTANCES`` in ``csrc/special_eval.cu``;
* :func:`special_eval_cuda` — on a CUDA tensor it launches the instance's
  kernel on the current stream (no synchronisation) and counts the launch
  under ``"B8"`` in
  :data:`~inflatox_torch.ops.cuda_kernels.LAUNCHES_BY_KERNEL`; on a CPU
  tensor it returns the plain version;
* :func:`special_eval_torch` — the plain version.
"""

from __future__ import annotations

import torch

from ..lowering import special as sp
from .cuda_kernels import LAUNCHES_BY_KERNEL

__all__ = ["INSTANCES", "special_eval_cuda", "special_eval_torch"]


def _orders(name, fn, orders):
    return {f"{name}_{'m' if n < 0 else ''}{abs(n)}": (lambda z, p, n=n: fn(n, z)) for n in orders}


#: instance name → plain version f(z, p)
INSTANCES = {
    **_orders("besselj", sp.besselj, (0, 1, 5, -2)),
    "besselj_nu": lambda z, p: sp._bessjy_frac(p[0], z)[0],
    **_orders("bessely", sp.bessely, (0, 1, 5, -2)),
    "bessely_nu": lambda z, p: sp._bessjy_frac(p[0], z)[1],
    **_orders("besseli", sp.besseli, (0, 1, 5, -2)),
    "besseli_nu": lambda z, p: sp._bessel_frac(p[0], z, modified=True),
    **_orders("besselk", sp.besselk, (0, 1, 5, -2)),
    "besselk_nu": lambda z, p: sp._besselk_frac(p[0], z),
    **_orders("sph_jn", sp.sph_jn, range(9)),
    "sph_jn_nu": lambda z, p: sp.sph_jn(p[0], z),
    "sph_jn_half3": lambda z, p: sp.sph_jn(2.5, z),
    **_orders("sph_yn", sp.sph_yn, range(9)),
    "sph_yn_nu": lambda z, p: sp.sph_yn(p[0], z),
    "sph_yn_half3": lambda z, p: sp.sph_yn(2.5, z),
    "hyp0f1": lambda z, p: sp.hyp0f1(p[0], z),
    "hyp1f1": lambda z, p: sp.hyp1f1(p[0], p[1], z),
    "hyp2f1": lambda z, p: sp.hyp2f1(p[0], p[1], p[2], z),
    "hyp2f0": lambda z, p: sp.hyp2f0(p[0], p[1], z),
    "erf": lambda z, p: sp.erf(z),
    "erfc": lambda z, p: sp.erfc(z),
    "lgamma": lambda z, p: sp.lgamma(z),
    "gamma": lambda z, p: sp.gamma(z),
    **_orders("polygamma", sp.polygamma, range(4)),
}

def _check(name, z, p):
    if name not in INSTANCES:
        raise ValueError(f"unknown special-function instance {name!r}")
    if not torch.is_tensor(z) or z.dtype not in (torch.float64, torch.float32):
        raise TypeError("z must be a float64 or float32 tensor")
    p = tuple(float(v) for v in p) + (0.0,) * (4 - len(p))
    if len(p) != 4:
        raise ValueError("at most four parameters p0..p3")
    return p


def special_eval_torch(name: str, z: torch.Tensor, p=()) -> torch.Tensor:
    """The plain version of instance ``name`` at ``z`` (its device and
    type), with the parameters ``p``."""
    p = _check(name, z, p)
    with sp.suppress_domain_warnings():
        return INSTANCES[name](z, p)


def special_eval_cuda(name: str, z: torch.Tensor, p=()) -> torch.Tensor:
    """Instance ``name`` of kernel B8 at every element of ``z`` (float64 or
    float32), with the run-time order and parameters ``p``.  On a CUDA
    tensor: builds the library (first use), allocates the output with
    ``torch.empty`` and launches on the current stream; a launch error
    raises.  On a CPU tensor: :func:`special_eval_torch`."""
    p = _check(name, z, p)
    if z.device.type == "cpu":
        return special_eval_torch(name, z, p)
    if z.device.type != "cuda":
        raise ValueError(f"special_eval_cuda runs on a CUDA or CPU device, got {z.device}")
    from .build import load_special_eval  # noqa: PLC0415

    lib = load_special_eval()
    with torch.cuda.device(z.device):
        z = z.contiguous()
        out = torch.empty_like(z)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = getattr(lib, f"inflx_sf_{name}")(
            int(z.dtype == torch.float32), *p, z.data_ptr(), out.data_ptr(), z.numel(), stream)
    if err != 0:
        msg = lib.inflx_error_string(err).decode()
        raise RuntimeError(f"special-function kernel {name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES_BY_KERNEL["B8"] += 1
    return out
