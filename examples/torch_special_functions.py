"""Special-function potentials: Bessel and hypergeometric models, in PyTorch.

Run with `python examples/torch_special_functions.py [--device cuda|cpu]` —
on the NVIDIA GPU (the default) the scans run kernel B1 with the special
functions (kernel B8, csrc/special.cuh) inside; `--device cpu` runs their
plain PyTorch version on the CPU.

The `inflatox_torch` version of examples/special_functions.py.  The
reference transpiles these to GSL calls in its generated C
(compiler.py:158-212, GSLInflatoxPrinter); here the same sympy functions
lower to the port's own implementations (inflatox_torch/lowering/special.py,
and op for op the same as CUDA device code) — integer AND any fractional
order |ν| ≤ 30 for J/Y/I/K, fractional spherical orders, 0F1/1F1/2F1/2F0
and erf/gamma — in IEEE f64 (f32 and double-double also exist: precision=).
"""

import argparse

try:  # installed wheel, or repo checkout
    import inflatox_torch  # noqa: F401
except ModuleNotFoundError:
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import sympy
import torch

import inflatox_torch as inflatox
from inflatox_torch.consistency_conditions import GeneralisedAL


def route(art, device):
    """What a scan of ``art`` runs on ``device``."""
    inside = " with kernel B8 inside" if art.uses_special_functions else ""
    if device.type == "cuda":
        return f"kernel B1{inside}, in f64"
    return "the plain PyTorch version on the CPU, in f64"


def build_models():
    """The Bessel-well and the hypergeometric models, compiled."""
    # ---- 1. a Bessel-well potential with a FRACTIONAL order ---------------- #
    # (any non-integer |ν| ≤ 30 — near-integer orders like 2.01 included)
    x, y, a = sympy.symbols("x y a")
    V_bessel = (
        a * sympy.besselj(sympy.Rational(5, 2), x + 1) ** 2
        + sympy.besselk(sympy.Rational(201, 100), x + 2) * y**2
        + 2
    )
    model = inflatox.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], V_bessel, silent=True, simplify=False,
        assertions=False,
    ).build()

    # ---- 2. the GSL hypergeometric family ---------------------------------- #
    half, th, fh = (sympy.Rational(1, 2), sympy.Rational(3, 2),
                    sympy.Rational(5, 2))
    V_hyp = (
        a * sympy.hyper((half,), (th,), -(x**2))            # 1F1 via 0F1 form
        + sympy.hyper((half, th), (fh,), y**2 / 4) / 10     # 2F1
        + sympy.erf(x) * sympy.gamma(y + 2) / 50 + 2
    )
    model_h = inflatox.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], V_hyp, silent=True, simplify=False,
        assertions=False,
    ).build()
    return (inflatox.Compiler(model, silent=True).compile(),
            inflatox.Compiler(model_h, silent=True).compile())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--n", type=int, default=128, help="grid points per axis of the analysis")
    parser.add_argument("--v-n", type=int, default=64, help="grid points per axis of the V grid")
    opts = parser.parse_args(argv)
    device = torch.device(opts.device)
    out = {}

    art, art_h = build_models()
    out["bessel_route"] = route(art, device)
    print("Bessel model runs on", out["bessel_route"])

    al = GeneralisedAL(art, device=device, validate_basis=False)
    maps = al.complete_analysis(np.array([2.0]), 0.5, 3.0, 0.2, 1.5, opts.n, opts.n,
                                progress=False)
    out["maps"] = np.stack(maps)
    out["finite_fraction"] = float(np.isfinite(maps[0]).mean())
    print("consistency map finite fraction:", out["finite_fraction"])

    out["hyp_route"] = route(art_h, device)
    print("hyp/erf/gamma model runs on", out["hyp_route"])
    al_h = GeneralisedAL(art_h, device=device, validate_basis=False)
    V_grid = al_h.calc_V_array(np.array([2.0]), (0.3, 0.2), (2.0, 1.2),
                               N=(opts.v_n, opts.v_n))
    out["V_grid"] = V_grid
    out["V_grid_finite"] = bool(np.isfinite(V_grid).all())
    print("V grid:", V_grid.shape, "finite:", out["V_grid_finite"])

    # calc_V evaluates one point with the plain version, on the device
    out["V_point"] = al_h.calc_V(np.array([1.0, 0.7]), np.array([2.0]))
    print(f"V(1.0, 0.7) = {out['V_point']:.12f}")
    return out


if __name__ == "__main__":
    main()
