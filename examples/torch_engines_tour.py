"""Tour of the engines and precisions on one model, in PyTorch.

Run with `python examples/torch_engines_tour.py [--device cuda|cpu]` — on
the NVIDIA GPU (the default) every row but the reference runs a hand-written
kernel; `--device cpu` runs each row's plain PyTorch version on the CPU.

The `inflatox_torch` version of examples/engines_tour.py.  Runs the same
complete-analysis window on every route and prints a small
agreement/throughput table: the plain PyTorch version in f64 (the reference
row), then the kernels in f64 (B1: what the JAX package's "pallas_df64" and
"pallas_edf64" emulate in double-f32), f32 (B2: its "pallas") and
double-double (B4: its "pallas_tf64").  Each wall time includes the first
call's kernel build; run twice to see the warm times.

See docs/manual.md ("Engines and precision") for when to use which.
"""

import argparse

try:  # installed wheel, or repo checkout
    import inflatox_torch  # noqa: F401
except ModuleNotFoundError:
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import time

import numpy as np
import sympy
import torch

import inflatox_torch as inflatox
from inflatox_torch.consistency_conditions import GeneralisedAL


def build_model():
    """The doc-example (hyperinflation) model, compiled."""
    r, th, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (th**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = inflatox.InflationModelBuilder.new([r, th], g, V, silent=True).build()
    return inflatox.Compiler(model, silent=True).compile()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--n", type=int, default=256, help="grid points per axis")
    opts = parser.parse_args(argv)
    device = torch.device(opts.device)
    engine = "cuda" if device.type == "cuda" else "torch"

    al = GeneralisedAL(build_model(), device=device)

    args = np.array([1.0])
    extent = (0.5, 2.5, 0.25, 3.0)
    N = opts.n
    out = {"rows": {}}

    ref = None
    routes = (("reference", "torch", "f64"), ("f64", engine, "f64"), ("f32", engine, "f32"),
              ("dd", engine, "dd"))
    for key, row_engine, precision in routes:
        t0 = time.perf_counter()
        maps = al.complete_analysis(
            args, *extent, N, N, progress=False, engine=row_engine, precision=precision
        )
        wall = time.perf_counter() - t0
        maps = np.stack(maps)
        if ref is None:
            ref = maps
            worst = None
            agree = "—  (reference)"
        else:
            worst = 0.0
            for got, want in zip(maps.astype(np.float64), ref):
                both = np.isfinite(got) & np.isfinite(want)
                rel = np.abs(got[both] - want[both]) / np.maximum(
                    np.abs(want[both]), 1e-300
                )
                worst = max(worst, float(np.median(rel)))
            agree = f"median dev vs torch f64 ≤ {worst:.1e}"
        out["rows"][key] = {"wall_ms": wall * 1e3, "nanmax": float(np.nanmax(maps[0])),
                            "median_dev": worst, "maps": maps}
        print(
            f"{row_engine + ' ' + precision:14s}  wall {wall*1e3:8.1f} ms   "
            f"nanmax(consistency) = {np.nanmax(maps[0]):.3f}   {agree}"
        )

    # the f64 kernel's pair output: per quantity (hi, lo) f32 planes on the
    # device, hi = f32(v), lo = f32(v - hi)
    pairs = al.complete_analysis(
        args, *extent, N, N, progress=False, engine=engine, precision="f64", output="pair"
    )
    hi, lo = pairs[0]
    out["pair_value"] = float(hi[0, 0]) + float(lo[0, 0])
    print(
        f"pair output: consistency as (hi, lo) f32 planes, "
        f"value[0,0] = {out['pair_value']:.6f}"
    )
    return out


if __name__ == "__main__":
    main()
