"""End-to-end workflow: survey → solve → normalize → predict, in PyTorch.

Run with `python examples/torch_pipeline.py [--device cuda|cpu]` — on the
NVIDIA GPU (the default) the survey is one launch of kernel B1, every
background solve one launch of kernel B6, and the rest torch operations on
the device; `--device cpu` runs every call's plain version on the CPU.

The `inflatox_torch` version of examples/pipeline.py.  This chains every
layer of the port the way a real analysis does:

1. **survey**: `complete_analysis` maps the consistency condition and the
   slow-roll parameters over the field-space domain in one fused kernel
   launch (the reference's headline capability),
2. **select**: pick an inflating starting point from the ε_V map,
3. **solve**: integrate the background through the end of inflation,
4. **normalize**: COBE-normalize the potential scale so P_ζ(k*) = A_s,
5. **predict**: n_s/r at the horizon-exit pivot plus the full spectra
   from both first-principles routes (δN with f_NL, Mukhanov-Sasaki with
   the exact tensor spectrum and the isocurvature fraction) — none of
   which the reference's design can express (no time axis in its solver
   output, background_solver.rs:283-295).
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
from inflatox_torch import background, observables, perturbations
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.models import alpha_attractor


def build_model():
    """The α-attractor T-model on the hyperbolic disc, compiled, and its
    default parameters."""
    model, args = alpha_attractor()
    return inflatox.Compiler(model, silent=True).compile(), args


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--n", type=int, default=256, help="grid points per axis of the survey")
    parser.add_argument("--steps", type=int, default=3000, help="rows of each background solve")
    parser.add_argument("--pivots", type=int, default=6, help="pivots of the two spectra")
    opts = parser.parse_args(argv)
    device = torch.device(opts.device)
    out = {}

    # ---- 1. survey the field space ---------------------------------------- #
    artifact, args = build_model()
    al = GeneralisedAL(artifact, device=device, validate_basis=False)
    extent = (0.05, 0.995, 0.0, np.pi)          # (r, θ) domain
    maps = al.complete_analysis(args, *extent, opts.n, opts.n)
    eps_v = maps[1]                              # ε_V map, (N, N)
    out["maps"] = np.stack(maps)
    out["frac"] = float(np.mean(np.nan_to_num(eps_v, nan=np.inf) < 1e-2))
    print(f"survey: {out['frac']:.0%} of the domain has ε_V < 0.01 (inflating)")

    # ---- 2/3. pick a deep slow-roll point and solve the background -------- #
    x0 = np.array([0.99, 0.5])                   # large-r plateau, off-axis θ
    rows, times = background.solve_eom(
        artifact, args, opts.steps, x0, np.zeros(2),
        max_err=1e-9, solver="rkf", return_time=True, device=device,
    )

    # ---- 4. COBE normalization --------------------------------------------- #
    res = observables.cobe_normalize(artifact, rows, times, args, device=device)
    slot = artifact.lookup_symbol(sympy.Symbol("M4"))
    args = args.copy()
    args[int(slot[slot.index("[") + 1 : -1])] *= res["scale"]
    rows, times = background.solve_eom(
        artifact, args, opts.steps, x0, np.zeros(2),
        max_err=1e-9, solver="rkf", return_time=True, device=device,
    )
    out["cobe"], out["args"], out["rows"], out["times"] = res, args, rows, times
    print(f"normalize: M⁴ × {res['scale']:.4g} → P_ζ(k*) = 2.1e-9")

    # ---- 5. predictions ------------------------------------------------------ #
    # the pivot is not a convention here: solve the horizon-matching equation
    # for the self-consistent N_* of k = 0.05/Mpc (instant reheating)
    match = observables.n_star_matching(artifact, args, rows, times, k_mpc=0.05,
                                        device=device)
    out["match"] = match
    print(f"matching: N_*(0.05/Mpc) = {match['N_star']:.2f} "
          f"(T_reh = {match['T_reh_gev']:.3g} GeV, instant reheating)")
    info = observables.horizon_exit(artifact, rows, times, args,
                                    N_before_end=match["N_star"], device=device)
    out["exit"] = info
    print(f"exit (N* = N_end − {match['N_star']:.1f}): "
          f"n_s = {info['n_s']:.4f}, r = {info['r']:.4g}")

    dn = perturbations.delta_n_spectrum(
        artifact, args, rows, times, pivots=opts.pivots, order=2, N_margin_end=10.0,
        max_err=1e-10, device=device,
    )
    ms = perturbations.mode_spectrum(
        artifact, args, rows, times, pivots=opts.pivots, N_margin_end=10.0, device=device,
    )
    out["dn"], out["ms"] = dn, ms
    print("delta-N  : P_zeta =", np.array2string(dn["P_zeta"], precision=3))
    print("           f_NL   =", np.array2string(dn["f_NL"], precision=4))
    print("MS       : P_zeta =", np.array2string(ms["P_zeta"], precision=3))
    print("           P_iso/P_zeta =",
          np.array2string(ms["P_iso"] / ms["P_zeta"], precision=3))

    # squeezed-limit non-Gaussianity at the matched pivot: the long mode at
    # N_* correlated with shorter CMB scales (the full amplitude including
    # the dilation term the local delta-N f_NL misses)
    sq = perturbations.squeezed_fnl(
        artifact, args, rows, times, N_long_before_end=match["N_star"],
        N_short_before_end=(match["N_star"] - 6.0, match["N_star"] - 10.0),
        max_err=1e-10, device=device,
    )
    out["squeezed"] = sq
    print("squeezed : f_NL(k_L; k_S) =",
          np.array2string(sq["f_NL_sq"], precision=4))

    # sanity: at the CMB pivot the normalized spectrum sits on A_s and the
    # two routes agree within the slow-roll envelope
    p_at_pivot = np.interp(info["N_exit"], dn["N"], dn["P_zeta"])
    rel = ms["P_zeta"] / np.interp(ms["ln_k"], dn["ln_k"], dn["P_zeta"]) - 1
    out["p_at_pivot"], out["rel"] = float(p_at_pivot), rel
    assert abs(p_at_pivot / 2.1e-9 - 1) < 0.05, "normalization drifted"
    assert np.all(np.abs(rel[:3]) < 0.08), "formalisms disagree deep in slow roll"
    print("pipeline complete: normalized, matched, cross-validated")
    return out


if __name__ == "__main__":
    main()
