"""First-principles primordial spectra — δN and Mukhanov-Sasaki — in PyTorch.

Run with `python examples/torch_spectra.py [--device cuda|cpu]` — on the
NVIDIA GPU (the default) every background solve is one launch of kernel B6
and the mode equations run as torch RK4 loops on the device; `--device cpu`
runs the plain solver and the loops on the CPU.

The `inflatox_torch` version of examples/spectra.py.  The reference stops at
the consistency-condition maps; the time-resolved batched solver makes the
actual observables computable from first principles, two independent ways:

1. solve one background trajectory on a curved two-field space,
2. δN: perturb the initial fields at 8 horizon-crossing pivots and solve
   every perturbed background in ONE batched kernel launch — the e-fold
   differences to a uniform-H surface give P_ζ(k), n_s, r, and (order=2)
   the local non-Gaussianity f_NL,
3. Mukhanov-Sasaki: integrate the coupled mode equations Q^a through
   horizon crossing (Riemann mass matrix from the geometry layer), all
   pivots as one batch — an independent formalism that must agree, and
   additionally yields the exact tensor spectrum and the isocurvature
   fraction.
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
from inflatox_torch import background, perturbations
from inflatox_torch.models import _args_by_symbol


def build_model():
    """A curved two-field model: flat in p1, e^{2 b p1} in p2; compiled."""
    p1, p2, m1, m2, b = sympy.symbols("p1 p2 m1 m2 b", real=True)
    V = sympy.Rational(1, 2) * (m1 * p1) ** 2 + sympy.Rational(1, 2) * (m2 * p2) ** 2
    metric = [[sympy.Integer(1), 0], [0, sympy.exp(2 * b * p1)]]
    model = inflatox.InflationModelBuilder.new([p1, p2], metric, V, silent=True).build()
    return inflatox.Compiler(model, silent=True).compile()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--steps", type=int, default=3000, help="rows of each background solve")
    parser.add_argument("--pivots", type=int, default=8, help="pivots of the two spectra")
    parser.add_argument("--sweep-pivots", type=int, default=6, help="pivots a survey set")
    parser.add_argument("--sweep-sets", type=int, default=6,
                        help="parameter sets of the survey (the first of its 6)")
    opts = parser.parse_args(argv)
    device = torch.device(opts.device)
    out = {}

    # ---- 1. a curved two-field model and its background ------------------- #
    artifact = build_model()
    args = _args_by_symbol(artifact.model, {"m1": 1e-5, "m2": 0.8e-5, "b": 0.25})

    rows, times = background.solve_eom(
        artifact, args, opts.steps, [10.0, 1.5], [0.0, 0.0],
        max_err=1e-10, solver="rkf", return_time=True, device=device,
    )
    out["rows"], out["times"] = rows, times

    # ---- 2. δN route: nonlinear separate-universe solves, one launch ------ #
    # keep pivots ≥8 e-folds before the end — closer in, slow roll is
    # breaking (r grows past 1) and both formalisms leave their validated
    # envelope
    dn = perturbations.delta_n_spectrum(
        artifact, args, rows, times, pivots=opts.pivots, order=2, max_err=1e-10,
        N_margin_end=8.0, device=device,
    )
    out["dn"] = dn
    print("delta-N   P_zeta:", np.array2string(dn["P_zeta"], precision=3))
    print("          n_s   :", np.array2string(dn["n_s"][1:-1], precision=4))
    print("          f_NL  :", np.array2string(dn["f_NL"], precision=4))

    # ---- 3. Mukhanov-Sasaki route: mode integration, must agree ----------- #
    ms = perturbations.mode_spectrum(
        artifact, args, rows, times, pivots=opts.pivots, N_margin_end=8.0, device=device,
    )
    out["ms"] = ms
    rel = ms["P_zeta"] / np.interp(ms["ln_k"], dn["ln_k"], dn["P_zeta"]) - 1.0
    out["rel"] = rel
    print("MS vs dN  rel   :", np.array2string(rel, precision=3))
    print("          r     :", np.array2string(ms["r"], precision=4))
    print("          P_iso/P_zeta:", np.array2string(ms["P_iso"] / ms["P_zeta"],
                                                     precision=3))
    # flat models agree to ~0.5%; on this turning trajectory δN's
    # velocities-on-the-attractor assumption costs a few % — 8% is the
    # validated envelope (tests/test_perturbations.py)
    assert np.all(np.abs(rel) < 0.08), "the two formalisms disagree"
    print("two independent formalisms agree — spectrum is trustworthy")

    # ---- 4. survey: δN spectra for a batch of parameter sets --------------- #
    # one launch solves every base trajectory, one launch every perturbed
    # trajectory of every set; on_failure="nan" keeps a pathological corner
    # from killing the scan (its row NaN-fills and `ok` flags it)
    grid_m2, grid_b = np.meshgrid([0.6e-5, 0.8e-5, 1.0e-5], [0.15, 0.25])
    pars = np.stack([
        _args_by_symbol(artifact.model, {"m1": 1e-5, "m2": mm, "b": bb})
        for mm, bb in zip(grid_m2.ravel(), grid_b.ravel())
    ])[: opts.sweep_sets]
    sweep = perturbations.delta_n_sweep(
        artifact, pars, [10.0, 1.5], [0.0, 0.0], steps=opts.steps, pivots=opts.sweep_pivots,
        max_err=1e-10, N_margin_end=8.0, on_failure="nan", device=device,
    )
    out["pars"], out["sweep"] = pars, sweep
    mid = opts.sweep_pivots // 2
    print(f"survey: {int(sweep['ok'].sum())}/{len(pars)} sets ok; "
          "P_zeta at the middle pivot per set:",
          np.array2string(sweep["P_zeta"][:, mid], precision=3))
    return out


if __name__ == "__main__":
    main()
