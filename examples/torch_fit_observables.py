"""Gradient-based parameter fitting of CMB observables, in PyTorch.

Run with `python examples/torch_fit_observables.py [--device cuda|cpu]` —
the fit and the integrator run on the NVIDIA GPU by default (plain torch
operations under autograd; the scan cross-check is kernel B1); `--device
cpu` runs everything on the CPU.

The `inflatox_torch` version of examples/fit_observables.py.  The reference
can only *evaluate* a model at given parameters; finding parameters that
reproduce observed quantities means a grid search over repeated scans.
Because the port lowers models to torch operations, the map parameters →
observables is differentiable end to end under autograd, so the same
problem is a few thousand optimizer steps of `torch.optim.Adam`:

1. build a two-field natural-inflation-style model (host-side sympy, as
   always) — a cosine potential, because Planck-like targets need a
   concave region (η_V < 0), which no positive-definite quadratic can
   provide,
2. fit the axion decay constant AND the horizon-exit pivot point so the
   leading-order slow-roll predictions hit Planck-like targets
   (n_s = 0.9649, r = 0.036) — the pivot is part of the inference, since
   observables are evaluated where the mode exits the horizon,
3. cross-check the fitted point on the standard consistency scan API, and
4. differentiate *through the background integrator* (fixed-step RK4 in
   torch operations) to show trajectory-level losses work too.
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
from inflatox_torch import observables
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.models import natural

M_SPECTATOR = 0.05  # held fixed during the fit
TARGETS = {"n_s": 0.9649, "r": 0.036}


def build_model():
    """The zoo's natural-inflation model, compiled."""
    model, _default_args = natural()
    return inflatox.Compiler(model, silent=True).compile()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--steps", type=int, default=2000, help="Adam steps of the fit")
    parser.add_argument("--points", type=int, default=401,
                        help="time-grid points of the differentiated integration")
    opts = parser.parse_args(argv)
    device = torch.device(opts.device)
    engine = "cuda" if device.type == "cuda" else "torch"
    out = {}

    # ---- 1. model: axion + spectator on a flat field space ---------------- #
    # V = 1 + cos(phi_1/f_a) + (m phi_2)^2 on a flat metric — the zoo's
    # natural-inflation model (inflatox_torch/models).  Building your own
    # works identically: InflationModelBuilder.new(fields, metric, V).build().
    artifact = build_model()
    fa, m = sympy.symbols("f_a m")

    # parameter slots follow printer registration order (reference contract,
    # compiler.py:102-106); query them instead of guessing
    def slot(sym):
        s = artifact.lookup_symbol(sym)  # e.g. "args[0]"
        return int(s[s.index("[") + 1 : -1])

    SLOT_FA, SLOT_M = slot(fa), slot(m)
    # args as torch operations on the fitted values, so the gradient flows:
    # one basis vector per parameter slot
    basis = torch.eye(artifact.n_parameters, dtype=torch.float64, device=device)

    # ---- 2. fit decay constant + pivot to Planck-like targets ------------- #
    sr = observables.slow_roll(artifact, device)

    def loss(z):
        # z = (f_a, phi_1*, phi_2*): model shape + horizon-exit point
        args = z[0] * basis[SLOT_FA] + M_SPECTATOR * basis[SLOT_M]
        got = sr(z[1:], args)
        return (got["n_s"] - TARGETS["n_s"]) ** 2 + (got["r"] - TARGETS["r"]) ** 2

    res = observables.fit_parameters(loss, np.array([5.0, 4.0, 0.1]), steps=opts.steps,
                                     learning_rate=0.01, device=device)
    args = np.zeros(artifact.n_parameters)
    args[SLOT_FA], args[SLOT_M] = res.params[0], M_SPECTATOR
    pivot = np.asarray(res.params[1:])
    fitted = {k: float(v) for k, v in sr(pivot, args).items()}
    out["params"], out["loss_history"], out["args"] = res.params, res.loss_history, args
    out["loss_end"] = float(loss(torch.as_tensor(res.params, device=device)))
    out["fitted"] = fitted
    print(f"fitted f_a, pivot   : {res.params[0]:.5f}, {pivot}")
    print(f"loss start -> end   : {res.loss_history[0]:.3e} -> {out['loss_end']:.3e}")
    print(f"n_s at pivot        : {fitted['n_s']:.6f}  (target {TARGETS['n_s']})")
    print(f"r at pivot          : {fitted['r']:.6f}  (target {TARGETS['r']})")
    print(f"epsilon_V / eta_V   : {fitted['epsilon_v']:.5f} / {fitted['eta_v']:.5f}")

    # ---- 3. cross-check on the scan API (same formulas, grid form) -------- #
    # the kernel (engine="cuda", B1 on a GPU) beside its plain version
    al = GeneralisedAL(artifact, device=device, validate_basis=False)
    for name in dict.fromkeys((engine, "torch")):
        eps_map = al.epsilon_v(
            args, *(float(pivot[0]),) * 2, *(float(pivot[1]),) * 2,
            N_x0=1, N_x1=1, progress=False, engine=name,
        )
        out[f"scan_eps_{name}"] = float(eps_map[0, 0])
        print(f"scan-API epsilon_V  : {float(eps_map[0, 0]):.5f} on engine={name!r} "
              f"(matches {fitted['epsilon_v']:.5f})")

    # ---- 4. trajectory-level gradient through the integrator -------------- #
    grid = torch.linspace(0.0, 2.0, opts.points, dtype=torch.float64, device=device)

    def displacement(a):
        rows = observables.solve_eom_fixed(
            artifact, a, grid, pivot, np.zeros(2), device=device
        )
        return rows[-1, 0] - rows[0, 0]  # how far phi_1 rolled by t=2

    a = torch.tensor(args, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(displacement(a), a)
    out["grad"] = g.cpu().numpy()
    print(f"d(roll distance)/d(f_a, m) = {out['grad'][[SLOT_FA, SLOT_M]]}  "
          f"(reverse-mode, through {opts.points - 1} RK4 steps)")
    return out


if __name__ == "__main__":
    main()
