"""Background-evolution parameter sweep on the CUDA solver kernel, in PyTorch.

Run with `python examples/torch_background_sweep.py [--device cuda|cpu]` —
on the NVIDIA GPU (the default) every batched solve is one launch of kernel
B6 (csrc/solver.cu, one thread a trajectory) and the on-trajectory scan one
launch of kernel B5a; `--device cpu` runs their plain PyTorch versions.

The `inflatox_torch` version of examples/background_sweep.py.  Demonstrates
the trajectory pipeline around `background.solve_eom_batch`:

1. one batched launch integrating hundreds of backgrounds at once,
2. per-trajectory parameters — a sweep over the model's mass parameter is
   ONE kernel launch (each trajectory reads its own parameter row;
   reference parity point: the reference integrates strictly one
   trajectory per call, background_solver.rs:263-336),
3. sharding the batch over a mesh of GPUs (`mesh=`) with no collectives,
4. feeding the solved trajectories to the on-trajectory consistency scans.
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
from inflatox_torch import background
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.parallel import make_mesh


def t_end(rows_b, times_b):
    """Physical time where H crosses zero (end of validity — neither this
    nor the reference integrator enforces a stop, so later rows continue
    into the unphysical H<0 regime)."""
    crossed = rows_b[:, :, 4] < 0.0
    idx = np.where(crossed.any(1), crossed.argmax(1), rows_b.shape[1] - 1)
    return times_b[np.arange(rows_b.shape[0]), idx]


def build_model():
    """The doc-example hyperinflation potential, compiled."""
    r, θ, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (θ**2 - sympy.Rational(2, 3) / r**2)
    metric = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = inflatox.InflationModelBuilder.new([r, θ], metric, V, silent=True).build()
    return inflatox.Compiler(model, silent=True).compile()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--batch", type=int, default=512, help="trajectories a batch")
    parser.add_argument("--steps", type=int, default=400, help="rows a trajectory")
    parser.add_argument("--survey-n", type=int, default=32,
                        help="initial conditions per axis of the basin survey")
    opts = parser.parse_args(argv)
    device = torch.device(opts.device)
    out = {}

    # ---- model: the doc-example hyperinflation potential ------------------ #
    artifact = build_model()

    # ---- 1. one batched launch, shared parameters ------------------------- #
    B, steps = opts.batch, opts.steps
    rng = np.random.default_rng(0)
    fields0 = np.column_stack([rng.uniform(1.8, 2.4, B), rng.uniform(1.7, 2.3, B)])
    derivs0 = np.zeros((B, 2))

    rows, times = background.solve_eom_batch(
        artifact, np.array([1.0]), steps, fields0, derivs0,
        solver="rkf",  # kernel B6 on a GPU; its plain version on the CPU
        return_time=True, device=device,
    )
    out["fields0"], out["rows"], out["times"] = fields0, rows, times
    out["t_end_median"] = float(np.median(t_end(rows, times)))
    print(f"batch: {rows.shape} rows; H crosses 0 at t ≈ "
          f"{out['t_end_median']:.3f} (median over {B})")

    # ---- 2. per-trajectory parameters: a mass sweep in one launch --------- #
    masses = np.linspace(0.5, 2.0, B)[:, None]  # (B, 1) — one m per trajectory
    sweep_rows, sweep_t = background.solve_eom_batch(
        artifact, masses, steps, fields0, derivs0, solver="rkf",
        return_time=True, device=device,
    )
    ends = t_end(sweep_rows, sweep_t)
    out["sweep_rows"], out["sweep_times"] = sweep_rows, sweep_t
    out["sweep_t_end_max"], out["sweep_t_end_min"] = float(ends.max()), float(ends.min())
    print(f"mass sweep: background survives t ≈ {ends.max():.2f} at m=0.5 "
          f"down to t ≈ {ends.min():.2f} at m=2.0 (one launch, {B} masses)")

    # ---- 3. shard the batch over every available GPU ----------------------- #
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 0
    if n_dev > 1 and B % n_dev == 0:
        mesh = make_mesh(axis_names=("solve",))
        rows_sharded = background.solve_eom_batch(
            artifact, np.array([1.0]), steps, fields0, derivs0,
            solver="rkf", mesh=mesh, device=device,
        )
        out["sharded_matches"] = bool(np.allclose(rows_sharded, rows, rtol=1e-9, atol=1e-12))
        print("sharded batch matches:", out["sharded_matches"])

    # ---- 4. on-trajectory analysis of one solved background --------------- #
    al = GeneralisedAL(artifact, device=device, validate_basis=False)
    trajectory = rows[0, :, :2]  # (steps, 2) field-space path
    ot = al.complete_analysis_ot(np.array([1.0]), trajectory)
    out["ot"] = np.stack(ot)
    out["ot_min"], out["ot_max"] = float(np.nanmin(ot[0])), float(np.nanmax(ot[0]))
    print(f"on-trajectory maps: {len(ot)} quantities × {ot[0].shape} points; "
          f"consistency range {out['ot_min']:.3e}..{out['ot_max']:.3e}")

    # ---- 5. basin survey: which initial conditions inflate, and how much -- #
    # the trajectories are reduced ON THE DEVICE (eps_H = 1 crossing, e-fold
    # count); only the per-IC summary maps come back to the host
    n = opts.survey_n
    gx, gy = np.meshgrid(np.linspace(1.6, 2.6, n), np.linspace(1.5, 2.5, n))
    out["survey_starts"] = np.stack([gx.ravel(), gy.ravel()], axis=1)
    basin = background.survey_initial_conditions(
        artifact, np.array([1.0]), steps, out["survey_starts"], np.zeros(2), device=device,
    )
    n_map = basin["N_inflation"].reshape(n, n)
    out["survey"] = basin
    out["survey_ended"] = int(basin["ended"].sum())
    out["survey_n_max"] = float(np.nanmax(n_map))
    print(f"basin survey: {out['survey_ended']}/{n_map.size} ICs end "
          f"inflation in-span; N_inflation up to {out['survey_n_max']:.1f} e-folds")
    return out


if __name__ == "__main__":
    main()
