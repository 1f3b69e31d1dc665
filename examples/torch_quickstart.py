"""Quickstart: define a model, compile it, run the full analysis suite, in PyTorch.

Run with `python examples/torch_quickstart.py [--device cuda|cpu]` — the
scans and solves run on the NVIDIA GPU's kernels by default; `--device cpu`
runs every call's plain PyTorch version on the CPU.

The `inflatox_torch` version of examples/quickstart.py.  Mirrors the
reference README example (hyperinflation) and then goes beyond it: the
kernel behind each call, background trajectories, multi-GPU scans, sweeps.
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
from inflatox_torch.ops import cuda_kernels
from inflatox_torch.parallel import make_mesh, parameter_sweep, sharded_scan


def ran_since(before):
    """The kernels launched since ``before`` (a copy of the launch counts),
    or the plain version when none was."""
    now = cuda_kernels.LAUNCHES_BY_KERNEL
    return ", ".join(f"kernel {k}" for k in now if now[k] > before[k]) or "the plain version"


def build_model():
    """The doc-example (hyperinflation) model, compiled."""
    # ---- 1. specify the model symbolically ------------------------------ #
    r, θ, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (θ**2 - sympy.Rational(2, 3) / r**2)
    metric = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]

    model = inflatox.InflationModelBuilder.new([r, θ], metric, V, silent=True).build()

    # ---- 2. compile (sympy → torch; the CUDA kernels build on first use) - #
    return inflatox.Compiler(model, silent=True).compile()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--n", type=int, default=512, help="grid points per axis of the analysis")
    parser.add_argument("--steps", type=int, default=200, help="rows of the single solve")
    parser.add_argument("--batch", type=int, default=16, help="trajectories of the batched solve")
    parser.add_argument("--batch-steps", type=int, default=100, help="rows of the batched solve")
    parser.add_argument("--sweep-n", type=int, default=128, help="grid points per axis a sweep set")
    parser.add_argument("--sweep-sets", type=int, default=8, help="values of m in the sweep")
    opts = parser.parse_args(argv)
    device = torch.device(opts.device)
    engine = "cuda" if device.type == "cuda" else "torch"
    out = {}

    artifact = build_model()
    artifact.print_sym_lookup_table()  # which sympy symbol is args[i]

    # ---- 3. point evaluation + the full grid analysis -------------------- #
    al = GeneralisedAL(artifact, device=device)
    args = np.array([1.0])  # m = 1
    out["V"] = al.calc_V(np.array([2.0, -2.0]), args)
    out["H"] = al.calc_H(np.array([2.0, -2.0]), args)
    print("V(2, -2) =", out["V"])
    print("H(2, -2) =\n", out["H"])

    maps = al.complete_analysis(
        args, 0.0, 2.5, 0.0, np.pi, N_x0=opts.n, N_x1=opts.n, progress=False
    )
    cons = maps[0]
    out["maps"] = np.stack(maps)
    out["cons_nanmin"] = float(np.nanmin(cons))
    print("consistency map:", cons.shape, "nanmin:", out["cons_nanmin"])

    # Engines: "cuda" (the hand-written kernel; the default on a GPU) or
    # "torch" (its plain PyTorch version); precision "f64" (kernel B1),
    # "f32" (B2) or "dd" (double-double, B4)
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    fast = al.complete_analysis(
        args, 0.0, 2.5, 0.0, np.pi, opts.n, opts.n, progress=False, engine=engine,
        precision="f64",
    )
    out["fast_maps"] = np.stack(fast)
    out["fast_ran"] = ran_since(before)
    print(f"f64 on engine={engine!r}:", fast[0].dtype, "from", out["fast_ran"])

    # ---- 4. background trajectories -------------------------------------- #
    traj, t = background.solve_eom(
        artifact, args, steps=opts.steps, fields_init=[2.0, 2.0],
        derivatives_init=[0.0, 0.0], solver="rkf", return_time=True, device=device,
    )
    out["traj"], out["t"] = traj, t
    print("trajectory: H goes", traj[0, 4], "->", traj[-1, 4], "over t =", t[-1])

    # batched: one kernel launch (B6) for many initial conditions
    inits = np.column_stack([np.linspace(1.8, 2.2, opts.batch), np.full(opts.batch, 2.0)])
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    batch = background.solve_eom_batch(
        artifact, args, opts.batch_steps, inits, np.zeros_like(inits), solver="rkf",
        device=device,
    )
    out["batch"] = batch
    print("batched trajectories:", batch.shape, "from", ran_since(before))

    # ---- 5. multi-GPU (runs on however many GPUs are attached) ------------ #
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = make_mesh(axis_names=("grid",))
        sharded = sharded_scan(al, args, (0.5, 2.5, 0.25, 3.0), (1024, 1024), mesh)
        out["sharded_shape"] = tuple(sharded.shape)
        print("sharded maps:", out["sharded_shape"])

    # parameter sweep with per-chunk checkpointing (resumable)
    masses = np.linspace(0.5, 2.0, opts.sweep_sets)[:, None]  # values of m
    sweep = parameter_sweep(
        al,
        masses,
        (0.5, 2.5, 0.25, 3.0),
        (opts.sweep_n, opts.sweep_n),
        progress=False,
        reduce_fn=lambda maps: maps[0].min(),  # keep only min-consistency
    )
    out["sweep"] = sweep
    print("sweep min-consistency per m:", np.round(sweep, 4))
    return out


if __name__ == "__main__":
    main()
