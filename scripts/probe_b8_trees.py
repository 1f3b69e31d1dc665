"""Kernel B8 (the special functions) of this checkout against another
tree's, on the card: alone and inside the kernels of the special-function
models.

    python scripts/probe_b8_trees.py [--tree NAME=DIR ...]

Needs one NVIDIA GPU and nvcc.  For this checkout ("current") and each
``--tree`` (e.g. the parent commit unpacked with ``git archive`` under
``build/``), builds from that tree's ``csrc/`` with the flags of
``inflatox_torch.ops.build``, one nvcc each, all started together, into
``build/b8_trees_probe/``: the special-function library
(``special_eval.cu``, B8 alone), the grid-scan libraries of ``chip_smoke.py``'s
models S1, S2 and S3 in f64 (B1, B5a) and f32 (B2), and S2's solver library
(B6), each tree's model headers generated by its own package.  Then times
each case with CUDA events in rounds of turns (a, b, b, a), arguments and
outputs on the card beforehand:

* B8 alone: every case of ``chip_smoke.py``'s phase 22 over 2^24 f64
  arguments uniform on the case's range, in random order and sorted (a warp
  whose lanes take different routes pays for each), with torch.special's
  call where one computes the function;
* B1 and B2 ``complete_analysis`` of S1-S3 at 1024², B5a over 1,048,576
  points of S1 and S3, B6 RKF45 on S2 at 4096 trajectories × 2000 rows
  (``chip_smoke.py``'s phases 23-25 sizes).

Each case also reports the share of outputs on which the trees agree bit for
bit (a route that this checkout changed on purpose agrees only where the
old and new algorithms round alike).  Prints one line per case and writes
``build/b8_trees_probe/report.json``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from inflatox_torch.ops import build  # noqa: E402
from probe_grid_stages import _out, grid, points, window_ms  # noqa: E402

ROUNDS = 2  # rounds of turns (a, b, b, a) per case
SF_N = 1 << 24
MODELS = ("S1", "S2", "S3")

_HEADERS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import sympy
import inflatox_torch
x, y, a = sympy.symbols("x y a")
half, th, fh = sympy.Rational(1, 2), sympy.Rational(3, 2), sympy.Rational(5, 2)
potentials = {
    "S1": (a * sympy.hyper((half,), (th,), -(x**2)) + sympy.hyper((half, th), (fh,), y**2 / 4)
           / 10 + sympy.erf(x) * sympy.gamma(y + 2) / 50 + 2),
    "S2": a * sympy.besselj(0, x) ** 2 + sympy.besselk(1, x + 2) * y**2 + 2,
    "S3": (a * sympy.besselj(sympy.Rational(3, 10), x) ** 2
           + sympy.besselk(sympy.Rational(5, 2), x + 2) * y**2 + 2),
}
out = {}
for name, V in potentials.items():
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], V, name, silent=True, simplify=False, assertions=False).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    out[name + " f64"] = art.cuda_source("f64")
    out[name + " f32"] = art.cuda_source("f32")
    if name == "S2":
        out["S2 solver"] = art.cuda_solver_source()
json.dump(out, sys.stdout)
"""


def tree_headers(root):
    proc = subprocess.run([sys.executable, "-c", _HEADERS, root], cwd=root,
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"header generation in {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout)


def start_build(work, main, header, csrc, flags):
    os.makedirs(work, exist_ok=True)
    if header is not None:
        with open(os.path.join(work, "inflx_model.h"), "w") as f:
            f.write(header)
    lib = os.path.join(work, "lib.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-I", work, "-I", csrc, "-o", lib,
           os.path.join(csrc, main)]
    log = open(os.path.join(work, "nvcc.log"), "w")
    return {"proc": subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), "lib": lib,
            "log": log, "start": time.perf_counter()}


def finish_build(label, job, bind):
    import ctypes

    job["proc"].wait()
    seconds = time.perf_counter() - job["start"]
    job["log"].close()
    if job["proc"].returncode != 0:
        text = open(job["log"].name).read()
        raise RuntimeError(f"build {label} failed:\n{text[-4000:]}")
    lib = ctypes.CDLL(job["lib"])
    bind(lib)
    return lib, seconds


def in_turns(fns, n):
    """Mean ms of each of ``fns`` (a dict), timed in ROUNDS rounds of turns
    (a, b, b, a)."""
    names = list(fns)
    times = {k: [] for k in names}
    for _ in range(ROUNDS):
        for k in names + names[::-1]:
            times[k].append(window_ms(fns[k], n))
    return {k: float(np.mean(v)) for k, v in times.items()}


def same_share(a, b):
    return float(((a == b) | (torch.isnan(a) & torch.isnan(b))).double().mean().item())


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", action="append", default=[], metavar="NAME=DIR")
    opts = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    trees = {"current": ROOT}
    for spec in opts.tree:
        name, path = spec.split("=", 1)
        trees[name] = os.path.abspath(path)
    out_root = os.path.join(ROOT, "build", "b8_trees_probe")
    jobs = {}
    for tree, root in trees.items():
        csrc = os.path.join(root, "inflatox_torch", "csrc")
        headers = tree_headers(root)
        jobs[tree, "B8"] = (start_build(os.path.join(out_root, tree, "special_eval"),
                                        "special_eval.cu", None, csrc, ("-fmad=false",)),
                            build._bind_special_eval)
        for key, header in headers.items():
            if key.endswith("solver"):
                job = start_build(os.path.join(out_root, tree, key.replace(" ", "_")),
                                  "solver.cu", header, csrc, ())
                jobs[tree, key] = (job, build._bind_solver)
            else:
                job = start_build(os.path.join(out_root, tree, key.replace(" ", "_")),
                                  "grid_scan.cu", header, csrc, ("-fmad=false",))
                jobs[tree, key] = (job, build._bind_grid_scan)
    libs, report = {}, {"card": card, "trees": trees, "builds": {}, "cases": []}
    for key, (job, bind) in jobs.items():
        libs[key], seconds = finish_build(" ".join(key), job, bind)
        report["builds"][" ".join(key)] = seconds
    print("built " + ", ".join(f"{k} {v:.1f} s" for k, v in report["builds"].items()))

    def record(case, outs, ms, extra=None):
        ref = outs["current"]
        entry = {"case": case, "ms": ms, **(extra or {}),
                 "same_as_current": {t: same_share(o, ref) for t, o in outs.items()
                                     if t != "current"}}
        report["cases"].append(entry)
        print(f"{case}: " + "; ".join(f"{t} {v:.4f} ms" for t, v in ms.items())
              + "".join(f"; {k} {v}" for k, v in (extra or {}).items())
              + "; bit-identical to current: " + ", ".join(
                  f"{t} {v:.6f}" for t, v in entry["same_as_current"].items()))

    # B8 alone: phase 22's cases
    gen = torch.Generator(device="cuda").manual_seed(22)
    library = chip_smoke.torch_library()
    for label, _, inst, params, (lo, hi), *_ in chip_smoke.b8_cases():
        z = torch.empty(SF_N, dtype=torch.float64, device="cuda").uniform_(lo, hi,
                                                                           generator=gen)
        p = tuple(float(v) for v in params) + (0.0,) * (4 - len(params))
        stream = torch.cuda.current_stream().cuda_stream
        for order, arg in (("random", z), ("sorted", z.sort().values)):
            def launch(tree, arg=arg):
                out = _out((SF_N,), torch.float64)
                err = getattr(libs[tree, "B8"], f"inflx_sf_{inst}")(
                    0, *p, arg.data_ptr(), out.data_ptr(), SF_N, stream)
                assert err == 0, err
                return out

            outs = {t: launch(t).clone() for t in trees}
            fns = {t: (lambda t=t: launch(t)) for t in trees}
            if inst in library and not params:
                fns["torch.special"] = lambda arg=arg: library[inst](arg)
            record(f"B8 {label} {order}", outs, in_turns(fns, 5))
        del z

    # the model paths at chip_smoke.py's sizes
    args32 = torch.tensor(chip_smoke.SPECIAL_ARGS, dtype=torch.float32, device="cuda")
    args64 = args32.double()
    n = chip_smoke.SPECIAL_N
    for name in MODELS:
        extent = chip_smoke.S1_EXTENT if name == "S1" else chip_smoke.S2_EXTENT
        for precision, p, kernel in (("f64", args64, "B1"), ("f32", args32, "B2")):
            key = f"{name} {precision}"
            dtype = torch.float64 if precision == "f64" else torch.float32
            outs = {t: grid(libs[t, key], "complete_analysis", p, extent, (n, n), dtype).clone()
                    for t in trees}
            fns = {t: (lambda t=t: grid(libs[t, key], "complete_analysis", p, extent, (n, n),
                                        dtype)) for t in trees}
            record(f"{kernel} {name} complete_analysis {n}² {precision}", outs,
                   in_turns(fns, 20))
    rng = np.random.default_rng(24)
    for name in ("S1", "S3"):
        extent = chip_smoke.S1_EXTENT if name == "S1" else chip_smoke.S2_EXTENT
        pts = torch.tensor(np.stack([rng.uniform(extent[0], extent[1], chip_smoke.SPECIAL_POINTS),
                                     rng.uniform(extent[2], extent[3],
                                                 chip_smoke.SPECIAL_POINTS)], 1), device="cuda")
        key = f"{name} f64"
        outs = {t: points(libs[t, key], "complete_analysis", args64, pts).clone() for t in trees}
        fns = {t: (lambda t=t: points(libs[t, key], "complete_analysis", args64, pts))
               for t in trees}
        record(f"B5a {name} complete_analysis {chip_smoke.SPECIAL_POINTS} points", outs,
               in_turns(fns, 5))
    rng = np.random.default_rng(25)
    batch, steps = chip_smoke.B_SOLVE, chip_smoke.STEPS
    ext = chip_smoke.S2_EXTENT
    f0 = torch.tensor(np.stack([rng.uniform(ext[0], ext[1], batch),
                                rng.uniform(ext[2], ext[3], batch)], 1), device="cuda")
    d0 = torch.zeros_like(f0)
    solve_out = torch.empty((steps, 6, batch), dtype=torch.float64, device="cuda")

    def solve(tree):
        err = libs[tree, "S2 solver"].inflx_solve(
            0, f0.data_ptr(), d0.data_ptr(), args64.data_ptr(), 0, solve_out.data_ptr(), batch,
            steps, 1e-6, 1e6, torch.cuda.current_stream().cuda_stream, None)
        assert err == 0, err
        return solve_out

    outs = {t: solve(t).clone() for t in trees}
    record(f"B6 rkf S2 {batch} x {steps}", outs,
           in_turns({t: (lambda t=t: solve(t)) for t in trees}, 2))
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"probe": "b8_trees", "card": card, "cases": len(report["cases"])}))


if __name__ == "__main__":
    main()
