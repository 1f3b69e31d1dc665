#!/usr/bin/env python3
"""Run the port's examples (``examples/torch_*.py``) in this process and
time them.

    python scripts/time_examples.py [--device cuda|cpu] [--only NAME ...]

Each example runs once through its ``main(["--device", DEVICE])`` at its
default (full) sizes, its standard output captured; one JSON line per
example: its wall time on the host clock, the kernel launches it made by
kernel (``ops/cuda_kernels.LAUNCHES_BY_KERNEL``) and its last printed
line.  ``chip_smoke.py``
phase 32 runs the same on the card after building every example's kernel
libraries at once (``libraries``).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

#: example → the kernels it launches on the card (B8 runs inside B1 for the
#: special-function models; B9, the survey's reduction, is in B6's library)
EXAMPLES = {
    "quickstart": ("B1", "B6", "B7a"),
    "engines_tour": ("B1", "B2", "B4"),
    "special_functions": ("B1",),
    "background_sweep": ("B6", "B5a", "B9"),
    "fit_observables": ("B1",),
    "spectra": ("B6",),
    "pipeline": ("B1", "B6"),
}


def load(name):
    """``examples/torch_<name>.py`` as a module (its ``main`` not run)."""
    path = os.path.join(REPO, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def libraries(name, module):
    """(label, loader, header source) of every kernel library the example
    loads on the card, from its own ``build_model``/``build_models``."""
    from inflatox_torch.ops.build import load_grid_scan, load_solver

    if name == "special_functions":
        arts = module.build_models()
    elif name == "pipeline":
        arts = (module.build_model()[0],)
    else:
        arts = (module.build_model(),)
    precisions = ("f64", "f32", "dd") if name == "engines_tour" else ("f64",)
    jobs = []
    for i, art in enumerate(arts):
        if name != "spectra":
            jobs += [(f"{name} {i} grid {p}", load_grid_scan, art.cuda_source(p))
                     for p in precisions]
        if "B6" in EXAMPLES[name]:
            jobs.append((f"{name} {i} solver", load_solver, art.cuda_solver_source()))
    return jobs


def reset_counts():
    from inflatox_torch.ops import cuda_kernels

    for key in cuda_kernels.LAUNCHES_BY_KERNEL:
        cuda_kernels.LAUNCHES_BY_KERNEL[key] = 0


def counts():
    from inflatox_torch.ops import cuda_kernels

    return {k: v for k, v in cuda_kernels.LAUNCHES_BY_KERNEL.items() if v}


def run(name, module, device):
    """One full-size run of the example on ``device`` after the counts are
    set to 0: {"example", "device", "wall_s", "launches", "last_line",
    "out"} (``out``: what ``main`` returned)."""
    import torch

    reset_counts()
    buf = io.StringIO()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = module.main(["--device", device])
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    lines = buf.getvalue().strip().splitlines()
    return {"example": name, "device": device, "wall_s": wall, "launches": counts(),
            "last_line": lines[-1] if lines else "", "out": out}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--only", nargs="*", default=list(EXAMPLES))
    opts = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    print(f"torch {torch.__version__}, host cores {os.cpu_count()}, threads "
          f"{torch.get_num_threads()}", flush=True)
    for name in opts.only:
        result = run(name, load(name), opts.device)
        result.pop("out")
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
