"""The grid-scan kernel with and without the parameter-set axis: kernel time
of the single scans (B1, B2) and of the batched one (B7a) on the card.

    python scripts/probe_set_axis.py [--tree NAME=DIR ...]

Needs one NVIDIA GPU and nvcc.  Builds the hyperinflation grid-scan library
in f64 and f32 from ``inflatox_torch/csrc`` of this checkout ("current") and
of each ``--tree`` (another checkout, or a directory holding
``inflatox_torch/csrc``), all with this checkout's generated headers and the
flags of ``inflatox_torch.ops.build``, one nvcc each, all started together,
into ``build/set_axis_probe/``.  Then for each scan below every tree's output
must be bit-identical to the current one's, and the trees are timed with
CUDA events over chained launches, in turns (a, b, c, c, b, a): B1
``complete_analysis`` at 4096² (bench cfg1), ``potential`` and ``hesse`` at
8000² (cfg0), ``gradient`` at 4096²; B2 ``potential`` at 8000² and
``complete_analysis`` at 4096²; and, in the trees whose library has
``inflx_grid_scan_batch``, B7a ``complete_analysis`` over 32 masses at 512²
(cfg5) in one launch.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from inflatox_torch.ops import build  # noqa: E402
from inflatox_torch.ops.cuda_kernels import KINDS  # noqa: E402

DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)
_SCAN_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
              ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_int64]


def start_build(name, header, csrc, out_root):
    work = os.path.join(out_root, name)
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "inflx_model.h"), "w") as f:
        f.write(header)
    lib = os.path.join(work, "lib.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-fmad=false", "-I", work, "-I", csrc,
           "-o", lib, os.path.join(csrc, "grid_scan.cu")]
    log = open(os.path.join(work, "nvcc.log"), "w")
    return {"proc": subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), "lib": lib,
            "log": log, "start": time.perf_counter()}


def finish_build(name, job):
    job["proc"].wait()
    seconds = time.perf_counter() - job["start"]
    job["log"].close()
    text = open(job["log"].name).read()
    if job["proc"].returncode != 0:
        raise RuntimeError(f"build {name} failed:\n{text[-4000:]}")
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
    print(f"build {name}: nvcc {seconds:.1f} s; ptxas {len(regs)} functions, registers "
          f"{min(regs)}-{max(regs)}")
    lib = ctypes.CDLL(job["lib"])
    lib.inflx_grid_scan.argtypes = _SCAN_ARGS + [ctypes.c_void_p]
    lib.inflx_grid_scan.restype = ctypes.c_int
    if hasattr(lib, "inflx_grid_scan_batch"):
        lib.inflx_grid_scan_batch.argtypes = _SCAN_ARGS + [ctypes.c_int64, ctypes.c_void_p]
        lib.inflx_grid_scan_batch.restype = ctypes.c_int
    return lib


def launch(lib, kind, p, shape, dtype):
    """One scan: p is (k,) for a single scan, (S, k) for a batch."""
    kind_id, n_out = KINDS[kind]
    n0, n1 = shape
    x0a, x0b, x1a, x1b = DOC_EXTENT
    geometry = (x0a, (x0b - x0a) / n0, x1a, (x1b - x1a) / n1, n0, n1)
    stream = torch.cuda.current_stream().cuda_stream
    if p.ndim == 1:
        out = torch.empty((n_out, n0, n1), dtype=dtype, device="cuda")
        err = lib.inflx_grid_scan(kind_id, p.data_ptr(), out.data_ptr(), *geometry, stream)
    else:
        out = torch.empty((p.shape[0], n_out, n0, n1), dtype=dtype, device="cuda")
        err = lib.inflx_grid_scan_batch(kind_id, p.data_ptr(), out.data_ptr(), *geometry,
                                        p.shape[0], stream)
    assert err == 0, err
    return out


def window_ms(fn, n):
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", action="append", default=[], metavar="NAME=DIR")
    opts = parser.parse_args()
    import inflatox_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    model, args = inflatox_torch.models.hyperinflation()
    hyp = inflatox_torch.Compiler(model, silent=True).compile()
    headers = {"f64": hyp.cuda_source("f64"), "f32": hyp.cuda_source("f32")}
    trees = {"current": str(build.CSRC)}
    for spec in opts.tree:
        name, path = spec.split("=", 1)
        trees[name] = os.path.join(os.path.abspath(path), "inflatox_torch", "csrc")
    out_root = os.path.join(ROOT, "build", "set_axis_probe")
    jobs = {(t, prec): start_build(f"{t}_{prec}", headers[prec], csrc, out_root)
            for t, csrc in trees.items() for prec in headers}
    libs = {key: finish_build(f"{key[0]} {key[1]}", job) for key, job in jobs.items()}

    masses = torch.linspace(0.5, 2.0, 32, dtype=torch.float64, device="cuda")[:, None]
    cases = [  # (label, precision, kind, shape, batched)
        ("B1", "f64", "complete_analysis", (4096, 4096), False),
        ("B1", "f64", "potential", (8000, 8000), False),
        ("B1", "f64", "hesse", (8000, 8000), False),
        ("B1", "f64", "gradient", (4096, 4096), False),
        ("B2", "f32", "potential", (8000, 8000), False),
        ("B2", "f32", "complete_analysis", (4096, 4096), False),
        ("B7a", "f64", "complete_analysis", (512, 512), True),
    ]
    for label, prec, kind, shape, batched in cases:
        dtype = torch.float32 if prec == "f32" else torch.float64
        p = (masses if batched else torch.tensor(args, dtype=torch.float64, device="cuda")).to(dtype)
        runs = {t: (lambda lib=libs[(t, prec)]: launch(lib, kind, p, shape, dtype))
                for t in trees if not batched or hasattr(libs[(t, prec)], "inflx_grid_scan_batch")}
        want = runs["current"]()
        for t, fn in runs.items():
            got = fn()
            assert bool(((got == want) | (got.isnan() & want.isnan())).all()), \
                f"{label} {kind}: {t} differs from current"
            del got
        one = window_ms(runs["current"], 1)
        n = max(3, min(200, int(200 / max(one, 1e-3))))
        order = list(runs) + list(runs)[::-1]
        windows = {t: [] for t in runs}
        for t in order:
            windows[t].append(window_ms(runs[t], n))
        print(f"{label} {kind} {'32 x ' if batched else ''}{shape[0]}x{shape[1]} {prec} on {card}: "
              + "; ".join(f"{t} {sum(w) / len(w):.4f} ms (windows "
                          f"{', '.join(f'{v:.4f}' for v in w)})" for t, w in windows.items())
              + f"; {n} chained launches per window, all bit-identical")
        del want


if __name__ == "__main__":
    main()
