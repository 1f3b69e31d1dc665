"""The grid-scan kernels of this checkout against another tree's, and the
rows per block of the staged kernel, on the card.

    python scripts/probe_grid_stages.py [--rows 8,16,32] [--tree NAME=DIR ...]

Needs one NVIDIA GPU and nvcc.  Builds the grid-scan library for four
headers (hyperinflation f64 and f32, D5 f64, EGNO double-double) from
``inflatox_torch/csrc`` of this checkout once for each value of ``--rows``
(``-DINFLX_ROWS``, the rows of one block; "current" is the checkout's own
value) and from each ``--tree`` (e.g. the parent commit unpacked with ``git
archive`` under ``build/``) with that tree's own headers
(``scripts/tree_headers.py``), all with the flags of
``inflatox_torch.ops.build``, one nvcc each, all started together, into
``build/grid_stages_probe/``; prints ptxas's registers and spills of each.
Then for each scan below every build's output must be bit-identical to the
current one's, and the builds are timed with CUDA events over chained
launches (parameters on the card and output buffers allocated before the
timing, so that the card never waits for the host), in four rounds of
turns (a, b, c, c, b, a): B1 ``complete_analysis`` at 4096²
(bench cfg1), ``potential`` and ``hesse`` at 8000² (cfg0), ``gradient`` at
4096²; B2 ``potential`` at 8000² and ``complete_analysis`` at 4096²; B1 on
D5 at 1024² (cfg4); B4 on EGNO at 2048² (cfg3/3b, both kinds); B5a over
8,192,000 points and B5b over 1,048,576 points (uniform on cfg1's and
cfg3's windows); B7a and B7b over 32 masses at 512² (cfg5) and B7d over 8
values of EGNO's c at 512².  Writes the table to
``build/grid_stages_probe/report.json`` as well.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from inflatox_torch.ops import build  # noqa: E402
from inflatox_torch.ops.cuda_kernels import KINDS  # noqa: E402
from tree_headers import tree_headers  # noqa: E402

DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)
D5_EXTENT = (0.1, 36.0, 0.0, 4 * np.pi)
EGNO_EXTENT = (0.46, 0.50, 0.0, np.pi)
D5_ARGS = {"V0": -1.17e-8, "N": 1000.0, "g_s": 0.01, "l_s": 501.961, "u": 50 * 501.961,
           "q": 1.0, "p": 5.0, "a0": 0.001, "a1": 0.0005, "b1": 0.001}
EGNO_ARGS = {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0}
_GEOMETRY = [ctypes.c_double] * 4 + [ctypes.c_int64] * 2
HEADERS = ("f64", "f32", "d5", "egno")
ROUNDS = 4  # rounds of turns (a, b, b, a) per case


def start_build(work, header, csrc, defines):
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "inflx_model.h"), "w") as f:
        f.write(header)
    lib = os.path.join(work, "lib.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-fmad=false", *defines, "-I", work,
           "-I", csrc, "-o", lib, os.path.join(csrc, "grid_scan.cu")]
    log = open(os.path.join(work, "nvcc.log"), "w")
    return {"proc": subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), "lib": lib,
            "log": log, "start": time.perf_counter()}


def finish_build(label, job):
    job["proc"].wait()
    seconds = time.perf_counter() - job["start"]
    job["log"].close()
    text = open(job["log"].name).read()
    if job["proc"].returncode != 0:
        raise RuntimeError(f"build {label} failed:\n{text[-4000:]}")
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    print(f"build {label}: nvcc {seconds:.1f} s; ptxas {len(regs)} functions, registers "
          f"{min(regs)}-{max(regs)}, spill bytes (stores + loads) at most {max(spills)}")
    lib = ctypes.CDLL(job["lib"])
    lib.inflx_grid_scan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                    *_GEOMETRY, ctypes.c_void_p]
    lib.inflx_grid_scan_batch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                          *_GEOMETRY, ctypes.c_int64, ctypes.c_void_p]
    lib.inflx_points_scan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    for fn in (lib.inflx_grid_scan, lib.inflx_grid_scan_batch, lib.inflx_points_scan):
        fn.restype = ctypes.c_int
    return {"lib": lib, "registers": regs, "spills": spills, "nvcc_s": seconds}


_OUT = {}


def _out(shape, dtype):
    """An output buffer of each shape and type, allocated once, so that a
    timed launch does no more on the host than the kernel's own call."""
    key = (tuple(shape), dtype)
    if key not in _OUT:
        _OUT[key] = torch.empty(shape, dtype=dtype, device="cuda")
    return _OUT[key]


def grid(lib, kind, p, extent, shape, dtype):
    """One grid scan: p is (k,) for a single scan, (S, k) for a batch."""
    kind_id, n_out = KINDS[kind]
    n0, n1 = shape
    x0a, x0b, x1a, x1b = extent
    geometry = (x0a, (x0b - x0a) / n0, x1a, (x1b - x1a) / n1, n0, n1)
    stream = torch.cuda.current_stream().cuda_stream
    if p.ndim == 1:
        out = _out((n_out, n0, n1), dtype)
        err = lib.inflx_grid_scan(kind_id, p.data_ptr(), out.data_ptr(), *geometry, stream)
    else:
        out = _out((p.shape[0], n_out, n0, n1), dtype)
        err = lib.inflx_grid_scan_batch(kind_id, p.data_ptr(), out.data_ptr(), *geometry,
                                        p.shape[0], stream)
    assert err == 0, err
    return out


def points(lib, kind, p, pts):
    kind_id, n_out = KINDS[kind]
    out = _out((n_out, pts.shape[0]), torch.float64)
    err = lib.inflx_points_scan(kind_id, p.data_ptr(), pts.data_ptr(), out.data_ptr(),
                                pts.shape[0], torch.cuda.current_stream().cuda_stream)
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
    parser.add_argument("--rows", default="", help="comma-separated rows per block to build")
    parser.add_argument("--tree", action="append", default=[], metavar="NAME=DIR")
    opts = parser.parse_args()
    import inflatox_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    builds = {"current": (ROOT, ())}
    for r in filter(None, opts.rows.split(",")):
        builds[f"rows{r}"] = (ROOT, (f"-DINFLX_ROWS={int(r)}",))
    for spec in opts.tree:
        name, path = spec.split("=", 1)
        builds[name] = (os.path.abspath(path), ())
    headers = {}
    for root in {root for root, _ in builds.values()}:
        headers[root] = tree_headers(root, HEADERS)
    out_root = os.path.join(ROOT, "build", "grid_stages_probe")
    jobs = {(b, h): start_build(os.path.join(out_root, f"{b}_{h}"), headers[root][h],
                                os.path.join(root, "inflatox_torch", "csrc"), defines)
            for b, (root, defines) in builds.items() for h in HEADERS}
    libs, report = {}, {"card": card, "builds": {}, "cases": {}}
    for key, job in jobs.items():
        built = finish_build(f"{key[0]} {key[1]}", job)
        libs[key] = built["lib"]
        report["builds"][f"{key[0]} {key[1]}"] = {k: v for k, v in built.items() if k != "lib"}

    def dev(a, dtype=torch.float64):
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device="cuda")

    hyp_model, hyp_args = inflatox_torch.models.hyperinflation()
    fixtures = os.path.join(ROOT, "tests", "fixtures")
    d5 = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "d5_bundle.json"))
    egno = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "egno_bundle.json"))
    d5_args = inflatox_torch.models._args_by_symbol(d5.model, D5_ARGS)
    egno_args = inflatox_torch.models._args_by_symbol(egno.model, EGNO_ARGS)
    egno_batch = np.stack([inflatox_torch.models._args_by_symbol(egno.model, {**EGNO_ARGS, "c": c})
                           for c in np.linspace(900.0, 1100.0, 8)])
    masses = np.linspace(0.5, 2.0, 32)[:, None]
    rng = np.random.default_rng(16)
    hyp_pts = dev(np.stack([rng.uniform(0.5, 2.5, 8_192_000), rng.uniform(0.25, 3.0, 8_192_000)],
                           1))
    egno_pts = dev(np.stack([rng.uniform(0.46, 0.50, 1 << 20), rng.uniform(0.0, np.pi, 1 << 20)],
                            1))
    f32 = torch.float32
    # parameters on the card once: a copy from the host in each launch would
    # wait for the card and time the host's loop instead of the kernel
    hyp_p, hyp_p32, d5_p, egno_p = dev(hyp_args), dev(hyp_args, f32), dev(d5_args), dev(egno_args)
    mass_p, mass_p32, egno_bp = dev(masses), dev(masses, f32), dev(egno_batch)
    cases = [  # (label, header, run(lib))
        ("B1 complete_analysis 4096²", "f64",
         lambda lib: grid(lib, "complete_analysis", hyp_p, DOC_EXTENT, (4096, 4096),
                          torch.float64)),
        ("B1 potential 8000²", "f64",
         lambda lib: grid(lib, "potential", hyp_p, DOC_EXTENT, (8000, 8000),
                          torch.float64)),
        ("B1 hesse 8000²", "f64",
         lambda lib: grid(lib, "hesse", hyp_p, DOC_EXTENT, (8000, 8000), torch.float64)),
        ("B1 gradient 4096²", "f64",
         lambda lib: grid(lib, "gradient", hyp_p, DOC_EXTENT, (4096, 4096),
                          torch.float64)),
        ("B2 potential 8000² f32", "f32",
         lambda lib: grid(lib, "potential", hyp_p32, DOC_EXTENT, (8000, 8000), f32)),
        ("B2 complete_analysis 4096² f32", "f32",
         lambda lib: grid(lib, "complete_analysis", hyp_p32, DOC_EXTENT,
                          (4096, 4096), f32)),
        ("B1 D5 complete_analysis 1024²", "d5",
         lambda lib: grid(lib, "complete_analysis", d5_p, D5_EXTENT, (1024, 1024),
                          torch.float64)),
        ("B4 EGNO consistency_rapidturn 2048² dd", "egno",
         lambda lib: grid(lib, "consistency_rapidturn", egno_p, EGNO_EXTENT,
                          (2048, 2048), torch.float64)),
        ("B4 EGNO complete_analysis 2048² dd", "egno",
         lambda lib: grid(lib, "complete_analysis", egno_p, EGNO_EXTENT, (2048, 2048),
                          torch.float64)),
        ("B5a complete_analysis 8192000 points", "f64",
         lambda lib: points(lib, "complete_analysis", hyp_p, hyp_pts)),
        ("B5b EGNO complete_analysis 1048576 points dd", "egno",
         lambda lib: points(lib, "complete_analysis", egno_p, egno_pts)),
        ("B7a 32 x 512²", "f64",
         lambda lib: grid(lib, "complete_analysis", mass_p, DOC_EXTENT, (512, 512),
                          torch.float64)),
        ("B7b 32 x 512² f32", "f32",
         lambda lib: grid(lib, "complete_analysis", mass_p32, DOC_EXTENT, (512, 512),
                          f32)),
        ("B7d EGNO 8 x 512² dd", "egno",
         lambda lib: grid(lib, "consistency_rapidturn", egno_bp, EGNO_EXTENT,
                          (512, 512), torch.float64)),
    ]
    for label, header, run in cases:
        runs = {b: (lambda lib=libs[(b, header)]: run(lib)) for b in builds}
        want = runs["current"]().clone()
        for b, fn in runs.items():
            for buf in _OUT.values():
                buf.fill_(-7.0)  # a build that writes nothing cannot pass
            got = fn()
            assert bool(((got == want) | (got.isnan() & want.isnan())).all()), \
                f"{label}: {b} differs from current"
            del got
        del want
        one = window_ms(runs["current"], 1)
        n = max(3, min(400, int(200 / max(one, 1e-3))))
        windows = {b: [] for b in runs}
        for b in (list(runs) + list(runs)[::-1]) * ROUNDS:
            windows[b].append(window_ms(runs[b], n))
        ms = {b: sum(w) / len(w) for b, w in windows.items()}
        report["cases"][label] = {"ms": ms, "windows": windows, "launches_per_window": n}
        print(f"{label} on {card}: " + "; ".join(
            f"{b} {ms[b]:.4f} ms (windows {', '.join(f'{v:.4f}' for v in w)})"
            for b, w in windows.items()) + f"; {n} chained launches per window, all bit-identical")
        _OUT.clear()
        torch.cuda.empty_cache()
    with open(os.path.join(out_root, "report.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
