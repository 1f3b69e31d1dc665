"""The grid-scan and point-scan kernels of this checkout against another
tree's, and other build settings of this checkout, on the card.

    python scripts/probe_grid_stages.py [--rows 8,16,32] [--tree NAME=DIR ...]
        [--define NAME=FLAG[,FLAG...] ...] [--points]

Needs one NVIDIA GPU and nvcc.  Builds the grid-scan library from
``inflatox_torch/csrc`` of this checkout once for each value of ``--rows``
(``-DINFLX_ROWS``, the rows of one block; "current" is the checkout's own
value), for each ``--define`` (extra nvcc flags, e.g.
``-DINFLX_POINT_BLOCKS=3`` or ``-DINFLX_POINT_THREADS=128``), and from each
``--tree`` (e.g. the parent commit unpacked with ``git archive`` under
``build/``) with that tree's own headers (``scripts/tree_headers.py``), all
with the flags of ``inflatox_torch.ops.build``, one nvcc each, all started
together, into ``build/grid_stages_probe/``; prints ptxas's registers and
spills of each build and of each point-scan instance.  Headers:
hyperinflation f64 and f32, angular and D5 f64, EGNO double-double and
``chip_smoke.py``'s special-function models S1-S3 in f64.  Then for each scan below every
build's output must be bit-identical to the current one's, and the builds
are timed with CUDA events over chained launches (parameters on the card and
output buffers allocated before the timing, so that the card never waits for
the host), in four rounds of turns (a, b, c, c, b, a): B1
``complete_analysis`` at 4096² (bench cfg1), ``potential`` and ``hesse`` at
8000² (cfg0), ``gradient`` at 4096²; B2 ``potential`` at 8000² and
``complete_analysis`` at 4096²; B1 on D5 at 1024² (cfg4); B4 on EGNO at
2048² (cfg3/3b, both kinds); B5a over 8,192,000 points (uniform on cfg1's
window), over 1,048,576 points of angular (uniform on (-0.7, 0.7)²) and D5
(on cfg4's extent), and over 1,048,576 points of S1, S2 and S3 (``chip_smoke.py``'s
phase 24: uniform on each model's window, seed 24; through the coherence
pass, as the wrapper launches them, where a tree has it), S3's also
without the pass and sorted by x[0] (the same points permuted; the outputs
compared after permuting back, and the ratio of random to sorted printed); B5b over 1,048,576 points
(uniform on cfg3's window); B7a and B7b over 32 masses at 512² (cfg5) and
B7d over 8 values of EGNO's c at 512².  ``--points`` runs the point scans
alone and builds with ``-DINFLX_POINTS_ONLY`` (no grid instances, so the
builds take less time).  Writes the table to
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

from chip_smoke import point_instances  # noqa: E402
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
HEADERS = ("f64", "f32", "d5", "egno", "angular", "s1", "s2", "s3")
POINT_HEADERS = ("f64", "angular", "d5", "egno", "s1", "s2", "s3")
S1_EXTENT = (0.3, 2.0, 0.2, 1.2)  # chip_smoke.py's S1_EXTENT, S2_EXTENT
S2_EXTENT = (0.5, 3.0, 0.2, 1.5)
SPECIAL_POINTS = 1 << 20
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
    points = point_instances(text)
    print(f"build {label}: nvcc {seconds:.1f} s; ptxas {len(regs)} functions, registers "
          f"{min(regs)}-{max(regs)}, spill bytes (stores + loads) at most {max(spills)}; "
          "point instances (kind: registers, spill bytes): "
          + ", ".join(f"{k}: {r}, {b}" for k, (r, b) in points.items()))
    lib = ctypes.CDLL(job["lib"])
    lib.inflx_grid_scan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                    *_GEOMETRY, ctypes.c_void_p]
    lib.inflx_grid_scan_batch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                          *_GEOMETRY, ctypes.c_int64, ctypes.c_void_p]
    lib.inflx_points_scan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    for fn in (lib.inflx_grid_scan, lib.inflx_grid_scan_batch, lib.inflx_points_scan):
        fn.restype = ctypes.c_int
    if hasattr(lib, "inflx_points_scan_coherent"):  # a tree with the coherence pass
        build._bind_grid_scan(lib)
    return {"lib": lib, "registers": regs, "spills": spills, "nvcc_s": seconds,
            "point_instances": points}


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


def points(lib, kind, p, pts, coherent=False):
    """One point scan through the library's C entry; ``coherent``: after
    the coherence pass (``inflx_points_scan_coherent``, as the wrapper
    launches a special-function model's scan), where the library has it."""
    kind_id, n_out = KINDS[kind]
    out = _out((n_out, pts.shape[0]), torch.float64)
    stream = torch.cuda.current_stream().cuda_stream
    if coherent and hasattr(lib, "inflx_points_scan_coherent"):
        err = lib.inflx_points_scan_coherent(kind_id, p.data_ptr(), pts.data_ptr(),
                                             out.data_ptr(), pts.shape[0], stream)
    else:
        err = lib.inflx_points_scan(kind_id, p.data_ptr(), pts.data_ptr(), out.data_ptr(),
                                    pts.shape[0], stream)
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
    parser.add_argument("--define", action="append", default=[], metavar="NAME=FLAG[,FLAG]")
    parser.add_argument("--points", action="store_true", help="the point scans alone")
    opts = parser.parse_args()
    import inflatox_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    only = ("-DINFLX_POINTS_ONLY",) if opts.points else ()
    builds = {"current": (ROOT, only)}  # name: (tree, nvcc flags)
    for r in filter(None, opts.rows.split(",")):
        builds[f"rows{r}"] = (ROOT, (f"-DINFLX_ROWS={int(r)}", *only))
    for spec in opts.define:
        name, flags = spec.split("=", 1)
        builds[name] = (ROOT, (*flags.split(","), *only))
    for spec in opts.tree:
        name, path = spec.split("=", 1)
        builds[name] = (os.path.abspath(path), only)
    header_names = POINT_HEADERS if opts.points else HEADERS
    headers = {root: tree_headers(root, header_names) for root in {r for r, _ in builds.values()}}
    out_root = os.path.join(ROOT, "build", "grid_stages_probe")
    jobs = {(b, h): start_build(os.path.join(out_root, f"{b}_{h}"), headers[root][h],
                                os.path.join(root, "inflatox_torch", "csrc"), defines)
            for b, (root, defines) in builds.items() for h in header_names}
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
    special_pts = {}
    for name, extent in (("s1", S1_EXTENT), ("s2", S2_EXTENT), ("s3", S2_EXTENT)):
        rng_s = np.random.default_rng(24)
        special_pts[name] = dev(np.stack([rng_s.uniform(extent[0], extent[1], SPECIAL_POINTS),
                                          rng_s.uniform(extent[2], extent[3], SPECIAL_POINTS)], 1))
    order = torch.argsort(special_pts["s3"][:, 0])
    s3_sorted = special_pts["s3"][order].contiguous()
    special_p = dev([2.0])  # chip_smoke.py's SPECIAL_ARGS
    ang_model, ang_args = inflatox_torch.models.angular()
    ang_p = dev(ang_args)
    ang_pts = dev(np.stack([rng.uniform(-0.7, 0.7, SPECIAL_POINTS),
                            rng.uniform(-0.7, 0.7, SPECIAL_POINTS)], 1))
    d5_pts = dev(np.stack([rng.uniform(D5_EXTENT[0], D5_EXTENT[1], SPECIAL_POINTS),
                           rng.uniform(D5_EXTENT[2], D5_EXTENT[3], SPECIAL_POINTS)], 1))
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
        (f"B5a angular complete_analysis {SPECIAL_POINTS} points", "angular",
         lambda lib: points(lib, "complete_analysis", ang_p, ang_pts)),
        (f"B5a D5 complete_analysis {SPECIAL_POINTS} points", "d5",
         lambda lib: points(lib, "complete_analysis", d5_p, d5_pts)),
        *[(f"B5a {name.upper()} complete_analysis {SPECIAL_POINTS} points", name,
           lambda lib, name=name: points(lib, "complete_analysis", special_p, special_pts[name],
                                         coherent=True))
          for name in ("s1", "s2", "s3")],
        (f"B5a S3 complete_analysis {SPECIAL_POINTS} points without the coherence pass", "s3",
         lambda lib: points(lib, "complete_analysis", special_p, special_pts["s3"])),
        (f"B5a S3 complete_analysis {SPECIAL_POINTS} points sorted by x[0]", "s3",
         lambda lib: points(lib, "complete_analysis", special_p, s3_sorted)),
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
    if opts.points:
        cases = [c for c in cases if c[0].startswith("B5")]
    sorted_want = None
    for label, header, run in cases:
        runs = {b: (lambda lib=libs[(b, header)]: run(lib)) for b in builds}
        want = runs["current"]().clone()
        if "sorted" in label:  # the random-order scan's outputs, permuted
            assert bool(((want == sorted_want[:, order]) | (want.isnan() & sorted_want[:, order]
                                                            .isnan())).all()), \
                f"{label}: differs from the random-order scan"
        elif label.startswith("B5a S3") and sorted_want is None:
            sorted_want = want
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
        if "sorted" in label:
            random_ms = report["cases"][label.replace(" sorted by x[0]",
                                                      " without the coherence pass")]["ms"]
            report["cases"][label]["random_over_sorted"] = {b: random_ms[b] / ms[b] for b in ms}
            print(f"{label}: random / sorted " + ", ".join(
                f"{b} {random_ms[b] / ms[b]:.3f}" for b in ms))
        print(f"{label} on {card}: " + "; ".join(
            f"{b} {ms[b]:.4f} ms (windows {', '.join(f'{v:.4f}' for v in w)})"
            for b, w in windows.items()) + f"; {n} chained launches per window, all bit-identical")
        _OUT.clear()
        torch.cuda.empty_cache()
    with open(os.path.join(out_root, "report.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
