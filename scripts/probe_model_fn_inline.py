"""Grid-scan model functions called or inlined: nvcc time, registers and
kernel time on the card.

    python scripts/probe_model_fn_inline.py [--other DIR] [--timeout SECONDS]

Needs one NVIDIA GPU and nvcc.  For hyperinflation (f64 and f32), D5 (f64)
and EGNO (double-double) it builds the grid-scan library
(``csrc/grid_scan.cu``) in these variants, with the flags of
``inflatox_torch.ops.build``, one nvcc each, all started together, into
``build/inline_probe/``:

* ``inlined``: the header as generated, every model function inlined;
* ``called``: the same header with every model function (each ``f_*``:
  the grid functions' stages and the fused point functions)
  ``__device__ __noinline__``;
* ``other`` (with ``--other DIR``): the headers and ``csrc/`` of another
  checkout of this repository in DIR, the headers generated there by its own
  ``inflatox_torch`` in a subprocess.

A build that passes ``--timeout`` (default 540 s) is stopped and reported.
Then, for each scan below, every variant's output must be bit-identical to
``inlined``'s, and the variants are timed with CUDA events over chained
launches, in turns (a, b, c, c, b, a): B1 ``complete_analysis`` at 4096² (bench
cfg1), B1 ``potential`` and ``hesse`` at 8000² (cfg0), B2
``complete_analysis`` at 4096², D5 ``complete_analysis`` on B1 at 1024²
(cfg4), EGNO ``consistency_rapidturn`` and ``complete_analysis`` on B4 at
2048² (cfg3).
"""

import argparse
import ctypes
import json
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
EGNO_EXTENT = (0.46, 0.50, 0.0, 3.141592653589793)
EGNO_ARGS = {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0}
D5_EXTENT = (0.1, 36.0, 0.0, 4 * 3.141592653589793)
D5_ARGS = {"V0": -1.17e-8, "N": 1000.0, "g_s": 0.01, "l_s": 501.961, "u": 50 * 501.961,
           "q": 1.0, "p": 5.0, "a0": 0.001, "a1": 0.0005, "b1": 0.001}
#: a model function's head in a generated header
MODEL_FN = re.compile(r"^INFLX_FN (\w+) (f_\w+)\(", re.MULTILINE)

#: (library, precision) → the models' headers, printed as JSON; run by this
#: script's interpreter with the checkout to generate from first on sys.path
HEADERS = r"""
import json, os, sys
import inflatox_torch
here = os.path.dirname(os.path.abspath(inflatox_torch.__file__))
fixtures = os.path.join(here, os.pardir, "tests", "fixtures")
model, _ = inflatox_torch.models.hyperinflation()
hyp = inflatox_torch.Compiler(model, silent=True).compile()
d5 = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "d5_bundle.json"))
egno = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "egno_bundle.json"))
json.dump({"hyp_f64": hyp.cuda_source("f64"), "hyp_f32": hyp.cuda_source("f32"),
           "d5_f64": d5.cuda_source("f64"), "egno_dd": egno.cuda_source("dd")}, sys.stdout)
"""


def headers(checkout):
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {checkout!r})"
                          + HEADERS], capture_output=True, text=True, check=True)
    return json.loads(out.stdout)


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


def finish_build(name, job, deadline):
    try:
        job["proc"].wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        job["proc"].kill()
        job["proc"].wait()
        job["log"].close()
        print(f"build {name}: stopped after {time.perf_counter() - job['start']:.1f} s "
              "(timeout)")
        return None
    seconds = time.perf_counter() - job["start"]
    job["log"].close()
    text = open(job["log"].name).read()
    if job["proc"].returncode != 0:
        raise RuntimeError(f"build {name} failed:\n{text[-4000:]}")
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    stack = [int(v) for v in re.findall(r"(\d+) bytes stack frame", text)]
    print(f"build {name}: nvcc {seconds:.1f} s; ptxas {len(regs)} functions, registers "
          f"{min(regs)}-{max(regs)}, spill bytes at most {max(spills)}, stack frame at most "
          f"{max(stack)} bytes")
    lib = ctypes.CDLL(job["lib"])
    build._bind_grid_scan(lib)
    return lib


def launch(lib, kind, p, extent, shape, dtype):
    kind_id, n_out = KINDS[kind]
    n0, n1 = shape
    x0a, x0b, x1a, x1b = extent
    out = torch.empty((n_out, n0, n1), dtype=dtype, device="cuda")
    err = lib.inflx_grid_scan(kind_id, p.data_ptr(), out.data_ptr(), x0a, (x0b - x0a) / n0,
                              x1a, (x1b - x1a) / n1, n0, n1,
                              torch.cuda.current_stream().cuda_stream)
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
    parser.add_argument("--other", help="another checkout of this repository")
    parser.add_argument("--timeout", type=float, default=540.0)
    opts = parser.parse_args()
    import inflatox_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    fixtures = os.path.join(ROOT, "tests", "fixtures")
    model, hyp_args = inflatox_torch.models.hyperinflation()
    hyp = inflatox_torch.Compiler(model, silent=True).compile()
    d5 = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "d5_bundle.json"))
    egno = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "egno_bundle.json"))
    args = {"hyp_f64": hyp_args, "hyp_f32": hyp_args,
            "d5_f64": inflatox_torch.models._args_by_symbol(d5.model, D5_ARGS),
            "egno_dd": inflatox_torch.models._args_by_symbol(egno.model, EGNO_ARGS)}
    variants = {"inlined": (headers(ROOT), str(build.CSRC))}
    called = {k: MODEL_FN.sub(r"__device__ __noinline__ \1 \2(", h)
              for k, h in variants["inlined"][0].items()}
    assert all(len(MODEL_FN.findall(h)) == 4 for h in variants["inlined"][0].values())
    variants["called"] = (called, str(build.CSRC))
    if opts.other:
        variants["other"] = (headers(opts.other),
                             os.path.join(opts.other, "inflatox_torch", "csrc"))
    out_root = os.path.join(ROOT, "build", "inline_probe")
    jobs = {(v, k): start_build(f"{k}_{v}", h, csrc, out_root)
            for v, (hs, csrc) in variants.items() for k, h in hs.items()}
    deadline = time.perf_counter() + opts.timeout
    libs = {key: finish_build(f"{key[1]} {key[0]}", job, deadline) for key, job in jobs.items()}

    cases = [  # (library, kind, extent, shape)
        ("hyp_f64", "complete_analysis", DOC_EXTENT, (4096, 4096)),
        ("hyp_f64", "potential", DOC_EXTENT, (8000, 8000)),
        ("hyp_f64", "hesse", DOC_EXTENT, (8000, 8000)),
        ("hyp_f32", "complete_analysis", DOC_EXTENT, (4096, 4096)),
        ("d5_f64", "complete_analysis", D5_EXTENT, (1024, 1024)),
        ("egno_dd", "consistency_rapidturn", EGNO_EXTENT, (2048, 2048)),
        ("egno_dd", "complete_analysis", EGNO_EXTENT, (2048, 2048)),
    ]
    for key, kind, extent, shape in cases:
        dtype = torch.float32 if key.endswith("f32") else torch.float64
        p = torch.tensor(args[key], dtype=dtype, device="cuda")
        runs = {v: (lambda lib=libs[(v, key)]: launch(lib, kind, p, extent, shape, dtype))
                for v in variants if libs[(v, key)] is not None}
        want = runs["inlined"]()
        for v, fn in runs.items():
            got = fn()
            same = torch.equal(got, want) or bool(((got == want) | (got.isnan() & want.isnan()))
                                                  .all())
            assert same, f"{key} {kind}: {v} differs from inlined"
            del got
        one = window_ms(runs["inlined"], 1)
        n = max(3, min(200, int(200 / max(one, 1e-3))))
        order = list(runs) + list(runs)[::-1]
        windows = {v: [] for v in runs}
        for v in order:
            windows[v].append(window_ms(runs[v], n))
        print(f"{key} {kind} {shape[0]}x{shape[1]} on {card}: " + "; ".join(
            f"{v} {sum(w) / len(w):.4f} ms (windows {', '.join(f'{t:.4f}' for t in w)})"
            for v, w in windows.items()) + f"; {n} chained launches per window, all "
            "bit-identical to inlined")
        del want


if __name__ == "__main__":
    main()
