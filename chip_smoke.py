#!/usr/bin/env python3
"""Drive inflatox_torch's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (nvcc) and this checkout; builds the
grid-scan kernel (B1) from ``inflatox_torch/csrc`` into
``build/inflatox_torch_kernels/`` on first use.  Phases, each of which either
passes or ends the script with a nonzero exit:

1. environment: torch, CUDA, nvcc, sympy, card name and power limit;
2. build: the hyperinflation model through ``models`` → ``Compiler`` →
   ``GeneralisedAL(device="cuda")``, and the kernel's build time;
3. golden values of tests/test_doc.py (calc_V, calc_H);
4. the main path: ``complete_analysis`` at 4096² through the default
   engine (kernel B1), held against the plain PyTorch version on the card
   and, for rows 0-63, on the CPU (rtol 5e-10, identical NaN/±inf masks),
   then again at the README's 1000²;
5. a second model (angular) at 1024², through the same comparisons;
6. timing at 4096²: CUDA events over chained launches, kernel and plain
   version in turns (plain, kernel, kernel, plain); the kernel's device time
   from torch.profiler; the user-facing call on the host clock.

The last lines are the kernel table (JSON), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

RTOL = 5e-10  # the repo's tolerance for the six analysis maps
N_TIMED = 20  # chained calls per timing window of the plain version
N_TIMED_KERNEL = 200  # chained launches per kernel window (~0.1 s of work)
DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)  # bench cfg1 extent
README_EXTENT = (0.0, 2.5, 0.0, 3.141592653589793)
ANGULAR_EXTENT = (-0.7, 0.7, -0.7, 0.7)  # inside the unit disc
GOLDEN_V = 1.9166666666666667  # tests/test_doc.py
GOLDEN_H = [[0.41206897, -1.05517241], [-1.05517241, -0.07873563]]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout or out.stderr).strip()


def compare(got, want, rtol=RTOL):
    """(max relative error, max absolute error, share bit-identical) of two
    map stacks on one device; raises unless the NaN and ±inf masks are
    identical and every finite value is within rtol (atol 0)."""
    import torch

    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        check(torch.equal(mask(got), mask(want)), f"{mask.__name__} masks differ")
    finite = torch.isfinite(want)
    diff = (got - want).abs()
    scale = want.abs()
    check(bool((diff[finite] <= rtol * scale[finite]).all()),
          f"maps differ beyond rtol {rtol}")
    nonzero = finite & (scale > 0)
    rel = (diff[nonzero] / scale[nonzero]).max().item() if nonzero.any() else 0.0
    absolute = diff[finite].max().item() if finite.any() else 0.0
    same = ((got == want) | (torch.isnan(got) & torch.isnan(want))).double().mean().item()
    return rel, absolute, same


def nanmax(t):
    import torch

    return t[~torch.isnan(t)].max().item()


def scan_and_check(al, art, args, extent, n, label):
    """The main path at n² plus its comparisons; returns (maps, launches,
    max abs error against the plain version on the card)."""
    import torch

    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.cuda_kernels import evaluate_points
    from inflatox_torch.ops.grid import axis_coords

    cuda_kernels.LAUNCHES = 0
    maps = al.complete_analysis(args, *extent, n, n, progress=False, output="f64_device")
    torch.cuda.synchronize()
    launches = cuda_kernels.LAUNCHES
    check(launches > 0, f"{label}: the main path launched no kernel")
    maps = torch.stack(maps)
    check(maps.shape == (6, n, n) and maps.dtype == torch.float64,
          f"{label}: maps of shape {tuple(maps.shape)}, {maps.dtype}")
    check(nanmax(maps[0]) <= 1.0, f"{label}: nanmax(consistency) > 1")
    check(bool(torch.isfinite(maps).any()), f"{label}: no finite value")

    plain = torch.stack(al.complete_analysis(args, *extent, n, n, progress=False,
                                             engine="torch", output="f64_device"))
    rel, absolute, same = compare(maps, plain)
    print(f"{label}: launches={launches} kernel vs plain torch on the card: "
          f"max_rel={rel:.3e} max_abs={absolute:.3e} bit_identical={same:.6f}")

    rows = 64
    x0 = axis_coords(extent[0], extent[1], n)[:rows].reshape(rows, 1).expand(rows, n)
    x1 = axis_coords(extent[2], extent[3], n).reshape(1, n).expand(rows, n)
    cpu = evaluate_points(art, "complete_analysis", args, (x0, x1))
    rel, absolute_cpu, same = compare(maps[:, :rows].cpu(), cpu)
    print(f"{label}: kernel rows 0-{rows - 1} vs plain torch on the CPU: "
          f"max_rel={rel:.3e} max_abs={absolute_cpu:.3e} bit_identical={same:.6f}")
    return maps, launches, absolute


def time_ms(fn, n=N_TIMED):
    import torch

    for _ in range(3):  # warm-up
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sympy

    import inflatox_torch
    from inflatox_torch.consistency_conditions import GeneralisedAL
    from inflatox_torch.ops.build import find_nvcc, load_grid_scan
    from inflatox_torch.ops.cuda_kernels import scan_cuda, scan_torch

    # 1. environment
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0] if card else "unknown"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print("nvcc: " + run([find_nvcc(), "--version"]).splitlines()[-1])
    print(f"sympy {sympy.__version__}")
    print(f"card: {card} (torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s))")
    device = torch.device("cuda", 0)

    # 2. build: model, lowering, kernel
    t0 = time.perf_counter()
    model, args = inflatox_torch.models.hyperinflation()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    t1 = time.perf_counter()
    load_grid_scan(art.cuda_source())
    t2 = time.perf_counter()
    al = GeneralisedAL(art, device=device, validation_seed=7)
    print(f"build: hyperinflation model {t1 - t0:.2f} s, kernel B1 first use "
          f"(nvcc + load) {t2 - t1:.2f} s")

    # 3. golden values
    v = al.calc_V([2.0, -2.0], [1.0])
    h = al.calc_H([2.0, -2.0], [1.0])
    check(abs(v - GOLDEN_V) <= 1e-12 * GOLDEN_V, f"calc_V = {v!r}")
    check(all(abs(h[a][b] - GOLDEN_H[a][b]) <= 1e-8 + 1e-5 * abs(GOLDEN_H[a][b])
              for a in range(2) for b in range(2)), f"calc_H = {h.tolist()}")
    print(f"golden: calc_V([2,-2],[1]) = {v!r}, calc_H = {h.tolist()}")

    # 4. the main path at the bench size, then at the README's
    _, launches, max_abs = scan_and_check(al, art, args, DOC_EXTENT, 4096,
                                          "hyperinflation 4096²")
    scan_and_check(al, art, args, README_EXTENT, 1000, "hyperinflation 1000² (README)")

    # 5. a second model
    ang_model, ang_args = inflatox_torch.models.angular()
    ang = inflatox_torch.Compiler(ang_model, silent=True).compile()
    ang_al = GeneralisedAL(ang, device=device, validate_basis=False)
    ang_al.validate_basis_on_domain(ang_args, [-0.7, -0.7], [0.7, 0.7], N=63)
    scan_and_check(ang_al, ang, ang_args, ANGULAR_EXTENT, 1024, "angular 1024²")

    # 6. timing at 4096², in turns: plain, kernel, kernel, plain
    n = 4096

    def kernel():
        scan_cuda(art, "complete_analysis", args, DOC_EXTENT, (n, n), device)

    def plain():
        scan_torch(art, "complete_analysis", args, DOC_EXTENT, (n, n), device)

    plain_a = time_ms(plain)
    kernel_a = time_ms(kernel, N_TIMED_KERNEL)
    kernel_b = time_ms(kernel, N_TIMED_KERNEL)
    plain_b = time_ms(plain)
    ms = (kernel_a + kernel_b) / 2
    plain_ms = (plain_a + plain_b) / 2
    print(f"timing hyperinflation complete_analysis {n}² f64 on {card}: "
          f"kernel B1 {ms:.4f} ms/launch ({n * n / ms * 1e3:.4e} points/s; "
          f"windows {kernel_a:.4f}, {kernel_b:.4f}; {N_TIMED_KERNEL} chained "
          f"launches each), plain torch {plain_ms:.4f} ms "
          f"({n * n / plain_ms * 1e3:.4e} points/s; windows {plain_a:.4f}, "
          f"{plain_b:.4f}; {N_TIMED} chained calls each)")

    # the kernel's own device time, from the profiler's trace, and the
    # wrapper's host time per call (enqueue only)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(N_TIMED):
            kernel()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "grid_scan_kernel" in e.key]
    device_us = sum(getattr(e, "device_time_total", 0) for e in events)
    count = sum(e.count for e in events)
    t = time.perf_counter()
    for _ in range(N_TIMED):
        kernel()
    enqueue_ms = (time.perf_counter() - t) * 1e3 / N_TIMED
    torch.cuda.synchronize()
    traced = f"{device_us / count / 1e3:.4f} ms" if count and device_us else "not measured"
    print(f"kernel B1 device time per launch (torch.profiler, {count} launches): "
          f"{traced}; wrapper host time per call (enqueue): {enqueue_ms:.4f} ms")

    # the user-facing call, host clock: numpy maps (device → host copy of
    # the six maps included) and maps left on the device
    def host_ms(output):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            al.complete_analysis(args, *DOC_EXTENT, n, n, progress=False, output=output)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times[1:])[1]  # median of three, after one warm-up

    print(f"end to end complete_analysis {n}² on {card}: output='f64' "
          f"{host_ms('f64'):.3f} ms, output='f64_device' "
          f"{host_ms('f64_device'):.3f} ms (host clock, median of 3)")

    print(json.dumps({"kernels": [{
        "name": "grid_scan_b1",
        "route": "cuda",
        "source": "inflatox_torch/csrc/grid_scan.cu",
        "replaces": "inflatox_tpu/ops/pallas_kernels.py:388",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    finally:
        if "joblib" in sys.modules:  # the symbolic build's worker pool
            from joblib.externals.loky import get_reusable_executor

            get_reusable_executor().shutdown(wait=True)
    sys.exit(code)
