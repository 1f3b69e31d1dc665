"""Where kernel B6's time per attempt goes, on the card.

    python scripts/probe_solver_chain.py [--tree NAME=DIR ...]

Needs one NVIDIA GPU and nvcc.  For this checkout ("current") and each
``--tree`` (another checkout, e.g. the parent commit unpacked with ``git
archive`` under ``build/``), the hyperinflation solver header comes from that
tree's own code generator (``scripts/tree_headers.py``), and three libraries
are built from the tree's ``inflatox_torch/csrc``, one nvcc each, all started
together, into ``build/solver_chain_probe/<tree>/``:

* ``lib``: the solver library as ``inflatox_torch.ops.build`` builds it;
* ``total``: a probe kernel of the solver kernel's shape (blocks of 32, one
  thread a trajectory) around ``inflx_solve_trajectory``, with ``clock64()``
  read before and after the whole trajectory;
* ``parts``: the same with ``INFLX_STAMP`` defined (the hooks of
  ``csrc/solver.cuh``): each stamp stores its part's last result to shared
  memory, reads ``clock64()`` and adds the cycles since the last stamp to
  its part (``INFLX_PART_*``), and counts itself.

Then, at cfg5d (4096 trajectories × 2000 rows, RKF45, ``default_rng(0)``
initial fields in [1.5, 2.5]²) and at 4096 × 500 RK4: the library's kernel
time by CUDA events, for the batch and for trajectory 0 alone, the trees in
turns (a, b, b, a); cycles per attempt of each part and in all, from
``parts`` and ``total``, for trajectory 0 alone and for the batch (its mean
and its trajectory 0); and the SASS of the library's kernels
(``cuobjdump -sass``), counted by opcode per function: DFMA, DADD, DMUL,
MUFU.RCP64H, MUFU.RSQ64H, CALL, BRA, BSSY, BSYNC and the rest.  A tree whose
``solver.cuh`` has no ``INFLX_STAMP`` hooks (the parent of the commit that
added them) gets them inserted into a copy of its ``csrc/`` at the same
places (:func:`add_stamps`).  A tree whose build fails is reported and
left out.  ``--variant NAME`` adds this checkout's code with its solver
header edited (:data:`VARIANTS`; ``nofb``: ``inflx_deriv`` without the
branch to its exact fallback, which changes no bit while every division is
in range).  The latency kernel is built for this checkout and each variant.
Writes everything to ``build/solver_chain_probe/report.json`` as well, and
each tree's library SASS to ``build/solver_chain_probe/<tree>/sass.txt``.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from inflatox_torch.ops import build  # noqa: E402
from tree_headers import tree_headers  # noqa: E402

N_PARTS = 16  # slots per thread; csrc/solver.cuh uses the first INFLX_N_PARTS
PART_NAMES = ("deriv", "combine", "norm", "recip", "pow", "accept", "store")
SLOTS = 1 + 2 * N_PARTS  # total cycles, then cycles and counts per part
OPCODES = ("DFMA", "DADD", "DMUL", "MUFU.RCP64H", "MUFU.RSQ64H", "CALL", "BRA", "BSSY", "BSYNC")

_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "inflx_model.h"

#define PROBE_THREADS 32
#define PROBE_SLOTS %(n_parts)d
#ifdef PROBE_PARTS
__shared__ long long probe_acc[PROBE_THREADS][PROBE_SLOTS];
__shared__ long long probe_count[PROBE_THREADS][PROBE_SLOTS];
__shared__ long long probe_last[PROBE_THREADS];
__shared__ double probe_sink[PROBE_THREADS];
__device__ __forceinline__ void probe_stamp(int part, double value) {
  const int t = threadIdx.x;
  ((volatile double*)probe_sink)[t] = value;
  long long now;
  asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(now) :: "memory");
  probe_acc[t][part] += now - probe_last[t];
  probe_count[t][part] += 1;
  probe_last[t] = now;
}
#define INFLX_STAMP(part, value) probe_stamp(part, value)
#endif
#include "solver.cuh"

template <int METHOD>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_kernel(const double* f0, const double* d0, const double* p, int64_t p_stride,
             double* out, int64_t n_traj, int64_t steps, double max_err,
             double inv_max_err, long long* cycles) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_traj) return;
  long long start, stop;
  asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(start) :: "memory");
#ifdef PROBE_PARTS
  for (int k = 0; k < PROBE_SLOTS; ++k) {
    probe_acc[threadIdx.x][k] = 0;
    probe_count[threadIdx.x][k] = 0;
  }
  probe_last[threadIdx.x] = start;
#endif
  inflx_solve_trajectory<METHOD>(f0 + b * INFLX_NF, d0 + b * INFLX_NF,
                                 p == nullptr ? p : p + b * p_stride, steps, max_err,
                                 inv_max_err, out + b, (int64_t)(INFLX_NY + 1) * n_traj,
                                 n_traj);
  asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(stop) :: "memory");
  long long* c = cycles + b * (1 + 2 * PROBE_SLOTS);
  c[0] = stop - start;
#ifdef PROBE_PARTS
  for (int k = 0; k < PROBE_SLOTS; ++k) {
    c[1 + k] = probe_acc[threadIdx.x][k];
    c[1 + PROBE_SLOTS + k] = probe_count[threadIdx.x][k];
  }
#endif
}

extern "C" int probe_solve(int method, const void* f0, const void* d0, const void* p,
                           int64_t p_stride, void* out, int64_t n_traj, int64_t steps,
                           double max_err, double inv_max_err, void* cycles,
                           void* stream) {
  const dim3 block(PROBE_THREADS);
  const dim3 grid((unsigned)((n_traj + PROBE_THREADS - 1) / PROBE_THREADS));
  cudaStream_t s = (cudaStream_t)stream;
#define PROBE_LAUNCH(M)                                                        \
  probe_kernel<M><<<grid, block, 0, s>>>((const double*)f0, (const double*)d0, \
      (const double*)p, p_stride, (double*)out, n_traj, steps, max_err,        \
      inv_max_err, (long long*)cycles)
  if (method == INFLX_RKF45) PROBE_LAUNCH(INFLX_RKF45);
  else PROBE_LAUNCH(INFLX_RK4);
  return (int)cudaGetLastError();
}
"""

# The stamps of csrc/solver.cuh, as text edits of the integrator that had
# none (one thread per trajectory, a row loop around an attempt loop, the
# derivative inflx_deriv(y, p, k)).
_STAMP_EDITS = (
    ("enum { INFLX_RKF45 = 0, INFLX_RK4 = 1 };",
     "enum { INFLX_RKF45 = 0, INFLX_RK4 = 1 };\n"
     "enum { INFLX_PART_DERIV, INFLX_PART_COMBINE, INFLX_PART_NORM, INFLX_PART_RECIP,\n"
     "       INFLX_PART_POW, INFLX_PART_ACCEPT, INFLX_PART_STORE, INFLX_N_PARTS };"),
    ("    inflx_deriv(yn, p, k[n]);\n",
     "    INFLX_STAMP(INFLX_PART_COMBINE, yn[INFLX_NY - 1]);\n"
     "    inflx_deriv(yn, p, k[n]);\n"
     "    INFLX_STAMP(INFLX_PART_DERIV, k[n][INFLX_NY - 1]);\n"),
    ("    if (LO) lo[c] = accl;\n  }\n}",
     "    if (LO) lo[c] = accl;\n  }\n  INFLX_STAMP(INFLX_PART_COMBINE, hi[INFLX_NY - 1]);\n}"),
    ("  const double err = sqrt(e2);\n",
     "  const double err = sqrt(e2);\n  INFLX_STAMP(INFLX_PART_NORM, err);\n"),
    ("    q = pow(inflx_mul(1.0 / (err > 1e-300 ? err : 1e-300), max_err), exponent);\n"
     "    q = q < 0.1 ? 0.1 : q;\n    q = q > 5.0 ? 5.0 : q;\n",
     "    const double ratio = inflx_mul(1.0 / (err > 1e-300 ? err : 1e-300), max_err);\n"
     "    INFLX_STAMP(INFLX_PART_RECIP, ratio);\n    q = pow(ratio, exponent);\n"
     "    q = q < 0.1 ? 0.1 : q;\n    q = q > 5.0 ? 5.0 : q;\n"
     "    INFLX_STAMP(INFLX_PART_POW, q);\n"),
    ("  *dt = inflx_mul(*dt, q);\n  return accept;",
     "  *dt = inflx_mul(*dt, q);\n  INFLX_STAMP(INFLX_PART_ACCEPT, *dt);\n  return accept;"),
    ("    row[INFLX_NY * comp_stride] = t;\n",
     "    row[INFLX_NY * comp_stride] = t;\n    INFLX_STAMP(INFLX_PART_STORE, t);\n"),
)


def add_stamps(csrc, work):
    """A copy of ``csrc`` under ``work`` whose solver.cuh has the stamps;
    returns its path, or None when an edit does not apply."""
    text = open(os.path.join(csrc, "solver.cuh")).read()
    for old, new in _STAMP_EDITS:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    text = text.replace('#include "inflx_math.cuh"\n',
                        '#include "inflx_math.cuh"\n#ifndef INFLX_STAMP\n'
                        '#define INFLX_STAMP(part, value)\n#endif\n', 1)
    copy = os.path.join(work, "csrc_stamped")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(csrc, copy)
    with open(os.path.join(copy, "solver.cuh"), "w") as f:
        f.write(text)
    return copy


# Latencies on one thread: dependent chains of each operation, of B6's
# slope (inflx_slope: the merged derivative with inflx_div_fast, then the
# state update) and of the derivative with the operator's divisions
# (inflx_deriv_exact); and fast_div (csrc/inflx_math.cuh's
# inflx_div_fast without its range flag) against a / b, bit for bit.
_LATENCY = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "inflx_model.h"
#include "solver.cuh"

__device__ __forceinline__ double fast_div(double a, double b) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(b));
  double e = fma(-b, y, 1.0);
  y = fma(y, e, y);
  e = fma(-b, y, 1.0);
  y = fma(y, e, y);
  const double q = __dmul_rn(a, y);
  return fma(fma(-b, q, a), y, q);
}

#define LAT_N 1024
// cycles per operation of each chain, written to out[0..]
extern "C" __global__ void latency_kernel(double seed, const double* __restrict__ p,
                                          long long* out, double* sink) {
  double x = seed, y = seed + 0.5, acc = 0.0;
  long long t0, t1;
#define CHAIN(k, body)                                               \
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0) :: "memory");     \
  for (int i = 0; i < LAT_N; ++i) { body; }                          \
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1) :: "memory");     \
  out[k] = (t1 - t0) / LAT_N; acc += x + y;
  CHAIN(0, x = inflx_add(x, 1e-3))
  CHAIN(1, x = inflx_mul(x, 1.0000001))
  CHAIN(2, x = 1.7 / x)
  CHAIN(3, x = fast_div(1.7, x))
  CHAIN(4, x = 1.7 / x; y = 2.3 / y)
  CHAIN(5, x = sqrt(x + 1.0))
  CHAIN(6, x = pow(x + 1.0, 1.0 / 7.0))
  CHAIN(7, x = inflx_mul(1.0 / (x > 1e-300 ? x : 1e-300), 1.7))
  {
    double st[INFLX_NY], k[INFLX_NY];
    for (int c = 0; c < INFLX_NY; ++c) st[c] = seed + 0.1 * c;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0) :: "memory");
    for (int i = 0; i < LAT_N; ++i) {
      inflx_slope(st, p, k);
      for (int c = 0; c < INFLX_NY; ++c) st[c] = inflx_add(st[c], inflx_mul(1e-9, k[c]));
    }
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1) :: "memory");
    out[8] = (t1 - t0) / LAT_N;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0) :: "memory");
    for (int i = 0; i < LAT_N; ++i) {
      inflx_deriv_exact(st, st + INFLX_NF, p, k);
      for (int c = 0; c < INFLX_NY; ++c) st[c] = inflx_add(st[c], inflx_mul(1e-9, k[c]));
    }
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1) :: "memory");
    out[9] = (t1 - t0) / LAT_N;
    for (int c = 0; c < INFLX_NY; ++c) acc += st[c];
  }
  *sink = acc + x + y;
}

__device__ unsigned long long mix(unsigned long long z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// fast_div against a / b at n pairs with exponents in [-emax, emax]:
// counts the pairs whose bits differ
extern "C" __global__ void div_check_kernel(long long n, int emax, unsigned long long* bad) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned long long u = mix(2 * i), v = mix(2 * i + 1);
    const long long ea = (long long)((u >> 52) % (2 * emax + 1)) - emax;
    const long long eb = (long long)((v >> 52) % (2 * emax + 1)) - emax;
    const double a = __longlong_as_double((long long)((u & 0x800fffffffffffffull) |
                                          ((unsigned long long)(ea + 1023) << 52)));
    const double b = __longlong_as_double((long long)((v & 0x800fffffffffffffull) |
                                          ((unsigned long long)(eb + 1023) << 52)));
    if (__double_as_longlong(fast_div(a, b)) != __double_as_longlong(a / b))
      atomicAdd(bad, 1ull);
  }
}

extern "C" int latency(double seed, const void* p, void* out, void* sink) {
  latency_kernel<<<1, 1>>>(seed, (const double*)p, (long long*)out, (double*)sink);
  return (int)cudaGetLastError();
}
extern "C" int div_check(long long n, int emax, void* bad) {
  div_check_kernel<<<1024, 256>>>(n, emax, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
"""
LATENCY_NAMES = ("add", "mul", "div", "fast_div", "two_divs", "sqrt", "pow", "recip_mul",
                 "slope", "deriv_exact")

_FALLBACK = "  } else {\n    inflx_deriv_cold_into(x, xd, p, out);\n  }\n"


def strip_fallback(header):
    """The solver header with ``inflx_deriv``'s branch to its fallback
    removed (the outputs are then wrong only where a
    division is out of ``inflx_div_fast``'s range)."""
    if header.count(_FALLBACK) != 1:
        raise ValueError("the solver header has no single fallback branch")
    return header.replace(_FALLBACK, "  }\n")


VARIANTS = {"nofb": strip_fallback}

_SOLVE_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
               ctypes.c_double]


def start_build(work, csrc, source, flags, lib_name):
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-I", work, "-I", csrc,
           "-o", os.path.join(work, lib_name), source]
    log = open(os.path.join(work, lib_name + ".log"), "w")
    return {"proc": subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), "log": log,
            "lib": os.path.join(work, lib_name), "start": time.perf_counter()}


def finish_build(label, job):
    """The loaded library, or None (reported) when the build failed."""
    job["proc"].wait()
    job["log"].close()
    text = open(job["log"].name).read()
    if job["proc"].returncode != 0:
        print(f"build {label} FAILED:\n{text[-4000:]}")
        return None
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    print(f"build {label}: nvcc {time.perf_counter() - job['start']:.1f} s; ptxas registers "
          f"{regs}, spill bytes {[int(a) + int(b) for a, b in spills]}")
    return ctypes.CDLL(job["lib"])


def sass_text(lib_path):
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout


def sass_counts(text):
    """{function: Counter of opcodes} of a library's SASS text."""
    counts, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and current is not None:
            op = m.group(1)
            base = op.split(".")[0]
            current[op if base == "MUFU" else base] += 1
    return counts


def parts_summary(c):
    """Attribution from a ``parts`` run's (batch, SLOTS) counts: attempts of
    trajectory 0 (and the batch's most, mean and total), cycles per attempt of
    each part for trajectory 0 and the batch mean, stamps per attempt, and
    the instrumented cycles per attempt of trajectory 0."""
    attempts = c[:, 1 + N_PARTS + 2]  # one error norm per attempt
    return {
        "attempts_traj0": int(attempts[0]), "attempts_max": int(attempts.max()),
        "attempts_mean": float(attempts.mean()), "attempts_total": int(attempts.sum()),
        "instrumented_cycles_per_attempt_traj0": float(c[0, 0]) / attempts[0],
        "parts_per_attempt_traj0": {part: float(c[0, 1 + k]) / attempts[0]
                                    for k, part in enumerate(PART_NAMES)},
        "parts_per_attempt_mean": {part: float((c[:, 1 + k] / attempts).mean())
                                   for k, part in enumerate(PART_NAMES)},
        "stamps_per_attempt_traj0": {part: float(c[0, 1 + N_PARTS + k]) / attempts[0]
                                     for k, part in enumerate(PART_NAMES)},
    }


def load_parts(header, name="smoke"):
    """This checkout's instrumented solver library for one generated solver
    header, built now into ``build/solver_chain_probe/<name>/`` (a
    ``ctypes`` library with ``build_seconds`` and ``build_log``)."""
    work = os.path.join(ROOT, "build", "solver_chain_probe", name)
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "inflx_model.h"), "w") as f:
        f.write(header)
    probe = os.path.join(work, "probe.cu")
    with open(probe, "w") as f:
        f.write(_PROBE % {"n_parts": N_PARTS})
    job = start_build(work, str(build.CSRC), probe, ("-DPROBE_PARTS",), "parts.so")
    lib = finish_build(f"{name} parts", job)
    if lib is None:
        raise RuntimeError("the instrumented solver library did not build")
    lib.probe_solve.argtypes = _SOLVE_ARGS + [ctypes.c_void_p, ctypes.c_void_p]
    lib.probe_solve.restype = ctypes.c_int
    lib.build_seconds = time.perf_counter() - job["start"]
    lib.build_log = job["log"].name
    return lib


def attribute(lib, method, f0, d0, p, steps, max_err=1e-6):
    """One run of an instrumented (``parts``) library on the (B, n) initial
    states f0, d0 and shared parameters p, all on the card; returns
    :func:`parts_summary`."""
    batch = f0.shape[0]
    out = torch.empty((steps, 2 * f0.shape[1] + 2, batch), dtype=torch.float64,
                      device=f0.device)
    cyc = torch.zeros((batch, SLOTS), dtype=torch.int64, device=f0.device)
    err = lib.probe_solve(method, f0.data_ptr(), d0.data_ptr(), p.data_ptr(), 0, out.data_ptr(),
                          batch, steps, max_err, 1.0 / max_err, cyc.data_ptr(),
                          torch.cuda.current_stream(f0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_solve failed: CUDA error {err}")
    return parts_summary(cyc.cpu().numpy())


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
    parser.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    opts = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    trees = {"current": ROOT}
    for spec in opts.tree:
        name, path = spec.split("=", 1)
        trees[name] = os.path.abspath(path)
    for name in opts.variant:
        trees[name] = ROOT
    headers = {root: tree_headers(root, ("solver",))["solver"] for root in set(trees.values())}
    out_root = os.path.join(ROOT, "build", "solver_chain_probe")
    jobs = {}
    for name, root in trees.items():
        csrc = os.path.join(root, "inflatox_torch", "csrc")
        work = os.path.join(out_root, name)
        os.makedirs(work, exist_ok=True)
        header = VARIANTS[name](headers[root]) if name in VARIANTS else headers[root]
        with open(os.path.join(work, "inflx_model.h"), "w") as f:
            f.write(header)
        with open(os.path.join(work, "probe.cu"), "w") as f:
            f.write(_PROBE % {"n_parts": N_PARTS})
        probe = os.path.join(work, "probe.cu")
        jobs[(name, "lib")] = start_build(work, csrc, os.path.join(csrc, "solver.cu"), (),
                                          "lib.so")
        jobs[(name, "total")] = start_build(work, csrc, probe, (), "total.so")
        with open(os.path.join(csrc, "solver.cuh")) as f:
            stamped = csrc if "INFLX_STAMP" in f.read() else add_stamps(csrc, work)
        if stamped is not None:
            jobs[(name, "parts")] = start_build(work, stamped, probe, ("-DPROBE_PARTS",),
                                                "parts.so")
        if name == "current" or name in VARIANTS:
            with open(os.path.join(work, "latency.cu"), "w") as f:
                f.write(_LATENCY)
            jobs[(name, "latency")] = start_build(work, csrc, os.path.join(work, "latency.cu"),
                                                  (), "latency.so")
    libs = {key: finish_build(f"{key[0]} {key[1]}", job) for key, job in jobs.items()}
    for name in list(trees):
        if libs.get((name, "lib")) is None or libs.get((name, "total")) is None:
            print(f"tree {name} left out: its build failed")
            del trees[name]
    libs = {key: lib for key, lib in libs.items() if lib is not None and key[0] in trees}
    if "current" not in trees:
        sys.exit(1)
    latency_libs = {name: libs.pop((name, "latency")) for name in list(trees)
                    if (name, "latency") in libs}
    for (name, what), lib in libs.items():
        if what == "lib":
            build._bind_solver(lib)
        else:
            lib.probe_solve.argtypes = _SOLVE_ARGS + [ctypes.c_void_p, ctypes.c_void_p]
            lib.probe_solve.restype = ctypes.c_int

    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f0 = torch.tensor(np.stack([rng.uniform(1.5, 2.5, 4096), rng.uniform(1.5, 2.5, 4096)], 1),
                      device=device)
    d0 = torch.zeros_like(f0)
    p = torch.tensor([1.0], dtype=torch.float64, device=device)
    report = {"card": card, "cases": {}}
    report["latency_cycles"] = {}
    for name, latency_lib in latency_libs.items():
        lat = torch.zeros(len(LATENCY_NAMES), dtype=torch.int64, device=device)
        sink = torch.zeros(1, dtype=torch.float64, device=device)
        assert latency_lib.latency(ctypes.c_double(1.3), ctypes.c_void_p(p.data_ptr()),
                                   ctypes.c_void_p(lat.data_ptr()),
                                   ctypes.c_void_p(sink.data_ptr())) == 0
        report["latency_cycles"][name] = dict(zip(LATENCY_NAMES, lat.tolist()))
        print(f"latency on one thread ({name}), cycles per operation of a dependent chain: "
              + ", ".join(f"{k} {v}" for k, v in report["latency_cycles"][name].items()))
        if name != "current":
            continue
        report["fast_div_mismatches"] = {}
        for emax in (60, 500):
            bad = torch.zeros(1, dtype=torch.int64, device=device)
            n = 1 << 32
            assert latency_lib.div_check(ctypes.c_longlong(n), ctypes.c_int(emax),
                                         ctypes.c_void_p(bad.data_ptr())) == 0
            report["fast_div_mismatches"][emax] = int(bad.item())
            print(f"fast_div against a / b, {n} pairs with exponents in [-{emax}, {emax}]: "
                  f"{int(bad.item())} differ")
    for method, label, steps in ((0, "rkf", 2000), (1, "rk4", 500)):
        case = report["cases"][label] = {}
        for batch in (4096, 1):
            out = torch.empty((steps, 6, batch), dtype=torch.float64, device=device)

            def run(lib, what, cycles=None, batch=batch, out=out):
                stream = torch.cuda.current_stream().cuda_stream
                args = (method, f0.data_ptr(), d0.data_ptr(), p.data_ptr(), 0, out.data_ptr(),
                        batch, steps, 1e-6, 1e6)
                if what == "lib":  # no work counter
                    err = lib.inflx_solve(*args, stream, None)
                else:
                    err = lib.probe_solve(*args, cycles.data_ptr(), stream)
                assert err == 0, err

            rows = {}
            for name in trees:
                run(libs[(name, "lib")], "lib")
                rows[name] = out.clone()
            for name in trees:
                same = bool(((rows[name] == rows["current"])
                             | (rows[name].isnan() & rows["current"].isnan())).all())
                case.setdefault("bit_identical_to_current", {})[f"{name} B={batch}"] = same
            del rows
            one = window_ms(lambda: run(libs[("current", "lib")], "lib"), 1)
            n = max(3, min(50, int(400 / max(one, 1e-3))))
            windows = {name: [] for name in trees}
            for name in list(trees) + list(trees)[::-1]:
                windows[name].append(window_ms(lambda: run(libs[(name, "lib")], "lib"), n))
            ms = {name: sum(w) / len(w) for name, w in windows.items()}
            print(f"B6 {label} {batch}x{steps} on {card}: "
                  + "; ".join(f"{name} {ms[name]:.4f} ms (windows "
                              f"{', '.join(f'{v:.4f}' for v in w)})"
                              for name, w in windows.items())
                  + f"; {n} chained launches per window")
            entry = case[f"B={batch}"] = {"ms": ms, "windows": windows, "trees": {}}
            for name in trees:
                cyc = torch.zeros((batch, SLOTS), dtype=torch.int64, device=device)
                run(libs[(name, "total")], "total", cyc)
                total = cyc[:, 0].double()
                t = {"total_cycles_traj0": int(cyc[0, 0]),
                     "total_cycles_max": int(cyc[:, 0].max()),
                     "total_cycles_mean": float(total.mean())}
                if (name, "parts") in libs:
                    cyc = torch.zeros((batch, SLOTS), dtype=torch.int64, device=device)
                    run(libs[(name, "parts")], "parts", cyc)
                    torch.cuda.synchronize()
                    t.update(parts_summary(cyc.cpu().numpy()))
                    attempts0 = t["attempts_traj0"]
                    t["total_cycles_per_attempt_traj0"] = t["total_cycles_traj0"] / attempts0
                    t["us_per_attempt_traj0"] = ms[name] * 1e3 / attempts0 if batch == 1 \
                        else None
                    print(f"  {name} B={batch} {label}: trajectory 0 {attempts0} attempts "
                          f"(batch max {t['attempts_max']}, mean {t['attempts_mean']:.2f}); "
                          f"cycles per attempt uninstrumented "
                          f"{t['total_cycles_per_attempt_traj0']:.0f}, instrumented "
                          f"{t['instrumented_cycles_per_attempt_traj0']:.0f}: "
                          + ", ".join(f"{k} {v:.0f}"
                                      for k, v in t["parts_per_attempt_traj0"].items())
                          + "; stamps per attempt "
                          + ", ".join(f"{k} {v:.2f}"
                                      for k, v in t["stamps_per_attempt_traj0"].items()))
                else:
                    print(f"  {name} B={batch} {label}: trajectory 0 {t['total_cycles_traj0']} "
                          f"cycles, batch max {t['total_cycles_max']}")
                entry["trees"][name] = t
    report["sass"] = {}
    for name in trees:
        text = sass_text(libs[(name, "lib")]._name)
        with open(os.path.join(out_root, name, "sass.txt"), "w") as f:
            f.write(text)
        counts = sass_counts(text)
        report["sass"][name] = {fn: dict(c) for fn, c in counts.items()}
        for fn, c in counts.items():
            shown = ", ".join(f"{op} {c.get(op, 0)}" for op in OPCODES)
            print(f"SASS {name} {fn}: {sum(c.values())} instructions; {shown}; other "
                  f"{sum(v for k, v in c.items() if k not in OPCODES)}")
    with open(os.path.join(out_root, "report.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)


if __name__ == "__main__":
    main()
