"""Kernel B9, the survey's reduction, on the card at the ``hyper.survey``
cell's size: its time beside its byte bound, the plain reduction's time,
and the survey call's host clock with either.

    python scripts/probe_survey_reduce.py [--out build/survey_reduce_probe/report.json]

Needs one NVIDIA GPU and nvcc.  Hyperinflation (m = 1), 4096 starts drawn
from [1.5, 2.5]² at rest, 2000 RKF45 rows on kernel B6 at max_err 1e-6:

* B9: CUDA events around 50 launches after 3 warm-ups, ms a launch (the
  rows, 393 MB, are eight times the 50 MB L2, so every launch reads them
  from device memory), beside its bound, the bytes it reads and writes
  over 3.35 TB/s; ptxas's report of the kernel from the build log;
* the plain reduction (``ops/cuda_survey.survey_reduce_torch``) on the
  card's tensors, CUDA events around 10 calls, and on the host's CPU, one
  call on the host clock;
* B9's five summaries against the plain reduction on the host's CPU, bit
  for bit, NaN in the same places;
* ``survey_initial_conditions`` at that size, host clock, median of 20
  calls after 2 warm-ups, with B9 and with the plain reduction put in
  ``background._survey_reduce``'s place (the same delivery).

Prints one JSON line (the card's name and power limit in it), also written
to ``--out``.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import inflatox_torch  # noqa: E402
from inflatox_torch import background  # noqa: E402
from inflatox_torch.ops.build import load_solver  # noqa: E402
from inflatox_torch.ops.cuda_solver import solve_cuda  # noqa: E402
from inflatox_torch.ops.cuda_survey import survey_reduce_cuda, survey_reduce_torch  # noqa: E402

BATCH, STEPS, MAX_ERR = 4096, 2000, 1e-6
PEAK_BYTES_PER_S = 3.35e12


def _card():
    smi = shutil.which("nvidia-smi")
    limit = None
    if smi:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip() or None
    return {"name": torch.cuda.get_device_name(0), "power_limit": limit}


def _event_ms(fn, n, warm):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _same_bits(got, want):
    got, want = got.cpu().numpy(), want.numpy()
    if got.dtype == bool:
        return bool(np.array_equal(got, want))
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan)
                and np.array_equal(got[~nan].view(np.int64), want[~nan].view(np.int64)))


def _ptxas(log_path, kernel):
    lines = log_path.read_text().splitlines()
    return [ln.strip() for i, ln in enumerate(lines)
            if any(kernel in lines[k] for k in range(max(0, i - 2), i + 1))]


def _survey_ms(art, args, f0, reduce_fn, calls=20):
    saved = background._survey_reduce
    background._survey_reduce = reduce_fn
    try:
        walls = []
        for k in range(calls + 2):
            t = time.perf_counter()
            background.survey_initial_conditions(art, args, STEPS, f0, np.zeros(2),
                                                 max_err=MAX_ERR, solver="rkf", chunk=BATCH)
            if k >= 2:
                walls.append((time.perf_counter() - t) * 1e3)
    finally:
        background._survey_reduce = saved
    return statistics.median(walls)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "survey_reduce_probe",
                                                      "report.json"))
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    model, args = inflatox_torch.models.hyperinflation()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    args = np.asarray(args, dtype=float)
    f0 = np.random.default_rng(2026).uniform(1.5, 2.5, (BATCH, 2))
    pars = torch.tensor(args, device="cuda")
    f0_t = torch.tensor(f0, device="cuda")
    rows, times = solve_cuda(art, pars, STEPS, f0_t, torch.zeros_like(f0_t), MAX_ERR, "rkf")
    torch.cuda.synchronize()

    got = survey_reduce_cuda(art, rows, times, pars)
    t = time.perf_counter()
    host = survey_reduce_torch(art, rows.cpu(), times.cpu(), pars.cpu())
    host_s = time.perf_counter() - t
    bits = [_same_bits(g, w) for g, w in zip(got, host)]

    ny = 2 * art.n_fields + 1
    bytes_moved = BATCH * STEPS * (ny + 1) * 8 + BATCH * ((art.n_fields + 3) * 8 + 1)
    b9_ms = _event_ms(lambda: survey_reduce_cuda(art, rows, times, pars), 50, 3)
    plain_ms = _event_ms(lambda: survey_reduce_torch(art, rows, times, pars), 10, 2)
    result = {
        "card": _card(),
        "torch": torch.__version__,
        "shape": [BATCH, STEPS, ny + 1],
        "b9_ms": b9_ms,
        "b9_bound_ms": bytes_moved / PEAK_BYTES_PER_S * 1e3,
        "b9_roofline_pct": bytes_moved / PEAK_BYTES_PER_S * 1e3 / b9_ms * 100.0,
        "b9_ptxas": _ptxas(load_solver(art.cuda_solver_source()).build_log, "survey_reduce"),
        "plain_card_ms": plain_ms,
        "plain_host_cpu_s": host_s,
        "bit_for_bit_with_host": bits,
        "ended_share": float(host[1].double().mean()),
        "survey_ms_b9": _survey_ms(art, args, f0, background._survey_reduce),
        "survey_ms_plain_on_card": _survey_ms(art, args, f0, survey_reduce_torch),
    }
    line = json.dumps(result)
    print(line)
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    with open(opts.out, "w") as f:
        f.write(line + "\n")
    if not all(bits):
        raise SystemExit("B9 differs from the host's plain reduction")


if __name__ == "__main__":
    main()
