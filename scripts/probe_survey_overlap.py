"""The survey's chunks side by side on the card, at the ``angular.survey``
cell's shape: kernel B6's launches of a call, their summed durations
beside the union of their intervals, and the call's host clock.

    python scripts/probe_survey_overlap.py [--tree DIR] [--out build/survey_overlap_probe/report.json]

Needs one NVIDIA GPU and nvcc.  Angular inflation
(``models.angular()``), 8192 starts drawn from [0.64, 0.705]² at rest,
2000 RKF45 rows at max_err 1e-6, in chunks of 4096, with the package of
``--tree`` (this checkout by default; another tree, e.g. the parent
unpacked with ``git archive`` under ``build/``, runs its own package):

* ``survey_initial_conditions`` on the host clock, 10 calls after a
  warm-up, and whether every summary repeats bit for bit;
* 5 calls under ``torch.profiler`` (CPU and CUDA): per call, each
  ``solve_kernel`` launch's duration, their sum (what ``ang.b6.device_ms``
  reads), the union of their intervals (the time B6 holds the card), and
  how long after the first launch's start the second starts;
* ``background.survey_counts()`` where the tree has it.

Prints one JSON line (the card's name and power limit in it), also written
to ``--out``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK, BATCH, STEPS = 4096, 8192, 2000


def _union_ms(intervals):
    """Length of the union of (start, end) intervals in µs, in ms."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "survey_overlap_probe",
                                                  "report.json"))
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.tree))
    import numpy as np  # noqa: PLC0415
    import torch  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    import inflatox_torch  # noqa: PLC0415
    from inflatox_torch import background  # noqa: PLC0415

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    model, args = inflatox_torch.models.angular()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    args = np.asarray(args, dtype=float)
    f0 = np.random.default_rng(5).uniform(0.64, 0.705, (BATCH, 2))

    def survey():
        return background.survey_initial_conditions(art, args, STEPS, f0, np.zeros(2),
                                                    chunk=CHUNK)

    first = survey()
    walls = []
    for _ in range(10):
        t = time.perf_counter()
        out = survey()
        walls.append(1e3 * (time.perf_counter() - t))
    repeats = all(np.array_equal(out[k], first[k], equal_nan=out[k].dtype != bool)
                  for k in first)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            survey()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    solves = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") == "kernel" and "solve_kernel" in e["name"])
    per_call = BATCH // CHUNK
    calls = [solves[i:i + per_call] for i in range(0, len(solves), per_call)]
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True)
    counts = getattr(background, "survey_counts", None)
    report = {
        "tree": os.path.abspath(opts.tree), "device": torch.cuda.get_device_name(0),
        "power_limit": limit.stdout.strip(), "survey_counts": counts() if counts else None,
        "wall_ms": walls, "wall_ms_median": statistics.median(walls),
        "repeats_bit_for_bit": repeats,
        "launch_ms": [[(b - a) / 1e3 for a, b in c] for c in calls],
        "b6_sum_ms": [sum(b - a for a, b in c) / 1e3 for c in calls],
        "b6_union_ms": [_union_ms(c) for c in calls],
        "second_start_after_first_ms": [(c[1][0] - c[0][0]) / 1e3 for c in calls
                                        if len(c) > 1],
    }
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
