"""Readings that set a cell's limits, in one process: the compared
numbers of sound runs on many seeds, then those of the control (the
configuration's ``control_precision``: f32 for an f64 configuration, f64
for a double-double one) and of each fault that the cell's traffic kind
can have (``benchmarks/faults.py``) on a few.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3 --check-among 20

Each reading is a run of the cell through ``run.run_cell``, at the cell's
own sizes, with a window of ``--seconds`` and the checked calls drawn
among the first ``--check-among`` (so that a short window reaches them).
Prints one JSON line a run (the run's ``correct`` and compared numbers),
then a summary: the largest reading of the sound runs (the lower reading)
and the smallest of the control and of each fault (the upper ones), per
compared number.  Not run by the benchmark's own runs.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import faults  # noqa: E402
import run  # noqa: E402

H = run.H


def readings(cell, seeds, seconds, overrides, fault=None, device="cuda"):
    """The compared numbers and ``correct`` of a run of ``cell`` on each
    seed, with ``fault`` planted (None: a sound run)."""
    workload = H.load_json("workloads", f"{cell}.json")
    traffic = H.load_module("traffic", f"{workload['traffic']['generator']}.py")
    out = []
    for seed in seeds:
        planted = faults.planted(fault, traffic) if fault else contextlib.nullcontext()
        with planted:
            res = run.run_cell(cell, seed, seconds, False, device=device, overrides=overrides)
        row = {"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
               "failed": res["failed"],
               **{k: c["value"] for k, c in res["checks"].items()}}
        print(json.dumps({"mode": fault or overrides.get("precision", "program"), **row}),
              flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--check-among", type=int, required=True)
    a = parser.parse_args(argv)
    workload = H.load_json("workloads", f"{a.workload}.json")
    config = H.load_json("configs", f"{workload['config']}.json")
    traffic = H.load_module("traffic", f"{workload['traffic']['generator']}.py")
    seeds = [int(s) for s in a.seeds.split(",")]
    control_seeds = [int(s) for s in a.control_seeds.split(",")]
    base = {"check_among": a.check_among}
    modes = {"program": readings(a.workload, seeds, a.seconds, base),
             "control": readings(a.workload, control_seeds, a.seconds,
                                 {**base, "precision": config["control_precision"]})}
    for fault in traffic.FAULTS:
        modes[fault] = readings(a.workload, control_seeds, a.seconds, base, fault)
    limits = workload["limits"]
    summary = {k: {"lower": max(r[k] for r in modes["program"]), "limit": limits[k],
                   **{m: min(r[k] for r in rows) for m, rows in modes.items()
                      if m != "program"}} for k in limits}
    correct = {m: sorted({r["correct"] for r in rows}) for m, rows in modes.items()}
    print(json.dumps({"workload": a.workload, "summary": summary, "correct": correct}),
          flush=True)
    bad = H.forbidden_modules()
    if bad:
        H.log(f"forbidden modules loaded in this process: {bad}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
