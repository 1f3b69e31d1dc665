"""The operation counter behind the frozen counts of ``benchmarks/configs``.

A frozen copy of ``chip_smoke.py``'s counters (``staged_ops``,
``dd_point_ops``' weights ``DD_OPS``, the tails ``TAIL_OPS`` and
``RAPIDTURN_TAIL_OPS``) as they stood when the benchmark was defined.  The
grid kernels run a model function in three stages: a row stage once per
grid row and parameter set, a column stage once per column and set, and a
point stage at every point, then the analysis tail at every point.  The
count of a launch is

    sets * (point * N0 * N1 + row * N0 + col * N1 + tail * N0 * N1)

with each stage's operations weighed in f64 operations: one each in f64,
and in double-double by ``DD_OPS`` (``csrc/dd.cuh``: add two TwoSums and
two quick ones, mul an FMA TwoProd, div three quotient digits).

Run once, offline, to print the per-stage counts of a configuration:

    python benchmarks/tools/count_ops.py hyperinflation complete_analysis f64

It builds the model through ``inflatox_torch`` and reads the stages from
``inflatox_torch.lowering.cuda_codegen.grid_stage_ops``.  The benchmark
never runs this at run time: it reads the numbers frozen in the
configuration's file.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

#: f64 operations of one double-double operation in csrc/dd.cuh
DD_OPS = {"add": 20, "mul": 9, "div": 70, "sqrt": 33, "exp": 676, "log": 726, "demoted": 2}
#: f64 operations of the analysis tails (csrc/anguelova.cuh)
TAIL_OPS = {"complete_analysis": 41, "consistency_rapidturn": 8}
#: the model functions each analysis kind runs
KIND_FNS = {"complete_analysis": ("f_V", "f_hesse", "f_gsq"),
            "consistency_rapidturn": ("f_V", "f_hesse")}


def weigh(ops: dict, precision: str) -> int:
    """f64 operations of a dict of operation counts by name."""
    return sum((DD_OPS.get(k, 1) if precision == "dd" else 1) * v for k, v in ops.items()
               if k != "special")


def stage_counts(stages: dict, kind: str, precision: str) -> dict:
    """Per-stage f64 operations of a kind from ``grid_stage_ops``'s
    ``{function: {"row"|"col"|"point": ops}}``, with the tail."""
    out = {s: sum(weigh(stages[f][s], precision) for f in KIND_FNS[kind])
           for s in ("point", "row", "col")}
    out["tail"] = TAIL_OPS[kind]
    return out


def launch_ops(counts: dict, n0: int, n1: int, sets: int = 1) -> int:
    """f64 operations of one grid launch from the frozen per-stage counts."""
    return sets * ((counts["point"] + counts["tail"]) * n0 * n1
                   + counts["row"] * n0 + counts["col"] * n1)


def main(argv=None) -> None:
    model_name, kind, precision = (argv or sys.argv[1:])[:3]
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from inflatox_torch import Compiler, models
    from inflatox_torch.lowering.cuda_codegen import grid_stage_ops

    model, _ = getattr(models, model_name)()
    art = Compiler(model, silent=True).compile()
    print(json.dumps(stage_counts(grid_stage_ops(art, precision), kind, precision)))


if __name__ == "__main__":
    main()
