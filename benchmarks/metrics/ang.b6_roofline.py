"""``ang.b6_roofline``: kernel B6's share of its roofline in the cell
``angular.survey``, in %: the least time of the traced calls'
``solve_kernel`` launches over their device time.

The least time is the larger of their bytes over the HBM bandwidth and
their f64 operations over the f64 peak (``benchmarks/peaks.json``).  Bytes
a call: the rows written, (steps, 2n + 2, batch) f64 over its chunks, and
the inputs, the fields and velocities, (batch, 2n) f64, and the parameters
once a launch, from the cell's ``batch``, ``chunk`` and ``steps`` and the
model's n = 2 fields.  Operations: the attempts the program counted on the
card over the traced calls (``inflatox_torch.ops.cuda_solver.
attempt_counts``, read once after the window; the program counts only
while a profiler records) times the operations of one attempt."""

import math

from harness import PEAKS

#: fields of the model (angular inflation, the configuration's)
N_FIELDS = 2
#: f64 operations of one RKF45 attempt of kernel B6 on angular inflation,
#: counted once with chip_smoke.attempt_ops(art, "rkf") at commit 4dc1774;
#: frozen here, never recounted at run time
OPS_PER_ATTEMPT = 705


def read(view):
    try:
        from inflatox_torch.ops.cuda_solver import attempt_counts
    except ImportError:  # a program without the counter
        return None
    times = view.kernel_us("solve_kernel")
    attempts = attempt_counts()["attempts"]
    if not times or not attempts:
        return None
    traffic = view.workload["traffic"]
    batch, steps = int(traffic["batch"]), int(traffic["steps"])
    launches = math.ceil(batch / int(traffic["chunk"]))
    call_bytes = 8 * (steps * (2 * N_FIELDS + 2) * batch + batch * 2 * N_FIELDS
                      + launches * len(view.config["parameters"]))
    least_us = 1e6 * max(len(view.calls) * call_bytes / PEAKS["hbm_bytes_per_s"],
                         attempts * OPS_PER_ATTEMPT / PEAKS["f64_ops_per_s"])
    return 100.0 * least_us / sum(times)
