"""``b7d_roofline``: kernel B7d's share of its roofline, in %: the least
time of its launches (the larger of their bytes over the HBM bandwidth and
their f64 operations, frozen in the configuration, over the f64 peak;
``benchmarks/peaks.json``) over their device time in the trace."""

from harness import roofline


def read(view):
    return roofline(view, "grid_scan_kernel", "B7d")
