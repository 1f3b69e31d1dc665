"""``survey.host_ms``: the survey's time a call outside kernel B6, in ms:
the traced calls' wall time less B6's device time in them, over their
number (the reduction's kernels, the copies and the host between them)."""


def read(view):
    times = view.kernel_us("solve_kernel")
    if not times:
        return None
    wall = sum(e - s for s, e in view.calls)
    return (wall - sum(times)) / len(view.calls) / 1e3
