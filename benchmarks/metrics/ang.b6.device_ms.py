"""``ang.b6.device_ms``: kernel B6's device time a call in the cell
``angular.survey``, in ms: the traced calls' ``solve_kernel`` launches (two
a call, one a chunk) over the number of calls."""


def read(view):
    times = view.kernel_us("solve_kernel")
    if not times:
        return None
    return sum(times) / len(view.calls) / 1e3
