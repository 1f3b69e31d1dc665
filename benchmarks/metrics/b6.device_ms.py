"""``b6.device_ms``: kernel B6's device time a call, in ms: the traced
calls' ``solve_kernel`` launches over their number.  (Its roofline waits
for a count of the attempts, which depend on the data.)"""


def read(view):
    times = view.kernel_us("solve_kernel")
    if not times:
        return None
    return sum(times) / len(view.calls) / 1e3
