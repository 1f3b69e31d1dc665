"""``sweep.host_ms_per_launch``: the sweep's host time a batched launch,
in ms: the traced calls' wall time less the device's kernel time in them,
divided by the batched grid launches the program counted (B7a, B7b, B7d)."""

BATCH_KERNELS = ("B7a", "B7b", "B7d")


def read(view):
    launches = sum(view.launches.get(k, 0) for k in BATCH_KERNELS)
    if launches == 0:
        return None
    wall = sum(e - s for s, e in view.calls)
    return (wall - view.busy_us(view.kernels)) / launches / 1e3
