"""``device_idle.sweep``: share of the traced window, from the first
traced call's start to the last one's end, in which no kernel runs on the
device, in % (copies count as idle), in the cells of the sweep family."""


def read(view):
    return 100.0 * (1.0 - view.busy_us(view.kernels) / view.window_us)
