"""``device_idle.ang``: share of the traced window of the cell
``angular.survey``, from the first traced call's start to the last one's
end, in which no kernel runs on the device, in % (copies count as idle)."""


def read(view):
    return 100.0 * (1.0 - view.busy_us(view.kernels) / view.window_us)
