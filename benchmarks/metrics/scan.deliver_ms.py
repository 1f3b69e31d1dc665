"""``scan.deliver_ms``: the program's delivery of a grid scan to numpy, in
ms a call: its ``inflx.scan.deliver`` spans (``GeneralisedAL._scan``: the
wait for the kernel, the numpy allocation and the pageable copy) over the
traced calls."""

from spans import ms_per_call


def read(view):
    return ms_per_call(view, "inflx.scan.deliver")
