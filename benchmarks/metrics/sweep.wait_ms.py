"""``sweep.wait_ms``: the sweep loop's waits for the device, in ms a call:
the program's ``inflx.shards.wait`` spans (each chunk's wait for its
kernel and its copies to the host) over the traced calls."""

from spans import ms_per_call


def read(view):
    return ms_per_call(view, "inflx.shards.wait")
