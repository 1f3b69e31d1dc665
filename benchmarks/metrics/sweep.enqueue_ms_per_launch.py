"""``sweep.enqueue_ms_per_launch``: the sweep loop's host time to put a
chunk on the device, in ms a batched launch: the program's
``inflx.sweep.launch`` (the batched scan), ``inflx.sweep.reduce``
(``vmap(reduce_fn)``) and ``inflx.shards.stage`` (the copies to the host
and their event) spans over the batched grid launches it counted (B7a,
B7b, B7d; on a host without the kernels, where the plain version launches
none, over its ``inflx.sweep.launch`` spans, one a chunk and slot)."""

from spans import span_us

BATCH_KERNELS = ("B7a", "B7b", "B7d")


def read(view):
    times = span_us(view, "inflx.sweep.launch", "inflx.sweep.reduce", "inflx.shards.stage")
    if not times:
        return None
    launches = (sum(view.launches.get(k, 0) for k in BATCH_KERNELS)
                or len(span_us(view, "inflx.sweep.launch")))
    return sum(times) / launches / 1e3
