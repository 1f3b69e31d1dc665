"""The program's own spans in a traced window: the ``inflx.*`` ranges that
``inflatox_torch.utils.profiling.annotate`` records (``user_annotation``
events of the torch profiler, on the trace's clock), which the per-layer
metrics of the program's layers read."""


def span_us(view, *names) -> list:
    """Durations (µs) of the host spans named ``names`` that start inside
    the traced window."""
    a, b = view.window
    return [d for n, s, d in view.host if n in names and a <= s <= b]


def ms_per_call(view, *names):
    """The spans' time a traced call, in ms; None where the program has no
    such span (a program older than the spans)."""
    times = span_us(view, *names)
    if not times:
        return None
    return sum(times) / len(view.calls) / 1e3
