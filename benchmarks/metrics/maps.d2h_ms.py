"""``maps.d2h_ms``: device-to-host copy time a call, in ms: the profiler's
device→host memcpy events over the traced calls, divided by their number."""


def read(view):
    a, b = view.window
    copies = [d for n, s, d in view.copies if "DtoH" in n and a <= s <= b]
    if not copies:
        return None
    return sum(copies) / len(view.calls) / 1e3
