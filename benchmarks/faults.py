"""Faults planted underneath a cell's timed path, for the runs that show
that the check deciding ``correct`` fails them.

A traffic kind names where its calls reach the program (``SCANS``: a
module of the program, the names in it to wrap, and the axis of the batch
in their output, a tensor or a tuple of tensors) and the faults that its
cells can have (``FAULTS``).  Each fault wraps that device output:

* ``altered``: the answer changed where it is produced (the first element
  of each floating-point output, relatively by 1e-3: grid point (0, 0) of
  the first map; the first trajectory's summaries);
* ``half_left_out``: the second half of the batch never written (grid rows
  of a map, parameter sets of a batched scan, trajectories of a survey);
* ``unchanged_state``: every wrapped call returns the previous one's
  answer (a chunk of a sweep gets the chunk before it; a call the call
  before it);
* ``swapped_sets``: the second entry of the batch gets the first's answer.

No cell spans chips, so there is no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib


def _each(out, fn):
    """``fn`` applied to a copy of each tensor of the output (one tensor,
    or a tuple of them)."""
    if isinstance(out, tuple):
        return tuple(fn(o.clone()) for o in out)
    return fn(out.clone())


def _altered(out, batch_dim):
    def alter(t):
        if t.is_floating_point():
            flat = t.reshape(-1)
            flat[0] = flat[0] * (1 + 1e-3) + 1e-3
        return t

    return _each(out, alter)


def _half_left_out(out, batch_dim):
    def half(t):
        n = t.shape[batch_dim]
        t.narrow(batch_dim, n // 2, n - n // 2).zero_()
        return t

    return _each(out, half)


def _swapped_sets(out, batch_dim):
    def swap(t):
        if t.shape[batch_dim] > 1:
            t.select(batch_dim, 1).copy_(t.select(batch_dim, 0))
        return t

    return _each(out, swap)


class _Stale:
    def __init__(self):
        self.last = None

    def __call__(self, out, batch_dim):
        prev, self.last = self.last, _each(out, lambda t: t)
        return out if prev is None else prev


FAULTS = {"altered": lambda: _altered, "half_left_out": lambda: _half_left_out,
          "swapped_sets": lambda: _swapped_sets, "unchanged_state": _Stale}


@contextlib.contextmanager
def planted(fault: str, traffic):
    """Inside the block, the scans that the traffic module ``traffic``
    names in ``SCANS`` return their answers broken by ``fault``."""
    if fault not in traffic.FAULTS:
        raise ValueError(f"the traffic kind cannot have the fault {fault!r}")
    module_name, names, batch_dim = traffic.SCANS
    module = importlib.import_module(module_name)
    breaker = FAULTS[fault]()
    saved = {name: getattr(module, name) for name in names}

    def wrap(scan):
        return lambda *args, **kwargs: breaker(scan(*args, **kwargs), batch_dim)

    try:
        for name, scan in saved.items():
            setattr(module, name, wrap(scan))
        yield
    finally:
        for name, scan in saved.items():
            setattr(module, name, scan)
