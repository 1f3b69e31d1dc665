"""Profiling helpers.

The port of ``inflatox_tpu/utils/profiling.py``: a ``torch.profiler`` trace
(CPU, and the card's kernels when CUDA is present) written for TensorBoard
or Perfetto, with the same ergonomics as
:class:`~inflatox_torch.utils.logging.Progress`.

The package marks its layer boundaries with :func:`annotate` spans named
``inflx.*`` (``README.md`` lists them).  A span is a
``torch.profiler.record_function`` range, so it lands in the same trace as
the card's kernels and copies, on one clock; while no profiler records
(:func:`recording`), a span costs one flag check and enters nothing.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from .logging import log_info

__all__ = ["trace", "annotate", "recording"]

#: :func:`trace` blocks open that profile every thread of the process
_ALL_THREADS = 0
_profiler_enabled = torch.autograd._profiler_enabled


def recording() -> bool:
    """Whether a torch profiler records this thread now: one of this
    thread's own (``torch.autograd._profiler_enabled()``, which a
    ``torch.profiler.profile`` started on this thread sets), or a
    :func:`trace` that profiles every thread."""
    return _ALL_THREADS > 0 or _profiler_enabled()


def _all_threads_config():
    """The profiler option that records every thread (the sweep's
    checkpoint writer among them), or None where torch has none."""
    try:
        from torch._C._profiler import _ExperimentalConfig  # noqa: PLC0415

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: str, label: str = "inflatox"):
    """Capture a profile of the enclosed block::

        with profiling.trace("/tmp/inflatox-profile"):
            al.complete_analysis(...)

    Writes ``<label>.<time>.pt.trace.json`` (Chrome trace format) into
    ``log_dir``; open the directory with TensorBoard or the file with
    Perfetto.  Every thread of the process is recorded where torch offers
    it (``profile_all_threads``), so spans of the package's worker threads
    are in the file too.  Yields the :class:`torch.profiler.profile` object
    (its ``key_averages()`` summarise the block)."""
    global _ALL_THREADS
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    config = _all_threads_config()
    options = {} if config is None else {"experimental_config": config}
    log_info(f"profiling '{label}' → {log_dir}")
    t0 = time.perf_counter()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir, worker_name=label),
                 **options) as prof:
        _ALL_THREADS += config is not None
        try:
            yield prof
        finally:
            _ALL_THREADS -= config is not None
    log_info(
        f"profile captured ({time.perf_counter() - t0:.2f}s wall) — "
        f"inspect with: tensorboard --logdir {log_dir}"
    )


class _Span:
    """A span as a decorator: the check of :func:`annotate` runs on each
    call of the decorated function."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return spanned


class _Idle(_Span):
    """A span while no profiler records: enters nothing.  One is shared by
    all uses of a name."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Recorded(_Span):
    """A span while a profiler records: a ``record_function`` range."""

    __slots__ = ("_range",)

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False


_IDLE: dict = {}  # name → its shared idle span


def annotate(name: str):
    """A named span in profiles, as a context manager or a decorator::

        with profiling.annotate("inflx.scan.deliver"):
            ...

        @profiling.annotate("inflx.load")
        def load(...): ...

    On entry, and on each call of a decorated function, it enters a
    ``torch.profiler.record_function`` range if a profiler records
    (:func:`recording`), and otherwise nothing: one flag check."""
    if recording():
        return _Recorded(name)
    idle = _IDLE.get(name)
    if idle is None:
        idle = _IDLE[name] = _Idle(name)
    return idle
