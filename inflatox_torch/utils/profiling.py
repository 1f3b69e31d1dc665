"""Profiling helpers.

The port of ``inflatox_tpu/utils/profiling.py``: a ``torch.profiler`` trace
(CPU, and the card's kernels when CUDA is present) written for TensorBoard
or Perfetto, with the same ergonomics as
:class:`~inflatox_torch.utils.logging.Progress`.
"""

from __future__ import annotations

import contextlib
import time

from .logging import log_info

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str, label: str = "inflatox"):
    """Capture a profile of the enclosed block::

        with profiling.trace("/tmp/inflatox-profile"):
            al.complete_analysis(...)

    Writes ``<label>.<time>.pt.trace.json`` (Chrome trace format) into
    ``log_dir``; open the directory with TensorBoard or the file with
    Perfetto.  Yields the :class:`torch.profiler.profile` object (its
    ``key_averages()`` summarise the block)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_info(f"profiling '{label}' → {log_dir}")
    t0 = time.perf_counter()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir, worker_name=label)) as prof:
        yield prof
    log_info(
        f"profile captured ({time.perf_counter() - t0:.2f}s wall) — "
        f"inspect with: tensorboard --logdir {log_dir}"
    )


def annotate(name: str):
    """Decorator/context manager adding a named region to profiles
    (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)
