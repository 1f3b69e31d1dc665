"""Logging, badges and progress reporting.

Reference parity: the Rust crate prints styled stderr badges
``[Inflatox Info]`` / ``[Inflatox Warning]`` / ``[Inflatox PANIC]``
(lib.rs:53-66) and exposes ``log_info``/``log_warn`` to Python
(lib.rs:94-102, re-exported at __init__.py:28).  The compute kernels print a
start/finish line with a wall-clock duration and an optional 2 Hz progress bar
(anguelova.rs:42-50, 203, 254-258).

On the GPU a grid scan is a single kernel launch, so there is no meaningful
intra-scan progress; :class:`Progress` reports start/finish + duration (and
per-chunk ticks for host-chunked launches such as checkpointed sweeps).
"""

from __future__ import annotations

import os
import sys
import threading
import time

_COLOR = sys.stderr.isatty() and os.environ.get("NO_COLOR") is None


def _badge(text: str, color_code: str) -> str:
    if _COLOR:
        return f"\x1b[1;{color_code}m[{text}]\x1b[0m\n"
    return f"[{text}]\n"


BADGE_INFO = _badge("Inflatox Info", "35")  # bold magenta, lib.rs:53-56
BADGE_WARN = _badge("Inflatox Warning", "33")  # bold yellow, lib.rs:58-61
BADGE_PANIC = _badge("Inflatox PANIC", "31")  # bold red, lib.rs:63-66


def log_info(msg: str) -> None:
    """Print an informational message with the inflatox badge (lib.rs:94-97)."""
    print(f"{BADGE_INFO}{msg}", file=sys.stderr)


def log_warn(msg: str) -> None:
    """Print a warning message with the inflatox badge (lib.rs:99-102)."""
    print(f"{BADGE_WARN}{msg}", file=sys.stderr)


def log_panic(msg: str) -> None:
    """Print a panic-styled message (BADGE_PANIC, lib.rs:63-66)."""
    print(f"{BADGE_PANIC}{msg}", file=sys.stderr)


def _human_duration(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f} µs"
    if seconds < 1.0:
        return f"{seconds * 1e3:.0f} ms"
    if seconds < 60.0:
        return f"{seconds:.2f} s"
    m, s = divmod(seconds, 60.0)
    if m < 60:
        return f"{int(m)} m {s:.0f} s"
    h, m = divmod(m, 60.0)
    return f"{int(h)} h {int(m)} m"


class Progress:
    """Start/finish reporter for device launches.

    Usage::

        with Progress("Calculating full analysis", enabled=progress) as prog:
            ...            # one or more device launches
            prog.tick(3, 8)  # optional: per-chunk progress for host loops

    Prints the same style of messages as the reference kernels
    (anguelova.rs:203, 254-258) when ``enabled``.

    A fused grid scan is ONE opaque device launch, so a true completion bar
    (anguelova.rs:42-50) has nothing to observe — instead, long launches get
    a live **heartbeat**: after ``grace`` seconds of silence a watcher
    thread reports elapsed time at 2 Hz (``\\r``-refreshed on a tty; one
    line every 15 s otherwise), so a reference-scale 8000² scan or a cold
    kernel build is never silent.  When
    ``total_ops`` is given, the finish line includes the realized ops/s —
    the same numbers indicatif's bar summarized.
    """

    _GRACE = 3.0  # s of silence before the heartbeat starts

    def __init__(self, what: str, enabled: bool = True,
                 total_ops: int | None = None, grace: float | None = None,
                 interval: float | None = None):
        self.what = what
        self.enabled = enabled
        self.total_ops = total_ops
        self._grace = self._GRACE if grace is None else float(grace)
        self._interval = interval
        self._t0 = 0.0
        self._ticked = False
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self._dirty = False  # heartbeat left an unterminated \r line
        # serializes heartbeat vs tick() prints on a tty (ADVICE r4: a tick
        # landing between the heartbeat's _ticked check and its print could
        # garble the chunk-progress line)
        self._print_lock = threading.Lock()

    def _heartbeat(self) -> None:
        tty = sys.stderr.isatty()
        interval = (0.5 if tty else 15.0) if self._interval is None \
            else self._interval
        stop = self._stop
        if stop.wait(self._grace):
            return
        while not stop.wait(interval):
            if self._ticked:
                return  # host-chunked loop reports real progress instead
            elapsed = time.perf_counter() - self._t0
            msg = (f"{self.what}: running … "
                   f"{_human_duration(elapsed)} elapsed "
                   "(single device launch; first call includes compilation)")
            with self._print_lock:
                if self._ticked:
                    return  # a tick landed while formatting — don't garble it
                if tty:
                    print(f"\r{msg}", end="", file=sys.stderr)
                    self._dirty = True
                else:
                    print(msg, file=sys.stderr)

    def __enter__(self) -> "Progress":
        if self.enabled:
            log_info(f"{self.what}.")
        self._t0 = time.perf_counter()
        if self.enabled:
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._heartbeat, name="inflatox-progress", daemon=True
            )
            self._thread.start()
        return self

    def tick(self, done: int, total: int) -> None:
        if self.enabled:
            self._ticked = True
            elapsed = time.perf_counter() - self._t0
            with self._print_lock:
                print(
                    f"\r{self.what}: {done}/{total} chunks "
                    f"({_human_duration(elapsed)} elapsed)",
                    end="",
                    file=sys.stderr,
                )
                if done == total:
                    print(file=sys.stderr)

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._stop is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
        if self._dirty:
            print(file=sys.stderr)
        if self.enabled and exc_type is None:
            dt = time.perf_counter() - self._t0
            rate = ""
            if self.total_ops and dt > 0:
                rate = f" ({self.total_ops / dt:,.0f} ops/s)"
            log_info(f"Calculation finished. Took {_human_duration(dt)}.{rate}")
