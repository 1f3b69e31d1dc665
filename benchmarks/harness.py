"""Shared parts of the benchmark: files found by name, the model bundle
cache, the closed-loop window, the trace's reduction and the result line.

Everything that belongs to one configuration, one cell, one traffic kind
or one per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the configuration (model, parameters, window,
  precision, frozen operation counts);
* ``workloads/<cell>.json``: the cell (configuration, traffic kind and its
  parameters, the limits of the correctness comparison);
* ``traffic/<kind>.py``: the generator and caller of a traffic kind;
* ``metrics/<metric>.py``: the reader of a per-layer metric;
* ``reference/<config>.py``: the plain reference of a configuration.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PEAKS = json.loads((BENCH / "peaks.json").read_text())
#: top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "inflatox_tpu")
#: the sources whose hash keys a model bundle
_BUNDLE_SOURCES = ("symbolic.py", "compiler.py", "models", "lowering")


def load_json(*parts) -> dict:
    return json.loads(BENCH.joinpath(*parts).read_text())


def load_module(*parts):
    """A Python file under ``benchmarks/`` as a module, by its path (names
    may hold dots and dashes)."""
    path = BENCH.joinpath(*parts)
    name = "bench_" + "_".join(parts).replace(".", "_").replace("-", "_").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def applies(entry: dict, cell: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in a cell."""
    return "workloads" not in entry or cell in entry["workloads"]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def check_program() -> None:
    """Import the program and make sure it is the checkout's own
    ``inflatox_torch``, beside ``benchmarks/``, and not an installed one."""
    import inflatox_torch

    found = Path(inflatox_torch.__file__).parent.parent.resolve()
    if found != ROOT:
        raise ImportError(f"inflatox_torch was imported from {found}, not from this "
                          f"checkout ({ROOT})")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------- #
# set-up                                                                #
# --------------------------------------------------------------------- #


def _sources_digest(model_name: str) -> str:
    import inflatox_torch

    h = hashlib.sha256(model_name.encode())
    pkg = Path(inflatox_torch.__file__).resolve().parent
    for entry in _BUNDLE_SOURCES:
        path = pkg / entry
        files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
        for f in files:
            h.update(str(f.relative_to(pkg)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def load_model(model_name: str):
    """The compiled model ``inflatox_torch.models.<model_name>()``, from a
    bundle under ``build/bench_bundles/`` keyed by the hash of the
    package's symbolic stage, lowering and compiler; the first run in a
    checkout builds the bundle with sympy and saves it."""
    from inflatox_torch import CompiledModel, Compiler, models

    path = ROOT / "build" / "bench_bundles" / f"{model_name}-{_sources_digest(model_name)}.json"
    if path.is_file():
        return CompiledModel.load(str(path))
    model, _ = getattr(models, model_name)()
    art = Compiler(model, silent=True).compile()
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    os.close(fd)
    art.save(tmp)
    os.replace(tmp, path)
    return art


@dataclass
class Context:
    """What a traffic kind gets: the cell, its configuration, the seed's
    generator, the compiled model and the reference."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    device: str
    rng: np.random.Generator
    reference: object
    precision: str
    art: object = None
    al: object = None
    spans: dict = field(default_factory=dict)

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    def args(self, values: dict) -> np.ndarray:
        """Parameter values by name, in the compiled model's order."""
        out = np.zeros(self.art.n_parameters)
        for name, slot in self.art.symbol_dictionary.items():
            if slot.startswith("args["):
                out[int(slot[5:-1])] = values[name]
        return out

    def n_inputs(self) -> int:
        """Inputs to make before the window: more than the fastest calls
        the traffic allows (``min_call_ms``) can use."""
        return int(math.ceil(self.seconds * 1e3 / self.traffic["min_call_ms"])) + 8

    def windows(self, n: int, shape) -> np.ndarray:
        """(n, 4) grid windows, the configuration's ``window`` shifted on
        each axis by a fraction of one grid step drawn from the seed, so
        that no two calls scan the same points and every call does the
        same work."""
        x0a, x0b, x1a, x1b = self.config["window"]
        step = np.array([(x0b - x0a) / shape[0], (x1b - x1a) / shape[1]])
        shift = self.rng.uniform(0.0, 1.0, (n, 2)) * step
        return np.array([x0a, x0b, x1a, x1b]) + np.repeat(shift, 2, axis=1)

    def picks(self, n: int, among: int) -> set:
        """``n`` call indices among the first ``among``, drawn from the seed:
        the calls whose answers the reference checks."""
        return {int(i) for i in self.rng.choice(among, size=min(n, among), replace=False)}


def scaled_gaps(program, reference):
    """|p − r| / max(|r|, 1) where both are finite, and the number of
    places finite on one side only."""
    p = np.asarray(program, dtype=np.float64)
    r = np.asarray(reference).astype(np.float64)
    fp, fr = np.isfinite(p), np.isfinite(r)
    both = fp & fr
    gap = np.abs(p[both] - r[both]) / np.maximum(np.abs(r[both]), 1.0)
    return (float(gap.max()) if gap.size else 0.0), int((fp != fr).sum())


# --------------------------------------------------------------------- #
# the trace                                                             #
# --------------------------------------------------------------------- #

@dataclass
class TraceView:
    """What a per-layer metric reader sees: the traced calls and the
    device's events in their window (µs on the trace's clock), the
    program's launch counts over the traced calls, the set-up spans, the
    cell, its configuration and what its traffic launches."""

    calls: list  # (start, end) of each traced call
    kernels: list  # (name, start, dur)
    copies: list  # (name, start, dur)
    host: list  # (name, start, dur) of host operations
    launches: dict
    setup: dict
    workload: dict
    config: dict
    launch: dict

    @property
    def window(self):
        return self.calls[0][0], self.calls[-1][1]

    @property
    def window_us(self) -> float:
        a, b = self.window
        return b - a

    def kernel_us(self, match: str = "") -> list:
        return [d for n, _, d in self.kernels if match in n]

    def busy_us(self, events) -> float:
        """The union of the events' intervals inside the window."""
        a, b = self.window
        spans = sorted((max(s, a), min(s + d, b)) for _, s, d in events if s < b and s + d > a)
        total, end = 0.0, a
        for s, e in spans:
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def launch_ops(self) -> int:
        """f64 operations of one grid launch of the traffic, from the
        configuration's frozen per-stage counts."""
        spec = self.launch
        counts = self.config["operations"][spec["kind"]]
        n0, n1 = spec["shape"]
        return spec["sets"] * ((counts["point"] + counts["tail"]) * n0 * n1
                               + counts["row"] * n0 + counts["col"] * n1)

    def launch_bytes(self) -> int:
        spec = self.launch
        n0, n1 = spec["shape"]
        return spec["sets"] * spec["n_out"] * n0 * n1 * spec["itemsize"]

    def least_us(self) -> float:
        """The least time of one grid launch: the larger of its bytes over
        the HBM bandwidth and its f64 operations over the f64 peak."""
        return 1e6 * max(self.launch_bytes() / PEAKS["hbm_bytes_per_s"],
                         self.launch_ops() / PEAKS["f64_ops_per_s"])


def roofline(view: TraceView, match: str, counter: str):
    """A grid kernel's share of its roofline, in %: the least time of its
    launches over their device time (kernels whose name holds ``match``;
    launches counted by the program under ``counter``)."""
    times = view.kernel_us(match)
    n = view.launches.get(counter, 0)
    if not times or n == 0 or len(times) != n:
        return None
    return 100.0 * view.least_us() * n / sum(times)


def parse_trace(path: str, label: str):
    """Kernels, copies, host operations and the traced calls (host spans
    named ``label``) of an exported Chrome trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    calls, kernels, copies, host = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        item = (name, float(ev["ts"]), float(ev.get("dur", 0.0)))
        if cat == "user_annotation" and name == label:
            calls.append(item[1:])
        if cat == "kernel":
            kernels.append(item)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies.append(item)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append(item)
    calls = sorted((s, s + d) for s, d in calls)
    return calls, kernels, copies, host


def breakdown(view: TraceView) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the innermost host operation that ran
    through its middle."""
    a, b = view.window
    by_name = {}
    for name, s, d in view.kernels + view.copies:
        if s < b and s + d > a:
            by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = sorted((s, s + d) for _, s, d in view.kernels + view.copies if s < b and s + d > a)
    gaps, end = [], a
    for s, e in busy:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if b > end:
        gaps.append((end, b))
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (g0 + g1)
        inside = [(d, n) for n, s, d in view.host if s <= mid <= s + d]
        named.append([min(inside)[1] if inside else "(no host operation)", (g1 - g0) * 1e-6])
    return {"device_ops": [[n, t * 1e-6] for n, t in ops], "idle_gaps": named}
