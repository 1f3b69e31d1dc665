"""Run one cell of the inflatox_torch benchmark on one process.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``: the imports, the CUDA context, the model bundle's
load, the traffic's inputs and one warm call at the cell's shapes, which
builds the kernels on a checkout's first run), then a closed loop with one
caller for ``--seconds`` seconds, then the reference's check of a sample of
the answers, drawn from the seed.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit.  The same numbers end standard error.

Without a CUDA device, or with fewer than the cell asks for, the run fails
and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness as H  # noqa: E402

sys.path.insert(0, str(H.BENCH / "reference"))
sys.path.insert(1, str(H.ROOT))


class NoDevice(RuntimeError):
    pass


def _device_name(device: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def _power_limit():
    """The card's power limit in W as ``nvidia-smi`` reads it (None
    without ``nvidia-smi``)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                          "-i", "0"], capture_output=True, text=True, timeout=30)
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def _window(cell, ctx, seconds, trace_calls, sync):
    """Calls back to back for ``seconds``; with ``trace_calls`` the first
    ones run under the profiler.  Returns the calls' records and the trace
    (or None)."""
    from inflatox_torch.ops import cuda_kernels

    n_inputs = cell.n_inputs
    records = []
    traced = None
    start = time.perf_counter()
    end = start + seconds
    i = 0

    def one(i):
        t0 = time.perf_counter()
        try:
            counts = cell.call(i)
        except Exception as exc:  # a failed call counts as missing
            H.log(f"call {i} failed: {type(exc).__name__}: {exc}")
            counts = None
        records.append((t0, time.perf_counter(), counts))

    if trace_calls:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if ctx.device == "cuda":
            activities.append(ProfilerActivity.CUDA)
        before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
        with profile(activities=activities) as prof:
            for i in range(trace_calls):
                with record_function("bench.call"):
                    one(i)
            sync()
        launches = {k: v - before[k] for k, v in cuda_kernels.LAUNCHES_BY_KERNEL.items()}
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            traced = (H.parse_trace(path, "bench.call"), launches)
        finally:
            os.unlink(path)
        i = trace_calls
    while time.perf_counter() < end:
        if i >= n_inputs:
            raise RuntimeError(f"the traffic's {n_inputs} inputs ran out inside the window")
        one(i)
        i += 1
    sync()
    return records, traced


def _end_to_end(entry, records, setup_s):
    """An end-to-end metric by the rule its name gives, before any
    ``.<family>`` suffix (one metric a family of cells, each with a bound
    of its own): ``setup_s``, ``<count>_per_s`` (the count the calls
    return, over the time they span) or ``call_p<q>_ms`` (the q-th
    percentile of every call's wall time, a failed call counting as
    infinite)."""
    name = entry["name"].split(".")[0]
    done = [r for r in records if r[2] is not None]
    if name == "setup_s":
        return setup_s
    if name.endswith("_per_s"):
        key = name[:-len("_per_s")]
        if not done:
            return None
        span = done[-1][1] - done[0][0]
        return sum(r[2].get(key, 0) for r in done) / span
    if name.startswith("call_p") and name.endswith("_ms"):
        q = float(name[len("call_p"):-len("_ms")])
        walls = [(r[1] - r[0]) * 1e3 if r[2] is not None else np.inf for r in records]
        return float(np.percentile(walls, q)) if walls else None
    raise ValueError(f"no rule computes the end-to-end metric {name!r}")


def run_cell(cell_name, seed, seconds, trace, device="cuda", overrides=None):
    """One run of a cell; returns the result line's object.
    ``device="cpu"`` (for tests) runs the program's plain versions on the
    host and skips the look for a card; ``overrides`` replace traffic
    parameters (for tests at small sizes)."""
    bench = H.benchmark()
    workload = H.load_json("workloads", f"{cell_name}.json")
    if overrides:
        workload = {**workload, "traffic": {**workload["traffic"], **overrides}}
    config = H.load_json("configs", f"{workload['config']}.json")
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == cell_name), 1)
    H.check_program()
    import torch

    torch.set_num_threads(1)  # one caller, few threads: steadier host timings
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() < chips:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    from inflatox_torch.consistency_conditions import GeneralisedAL

    traffic = H.load_module("traffic", f"{workload['traffic']['generator']}.py")
    ctx = H.Context(cell=cell_name, workload=workload, config=config, seed=seed,
                    seconds=seconds, device=device, rng=np.random.default_rng(seed),
                    reference=H.load_module("reference", f"{workload['config']}.py"),
                    precision=workload["traffic"].get(
                        "precision", config["precision"]))
    t = time.perf_counter()
    ctx.art = H.load_model(config["model"])
    ctx.al = GeneralisedAL(ctx.art, device=device, validate_basis=False)
    sync()
    ctx.spans["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell = traffic.Traffic(ctx)
    sync()
    ctx.spans["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T0
    from inflatox_torch.ops import build

    built = {str(k[0]): getattr(v, "build_seconds", None)
             for k, v in getattr(build, "_loaded", {}).items()}
    H.log(f"set-up {setup_s:.4f} s: load {ctx.spans['load_s']:.4f} s, warm call "
          f"{ctx.spans['warm_s']:.4f} s; kernel libraries' build_seconds {built}")

    trace_calls = int(workload["traffic"]["trace_calls"]) if trace else 0
    records, traced = _window(cell, ctx, seconds, trace_calls, sync)
    memory_peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    attempted = len(records)
    failed = sum(r[2] is None for r in records)
    H.log(f"window: {attempted} calls, {failed} failed")
    if records:  # the window's steadiness: completed calls in each second
        t0 = records[0][0]
        per_s = np.bincount([int(r[1] - t0) for r in records if r[2] is not None])
        H.log(f"calls completed in each second of the window: {per_s.tolist()}")

    metrics, extra = {}, {}
    if trace:
        (calls, kernels, copies, host), launches = traced
        view = H.TraceView(calls=calls, kernels=kernels, copies=copies, host=host,
                           launches=launches, setup=dict(ctx.spans), workload=workload,
                           config=config, launch=cell.launch)
        for entry in bench["per_layer"]:
            if H.applies(entry, cell_name):
                value = H.load_module("metrics", f"{entry['name']}.py").read(view)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        busy = view.busy_us(kernels + copies)
        extra = {"busy_s": busy * 1e-6, "window_s": view.window_us * 1e-6}
        bd = H.breakdown(view)
    else:
        for entry in bench["end_to_end"]:
            if H.applies(entry, cell_name):
                value = _end_to_end(entry, records, setup_s)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    ctx.al = None  # the program's state goes before the reference runs
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = cell.check()
    H.log(f"reference check {time.perf_counter() - t:.4f} s")
    limits = workload["limits"]
    correct = (failed == 0 and attempted > 0 and set(checks) == set(limits)
               and all(checks[k] <= limits[k] for k in limits))
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else "cpu",
                         "kind": _device_name(device), "count": chips,
                         "memory_peak_bytes": memory_peak, **extra}}
    if device == "cuda":
        result["device"]["power_limit_w"] = _power_limit()
    if trace:
        result["breakdown"] = bd
    result["checks"] = {k: {"value": checks.get(k), "limit": limits[k]} for k in limits}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = parser.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoDevice as exc:
        H.log(str(exc))
        return 2
    bad = H.forbidden_modules()
    if bad:
        H.log(f"forbidden modules loaded in this process: {bad}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
