"""The benchmark harness on the CPU: files found by name, the result
line's schema, no run without a card, no forbidden import, and
``BENCHMARK.json`` within its contract.

Run with ``python -m pytest benchmarks/tests``.  Runs here use the
program's plain versions on the host (``run_cell(..., device="cpu")``) at
small sizes; the benchmark's command itself refuses to run without a card.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
import run  # noqa: E402

SMALL = {"hyper.maps": {"shape": [48, 40], "check_among": 4, "check_calls": 2,
                        "min_call_ms": 0.5, "trace_calls": 3},
         "egno.sweep-dd": {"shape": [16, 16], "sets": 4, "chunk_size": 2, "stride": 4,
                           "check_among": 1, "check_calls": 1, "check_min_sets": 1,
                           "min_call_ms": 0.5, "trace_calls": 1},
         "hyper.survey": {"batch": 32, "steps": 300, "chunk": 32, "check_among": 1,
                          "min_call_ms": 0.5, "trace_calls": 1}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line_schema(cell, trace):
    res = run.run_cell(cell, 2**33 + 17, 0.3, trace, device="cpu", overrides=SMALL[cell])
    line = json.loads(json.dumps(res))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = harness.benchmark()
    kind = "per_layer" if trace else "end_to_end"
    names = {e["name"]: e["unit"] for e in bench[kind] if harness.applies(e, cell)}
    assert set(line["metrics"]) <= set(names)
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == names[name]
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
    else:
        assert set(line["metrics"]) == set(names)
    assert set(line["checks"]) == set(harness.load_json("workloads", f"{cell}.json")["limits"])


def test_cell_found_by_name_in_a_copy(tmp_path):
    """A cell that exists only as a new file and a new entry of a copy of
    the benchmark runs by its name."""
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "inflatox_torch").symlink_to(ROOT / "inflatox_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((BENCH / "workloads" / "hyper.maps.json").read_text())
    cell["traffic"] = {**cell["traffic"], "name": "maps_small", **SMALL["hyper.maps"]}
    (tmp_path / "benchmarks" / "workloads" / "hyper.maps-small.json").write_text(
        json.dumps(cell))
    bench["workloads"].append({"name": "hyper.maps-small", "config": "hyperinflation-f64",
                               "traffic": "maps_small", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import run; "
            "print(json.dumps(run.run_cell('hyper.maps-small', 3, 0.3, False, 'cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "benchmarks")],
                         capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] > 0


def test_only_the_benchmark_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the files
    under ``paths`` the command exits non-zero and prints no result, even
    where another copy of the program can be imported."""
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "hyper.maps",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=_env(), timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "not from this checkout" in out.stderr


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result: it never falls back to the CPU."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "hyper.maps",
                          "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_forbidden_module_loaded():
    """Everything the harness loads, a run on the host included, leaves no
    module whose top-level name (before the first dot, compared whole) is
    jax, jaxlib, flax or inflatox_tpu."""
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]); import run, control, faults, harness\n"
        "from pathlib import Path\n"
        "for sub in ('traffic', 'metrics', 'reference'):\n"
        "    for f in sorted((Path(sys.argv[1]) / sub).glob('*.py')):\n"
        "        harness.load_module(sub, f.name)\n"
        "for cell, small in json.loads(sys.argv[2]).items():\n"
        "    run.run_cell(cell, 5, 0.2, True, 'cpu', small)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(BENCH), json.dumps(SMALL)],
                         capture_output=True, text=True, env=_env(), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "inflatox_torch" in top
    assert not top & set(harness.FORBIDDEN_MODULES)


def test_benchmark_json_within_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmarks"] and bench["command"][1] == "benchmarks/run.py"
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert (BENCH / "reference" / f"{c['name']}.py").is_file()
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["traffic"]["name"] == w["traffic"]
        assert (BENCH / "traffic" / f"{cell['traffic']['generator']}.py").is_file()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {e["name"] for e in bench["end_to_end"]}
    assert "setup_s" in e2e
    for e in bench["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in bench["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(e["unit"]) and e["moves"] in e2e
        assert set(e.get("workloads", cells)) <= cells
        moves = next(m for m in bench["end_to_end"] if m["name"] == e["moves"])
        assert all(harness.applies(moves, c) for c in e.get("workloads", cells))
        assert (BENCH / "metrics" / f"{e['name']}.py").is_file()
    for c in cells:  # every cell: set-up, another end-to-end metric, a per-layer one
        reported = [m["name"] for m in bench["end_to_end"] if harness.applies(m, c)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(harness.applies(m, c) for m in bench["per_layer"])
