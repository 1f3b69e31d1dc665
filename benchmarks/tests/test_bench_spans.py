"""The per-layer metrics that read the program's own spans, on the CPU: a
traced run of each cell reports every one of its metrics that reads an
``inflx.*`` span, non-null (kernel B6's counter metrics need the card and
may be absent here), and a metric of a program without the spans reads
None.

Run with ``python -m pytest benchmarks/tests``.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
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
SPAN_METRICS = {"hyper.maps": {"scan.deliver_ms"},
                "egno.sweep-dd": {"sweep.enqueue_ms_per_launch", "sweep.wait_ms"},
                "hyper.survey": {"survey.reduce_ms", "survey.deliver_ms"}}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reports_the_span_metrics(cell):
    bench = harness.benchmark()
    listed = {e["name"] for e in bench["per_layer"] if harness.applies(e, cell)}
    assert SPAN_METRICS[cell] <= listed
    res = run.run_cell(cell, 2**33 + 29, 0.3, True, device="cpu", overrides=SMALL[cell])
    assert res["correct"] is True
    for name in SPAN_METRICS[cell]:
        value = res["metrics"][name]["value"]
        assert value is not None and value > 0.0, name


@pytest.mark.parametrize("name", sorted(set().union(*SPAN_METRICS.values())))
def test_span_metrics_read_none_without_spans(name):
    view = harness.TraceView(calls=[(0.0, 10.0)], kernels=[], copies=[],
                             host=[("bench.call", 0.0, 10.0), ("aten::copy_", 1.0, 2.0)],
                             launches={"B7d": 1}, setup={}, workload={}, config={},
                             launch={})
    assert harness.load_module("metrics", f"{name}.py").read(view) is None
