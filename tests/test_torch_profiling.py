"""``inflatox_torch.utils.profiling`` on the CPU: ``trace`` writes a
torch.profiler trace file that names the annotated regions, and
``annotate`` works as a context manager and as a decorator."""

import json

import torch

from inflatox_torch.utils import profiling


@profiling.annotate("inflatox_decorated_region")
def _decorated(a):
    return (a * a).sum()


def test_trace_writes_a_trace_file_naming_the_regions(tmp_path, capsys):
    a = torch.arange(64, dtype=torch.float64)
    with profiling.trace(str(tmp_path), label="smoke") as prof:
        with profiling.annotate("inflatox_context_region"):
            total = (a + 1.0).sum()
        decorated = _decorated(a)
    assert float(total) == 64 * 65 / 2
    assert float(decorated) == float((a * a).sum())
    files = sorted(tmp_path.glob("smoke*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"inflatox_context_region", "inflatox_decorated_region"} <= names
    assert any(e.key == "inflatox_context_region" for e in prof.key_averages())
    err = capsys.readouterr().err
    assert "profiling 'smoke'" in err and "profile captured" in err


def test_annotate_outside_a_trace_is_harmless():
    with profiling.annotate("inflatox_no_trace"):
        value = torch.ones(3).sum()
    assert float(value) == 3.0
    assert float(_decorated(torch.ones(4))) == 4.0
