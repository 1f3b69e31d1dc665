"""``inflatox_torch.utils.profiling`` on the CPU: ``trace`` writes a
torch.profiler trace file that names the annotated regions, and
``annotate`` works as a context manager and as a decorator, and enters
no ``record_function`` range while no profiler records."""

import json

import pytest
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


def _refuse_record_function(monkeypatch):
    """Make entering a ``record_function`` range raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function was entered")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)


def test_annotate_enters_no_record_function_without_a_profiler(monkeypatch):
    assert not profiling.recording()
    _refuse_record_function(monkeypatch)
    with profiling.annotate("inflatox_idle_region"):
        value = torch.ones(3).sum()
    assert float(value) == 3.0
    assert float(_decorated(torch.ones(4))) == 4.0
    # the refusal is live: under a profiler the same span enters one
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
        with pytest.raises(AssertionError, match="record_function was entered"):
            with profiling.annotate("inflatox_idle_region"):
                pass


def _names(prof):
    return [e.name for e in prof.events()]


def test_decorated_function_records_its_span_only_under_a_profiler(monkeypatch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # decorated while a profiler records: the check is made at each call
        @profiling.annotate("inflatox_late_region")
        def late(a):
            return a + 1.0

        late(torch.ones(2))
        _decorated(torch.ones(2))
    assert _names(prof).count("inflatox_late_region") == 1
    assert _names(prof).count("inflatox_decorated_region") == 1
    _refuse_record_function(monkeypatch)
    assert float(late(torch.ones(2)).sum()) == 4.0
    assert float(_decorated(torch.ones(2))) == 2.0
