"""The per-layer metric that reads a counter of the program's survey,
``survey.overlap_share``, against a stand-in for the counter: nothing from
a program without it or with no chunk on the card, 0 % where every call is
one chunk, 50 % where every call is two chunks side by side.

Run with ``python -m pytest benchmarks/tests``.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402

VIEW = harness.TraceView(calls=[(0.0, 10.0)], kernels=[], copies=[], host=[], launches={},
                         setup={}, workload={}, config={}, launch={})


@pytest.mark.parametrize("counts,want", [
    (None, None),  # a program without survey_counts, as the parent's
    ({"chunks": 0, "overlapped": 0}, None),  # no chunk on the card (the CPU)
    ({"chunks": 3, "overlapped": 0}, 0.0),  # three calls of one chunk
    ({"chunks": 6, "overlapped": 3}, 50.0),  # three calls of two chunks
], ids=["no-counter", "no-chunk", "one-chunk", "two-chunks"])
def test_overlap_share_reads_the_survey_counter(monkeypatch, counts, want):
    from inflatox_torch import background

    if counts is None:
        monkeypatch.delattr(background, "survey_counts")
    else:
        monkeypatch.setattr(background, "survey_counts", lambda: dict(counts))
    assert harness.load_module("metrics", "survey.overlap_share.py").read(VIEW) == want
