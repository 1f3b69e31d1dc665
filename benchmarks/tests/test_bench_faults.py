"""The check that decides ``correct``, shown to fail: runs of a cell on the
host with the timed path broken underneath by each fault that the cell's
traffic kind can have (``benchmarks/faults.py``: an answer altered where it
is produced, a scan that returns the previous scan's answer, half of the
batch left out, and in a sweep one set given another set's answer), and
the control (the configuration's lower precision), at sizes a test run
holds.  ``benchmarks/control.py`` reads the same at each cell's own size
on the card.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import control  # noqa: E402
import run  # noqa: E402
from test_bench_harness import SMALL  # noqa: E402

H = run.H


def _faults(cell):
    workload = H.load_json("workloads", f"{cell}.json")
    return H.load_module("traffic", f"{workload['traffic']['generator']}.py").FAULTS


CASES = [(cell, fault) for cell in sorted(SMALL) for fault in _faults(cell)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault):
    (row,) = control.readings(cell, [2**33 + 29], 0.3, SMALL[cell], fault, device="cpu")
    limits = H.load_json("workloads", f"{cell}.json")["limits"]
    assert row["attempted"] > 0 and row["failed"] == 0
    assert row["correct"] is False
    assert any(row[k] > limits[k] for k in limits), row


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    (row,) = control.readings(cell, [2**33 + 29], 0.3, SMALL[cell], device="cpu")
    assert row["correct"] is True, row


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_the_limits(cell):
    """The program's lower-precision path reads above the cell's limit."""
    workload = H.load_json("workloads", f"{cell}.json")
    config = H.load_json("configs", f"{workload['config']}.json")
    small = {**SMALL[cell], "precision": config["control_precision"]}
    (row,) = control.readings(cell, [2**33 + 41], 0.3, small, device="cpu")
    limits = workload["limits"]
    assert row["correct"] is False
    assert any(row[k] > limits[k] for k in limits), row
