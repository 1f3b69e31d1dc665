"""The port's own spans (``inflx.*``, ``utils.profiling.annotate``) on the
CPU: under ``profiling.trace`` each traced path records exactly its spans,
once a chunk, each inside the caller's span and none inside another; the
plain solver's attempts go to ``cuda_solver.attempt_counts`` only while a
profiler records."""

import collections
import json

import numpy as np
import pytest
import torch

import inflatox_torch
from inflatox_torch import background
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops import cuda_solver
from inflatox_torch.parallel import parameter_sweep
from inflatox_torch.utils import profiling

EXTENT = (0.5, 2.5, 0.25, 3.0)
CALL = "test.call"


@pytest.fixture(scope="module")
def hyper():
    model, _ = inflatox_torch.models.hyperinflation()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    return art, GeneralisedAL(art, device="cpu", validate_basis=False)


def traced_spans(tmp_path, fn):
    """Run ``fn`` inside a ``test.call`` span under ``profiling.trace``;
    return the trace file's ``test.call`` span and the ``inflx.*`` spans as
    (name, start, end, thread), in order of their start."""
    with profiling.trace(str(tmp_path), label="spans"):
        with profiling.annotate(CALL):
            fn()
    (path,) = tmp_path.glob("spans*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and (e["name"] == CALL or e["name"].startswith("inflx.")))
    spans.sort(key=lambda s: s[1])
    (call,) = [s for s in spans if s[0] == CALL]
    return call, [s for s in spans if s[0] != CALL]


def assert_flat_inside(call, spans):
    """Every span lies inside the caller's span, on its thread, and none
    overlaps another (no inflx span nests in another)."""
    for name, start, end, tid in spans:
        assert tid == call[3], name
        assert call[1] <= start <= end <= call[2], name
    for before, after in zip(spans, spans[1:]):
        assert before[2] <= after[1], (before[0], after[0])


def test_complete_analysis_records_launch_then_deliver(hyper, tmp_path):
    _, al = hyper
    call, spans = traced_spans(tmp_path, lambda: al.complete_analysis(
        np.array([1.0]), *EXTENT, 24, 20, progress=False))
    assert [s[0] for s in spans] == ["inflx.scan.launch", "inflx.scan.deliver"]
    assert_flat_inside(call, spans)


def test_parameter_sweep_records_each_chunk_span_once(hyper, tmp_path):
    _, al = hyper
    masses = np.linspace(0.5, 2.0, 6)[:, None]
    ckpt = tmp_path / "ckpt"
    out = {}

    def sweep():
        out["sweep"] = parameter_sweep(al, masses, EXTENT, (16, 12), chunk_size=2,
                                       checkpoint_dir=str(ckpt), progress=False,
                                       reduce_fn=lambda maps: maps[0].amin())

    call, spans = traced_spans(tmp_path, sweep)
    assert out["sweep"].shape == (6,)
    assert len(list(ckpt.glob("chunk_*.npy"))) == 3
    counts = collections.Counter(s[0] for s in spans)
    assert counts == {f"inflx.{n}": 3 for n in (
        "sweep.launch", "sweep.reduce", "shards.stage", "shards.wait", "sweep.store",
        "sweep.write")}
    writes = [s for s in spans if s[0] == "inflx.sweep.write"]
    loop = [s for s in spans if s[0] != "inflx.sweep.write"]
    assert_flat_inside(call, loop)
    # chunk i+1 is launched before chunk i is waited for, stored and written
    assert [s[0] for s in loop[:4]] == ["inflx.sweep.launch", "inflx.sweep.reduce",
                                        "inflx.shards.stage", "inflx.sweep.launch"]
    # the writes run on the writer thread, each after its chunk's store
    assert all(w[3] != call[3] for w in writes)
    stores = [s for s in loop if s[0] == "inflx.sweep.store"]
    assert all(st[2] <= w[1] for st, w in zip(stores, writes))


def test_survey_records_solve_reduce_deliver_per_chunk(hyper, tmp_path):
    art, _ = hyper
    f0 = np.random.default_rng(5).uniform(1.5, 2.5, (24, 2))
    out = {}

    def survey():
        out["survey"] = background.survey_initial_conditions(
            art, np.array([1.0]), 40, f0, np.zeros(2), chunk=12, device="cpu")

    call, spans = traced_spans(tmp_path, survey)
    assert out["survey"]["N_span"].shape == (24,)
    assert [s[0] for s in spans] == 2 * ["inflx.survey.solve", "inflx.survey.reduce",
                                         "inflx.survey.deliver"]
    assert_flat_inside(call, spans)


def test_model_load_records_its_lowering(hyper, tmp_path):
    art, _ = hyper
    bundle = tmp_path / "hyper.json"
    art.save(str(bundle))
    trace_dir = tmp_path / "trace"
    trace_dir.mkdir()
    call, spans = traced_spans(trace_dir, lambda: inflatox_torch.CompiledModel.load(
        str(bundle)))
    assert [s[0] for s in spans] == ["inflx.load"]
    assert_flat_inside(call, spans)


def test_plain_solver_counts_attempts_only_under_a_profiler(hyper):
    art, _ = hyper
    f0 = torch.tensor(np.random.default_rng(6).uniform(1.5, 2.5, (5, 2)))
    d0 = torch.zeros_like(f0)
    p = torch.tensor([1.0], dtype=torch.float64)
    before = cuda_solver.attempt_counts()
    rows, _, attempts = cuda_solver.solve_torch(art, p, 30, f0, d0, count_attempts=True)
    assert cuda_solver.attempt_counts() == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced_rows, _, traced = cuda_solver.solve_torch(art, p, 30, f0, d0,
                                                         count_attempts=True)
        plain = cuda_solver.solve_torch(art, p, 30, f0, d0)
    after = cuda_solver.attempt_counts()
    assert len(plain) == 2 and torch.equal(plain[0], rows)
    assert torch.equal(traced, attempts) and torch.equal(traced_rows, rows)
    assert after["attempts"] - before["attempts"] == 2 * int(attempts.sum())
    assert after["lane_attempts"] == before["lane_attempts"]
    cuda_solver.solve_torch(art, p, 30, f0, d0)
    assert cuda_solver.attempt_counts() == after
