"""The survey's reduction (kernel B9, ``csrc/survey.cuh``) and its
delivery, on the CPU.

Kernel B9 itself runs only on a card (its tests are in
tests/test_torch_cuda.py).  Here its row functions — Ḣ and ε of a row
(with the generated ``inflx_chi_sq``), a row's flags, the e-fold segment,
the walk and the summaries — are built with the host's C++ compiler
(``-ffp-contract=off``, as the other header tests) and walked over each
trajectory in order, against the plain reduction
(``ops/cuda_survey.survey_reduce_torch``) on the same rows: bit for bit,
NaN in the same places, since every operation is one IEEE operation in the
plain version's order and torch's CPU ``cumsum`` sums in order.  The rows
are real solves and drawn rows with the edge cases laid in.  The survey
itself is checked for the host assembly of its one stacked delivery."""

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
from inflatox_torch import background
from inflatox_torch.ops.build import CSRC
from inflatox_torch.ops.cuda_solver import solve_torch
from inflatox_torch.ops.cuda_survey import survey_reduce_cuda, survey_reduce_torch

_HARNESS = r"""
#include <stdint.h>
#include "inflx_model.h"
#include "solver.cuh"
#include "survey.cuh"

// kernel B9's row functions over each trajectory in order: rows (steps,
// 2n+2, B) as B6 writes them; out (B, n+3); ended (B,)
extern "C" void reduce(const double* rows, const double* p, int64_t p_stride,
                       int64_t n_traj, int64_t steps, double* out,
                       unsigned char* ended) {
  const int C = INFLX_NY + 1;
  const int64_t plane = C * n_traj;
  for (int64_t b = 0; b < n_traj; ++b) {
    const double* pb = p == nullptr ? p : p + b * p_stride;
    inflx_survey_walk w = inflx_survey_begin();
    double h0 = 0.0, t0 = 0.0, hd0 = 0.0;
    for (int64_t s = 0; s < steps; ++s) {
      double y[INFLX_NY];
      for (int c = 0; c < INFLX_NY; ++c) y[c] = rows[s * plane + c * n_traj + b];
      const double t = rows[s * plane + (C - 1) * n_traj + b];
      double hd, eps;
      inflx_survey_eps(y, pb, &hd, &eps);
      const double h = y[2 * INFLX_NF];
      const double seg = s > 0 ? inflx_survey_seg(h0, t0, hd0, h, t, hd) : 0.0;
      inflx_survey_step(&w, s, seg, inflx_survey_flags(eps, h));
      h0 = h;
      t0 = t;
      hd0 = hd;
    }
    double lo[INFLX_NY], hi[INFLX_NY];
    if (w.i >= 0) {
      for (int c = 0; c < INFLX_NY; ++c) {
        lo[c] = rows[(w.i - 1) * plane + c * n_traj + b];
        hi[c] = rows[w.i * plane + c * n_traj + b];
      }
    }
    double* o = out + b * (INFLX_NF + 3);
    inflx_survey_finish(&w, lo, hi, pb, o, o + 1, o + 2, 1);
    o[INFLX_NF + 2] = w.n;
    ended[b] = w.i >= 0 ? 1 : 0;
  }
}
"""


def _doc():
    r, theta, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = inflatox_torch.InflationModelBuilder.new([r, theta], g, V, silent=True).build()
    return inflatox_torch.Compiler(model, silent=True).compile(), np.array([1.0])


def _three():
    a, b, c, m = sympy.symbols("a3 b3 c3 m3")
    V = sympy.Rational(1, 2) * m**2 * (a**2 + 2 * b**2 + 3 * c**2)
    model = inflatox_torch.InflationModelBuilder.new(
        [a, b, c], [[1, 0, 0], [0, 1, 0], [0, 0, 1]], V, silent=True
    ).build(guesses=[[0, 1, 0], [0, 0, 1]])
    return inflatox_torch.Compiler(model, silent=True).compile(), np.array([1.3])


def _alpha():
    model, args = inflatox_torch.models.alpha_attractor()
    return inflatox_torch.Compiler(model, silent=True).compile(), np.asarray(args, dtype=float)


@pytest.fixture(scope="module")
def models():
    return {"doc": _doc(), "three": _three(), "alpha": _alpha()}


def _host_reduction(artifact, workdir):
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (workdir / "inflx_model.h").write_text(artifact.cuda_solver_source())
    (workdir / "harness.cpp").write_text(_HARNESS)
    lib = workdir / "libharness.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(workdir), "-I", str(CSRC), "-o", str(lib), str(workdir / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    dll.reduce.argtypes = [ptr, ptr, i64, i64, i64, ptr, ptr]
    return dll


def _harness_reduce(dll, artifact, rows, times, pars):
    """The harness's summaries of (B, steps, 2n+1) rows and (B, steps)
    times, in the plain version's five outputs."""
    n = artifact.n_fields
    B, steps, _ = rows.shape
    buf = np.ascontiguousarray(np.concatenate([rows, times[..., None]], axis=2).transpose(1, 2, 0))
    pars = np.ascontiguousarray(pars, dtype=np.float64)
    out = np.zeros((B, n + 3))
    ended = np.zeros(B, dtype=np.uint8)
    dll.reduce(buf.ctypes.data, pars.ctypes.data if pars.size else None,
               pars.shape[1] if pars.ndim == 2 else 0, B, steps, out.ctypes.data,
               ended.ctypes.data)
    return out[:, 0], ended.astype(bool), out[:, 1], out[:, 2:2 + n], out[:, 2 + n]


def assert_same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == bool:
        assert np.array_equal(got, want)
        return
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int64), want[~nan].view(np.int64))


def edge_rows(artifact, steps=60, seed=0):
    """(rows, times) of ten drawn trajectories of a 2-field model whose
    metric's first entry is a constant g (ε = g χ₀² / (2 H²) with χ₁ = 0),
    each with an edge case of the reduction laid in by the ε it is given:
    never inflates; inflates from row 0; never ends; crosses at the last
    row; H <= 0 on some rows; NaN and ±inf rows, one just before the
    crossing; H = 0 on a row; ε = 1 (to rounding) at the crossing; starts
    late; the two rows about the crossing with equal ε (H < 0 on the
    first)."""
    rng = np.random.default_rng(seed)
    g = float(artifact.metric([torch.tensor([2.0]), torch.tensor([1.0])],
                              torch.tensor([1.0] * artifact.n_parameters))[0, 0, 0])
    eps = np.full((10, steps), 0.5)
    hub = np.ones((10, steps))
    eps[0] = 2.0
    eps[1, 20:] = 1.5
    eps[2] = 0.3
    eps[3, -1] = 1.2
    hub[4, 5:10] = -1.0
    eps[4, :10] = 1.5
    eps[4, 30:] = 1.1
    eps[5, 25:] = 1.3
    eps[5, 3:5] = np.nan
    eps[5, 24] = np.inf
    hub[6, 12] = 0.0
    eps[6, 40:] = 1.7
    eps[7, 33:] = [1.0] + [2.0] * (steps - 34)
    eps[8, :10] = 2.0
    eps[8, 30:] = 1.25
    hub[9, 20] = -1.0
    eps[9, 20:] = 1.5
    hub = hub * rng.uniform(0.5, 2.0, (10, 1))
    chi0 = np.sqrt(2.0 * eps / g) * np.abs(hub)
    rows = np.zeros((10, steps, 5))
    rows[..., 0] = rng.uniform(1.5, 2.5, (10, steps))
    rows[..., 1] = rng.uniform(1.5, 2.5, (10, steps))
    rows[..., 2] = np.where(np.isinf(eps), np.inf, chi0)
    rows[..., 4] = hub
    rows[5, 3:5, 4] = np.nan
    times = np.cumsum(rng.uniform(0.01, 0.2, (10, steps)), axis=1)
    return rows, times - times[:, :1]


def _solve(artifact, pars, batch, steps, max_err, box=(1.5, 2.5), seed=0):
    f0 = np.random.default_rng(seed).uniform(*box, (batch, artifact.n_fields))
    rows, times = solve_torch(artifact, torch.tensor(np.asarray(pars, dtype=float)), steps,
                              torch.tensor(f0), torch.zeros_like(torch.tensor(f0)),
                              max_err, "rkf")
    return rows.numpy(), times.numpy()


def test_b9_counts_under_a_key_made_at_import():
    """The benchmark subtracts a snapshot of the launch table taken before
    its window, so B9's key exists from the first import, at 0."""
    code = ("from inflatox_torch.ops import cuda_kernels as k; "
            "print(k.LAUNCHES_BY_KERNEL['B9'], k.launches())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.split() == ["0", "0"]


@pytest.mark.parametrize("case", ["doc-shared", "doc-per_traj", "three", "alpha"])
def test_row_functions_match_the_plain_reduction_on_solves(models, case, tmp_path):
    name = case.split("-")[0]
    art, args = models[name]
    batch = 12
    pars = np.tile(args, (batch, 1)) * np.linspace(0.8, 1.2, batch)[:, None] \
        if case.endswith("per_traj") else args
    rows, times = _solve(art, pars, batch, 400, 1e-7 if name == "three" else 1e-6,
                         box=(0.85, 0.95) if name == "alpha" else (1.5, 2.5))
    want = survey_reduce_torch(art, torch.tensor(rows), torch.tensor(times),
                               torch.tensor(np.asarray(pars, dtype=float)))
    got = _harness_reduce(_host_reduction(art, tmp_path), art, rows, times, pars)
    for g, w in zip(got, want):
        assert_same_bits(g, w.numpy())
    if name == "doc":
        assert want[1].any(), "some trajectory should end inflation in 400 rows"


def test_row_functions_match_the_plain_reduction_on_edge_cases(models, tmp_path):
    art, args = models["doc"]
    rows, times = edge_rows(art)
    want = survey_reduce_torch(art, torch.tensor(rows), torch.tensor(times), torch.tensor(args))
    got = _harness_reduce(_host_reduction(art, tmp_path), art, rows, times, args)
    for g, w in zip(got, want):
        assert_same_bits(g, w.numpy())
    ended = want[1].numpy()
    assert list(ended) == [False, True, False, True, True, True, True, True, True, True]
    assert np.isnan(want[0].numpy()[5])  # NaN rows, and ε = inf before the crossing
    assert want[0].numpy()[9] == want[0].numpy()[9]  # equal ε about the crossing: frac 0


def test_reduction_wrapper_on_the_cpu_is_the_plain_version(models):
    art, args = models["doc"]
    rows, times = edge_rows(art)
    got = survey_reduce_cuda(art, torch.tensor(rows), torch.tensor(times), torch.tensor(args))
    want = survey_reduce_torch(art, torch.tensor(rows), torch.tensor(times), torch.tensor(args))
    for g, w in zip(got, want):
        assert_same_bits(g.numpy(), w.numpy())
    with pytest.raises(ValueError, match="two rows"):
        survey_reduce_cuda(art, torch.tensor(rows[:, :1]), torch.tensor(times[:, :1]),
                           torch.tensor(args))
    with pytest.raises(ValueError, match="pars"):
        survey_reduce_cuda(art, torch.tensor(rows), torch.tensor(times),
                           torch.ones(3, 2, dtype=torch.float64))


def test_survey_delivers_the_plain_summaries_in_their_dtypes(models):
    """The stacked delivery, taken apart on the host: the dtypes and shapes
    of the five summaries, each bit for bit the plain reduction of the same
    solve, chunked (B not a multiple of the chunk) as unchunked."""
    art, args = models["doc"]
    f0 = np.random.default_rng(7).uniform(1.5, 2.5, (20, 2))
    got = background.survey_initial_conditions(art, args, 300, f0, np.zeros(2), chunk=8,
                                               device="cpu")
    whole = background.survey_initial_conditions(art, args, 300, f0, np.zeros(2),
                                                 device="cpu")
    rows, times = background._solve_batch_device(art, args, 300, f0, np.zeros((20, 2)), 1e-6,
                                                 "rkf", torch.device("cpu"), "torch")
    want = survey_reduce_torch(art, rows, times, torch.tensor(args))
    keys = ("N_inflation", "ended", "H_end", "x_end", "N_span")
    shapes = {"x_end": (20, 2)}
    for key, w in zip(keys, want):
        for out in (got, whole):
            assert out[key].shape == shapes.get(key, (20,))
            assert out[key].dtype == (bool if key == "ended" else np.float64)
            assert out[key].flags.c_contiguous
            assert_same_bits(out[key], w.numpy())
    assert got["ended"].any()


#: kernel B6's output of one chunk of 4096 trajectories × 2000 rows of a
#: 2-field model: steps × (2n + 2) × chunk f64 values
ROWS_4096 = 2000 * 6 * 4096 * 8
#: an H100's warp schedulers, four on each of its 132 SMs
H100_SCHEDULERS = 4 * 132
#: (schedulers, chunk, chunks, free bytes, steps, n_fields) → the depth
DEPTHS = {
    "4096-in-2": ((H100_SCHEDULERS, 4096, 2, 80 * 10**9, 2000, 2), 2),
    "4096-in-8": ((H100_SCHEDULERS, 4096, 8, 80 * 10**9, 2000, 2), 4),
    "16896-in-4": ((H100_SCHEDULERS, 16896, 4, 80 * 10**9, 2000, 2), 1),
    "20000-in-4": ((H100_SCHEDULERS, 20000, 4, 80 * 10**9, 2000, 2), 1),
    "one-chunk": ((H100_SCHEDULERS, 4096, 1, 80 * 10**9, 2000, 2), 1),
    "memory-below-two-chunks": ((H100_SCHEDULERS, 4096, 8, 4 * ROWS_4096 - 1, 2000, 2), 1),
    "memory-for-three-chunks": ((H100_SCHEDULERS, 4096, 8, 6 * ROWS_4096, 2000, 2), 3),
}


@pytest.mark.parametrize("case", [*DEPTHS, "cpu-survey"])
def test_overlap_depth_and_the_cpu_survey(models, case):
    """The survey's chunks a launch on the card: as many chunks as fill
    the card's warp schedulers with B6's one-warp blocks, at most the
    number of chunks, with their rows within half the free memory, and at
    least one.  A survey on the CPU counts no chunk and returns the plain
    reduction of its solve, chunked as unchunked."""
    if case in DEPTHS:
        args, want = DEPTHS[case]
        assert background._overlap_depth(*args) == want
        return
    art, args = models["doc"]
    f0 = np.random.default_rng(8).uniform(1.5, 2.5, (20, 2))
    before = background.survey_counts()
    got = background.survey_initial_conditions(art, args, 300, f0, np.zeros(2), chunk=8,
                                               device="cpu")
    assert background.survey_counts() == before == {"chunks": 0, "overlapped": 0}
    rows, times = background._solve_batch_device(art, args, 300, f0, np.zeros((20, 2)), 1e-6,
                                                 "rkf", torch.device("cpu"), "torch")
    want = survey_reduce_torch(art, rows, times, torch.tensor(args))
    for key, w in zip(("N_inflation", "ended", "H_end", "x_end", "N_span"), want):
        assert_same_bits(got[key], w.numpy())
