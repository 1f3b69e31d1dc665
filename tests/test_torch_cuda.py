"""Kernels B1, B2, B4, B5a, B5b, B6, the batched B7a, B7b, B7d, B8 and B9 on
the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): they
carry the ``cuda`` marker and skip on a host without one.  This file
imports only torch and the port, so it also runs on a host without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 5e-10 with identical NaN/±inf masks for the analysis maps
(B1, B4, B5a, B5b), the repo's tolerance; rtol 1e-5 for the f32 kernel B2;
rtol 1e-12 with identical NaN masks for the solver's rows and times (B6).
Each kernel repeats its plain version's operations in their order, so both
are expected to agree exactly; the batched kernels B7a, B7b and B7d are held
to that: bit for bit their plain version, and each set its single scan.
B6's work counter (on while a profiler records) moves no bit of its rows,
counts the plain version's attempts exactly, and leaves the instance that
counts nothing as ptxas built it before the counter existed; the program's
spans and the counter land in a ``profiling.trace`` of the card.  B9, the
survey's reduction, is held bit for bit, NaN in the same places, to the
plain reduction run on the host's CPU from the same rows (torch's CUDA
cumsum sums in another order, and torch on the card divides by a number
through its reciprocal).  Angular inflation, whose disc metric has a pole
near the benchmark's starts, runs through B6, B9 and the survey's chunk
loop at the cell ``angular.survey``'s sizes, and B6's counting instance
counts its rejected attempts.  A survey of several chunks runs them side
by side in one B6 launch, bit for bit the one-chunk call."""

import json
import os
import re

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
from inflatox_torch import background
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops import cuda_kernels, cuda_solver
from inflatox_torch.ops.cuda_kernels import (
    KINDS,
    POINT_KINDS,
    PRECISIONS,
    scan_batch_cuda,
    scan_batch_torch,
    scan_cuda,
    scan_points_cuda,
    scan_points_torch,
    scan_torch,
)
from inflatox_torch.ops.cuda_solver import solve_cuda, solve_torch
from inflatox_torch.parallel import parameter_sweep

pytestmark = pytest.mark.cuda

DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)
ANGULAR_EXTENT = (-0.7, 0.7, -0.7, 0.7)


def assert_maps_close(got, want, rtol=5e-10):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape
    for mask in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(mask(got), mask(want)), mask.__name__
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA and have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def doc(cuda_device):
    r, theta, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = inflatox_torch.InflationModelBuilder.new([r, theta], g, V, silent=True).build()
    return inflatox_torch.Compiler(model, silent=True).compile(), np.array([1.0])


@pytest.fixture(scope="module")
def angular(cuda_device):
    model, args = inflatox_torch.models.angular()
    return inflatox_torch.Compiler(model, silent=True).compile(), args


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_matches_plain_torch_256(doc, cuda_device, kind):
    art, args = doc
    before = cuda_kernels.launches()
    got = scan_cuda(art, kind, args, DOC_EXTENT, (256, 256), cuda_device)
    torch.cuda.synchronize()
    assert cuda_kernels.launches() == before + 1
    assert got.shape == (KINDS[kind][1], 256, 256) and got.dtype == torch.float64
    want = scan_torch(art, kind, args, DOC_EXTENT, (256, 256), cuda_device)
    assert_maps_close(got, want)


def test_kernel_matches_plain_torch_angular(angular, cuda_device):
    art, args = angular
    got = scan_cuda(art, "complete_analysis", args, ANGULAR_EXTENT, (256, 200), cuda_device)
    want = scan_torch(art, "complete_analysis", args, ANGULAR_EXTENT, (256, 200), cuda_device)
    assert_maps_close(got, want)


def test_kernel_rows_beyond_one_grid_dimension(doc, cuda_device):
    """N0 above 65535 blocks of gridDim.y at 32 rows a block (the most a
    block takes): row blocks are strided in-kernel."""
    art, args = doc
    shape = (65535 * 32 + 17, 3)
    got = scan_cuda(art, "epsilon_v", args, DOC_EXTENT, shape, cuda_device)
    want = scan_torch(art, "epsilon_v", args, DOC_EXTENT, shape, cuda_device)
    assert_maps_close(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (17, 257), (33, 511), (5, 1000)])
@pytest.mark.parametrize("precision", ["f64", "f32", "dd"])
def test_staged_kernel_at_ragged_shapes(doc, cuda_device, shape, precision):
    """Grids whose rows and columns are not whole blocks: the last row
    block's row stage and the last column block's idle threads."""
    art, args = doc
    for kind in ("complete_analysis", "hesse", "gradient"):
        got = scan_cuda(art, kind, args, DOC_EXTENT, shape, cuda_device, precision)
        want = scan_torch(art, kind, args, DOC_EXTENT, shape, cuda_device, precision)
        assert_maps_close(got, want, 1e-5 if precision == "f32" else 5e-10)


def test_default_engine_runs_the_kernel(doc, cuda_device):
    art, args = doc
    al = GeneralisedAL(art, device=cuda_device, validation_seed=7)
    before = cuda_kernels.launches()
    maps = al.complete_analysis(args, *DOC_EXTENT, 128, 96, progress=False,
                                output="f64_device")
    assert cuda_kernels.launches() == before + 1
    assert maps[0].device.type == "cuda" and maps[0].shape == (128, 96)
    host = al.complete_analysis(args, *DOC_EXTENT, 128, 96, progress=False)
    for m, h in zip(maps, host):
        assert np.array_equal(m.cpu().numpy(), h, equal_nan=True)
    plain = al.complete_analysis(args, *DOC_EXTENT, 128, 96, progress=False,
                                 engine="torch", output="f64_device")
    assert cuda_kernels.launches() == before + 2
    for m, p in zip(maps, plain):
        assert_maps_close(m, p)


def test_golden_values_on_the_card(doc, cuda_device):
    art, _ = doc
    al = GeneralisedAL(art, device=cuda_device, validation_seed=7)
    assert np.isclose(al.calc_V([2.0, -2.0], [1.0]), 1.9166666666666667, rtol=1e-12)


def assert_rows_equal(got, want, rtol=1e-12):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _inits(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    f0 = torch.tensor(rng.uniform(1.5, 2.5, (batch, n)), device="cuda")
    return f0, torch.zeros_like(f0)


@pytest.mark.parametrize("solver", ["rkf", "rk4"])
@pytest.mark.parametrize("per_trajectory", [False, True], ids=["shared", "per_traj"])
def test_solver_kernel_matches_plain_torch(doc, cuda_device, solver, per_trajectory):
    art, args = doc
    f0, d0 = _inits(96, 2)
    pars = (torch.linspace(0.5, 2.0, 96, dtype=torch.float64, device="cuda")[:, None]
            if per_trajectory else torch.tensor(args, device="cuda"))
    before = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    rows, times = solve_cuda(art, pars, 120, f0, d0, 1e-6, solver)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == before + 1
    assert rows.shape == (96, 120, 5) and times.shape == (96, 120)
    want_rows, want_times = solve_torch(art, pars, 120, f0, d0, 1e-6, solver)
    assert_rows_equal(rows, want_rows)
    assert_rows_equal(times, want_times)


def test_solver_kernel_three_fields(cuda_device):
    a, b, c, m = sympy.symbols("a3 b3 c3 m3")
    V = sympy.Rational(1, 2) * m**2 * (a**2 + 2 * b**2 + 3 * c**2)
    model = inflatox_torch.InflationModelBuilder.new(
        [a, b, c], [[1, 0, 0], [0, 1, 0], [0, 0, 1]], V, silent=True
    ).build(guesses=[[0, 1, 0], [0, 0, 1]])
    art = inflatox_torch.Compiler(model, silent=True).compile()
    f0, d0 = _inits(64, 3)
    pars = torch.tensor([1.3], dtype=torch.float64, device="cuda")
    rows, times = solve_cuda(art, pars, 80, f0, d0, 1e-8, "rkf")
    want_rows, want_times = solve_torch(art, pars, 80, f0, d0, 1e-8, "rkf")
    assert rows.shape == (64, 80, 7)
    assert_rows_equal(rows, want_rows)
    assert_rows_equal(times, want_times)


def test_background_entry_points_run_the_kernels(doc, cuda_device):
    art, args = doc
    f0 = np.random.default_rng(3).uniform(1.5, 2.5, (40, 2))
    d0 = np.zeros((40, 2))
    before = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    rows, times = background.solve_eom_batch(art, args, 60, f0, d0, solver="rkf",
                                             return_time=True)
    single = background.solve_eom(art, args, 60, f0[0], d0[0], solver="rkf")
    survey = background.survey_initial_conditions(art, args, 60, f0, np.zeros(2), chunk=16)
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == before + 2 + 1  # three chunks, one launch
    plain = background.solve_eom_batch(art, args, 60, f0, d0, solver="rkf",
                                       return_time=True, engine="torch")
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == before + 3
    np.testing.assert_array_equal(rows, plain[0])
    np.testing.assert_array_equal(times, plain[1])
    np.testing.assert_array_equal(single, rows[0])
    want = background.survey_initial_conditions(art, args, 60, f0, np.zeros(2), chunk=16,
                                                engine="torch")
    for key in want:
        np.testing.assert_array_equal(survey[key], want[key])


@pytest.mark.parametrize("kind", sorted(POINT_KINDS))
def test_points_kernel_matches_plain_torch(doc, cuda_device, kind):
    art, args = doc
    rng = np.random.default_rng(5)
    x = torch.tensor(np.stack([rng.uniform(0.3, 3.0, 10_007), rng.uniform(-3.0, 3.0, 10_007)], 1),
                     device="cuda")
    before = cuda_kernels.launches()
    got = scan_points_cuda(art, kind, args, x)
    torch.cuda.synchronize()
    assert cuda_kernels.launches() == before + 1
    assert got.shape == (KINDS[kind][1], 10_007)
    assert_maps_close(got, scan_points_torch(art, kind, args, x))
    # a strided view of solver rows is made contiguous by the wrapper
    wide = torch.cat([x, x], dim=1)[:, 1:3]
    assert_maps_close(scan_points_cuda(art, kind, args, wide),
                      scan_points_torch(art, kind, args, wide))


def test_trajectory_scans_run_the_kernel(doc, cuda_device):
    art, args = doc
    al = GeneralisedAL(art, device=cuda_device, validation_seed=7)
    rows = background.solve_eom(art, args, 200, [2.0, 2.0], [0.0, 0.0], solver="rkf")
    before = cuda_kernels.launches()
    got = al.complete_analysis_ot(args, rows[:, :2], progress=False)
    singles = [getattr(al, kind)(args, rows[:, :2], progress=False)
               for kind in ("consistency_ot", "consistency_rapidturn_ot", "epsilon_v_ot")]
    assert cuda_kernels.launches() == before + 4
    want = al.complete_analysis_ot(args, rows[:, :2], progress=False, engine="torch")
    assert cuda_kernels.launches() == before + 4
    assert len(got) == 6 and got[0].shape == (200, 1)
    for g, w in zip(got, want):
        assert_maps_close(torch.from_numpy(g), torch.from_numpy(w))
    assert all(s.shape == (200,) for s in singles)


@pytest.mark.parametrize("precision", ["f32", "dd"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_f32_and_dd_kernels_match_plain_torch(doc, cuda_device, kind, precision):
    art, args = doc
    kernel = {"f32": "B2", "dd": "B4"}[precision]
    before = cuda_kernels.LAUNCHES_BY_KERNEL[kernel]
    got = scan_cuda(art, kind, args, DOC_EXTENT, (256, 200), cuda_device, precision)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES_BY_KERNEL[kernel] == before + 1
    assert got.dtype == (torch.float32 if precision == "f32" else torch.float64)
    want = scan_torch(art, kind, args, DOC_EXTENT, (256, 200), cuda_device, precision)
    assert_maps_close(got, want, rtol=1e-5 if precision == "f32" else 5e-10)


@pytest.mark.parametrize("kind", sorted(POINT_KINDS))
def test_dd_points_kernel_matches_plain_torch(doc, cuda_device, kind):
    art, args = doc
    rng = np.random.default_rng(6)
    x = torch.tensor(np.stack([rng.uniform(0.3, 3.0, 5003), rng.uniform(-3.0, 3.0, 5003)], 1),
                     device="cuda")
    before = cuda_kernels.LAUNCHES_BY_KERNEL["B5b"]
    got = scan_points_cuda(art, kind, args, x, "dd")
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B5b"] == before + 1
    assert_maps_close(got, scan_points_torch(art, kind, args, x, "dd"))


def test_array_entries_run_the_kernels(doc, cuda_device):
    art, args = doc
    al = GeneralisedAL(art, device=cuda_device, validation_seed=7)
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    v = al.calc_V_array(args, DOC_EXTENT[::2], DOC_EXTENT[1::2], [96, 80])
    h = al.calc_H_array(args, *DOC_EXTENT, [96, 80])
    flags = al.flag_quantum_dif(args, *DOC_EXTENT, 96, 80, progress=False, accuracy=0.3)
    v32 = al.calc_V_array(args, DOC_EXTENT[::2], DOC_EXTENT[1::2], [96, 80], precision="f32")
    pairs = al.complete_analysis(args, *DOC_EXTENT, 96, 80, progress=False, output="pair",
                                 precision="dd")
    after = cuda_kernels.LAUNCHES_BY_KERNEL
    assert (after["B1"] - before["B1"], after["B2"] - before["B2"],
            after["B4"] - before["B4"]) == (3, 1, 1)
    assert v.shape == (96, 80) and h.shape == (2, 2, 96, 80) and flags.dtype == bool
    assert v32.dtype == np.float32 and pairs[0][0].device.type == "cuda"
    plain = al.calc_H_array(args, *DOC_EXTENT, [96, 80], engine="torch")
    np.testing.assert_array_equal(h, plain)


def test_egno_dd_and_d5_f64_on_the_card(cuda_device):
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    egno = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "egno_bundle.json"))
    e_args = inflatox_torch.models._args_by_symbol(
        egno.model, {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0})
    extent = (0.46, 0.50, 0.0, np.pi)
    got = scan_cuda(egno, "complete_analysis", e_args, extent, (128, 96), cuda_device, "dd")
    assert_maps_close(got, scan_torch(egno, "complete_analysis", e_args, extent, (128, 96),
                                      cuda_device, "dd"))
    d5 = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "d5_bundle.json"))
    d_args = inflatox_torch.models._args_by_symbol(d5.model, {
        "V0": -1.17e-8, "N": 1000.0, "g_s": 0.01, "l_s": 501.961, "u": 50 * 501.961,
        "q": 1.0, "p": 5.0, "a0": 0.001, "a1": 0.0005, "b1": 0.001})
    extent = (0.1, 36.0, 0.0, 4 * np.pi)
    got = scan_cuda(d5, "complete_analysis", d_args, extent, (128, 96), cuda_device)
    assert_maps_close(got, scan_torch(d5, "complete_analysis", d_args, extent, (128, 96),
                                      cuda_device))


def assert_bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.cpu().numpy(), want.cpu().numpy(), equal_nan=True)


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batch_kernels_match_plain_torch_and_single_scans(doc, cuda_device, kind, precision):
    art, _ = doc
    batch = np.linspace(0.5, 2.0, 5)[:, None]
    kernel = PRECISIONS[precision].batch_kernel
    before = cuda_kernels.LAUNCHES_BY_KERNEL[kernel]
    got = scan_batch_cuda(art, kind, batch, DOC_EXTENT, (96, 200), cuda_device, precision)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES_BY_KERNEL[kernel] == before + 1
    assert got.shape == (5, KINDS[kind][1], 96, 200)
    assert_bits_equal(got, scan_batch_torch(art, kind, batch, DOC_EXTENT, (96, 200),
                                            cuda_device, precision))
    for s in range(5):
        assert_bits_equal(got[s], scan_cuda(art, kind, batch[s], DOC_EXTENT, (96, 200),
                                            cuda_device, precision))


def test_batch_kernel_sets_beyond_one_grid_dimension(doc, cuda_device):
    """More sets than the 65535 blocks of gridDim.z: sets are strided in-kernel."""
    art, _ = doc
    batch = np.linspace(0.5, 2.0, 70_001)[:, None]
    got = scan_batch_cuda(art, "complete_analysis", batch, DOC_EXTENT, (2, 3), cuda_device)
    assert_bits_equal(got, scan_batch_torch(art, "complete_analysis", batch, DOC_EXTENT,
                                            (2, 3), cuda_device))
    last = scan_cuda(art, "complete_analysis", batch[-1], DOC_EXTENT, (2, 3), cuda_device)
    assert_bits_equal(got[-1], last)


def test_batch_kernel_model_without_parameters(cuda_device):
    x, y = sympy.symbols("x y")
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], (x**2 + 2 * y**2 + 1) / 3, silent=True).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    for precision in sorted(PRECISIONS):
        got = scan_batch_cuda(art, "complete_analysis", np.zeros((4, 0)), DOC_EXTENT, (64, 48),
                              cuda_device, precision)
        single = scan_cuda(art, "complete_analysis", [], DOC_EXTENT, (64, 48), cuda_device,
                           precision)
        for s in range(4):
            assert_bits_equal(got[s], single)


def test_sweep_runs_the_batch_kernels_and_checkpoints_in_order(doc, cuda_device, tmp_path):
    art, _ = doc
    al = GeneralisedAL(art, device=cuda_device, validation_seed=7)
    batch = np.linspace(0.5, 2.0, 7)[:, None]
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    whole = parameter_sweep(al, batch, DOC_EXTENT, (64, 80), progress=False)
    chunked = parameter_sweep(al, batch, DOC_EXTENT, (64, 80), chunk_size=3, progress=False,
                              checkpoint_dir=str(tmp_path / "ck"))
    f32 = parameter_sweep(al, batch, DOC_EXTENT, (64, 80), progress=False, precision="f32")
    dd = parameter_sweep(al, batch, DOC_EXTENT, (64, 80), progress=False, precision="dd",
                         kind="consistency_rapidturn")
    after = cuda_kernels.LAUNCHES_BY_KERNEL
    assert (after["B7a"] - before["B7a"], after["B7b"] - before["B7b"],
            after["B7d"] - before["B7d"]) == (1 + 3, 1, 1)
    assert np.array_equal(chunked, whole, equal_nan=True)
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "chunk_000000.npy", "chunk_000001.npy", "chunk_000002.npy", "manifest.json"]
    for ci in range(3):
        saved = np.load(tmp_path / "ck" / f"chunk_{ci:06d}.npy")
        assert np.array_equal(saved, whole[3 * ci:3 * ci + 3], equal_nan=True)
    for s in (0, 6):
        maps = np.stack(al.complete_analysis(batch[s], *DOC_EXTENT, 64, 80, progress=False))
        assert np.array_equal(whole[s], maps, equal_nan=True)
    assert f32.dtype == np.float32 and dd.shape == (7, 1, 64, 80)
    plain = parameter_sweep(al, batch, DOC_EXTENT, (64, 80), progress=False, engine="torch",
                            kind="flag_quantum_dif", accuracy=0.3)
    flags = parameter_sweep(al, batch, DOC_EXTENT, (64, 80), progress=False,
                            kind="flag_quantum_dif", accuracy=0.3)
    np.testing.assert_array_equal(flags, plain)

    def nanmin(maps):
        return torch.where(torch.isnan(maps[0]), torch.inf, maps[0]).min()

    reduced = parameter_sweep(al, batch, DOC_EXTENT, (64, 80), chunk_size=2, progress=False,
                              reduce_fn=nanmin)
    np.testing.assert_array_equal(reduced, np.nanmin(whole[:, 0], axis=(1, 2)))


# --------------------------------------------------------------------------- #
# kernel B8: the special functions, alone and inside B1, B2, B5a and B6        #
# --------------------------------------------------------------------------- #

_B8_PARAMS = {"besselj_nu": (12.7,), "bessely_nu": (-12.7,), "besseli_nu": (2.5,),
              "besselk_nu": (0.3,), "sph_jn_nu": (2.3,), "sph_yn_nu": (2.3,),
              "hyp0f1": (2.5,), "hyp1f1": (0.5, 1.5), "hyp2f1": (0.5, 1.5, 2.5),
              "hyp2f0": (0.5, 1.0)}
_B8_RANGE = {"hyp1f1": (-20.0, 20.0), "hyp2f1": (-0.95, 0.95), "hyp2f0": (-0.02, 0.02),
             "erf": (-6.0, 6.0), "erfc": (-6.0, 7.0), "lgamma": (-7.9, 30.0),
             "gamma": (-7.9, 30.0)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_b8_alone_matches_plain_torch(cuda_device, dtype):
    """Every instance of csrc/special_eval.cu against the plain version on
    the card: rtol 5e-10 (f64) or 1e-5 (f32), identical NaN/±inf masks."""
    from inflatox_torch.ops import special_eval

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    for name in special_eval.INSTANCES:
        lo, hi = _B8_RANGE.get(name, (-7.9, 30.0) if name.startswith("polygamma")
                               else (0.01, 60.0))
        z = torch.empty(1 << 16, dtype=torch.float64, device=cuda_device).uniform_(
            lo, hi, generator=gen).to(dtype)
        params = _B8_PARAMS.get(name, ())
        before = cuda_kernels.LAUNCHES_BY_KERNEL["B8"]
        got = special_eval.special_eval_cuda(name, z, params)
        assert cuda_kernels.LAUNCHES_BY_KERNEL["B8"] == before + 1
        want = special_eval.special_eval_torch(name, z, params)
        assert_maps_close(got.double(), want.double(),
                          5e-10 if dtype == torch.float64 else 1e-5)


#: every route's range: both sides of each branch and domain edge, each
#: series' early and full-length exits
_B8_WIDE = {"hyp0f1": (-60.0, 60.0), "hyp1f1": (-320.0, 320.0), "hyp2f1": (-1.02, 1.02),
            "hyp2f0": (-0.05, 0.05), "erf": (-6.0, 6.0), "erfc": (-6.0, 7.0),
            "lgamma": (-7.9, 30.0), "gamma": (-7.9, 30.0), "besseli_nu": (-5.0, 20.0),
            "besselk_nu": (-5.0, 60.0), "besseli_0": (-20.0, 20.0), "besseli_1": (-20.0, 20.0)}
#: the routes' branch points: J/Y's rational form to 5, K's series to 2, I's
#: to 8, Steed's Temme/CF2 at 2 and Hankel beyond 40, J_n's Miller/upward at
#: n, 1F1's direct/Kummer at 0 and its domain at ±300, 2F1's at ±1 and 0.99,
#: ψ's at −32 and 16
_B8_EDGES = (0.0, 1.0, 2.0, 5.0, 8.0, 16.0, 40.0, 300.0, 0.99, -1.0, -2.0, -5.0, -32.0, -300.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_b8_bit_for_bit_on_every_route(cuda_device, dtype):
    """Every instance of csrc/special_eval.cu bit for bit its plain version
    on the card (one route per argument, each loop left where the plain
    version freezes it, each series where its sum settles): over a range
    that takes every route, at each branch point and its neighbours, and at
    NaN, ±0 and ±inf; zeros keep their sign."""
    from inflatox_torch.ops import special_eval

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    edges = torch.tensor(_B8_EDGES, dtype=dtype, device=cuda_device)
    special = torch.cat([edges, torch.nextafter(edges, torch.full_like(edges, -np.inf)),
                         torch.nextafter(edges, torch.full_like(edges, np.inf)),
                         torch.tensor([np.nan, 0.0, -0.0, np.inf, -np.inf], dtype=dtype,
                                      device=cuda_device)])
    for name in special_eval.INSTANCES:
        lo, hi = _B8_WIDE.get(name, (-34.0, 30.0) if name.startswith("polygamma")
                              else (-5.0, 300.0))
        z = torch.empty(1 << 16, dtype=torch.float64, device=cuda_device).uniform_(
            lo, hi, generator=gen).to(dtype)
        z = torch.cat([z, special])
        params = _B8_PARAMS.get(name, ())
        got = special_eval.special_eval_cuda(name, z, params)
        want = special_eval.special_eval_torch(name, z, params)
        same = (got == want) & (torch.signbit(got) == torch.signbit(want))
        same |= torch.isnan(got) & torch.isnan(want)
        assert bool(same.all()), (name, z[~same][:4].tolist(), got[~same][:4].tolist(),
                                  want[~same][:4].tolist())


def test_b8_inside_the_grid_point_and_solver_kernels(cuda_device):
    """a·J₀(x)² + K₁(x+2)·y² + 2 through B1, B5a and B6 (each launch runs
    B8 inside, since the model calls special functions), each against its
    plain version."""
    x, y, a = sympy.symbols("x y a")
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], a * sympy.besselj(0, x) ** 2
        + sympy.besselk(1, x + 2) * y**2 + 2, silent=True, simplify=False,
        assertions=False).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    args, extent = np.array([2.0]), (0.5, 3.0, 0.2, 1.5)
    assert art.uses_special_functions
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    solves = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    got = scan_cuda(art, "complete_analysis", args, extent, (256, 256), cuda_device)
    assert_maps_close(got, scan_torch(art, "complete_analysis", args, extent, (256, 256),
                                      cuda_device))
    pts = torch.rand(4096, 2, dtype=torch.float64, device=cuda_device) * 2 + 0.5
    assert_maps_close(scan_points_cuda(art, "complete_analysis", args, pts),
                      scan_points_torch(art, "complete_analysis", args, pts))
    f0 = pts[:256].contiguous()
    p = torch.tensor(args, device=cuda_device)
    k_rows, k_t = solve_cuda(art, p, 20, f0, torch.zeros_like(f0))
    p_rows, p_t = solve_torch(art, p, 20, f0, torch.zeros_like(f0))
    assert_maps_close(torch.cat([k_rows, k_t[..., None]], -1),
                      torch.cat([p_rows, p_t[..., None]], -1), 1e-12)
    after = cuda_kernels.LAUNCHES_BY_KERNEL
    assert (after["B1"] - before["B1"], after["B5a"] - before["B5a"]) == (1, 1)
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == solves + 1


@pytest.mark.parametrize("n", [1, 33, 4096, 300_000])
def test_points_coherence_pass_keeps_every_point(cuda_device, n):
    """A special-function model's point scan runs the coherent kernel
    (``inflx_points_scan_coherent``: each block sorts its tile of points by
    a coarse cell): with NaN and ±inf coordinates, repeated points, one
    value on one axis and a last tile cut short, every output is bit for
    bit the plain version's, NaN masks included."""
    x, y, a = sympy.symbols("x y a")
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], a * sympy.besselj(sympy.Rational(3, 10), x) ** 2
        + sympy.besselk(1, x + 2) * y**2 + 2, silent=True, simplify=False,
        assertions=False).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    args = np.array([2.0])
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    pts = torch.rand(n, 2, dtype=torch.float64, device=cuda_device, generator=gen)
    pts[:, 0] = pts[:, 0] * 2.5 + 0.5
    if n > 8:
        pts[1] = float("nan")
        pts[2, 0] = float("inf")
        pts[3, 1] = -float("inf")
        pts[5:8] = pts[4]
    for points in (pts, torch.stack([pts[:, 0], torch.full_like(pts[:, 1], 0.7)], 1)):
        before = cuda_kernels.LAUNCHES_BY_KERNEL["B5a"]
        for kind in ("complete_analysis", "epsilon_v"):
            got = scan_points_cuda(art, kind, args, points)
            want = scan_points_torch(art, kind, args, points)
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            assert bool(same.all()), kind
        assert cuda_kernels.LAUNCHES_BY_KERNEL["B5a"] == before + 2


# ------------------------------------------------------------------------- #
# geometry and observables with device="cuda" against device="cpu"           #
# ------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def hyperbolic(cuda_device):
    x, y, m = sympy.symbols("x y m", positive=True)
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[sympy.Integer(1), 0], [0, sympy.sinh(x) ** 2]],
        sympy.Rational(1, 2) * m**2 * (x**2 + y**2), silent=True).build()
    return inflatox_torch.Compiler(model, silent=True).compile(), np.array([1.3])


@pytest.fixture(scope="module")
def quadratic(cuda_device):
    f1, f2, m1, m2 = sympy.symbols("phi_1 phi_2 m_1 m_2")
    model = inflatox_torch.InflationModelBuilder.new(
        [f1, f2], [[1, 0], [0, 1]], (m1 * f1) ** 2 + (m2 * f2) ** 2, "trivial",
        silent=True).build()
    return inflatox_torch.Compiler(model, silent=True).compile()


def _close(got, want, rtol=1e-12):
    """Within rtol, with a floor of 1e-13 of the largest value (components
    that cancel to 0 are rounding noise on both devices)."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    floor = 1e-13 * np.nanmax(np.abs(want)) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor, equal_nan=True)


@pytest.mark.parametrize("surface", ["christoffels", "riemann", "ricci_scalar", "hesse"])
def test_geometry_on_the_card_matches_the_cpu(hyperbolic, doc, cuda_device, surface):
    rng = np.random.default_rng(2)
    for (art, args), lo, hi in ((hyperbolic, (0.3, -1.0), (2.0, 1.0)),
                                (doc, (0.5, 0.25), (2.5, 3.0))):
        grid = [rng.uniform(lo[i], hi[i], (64, 48)) for i in range(2)]
        fn = getattr(art.geometry, surface)
        got = fn([torch.tensor(g, device=cuda_device) for g in grid],
                 torch.tensor(args, device=cuda_device))
        want = fn([torch.tensor(g) for g in grid], torch.tensor(args))
        assert got.device.type == "cuda" and got.dtype == torch.float64
        assert got.shape[-2:] == (64, 48)
        _close(got.cpu().numpy(), want.numpy())


def test_observables_on_the_card_match_the_cpu(doc, quadratic, cuda_device):
    from inflatox_torch import observables as ob

    art, args = doc
    rng = np.random.default_rng(4)
    grid = [rng.uniform(0.5, 2.5, (96, 64)), rng.uniform(0.25, 3.0, (96, 64))]
    got = ob.slow_roll(art, device="cuda")(grid, args)
    want = ob.slow_roll(art, device="cpu")(grid, args)
    for k in want:
        assert got[k].device.type == "cuda"
        _close(got[k].cpu().numpy(), want[k].numpy())
    x, m = np.array([1.2, -0.8]), np.array([1.0, 0.7])
    jac = ob.observable_jacobian(quadratic, ("epsilon_v", "eta_v", "n_s", "r"), device="cuda")
    j_cuda = jac(x, m)
    assert j_cuda.device.type == "cuda"
    _close(j_cuda.cpu().numpy(), ob.observable_jacobian(
        quadratic, ("epsilon_v", "eta_v", "n_s", "r"), device="cpu")(x, m).numpy(), 1e-10)
    _close(ob.fisher_matrix(quadratic, x, m, [0.004, 0.01], device="cuda"),
           ob.fisher_matrix(quadratic, x, m, [0.004, 0.01], device="cpu"), 1e-10)

    # the trajectory level on kernel B6's rows, read by both devices
    solves = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    rows, times = background.solve_eom(quadratic, np.ones(2), 3000, [16.0, 0.0], [0.0, 0.0],
                                       max_err=1e-9, solver="rkf", return_time=True,
                                       device=cuda_device)
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == solves + 1
    for call in (
        lambda dev: ob.along_trajectory(quadratic, rows, np.ones(2), device=dev),
        lambda dev: ob.horizon_exit(quadratic, rows, times, np.ones(2), device=dev),
        lambda dev: ob.power_spectrum(quadratic, rows, times, np.ones(2), device=dev),
        lambda dev: ob.cobe_normalize(quadratic, rows, times, np.ones(2), device=dev),
        lambda dev: ob.n_star_matching(quadratic, np.ones(2), rows, times, A_s=2.1e-9,
                                       device=dev),
    ):
        on_card, on_cpu = call("cuda"), call("cpu")
        assert set(on_card) == set(on_cpu)
        for k in on_cpu:
            _close(on_card[k], on_cpu[k])

    # the fixed-step solver and its gradient, and a multi-start fit
    grid_t = np.linspace(0.0, 1.5, 301)
    out = {}
    for dev in ("cuda", "cpu"):
        p = torch.tensor(m, device=dev, requires_grad=True)
        fixed = ob.solve_eom_fixed(quadratic, p, grid_t, [1.0, 0.5], [0.0, 0.0], device=dev)
        assert fixed.device.type == dev
        fixed[-1, 0].backward()
        out[dev] = (fixed.detach().cpu().numpy(), p.grad.cpu().numpy())
    _close(out["cuda"][0], out["cpu"][0])
    _close(out["cuda"][1], out["cpu"][1], 1e-10)
    starts = rng.uniform(0.5, 1.5, (4, 2))
    fits = {}
    for dev in ("cuda", "cpu"):
        sr = ob.slow_roll(quadratic, device=dev)

        def loss(a, sr=sr):
            got = sr(x, a)
            return (got["n_s"] - 0.95) ** 2 + (got["r"] - 0.1) ** 2

        fits[dev] = ob.fit_parameters(loss, starts, steps=30, device=dev)
    np.testing.assert_allclose(fits["cuda"].loss_history, fits["cpu"].loss_history, rtol=1e-9)
    np.testing.assert_allclose(fits["cuda"].params, fits["cpu"].params, rtol=1e-10)


def test_spectra_on_the_card_match_the_cpu(quadratic, cuda_device):
    """The perturbation spectra with device="cuda": the δN solves on kernel
    B6 (one launch a call) against the plain solver on the CPU (N_grad within
    1e-6, the second differences 1e-4, of their largest component); the mode
    and transport routes on the same base rows against device="cpu"
    (1e-10)."""
    from inflatox_torch import perturbations as pt

    m = np.ones(2)
    rows, times = background.solve_eom(quadratic, m, 2000, [12.0, 0.0], [0.0, 0.0],
                                       max_err=1e-9, solver="rkf", return_time=True,
                                       device=cuda_device)
    solves = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    kw = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0, steps=2000, order=2)
    dn = {dev: pt.delta_n_spectrum(quadratic, m, rows, times, device=dev, **kw)
          for dev in ("cuda", "cpu")}
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == solves + 1
    for key, rtol in (("P_zeta", 1e-6), ("N_grad", 1e-6), ("N_hess", 1e-4), ("f_NL", 1e-4)):
        want = dn["cpu"][key]
        np.testing.assert_allclose(dn["cuda"][key], want, rtol=rtol,
                                   atol=rtol * np.abs(want).max(), err_msg=key)
    small = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0, dense_steps=800,
                 tail_steps=300)
    for route in (pt.mode_spectrum, pt.transport_spectrum):
        on_card = route(quadratic, m, rows, times, device="cuda", **small)
        on_cpu = route(quadratic, m, rows, times, device="cpu", **small)
        assert set(on_card) == set(on_cpu)
        for k in on_cpu:
            np.testing.assert_allclose(on_card[k], on_cpu[k], rtol=1e-10, atol=1e-12,
                                       err_msg=k)
    solves = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    sw = pt.mode_sweep(quadratic, np.array([[1.0, 1.0], [1.05, 1.0]]), [12.0, 0.0],
                       [0.0, 0.0], steps=2000, device="cuda", **small)
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == solves + 1 and sw["ok"].all()


def test_posterior_on_the_card_matches_the_cpu(quadratic, cuda_device):
    """The log-posterior's value and gradient, one HMC and one NUTS
    transition from one pre-drawn block, on the card against the CPU
    (1e-12): plain torch, no kernel of the port's."""
    from inflatox_torch import inference
    from inflatox_torch import observables as ob

    x, theta = np.array([14.0, 6.0]), np.array([1.0, 0.7])
    sr = ob.slow_roll(quadratic, device="cpu")(x, theta)
    data = {"n_s": float(sr["n_s"]), "r": float(sr["r"])}
    sigma = {"n_s": 0.004, "r": 0.01}
    densities, points = {}, np.array([[1.02, 0.66], [0.97, 0.74], [1.05, 0.71]])
    for dev in ("cuda", "cpu"):
        centre = torch.tensor(theta, device=dev)

        def prior(th, centre=centre):
            return -0.5 * torch.sum(((th - centre) / 0.05) ** 2)

        logp = inference.observable_log_posterior(quadratic, x, data, sigma, prior=prior,
                                                  device=dev)
        densities[dev] = inference._Density(logp)
    got = {dev: densities[dev](torch.tensor(points, device=dev)) for dev in densities}
    assert got["cuda"][0].device.type == "cuda" and densities["cuda"].route == "vmap"
    for a, b in zip(got["cuda"], got["cpu"]):
        _close(a.cpu().numpy(), b.numpy())

    gen = torch.Generator().manual_seed(11)
    blocks = {"hmc": inference._hmc_draws(gen, 3, 2, 24, "cpu"),
              "nuts": inference._nuts_draws(gen, 3, 2, 7, "cpu")}
    for name, block in blocks.items():
        outs = {}
        for dev, density in densities.items():
            kernel = (inference._hmc_kernel(density, 24) if name == "hmc"
                      else inference._nuts_kernel(density, 7))
            f64 = dict(dtype=torch.float64, device=dev)
            q = torch.tensor(points, device=dev)
            outs[dev] = kernel(q, *density(q), tuple(t.to(dev) for t in block),
                               torch.tensor(0.4, **f64), torch.tensor([2.4e-3, 2.4e-3], **f64))
        for a, b in zip(outs["cuda"][:4], outs["cpu"][:4]):
            _close(a.cpu().numpy(), b.numpy())
        assert torch.equal(outs["cuda"][4].cpu(), outs["cpu"][4]), name


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_sharded_scan_on_four_slots_of_one_card(doc, cuda_device, precision):
    """``sharded_scan`` over four slots of cuda:0 at 256²: one launch a slot
    (each row at its global index), bit for bit the unsharded scan."""
    from inflatox_torch.parallel import make_mesh, sharded_scan

    art, args = doc
    al = GeneralisedAL(art, device=cuda_device, validate_basis=False)
    mesh = make_mesh(("grid",), devices=[cuda_device] * 4)
    kernel = PRECISIONS[precision].grid_kernel
    before = cuda_kernels.LAUNCHES_BY_KERNEL[kernel]
    got = sharded_scan(al, args, DOC_EXTENT, (256, 256), mesh, precision=precision)
    assert cuda_kernels.LAUNCHES_BY_KERNEL[kernel] - before == 4
    want = scan_cuda(art, "complete_analysis", args, DOC_EXTENT, (256, 256), cuda_device,
                     precision)
    assert got.device == cuda_device and got.shape == want.shape and got.dtype == want.dtype
    bits = torch.int32 if precision == "f32" else torch.int64
    assert torch.equal(got.view(bits), want.view(bits))


def test_engines_tour_example_on_the_card(cuda_device):
    """``examples/torch_engines_tour.py --device cuda --n 128``: the f64, f32
    and double-double rows launch B1, B2 and B4 once each (the pair output
    one more B1), and the f64 and dd maps agree with the ``engine="torch"``
    row at phase 4's tolerance (rtol 5e-10, identical NaN/±inf masks); the
    f32 row's median deviation from it below phase 13's 1e-5."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "torch_engines_tour.py")
    spec = importlib.util.spec_from_file_location("torch_engines_tour", path)
    tour = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tour)
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    out = tour.main(["--device", "cuda", "--n", "128"])
    launched = {k: v - before[k] for k, v in cuda_kernels.LAUNCHES_BY_KERNEL.items()}
    assert launched == {**{k: 0 for k in launched}, "B1": 2, "B2": 1, "B4": 1}
    rows = out["rows"]
    ref = torch.from_numpy(rows["reference"]["maps"])
    for key in ("f64", "dd"):
        assert_maps_close(torch.from_numpy(rows[key]["maps"]), ref)
    assert rows["f32"]["median_dev"] < 1e-5
    np.testing.assert_allclose(out["pair_value"], rows["f64"]["maps"][0, 0, 0],
                               rtol=2.0**-48, atol=0)


#: ptxas's (registers, spill store bytes, spill load bytes) of kernel B6's
#: instances that count nothing, for the doc model, as the tree before the
#: work counter built them (commit 821aba5; nvcc 12.9, ``-Xptxas=-v``,
#: sm_90a)
B6_PTXAS_BEFORE_THE_COUNTER = {"rkf": (122, 0, 0), "rk4": (128, 0, 0)}


def ptxas_entries(log: str) -> dict:
    """Mangled entry name → (registers, spill store bytes, spill load bytes)
    from ptxas's ``-v`` report."""
    entries, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1)
            entries[name] = [None, None, None]
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found and name:
            entries[name][1:] = [int(found.group(1)), int(found.group(2))]
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            entries[name][0] = int(found.group(1))
    return {k: tuple(v) for k, v in entries.items()}


def test_b6_uncounted_instance_compiles_as_before_the_counter(doc, cuda_device):
    from inflatox_torch.ops.build import load_solver

    art, _ = doc
    entries = ptxas_entries(load_solver(art.cuda_solver_source()).build_log.read_text())
    for solver, (method, _) in cuda_solver.METHODS.items():
        (uncounted,) = [v for k, v in entries.items() if f"solve_kernelILi{method}ELb0E" in k]
        (counted,) = [v for k, v in entries.items() if f"solve_kernelILi{method}ELb1E" in k]
        print(f"B6 {solver} ptxas (registers, spill stores, spill loads): "
              f"uncounted {uncounted}, counted {counted}")
        assert uncounted == B6_PTXAS_BEFORE_THE_COUNTER[solver], solver


@pytest.mark.parametrize("solver", ["rkf", "rk4"])
def test_b6_counter_moves_no_row_and_counts_the_plain_attempts(doc, cuda_device, solver):
    """200 trajectories (a last warp of 8 lanes): the counted launch's rows
    bit for bit the uncounted launch's and the plain version's, its
    attempts the plain version's sum, its lane attempts each warp's most
    attempts times its lanes."""
    art, args = doc
    f0, d0 = _inits(200, 2, seed=4)
    pars = torch.tensor(args, device="cuda")
    plain_rows, plain_times, attempts = solve_torch(art, pars, 150, f0, d0, 1e-6, solver,
                                                    count_attempts=True)
    rows, times = solve_cuda(art, pars, 150, f0, d0, 1e-6, solver)
    before = cuda_solver.attempt_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        counted_rows, counted_times = solve_cuda(art, pars, 150, f0, d0, 1e-6, solver)
        torch.cuda.synchronize()
    after = cuda_solver.attempt_counts()
    for got in (counted_rows, plain_rows):
        assert torch.equal(got.view(torch.int64), rows.view(torch.int64))
    for got in (counted_times, plain_times):
        assert torch.equal(got.view(torch.int64), times.view(torch.int64))
    assert after["attempts"] - before["attempts"] == int(attempts.sum())
    warps = sum(len(w) * int(w.max()) for w in attempts.split(32))
    assert after["lane_attempts"] - before["lane_attempts"] == warps
    assert int(attempts.sum()) <= warps
    solve_cuda(art, pars, 150, f0, d0, 1e-6, solver)
    torch.cuda.synchronize()
    assert cuda_solver.attempt_counts() == after


def test_spans_and_the_b6_counter_in_a_trace_of_the_card(doc, cuda_device, tmp_path):
    """Under ``profiling.trace`` on the card: ``complete_analysis`` records
    its launch and delivery spans beside B1's kernel, a survey its solve,
    reduce and delivery spans beside the counting instance of B6, whose
    attempts are counted."""
    from inflatox_torch.utils import profiling

    art, args = doc
    al = GeneralisedAL(art, device=cuda_device, validate_basis=False)
    f0 = np.random.default_rng(9).uniform(1.5, 2.5, (64, 2))
    al.complete_analysis(args, *DOC_EXTENT, 64, 64, progress=False)  # builds outside
    background.survey_initial_conditions(art, args, 80, f0, np.zeros(2))
    before = cuda_solver.attempt_counts()
    with profiling.trace(str(tmp_path), label="card"):
        al.complete_analysis(args, *DOC_EXTENT, 64, 64, progress=False)
        background.survey_initial_conditions(art, args, 80, f0, np.zeros(2))
    assert cuda_solver.attempt_counts()["attempts"] > before["attempts"]
    (path,) = tmp_path.glob("card*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e["name"] for e in sorted(events, key=lambda e: float(e.get("ts", 0)))
             if e.get("cat") == "user_annotation" and e["name"].startswith("inflx.")]
    assert spans == ["inflx.scan.launch", "inflx.scan.deliver", "inflx.survey.solve",
                     "inflx.survey.reduce", "inflx.survey.deliver"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("grid_scan_kernel" in k for k in kernels)
    assert any("solve_kernel" in k for k in kernels)
    assert any("survey_reduce_kernel" in k for k in kernels)


# ------------------------------------------------------------------------- #
# kernel B9: the survey's reduction, against the plain one on the host      #
# ------------------------------------------------------------------------- #


def assert_same_bits(got, want):
    """One shape and dtype, NaN in the same places, every other value the
    same bits (the sign of a zero included)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == bool:
        assert np.array_equal(got, want)
        return
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int64), want[~nan].view(np.int64))


def assert_b9_is_the_host_reduction(art, rows, times, pars):
    """One B9 launch on the card, its five summaries bit for bit the plain
    reduction's on the host's CPU from the same rows."""
    from inflatox_torch.ops.cuda_survey import survey_reduce_cuda, survey_reduce_torch

    before = cuda_kernels.LAUNCHES_BY_KERNEL["B9"]
    got = survey_reduce_cuda(art, rows, times, pars)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B9"] == before + 1
    want = survey_reduce_torch(art, rows.cpu(), times.cpu(), pars.cpu())
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert_same_bits(g, w)
    return want


def _edge_rows(art, steps=60, seed=0):
    """tests/test_torch_survey.py's ``edge_rows`` for the doc model (g₀₀ =
    ½): ten trajectories with one edge case each — never inflates;
    inflates from row 0; never ends; crosses at the last row; H <= 0 on
    some rows; NaN and inf rows, ε = inf just before the crossing; H = 0 on
    a row; ε = 1 at the crossing; starts late; equal ε about the crossing."""
    rng = np.random.default_rng(seed)
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
    rows = np.zeros((10, steps, 5))
    rows[..., 0] = rng.uniform(1.5, 2.5, (10, steps))
    rows[..., 1] = rng.uniform(1.5, 2.5, (10, steps))
    rows[..., 2] = np.where(np.isinf(eps), np.inf, np.sqrt(4.0 * eps) * np.abs(hub))
    rows[..., 4] = hub
    rows[5, 3:5, 4] = np.nan
    times = np.cumsum(rng.uniform(0.01, 0.2, (10, steps)), axis=1)
    return rows, times - times[:, :1]


def test_b9_matches_the_host_reduction_at_the_survey_cells_size(doc, cuda_device):
    """Hyperinflation, 4096 trajectories × 2000 RKF45 rows on B6 (the
    ``hyper.survey`` cell's call), and a ragged 100 × 777 (a last block of
    4 lanes, a last tile part full)."""
    art, args = doc
    pars = torch.tensor(args, device="cuda")
    for batch, steps in ((4096, 2000), (100, 777)):
        f0 = torch.tensor(np.random.default_rng(batch).uniform(1.5, 2.5, (batch, 2)),
                          device="cuda")
        rows, times = solve_cuda(art, pars, steps, f0, torch.zeros_like(f0), 1e-6, "rkf")
        want = assert_b9_is_the_host_reduction(art, rows, times, pars)
        assert want[1].any()


def test_b9_quadratic_model_per_trajectory_parameters(quadratic, cuda_device):
    """tests/test_torch_background.py's ``test_survey_matches_jax`` model and
    starts (14 of 16 end in 400 rows), each trajectory its own masses; the
    survey through B9 equal to the survey on the CPU."""
    gx, gy = np.meshgrid(np.linspace(3.0, 24.0, 4), np.linspace(0.0, 6.0, 4))
    f0 = np.stack([gx.ravel(), gy.ravel()], axis=1)
    pars = np.array([1.0, 0.7]) * np.linspace(0.9, 1.1, 16)[:, None]
    rows, times = solve_cuda(quadratic, torch.tensor(pars, device="cuda"), 400,
                             torch.tensor(f0, device="cuda"),
                             torch.zeros(16, 2, dtype=torch.float64, device="cuda"), 1e-8, "rkf")
    want = assert_b9_is_the_host_reduction(quadratic, rows, times,
                                           torch.tensor(pars, device="cuda"))
    assert want[1].any()


def test_b9_edge_cases_and_rows_in_b6_layout_only(doc, cuda_device):
    """Drawn rows with the reduction's edge cases, as views of one buffer in
    B6's layout; the same rows as plain (B, steps, 2n+1) and (B, steps)
    tensors raise."""
    from inflatox_torch.ops.cuda_survey import survey_reduce_cuda

    art, args = doc
    rows, times = _edge_rows(art)
    pars = torch.tensor(args, device="cuda")
    buf = torch.tensor(np.concatenate([rows, times[..., None]], axis=2).transpose(1, 2, 0)
                       .copy(), device="cuda")
    view = buf.permute(2, 0, 1)
    want = assert_b9_is_the_host_reduction(art, view[..., :5], view[..., 5], pars)
    assert list(want[1].numpy()) == [False, True, False, True, True, True, True, True, True,
                                     True]
    with pytest.raises(ValueError, match="layout|views"):
        survey_reduce_cuda(art, torch.tensor(rows, device="cuda"),
                           torch.tensor(times, device="cuda"), pars)


def test_b9_three_fields(cuda_device):
    a, b, c, m = sympy.symbols("a3 b3 c3 m3")
    V = sympy.Rational(1, 2) * m**2 * (a**2 + 2 * b**2 + 3 * c**2)
    model = inflatox_torch.InflationModelBuilder.new(
        [a, b, c], [[1, 0, 0], [0, 1, 0], [0, 0, 1]], V, silent=True
    ).build(guesses=[[0, 1, 0], [0, 0, 1]])
    art = inflatox_torch.Compiler(model, silent=True).compile()
    f0, d0 = _inits(300, 3)
    pars = torch.tensor([1.3], dtype=torch.float64, device="cuda")
    rows, times = solve_cuda(art, pars, 500, f0, d0, 1e-8, "rkf")
    assert_b9_is_the_host_reduction(art, rows, times, pars)


def _wide_model(n):
    """An n-field model with a flat metric and V = ½ m² Σ (a+1) φ_a², built
    without the symbolic builder (its basis and Hesse matrix, which the
    solver library does not use, are the trivial ones)."""
    xs = sympy.symbols(f"w0:{n}")
    chis = sympy.symbols(f"wd0:{n}")
    m = sympy.Symbol("m")
    V = sympy.Rational(1, 2) * m**2 * sum((a + 1) * x**2 for a, x in enumerate(xs))
    kin = sympy.Rational(1, 2) * sum(c**2 for c in chis)
    one, zero = sympy.Integer(1), sympy.Integer(0)
    eye = [[one if a == b else zero for b in range(n)] for a in range(n)]
    model = inflatox_torch.InflationModel(
        model_name="wide", coordinates=list(xs), tangents=list(chis), basis=eye,
        eom_fields=[sympy.diff(V, x) for x in xs], eom_h=sympy.sqrt((V + kin) / 3),
        eom_hdot=-kin, potential=V, metric=eye,
        gradient_square=sum(sympy.diff(V, x)**2 for x in xs),
        hesse_cmp=[[(a + 1) * m**2 if a == b else zero for b in range(n)] for a in range(n)])
    return inflatox_torch.Compiler(model, silent=True).compile()


def test_b9_many_fields_reads_its_rows_in_place(cuda_device):
    """80 fields, where B9's ring of row tiles does not fit in a block's
    shared memory (it does up to 73): the launch reads the rows in place
    and its summaries are still bit for bit the host's plain reduction.
    Drawn rows in B6's layout, 333 trajectories (a last block of 13 lanes)
    × 301 rows, each with its own mass; ε rises through 1 at a drawn row,
    or never reaches it, and some rows are NaN or have H <= 0."""
    n, batch, steps = 80, 333, 301
    art = _wide_model(n)
    rng = np.random.default_rng(80)
    cross = rng.integers(-40, steps + 40, batch)
    s = np.arange(steps)[None, :]
    eps = np.clip(0.2 + 0.9 * (s - cross[:, None] + 30) / 30.0, 0.05, 3.0)
    hub = rng.uniform(0.5, 2.0, (batch, 1)) * np.exp(-s / steps)
    chi = rng.normal(size=(batch, steps, n))
    chi *= np.sqrt(2.0 * eps * hub**2 / (chi * chi).sum(axis=2))[..., None]
    rows = np.concatenate([rng.uniform(-1.0, 1.0, (batch, steps, n)), chi, hub[..., None]],
                          axis=2)
    rows[::17, 50:53] = np.nan
    rows[5::29, 100:104, 2 * n] = -hub[5::29, 100:104]
    times = np.cumsum(rng.uniform(0.01, 0.2, (batch, steps)), axis=1)
    buf = torch.tensor(np.concatenate([rows, (times - times[:, :1])[..., None]], axis=2)
                       .transpose(1, 2, 0).copy(), device="cuda")
    view = buf.permute(2, 0, 1)
    pars = torch.tensor(rng.uniform(0.5, 2.0, (batch, 1)), device="cuda")
    want = assert_b9_is_the_host_reduction(art, view[..., :2 * n + 1], view[..., 2 * n + 1],
                                           pars)
    assert want[1].any() and not want[1].all()


def test_survey_on_the_card_chunked_as_unchunked(doc, cuda_device):
    """B = 1000 in chunks of 384 (not a whole number of them): the three
    chunks side by side in one B6 and one B9 launch, the summaries bit for
    bit the unchunked survey's and, row for row, the host's plain reduction
    of the card's rows."""
    art, args = doc
    f0 = np.random.default_rng(12).uniform(1.5, 2.5, (1000, 2))
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    got = background.survey_initial_conditions(art, args, 600, f0, np.zeros(2), chunk=384)
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == before["B6"] + 1
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B9"] == before["B9"] + 1
    whole = background.survey_initial_conditions(art, args, 600, f0, np.zeros(2))
    rows, times = background.solve_eom_batch(art, args, 600, f0, np.zeros((1000, 2)),
                                             solver="rkf", return_time=True)
    from inflatox_torch.ops.cuda_survey import survey_reduce_torch

    want = survey_reduce_torch(art, torch.tensor(rows), torch.tensor(times), torch.tensor(args))
    keys = ("N_inflation", "ended", "H_end", "x_end", "N_span")
    for key, w in zip(keys, want):
        assert got[key].dtype == (bool if key == "ended" else np.float64)
        assert_same_bits(torch.from_numpy(got[key]), torch.from_numpy(whole[key]))
        assert_same_bits(torch.from_numpy(got[key]), w)


def test_survey_on_four_slots_of_one_card_through_b9(doc, cuda_device):
    """``mesh=`` with four slots on cuda:0 (203 starts, padded): B6 once a
    slot, the rows joined on the mesh's home and reduced there by one B9
    launch, every summary bit for bit the unsharded survey's."""
    from inflatox_torch.parallel import make_mesh

    art, args = doc
    f0 = np.random.default_rng(13).uniform(1.5, 2.5, (203, 2))
    mesh = make_mesh(("solve",), devices=[cuda_device] * 4)
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    got = background.survey_initial_conditions(art, args, 300, f0, np.zeros(2), mesh=mesh)
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == before["B6"] + 4
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B9"] == before["B9"] + 1
    want = background.survey_initial_conditions(art, args, 300, f0, np.zeros(2))
    for key in want:
        assert_same_bits(torch.from_numpy(got[key]), torch.from_numpy(want[key]))


# ------------------------------------------------------------------------- #
# angular inflation on the survey path: B6, B9 and the chunk loop           #
# ------------------------------------------------------------------------- #

#: the box of starts of the benchmark's cell ``angular.survey``, (φ, χ): the
#: disc's metric 6α/(1 − φ² − χ²)² has a pole at r = 1, and the box reaches
#: r = 0.997
ANGULAR_BOX = (0.64, 0.705)


@pytest.fixture(scope="module")
def angular(cuda_device):
    model, args = inflatox_torch.models.angular()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    return art, torch.tensor(args, device=cuda_device)


def _angular_starts(batch, seed):
    f0 = torch.tensor(np.random.default_rng(seed).uniform(*ANGULAR_BOX, (batch, 2)),
                      device="cuda")
    return f0, torch.zeros_like(f0)


def test_angular_b6_matches_the_plain_version_on_the_first_rows(angular):
    """4096 starts (one of the cell's chunks), 20 rows: the kernel's rows and
    times those of the plain version on the card, rtol 1e-12 with NaN in the
    same places, as the other models' B6 tests."""
    art, pars = angular
    f0, d0 = _angular_starts(4096, seed=1)
    rows, times = solve_cuda(art, pars, 20, f0, d0, 1e-6, "rkf")
    want_rows, want_times = solve_torch(art, pars, 20, f0, d0, 1e-6, "rkf")
    assert_rows_equal(rows, want_rows)
    assert_rows_equal(times, want_times)


def test_angular_b9_is_the_host_reduction(angular):
    """B6's 4096 × 2000 rows of the cell's chunk, reduced by one B9 launch:
    its five summaries bit for bit the plain reduction's on the host's CPU,
    with trajectories that end inflation and trajectories whose state is no
    longer finite at the disc's edge among them."""
    art, pars = angular
    f0, d0 = _angular_starts(4096, seed=2)
    rows, times = solve_cuda(art, pars, 2000, f0, d0, 1e-6, "rkf")
    assert assert_b9_is_the_host_reduction(art, rows, times, pars)[1].any()


def test_angular_survey_in_two_chunks_is_each_chunks_reduction(angular):
    """The cell's call: 8192 starts in chunks of 4096 through
    ``survey_initial_conditions`` on the card (both chunks in one B6 and
    one B9 launch, one wait), each chunk's summaries those of B9 on that
    chunk's rows solved alone (B6 is deterministic)."""
    from inflatox_torch.ops.cuda_survey import survey_reduce_cuda

    art, pars = angular
    f0, d0 = _angular_starts(8192, seed=3)
    launches = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    got = background.survey_initial_conditions(art, pars.cpu().numpy(), 2000,
                                               f0.cpu().numpy(), np.zeros(2), chunk=4096)
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == launches["B6"] + 1
    assert cuda_kernels.LAUNCHES_BY_KERNEL["B9"] == launches["B9"] + 1
    for c in range(2):
        sl = slice(4096 * c, 4096 * (c + 1))
        rows, times = solve_cuda(art, pars, 2000, f0[sl], d0[sl], 1e-6, "rkf")
        n_inf, ended, h_end, x_end, n_span = survey_reduce_cuda(art, rows, times, pars)
        for key, want in (("N_inflation", n_inf), ("ended", ended), ("H_end", h_end),
                          ("x_end", x_end), ("N_span", n_span)):
            assert_same_bits(torch.as_tensor(got[key][sl]), want)


@pytest.mark.parametrize("case", ["angular", "hyperinflation", "angular-trace"])
def test_survey_chunks_side_by_side(doc, angular, tmp_path, case):
    """8192 starts, 2000 rows.  In chunks of 4096 and of 3000 (a ragged last
    chunk), k chunks (``_overlap_depth``) side by side in one B6 and one B9
    launch: every summary bit for bit the one-chunk call's (chunk 8192), on
    angular inflation and on hyperinflation, and ``survey_counts``
    counting every chunk and, in each launch, every chunk after its first
    as overlapped.  Under ``profiling.trace``, three of the cell
    ``angular.survey``'s calls: one B6 and one B9 launch a call, as
    ``LAUNCHES_BY_KERNEL`` counts them; in the trace one set of
    ``inflx.survey.*`` spans a call, and every ``solve_kernel`` and
    ``survey_reduce_kernel`` over the 256 one-warp blocks of a call's 8192
    trajectories.  (Late in this file's process
    the trace has been seen to lose some of a block's kernels, the first
    or the later calls', so it asks this of the launches it holds.)"""
    if case == "hyperinflation":
        art, args = doc
        f0 = np.random.default_rng(21).uniform(1.5, 2.5, (8192, 2))
    else:
        art, pars = angular
        args = pars.cpu().numpy()
        f0 = np.random.default_rng(22).uniform(*ANGULAR_BOX, (8192, 2))

    def survey(chunk):
        before = background.survey_counts()
        out = background.survey_initial_conditions(art, args, 2000, f0, np.zeros(2),
                                                   chunk=chunk)
        after = background.survey_counts()
        return out, {k: after[k] - before[k] for k in after}

    if case.endswith("trace"):
        from inflatox_torch.utils import profiling

        survey(4096)  # builds outside the trace
        launches = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
        with profiling.trace(str(tmp_path), label="overlap"):
            counted = [survey(4096)[1] for _ in range(3)]
        assert counted == [{"chunks": 2, "overlapped": 1}] * 3
        for name in ("B6", "B9"):
            assert cuda_kernels.LAUNCHES_BY_KERNEL[name] == launches[name] + 3
        (path,) = tmp_path.glob("overlap*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
        spans = sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                       and e["name"].startswith("inflx.survey."))
        assert spans == 3 * ["inflx.survey.deliver"] + 3 * ["inflx.survey.reduce"] + 3 * [
            "inflx.survey.solve"], spans
        grids = {"solve_kernel": [], "survey_reduce_kernel": []}
        for e in events:
            for name, found in grids.items():
                if e.get("cat") == "kernel" and name in e["name"]:
                    found.append(e["args"]["grid"])
        assert any(grids.values()), grids
        for found in grids.values():
            assert len(found) <= 3 and all(g == [256, 1, 1] for g in found), grids
        return
    whole, counted = survey(8192)
    assert counted == {"chunks": 1, "overlapped": 0}
    props = torch.cuda.get_device_properties(0)
    for chunk in (4096, 3000):
        got, counted = survey(chunk)
        chunks = -(-8192 // chunk)
        k = background._overlap_depth(4 * props.multi_processor_count, chunk, chunks,
                                      torch.cuda.mem_get_info(0)[0], 2000, 2)
        assert counted == {"chunks": chunks, "overlapped": chunks - -(-chunks // k)}
        for key in whole:
            assert_same_bits(torch.from_numpy(got[key]), torch.from_numpy(whole[key]))


def test_angular_b6_rejection_counter(angular):
    """200 starts (a last warp of 8 lanes), 150 rows, under a profiler: the
    counting instance's attempts those of the plain version on the card,
    its rejects the plain version's attempts less the accepted rows; its
    rows those of the launch that counts nothing.  (The plain version's own
    count under a profiler is tested on the CPU, in
    tests/test_torch_survey_angular.py.)"""
    art, pars = angular
    f0, d0 = _angular_starts(200, seed=4)
    rows, times = solve_cuda(art, pars, 150, f0, d0, 1e-6, "rkf")
    _, _, attempts = solve_torch(art, pars, 150, f0, d0, 1e-6, "rkf", count_attempts=True)
    before = cuda_solver.attempt_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        counted_rows, counted_times = solve_cuda(art, pars, 150, f0, d0, 1e-6, "rkf")
        torch.cuda.synchronize()
    after = cuda_solver.attempt_counts()
    assert_same_bits(counted_rows, rows)
    assert_same_bits(counted_times, times)
    assert after["attempts"] - before["attempts"] == int(attempts.sum())
    assert after["rejects"] - before["rejects"] == int(attempts.sum()) - 200 * 149 > 0
