"""Kernels B1, B2, B4, B5a, B5b, B6, the batched B7a, B7b, B7d and B8 on the
card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): they
carry the ``cuda`` marker and skip on a host without one.  This file
imports only torch and the port, so it also runs on a host without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 5e-10 with identical NaN/±inf masks for the analysis maps
(B1, B4, B5a, B5b), the repo's tolerance; rtol 1e-5 for the f32 kernel B2;
rtol 1e-12 with identical NaN masks for the solver's rows and times (B6).
Each kernel repeats its plain version's operations in their order, so both
are expected to agree exactly; the batched kernels B7a, B7b and B7d are held
to that: bit for bit their plain version, and each set its single scan."""

import os

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
    before = cuda_solver.LAUNCHES
    rows, times = solve_cuda(art, pars, 120, f0, d0, 1e-6, solver)
    torch.cuda.synchronize()
    assert cuda_solver.LAUNCHES == before + 1
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
    before = cuda_solver.LAUNCHES
    rows, times = background.solve_eom_batch(art, args, 60, f0, d0, solver="rkf",
                                             return_time=True)
    single = background.solve_eom(art, args, 60, f0[0], d0[0], solver="rkf")
    survey = background.survey_initial_conditions(art, args, 60, f0, np.zeros(2), chunk=16)
    assert cuda_solver.LAUNCHES == before + 2 + 3
    plain = background.solve_eom_batch(art, args, 60, f0, d0, solver="rkf",
                                       return_time=True, engine="torch")
    assert cuda_solver.LAUNCHES == before + 5
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
        before = special_eval.LAUNCHES["B8"]
        got = special_eval.special_eval_cuda(name, z, params)
        assert special_eval.LAUNCHES["B8"] == before + 1
        want = special_eval.special_eval_torch(name, z, params)
        assert_maps_close(got.double(), want.double(),
                          5e-10 if dtype == torch.float64 else 1e-5)


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
    solves = cuda_solver.LAUNCHES
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
    assert cuda_solver.LAUNCHES == solves + 1
