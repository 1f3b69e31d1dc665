"""Kernel B1 on the card, against its plain PyTorch version.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): they
carry the ``cuda`` marker and skip on a host without one.  This file
imports only torch and the port, so it also runs on a host without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 5e-10 with identical NaN/±inf masks, the repo's tolerance
for the six analysis maps; the kernel repeats the plain version's
operations in its order, so the maps are expected to agree exactly."""

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops import cuda_kernels
from inflatox_torch.ops.cuda_kernels import KINDS, scan_cuda, scan_torch

pytestmark = pytest.mark.cuda

DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)
ANGULAR_EXTENT = (-0.7, 0.7, -0.7, 0.7)


def assert_maps_close(got, want, rtol=5e-10):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape
    for mask in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(mask(got), mask(want)), mask.__name__
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel B1 is CUDA and has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def doc():
    r, theta, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = inflatox_torch.InflationModelBuilder.new([r, theta], g, V, silent=True).build()
    return inflatox_torch.Compiler(model, silent=True).compile(), np.array([1.0])


@pytest.fixture(scope="module")
def angular():
    model, args = inflatox_torch.models.angular()
    return inflatox_torch.Compiler(model, silent=True).compile(), args


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_matches_plain_torch_256(doc, cuda_device, kind):
    art, args = doc
    before = cuda_kernels.LAUNCHES
    got = scan_cuda(art, kind, args, DOC_EXTENT, (256, 256), cuda_device)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES == before + 1
    assert got.shape == (KINDS[kind][1], 256, 256) and got.dtype == torch.float64
    want = scan_torch(art, kind, args, DOC_EXTENT, (256, 256), cuda_device)
    assert_maps_close(got, want)


def test_kernel_matches_plain_torch_angular(angular, cuda_device):
    art, args = angular
    got = scan_cuda(art, "complete_analysis", args, ANGULAR_EXTENT, (256, 200), cuda_device)
    want = scan_torch(art, "complete_analysis", args, ANGULAR_EXTENT, (256, 200), cuda_device)
    assert_maps_close(got, want)


def test_kernel_rows_beyond_one_grid_dimension(doc, cuda_device):
    """N0 above the 65535 blocks of gridDim.y: rows are strided in-kernel."""
    art, args = doc
    got = scan_cuda(art, "epsilon_v", args, DOC_EXTENT, (70_001, 3), cuda_device)
    want = scan_torch(art, "epsilon_v", args, DOC_EXTENT, (70_001, 3), cuda_device)
    assert_maps_close(got, want)


def test_default_engine_runs_the_kernel(doc, cuda_device):
    art, args = doc
    al = GeneralisedAL(art, device=cuda_device, validation_seed=7)
    before = cuda_kernels.LAUNCHES
    maps = al.complete_analysis(args, *DOC_EXTENT, 128, 96, progress=False,
                                output="f64_device")
    assert cuda_kernels.LAUNCHES == before + 1
    assert maps[0].device.type == "cuda" and maps[0].shape == (128, 96)
    host = al.complete_analysis(args, *DOC_EXTENT, 128, 96, progress=False)
    for m, h in zip(maps, host):
        assert np.array_equal(m.cpu().numpy(), h, equal_nan=True)
    plain = al.complete_analysis(args, *DOC_EXTENT, 128, 96, progress=False,
                                 engine="torch", output="f64_device")
    assert cuda_kernels.LAUNCHES == before + 2
    for m, p in zip(maps, plain):
        assert_maps_close(m, p)


def test_golden_values_on_the_card(doc, cuda_device):
    art, _ = doc
    al = GeneralisedAL(art, device=cuda_device, validation_seed=7)
    assert np.isclose(al.calc_V([2.0, -2.0], [1.0]), 1.9166666666666667, rtol=1e-12)
