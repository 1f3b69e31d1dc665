"""Kernel B1 (the CUDA grid scan) and its plain PyTorch version.

On the CPU: the kernel's arithmetic — the generated per-model header and
``csrc/anguelova.cuh`` — is compiled with the host's C++ compiler through a
small C harness and held against the torch lowering and the torch point
tail; ``scan_torch`` is held against the JAX package's reference paths
(the double-f32 kernel's CPU path, ``engine="xla"``) and the native C
oracle.  The kernel itself runs only on a card: its tests are in
tests/test_torch_cuda.py.

Tolerances are the repo's: rtol 1e-12 for point values of V, Hesse and
|∇V|², rtol 5e-10 with identical NaN masks for the six analysis maps
(tests/test_native.py)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch.ops import cuda_kernels
from inflatox_torch.ops.anguelova import (
    complete_analysis_op,
    consistency_only_op,
    consistency_rapidturn_only_op,
    epsilon_v_only_op,
)
from inflatox_torch.ops.build import CSRC
from inflatox_torch.ops.cuda_kernels import KINDS, scan_cuda, scan_torch

PARAMS = np.array([1.0])
EXTENT = (0.5, 2.5, 0.25, 3.0)
MAPS_RTOL = 5e-10
POINT_RTOL = 1e-12


def assert_maps_close(got, want, rtol=MAPS_RTOL):
    """rtol with atol 0, identical NaN and ±inf masks."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for mask in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(mask(got), mask(want)), mask.__name__
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _port(jax_artifact, tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp("bundles") / f"{name}.json")
    jax_artifact.save(path)
    return inflatox_torch.CompiledModel.load(path)


@pytest.fixture(scope="module")
def models(doc_model_artifact, trivial_artifact, tmp_path_factory):
    """name → (jax artifact, torch artifact, args, extent, seeded points)."""
    rng = np.random.default_rng(99)
    ang_model, ang_args = inflatox_tpu.models.angular()
    ang = inflatox_tpu.Compiler(ang_model, silent=True).compile()
    radius = np.sqrt(rng.uniform(0.0, 0.8, 64))
    phase = rng.uniform(0.0, 2 * np.pi, 64)
    table = {
        "doc": (doc_model_artifact, PARAMS, EXTENT,
                np.stack([rng.uniform(0.3, 3.0, 64), rng.uniform(-3.0, 3.0, 64)])),
        "trivial": (trivial_artifact, np.array([0.7, 1.9]), (-2.0, 2.0, -1.5, 1.5),
                    rng.uniform(-2.0, 2.0, (2, 64))),
        "angular": (ang, ang_args, (-0.55, 0.65, -0.6, 0.5),
                    np.stack([radius * np.cos(phase), radius * np.sin(phase)])),
    }
    return {
        name: (j, _port(j, tmp_path_factory, name), args, extent, pts)
        for name, (j, args, extent, pts) in table.items()
    }


# --------------------------------------------------------------------------- #
# the kernel's arithmetic, compiled with the host C++ compiler                 #
# --------------------------------------------------------------------------- #

_HARNESS = r"""
#include <stdint.h>
#include "inflx_model.h"
#include "anguelova.cuh"

extern "C" void eval_points(int64_t n, const double* x0, const double* x1,
                            const double* p, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double x[2] = {x0[i], x1[i]};
    out[5 * i + 0] = f_V(x, p);
    out[5 * i + 1] = f_h00(x, p);
    out[5 * i + 2] = f_h10(x, p);
    out[5 * i + 3] = f_h11(x, p);
    out[5 * i + 4] = f_gsq(x, p);
  }
}

extern "C" void tails(int64_t n, const double* in, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double* q = in + 5 * i;
    double* o = out + 9 * i;
    inflx_tail_complete(q[0], q[1], q[2], q[3], q[4], o);
    o[6] = inflx_tail_consistency(q[0], q[1], q[2], q[3]);
    o[7] = inflx_tail_consistency_rapidturn(q[0], q[1], q[2], q[3]);
    o[8] = inflx_tail_epsilon_v(q[0], q[4]);
  }
}
"""


def _host_build(artifact, workdir):
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (workdir / "inflx_model.h").write_text(artifact.cuda_source())
    (workdir / "harness.cpp").write_text(_HARNESS)
    lib = workdir / "libharness.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(workdir), "-I", str(CSRC), "-o", str(lib),
         str(workdir / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(str(lib))
    ptr = ctypes.POINTER(ctypes.c_double)
    dll.eval_points.argtypes = [ctypes.c_int64, ptr, ptr, ptr, ptr]
    dll.tails.argtypes = [ctypes.c_int64, ptr, ptr]
    return dll


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


@pytest.mark.parametrize("name", ["doc", "trivial", "angular"])
def test_header_point_functions_match_torch(models, name, tmp_path):
    _, art, args, _, pts = models[name]
    dll = _host_build(art, tmp_path)
    x0, x1 = (np.ascontiguousarray(c) for c in pts)
    p = np.ascontiguousarray(args, dtype=np.float64)
    out = np.zeros((x0.size, 5))
    dll.eval_points(x0.size, _ptr(x0), _ptr(x1), _ptr(p), _ptr(out))
    xs = (torch.from_numpy(x0), torch.from_numpy(x1))
    pt = torch.from_numpy(p)
    h = art.hesse_tuple(xs, pt)
    want = [art.potential(xs, pt), h[0], h[2], h[3], art.grad_square(xs, pt)]
    for k, w in enumerate(want):
        w = np.broadcast_to(np.asarray(w, dtype=np.float64), x0.shape)
        np.testing.assert_allclose(out[:, k], w, rtol=POINT_RTOL, atol=0)


@pytest.mark.parametrize("name", ["doc", "trivial", "angular"])
def test_header_tail_matches_torch_ops(models, name, tmp_path):
    _, art, args, _, pts = models[name]
    dll = _host_build(art, tmp_path)
    xs = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in pts)
    pt = torch.from_numpy(np.asarray(args, dtype=np.float64))
    h = art.hesse_tuple(xs, pt)
    ins = [art.potential(xs, pt), h[0], h[2], h[3], art.grad_square(xs, pt)]
    ins = [torch.as_tensor(t, dtype=torch.float64).expand(xs[0].shape) for t in ins]
    packed = np.ascontiguousarray(torch.stack(ins, dim=1).numpy())
    out = np.zeros((packed.shape[0], 9))
    dll.tails(packed.shape[0], _ptr(packed), _ptr(out))
    v, v00, v10, v11, gs = ins
    want = [
        *complete_analysis_op(v, v00, v10, v11, gs),
        consistency_only_op(v, v00, v10, v11),
        consistency_rapidturn_only_op(v, v00, v10, v11),
        epsilon_v_only_op(v, gs),
    ]
    for k, w in enumerate(want):
        assert_maps_close(out[:, k], w.numpy())


def test_ratio_metric_clamp_keeps_nan():
    """The tail's clamp to ≤ 1 must propagate NaN (fmin would drop it)."""
    nan = float("nan")
    v = torch.tensor([nan, 1.0], dtype=torch.float64)
    out = consistency_rapidturn_only_op(v, torch.ones(2, dtype=torch.float64),
                                        torch.ones(2, dtype=torch.float64),
                                        torch.ones(2, dtype=torch.float64))
    assert torch.isnan(out[0]) and out[1] <= 1.0


# --------------------------------------------------------------------------- #
# scan_torch against the JAX package and the C oracle                          #
# --------------------------------------------------------------------------- #


def test_scan_torch_matches_jax_df64_path(models):
    """Against scan_pallas_df64's own CPU path (the eager double-f32 engine,
    as tests/test_pallas.py runs it) on the doc model at 64².

    ε_H is held at rtol 1e-6, the repo's tolerance for this engine's ε_H
    (tests/test_pallas.py::test_df64_engine_parity): its scale-invariant
    double-f32 tail loses digits where ε_V − vt2 cancels.  The other five
    maps are held at 5e-10."""
    from inflatox_tpu.ops.pallas_kernels import scan_pallas_df64

    jax_art, art, args, extent, _ = models["doc"]
    ref = scan_pallas_df64(jax_art, "complete_analysis", args, extent, (64, 64))
    got = scan_torch(art, "complete_analysis", args, extent, (64, 64), "cpu").numpy()
    for k in range(6):
        assert_maps_close(got[k], ref[k], rtol=1e-6 if k == 2 else MAPS_RTOL)


@pytest.mark.parametrize("shape", [(32, 16), (64, 48)])
@pytest.mark.parametrize("name", ["doc", "trivial", "angular"])
def test_scan_torch_matches_jax_xla(models, name, shape):
    jax_art, art, args, extent, _ = models[name]
    al = inflatox_tpu.consistency_conditions.GeneralisedAL(jax_art, validate_basis=False)
    ref = al.complete_analysis(args, *extent, *shape, progress=False, engine="xla")
    got = scan_torch(art, "complete_analysis", args, extent, shape, "cpu").numpy()
    for k in range(6):
        assert_maps_close(got[k], ref[k])


@pytest.mark.parametrize("name", ["doc", "angular"])
def test_scan_torch_matches_c_oracle(models, name):
    """The port matches the JAX package's native C oracle (true IEEE f64,
    the reference's formulas) — also where XLA's faithfully rounded
    division drifts (ROADMAP C4)."""
    from inflatox_tpu.native import NativeModel, native_available

    if not native_available():
        pytest.skip("no C compiler for the native oracle")
    jax_art, art, args, extent, _ = models[name]
    ref = NativeModel(jax_art.model).complete_analysis(args, *extent, 64, 64)
    got = scan_torch(art, "complete_analysis", args, extent, (64, 64), "cpu").numpy()
    for k in range(6):
        assert_maps_close(got[k], ref[k])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_scan_cuda_on_cpu_is_the_plain_version_and_never_launches(models, kind):
    _, art, args, extent, _ = models["doc"]
    before = cuda_kernels.LAUNCHES
    got = scan_cuda(art, kind, args, extent, (24, 40), "cpu")
    want = scan_torch(art, kind, args, extent, (24, 40), "cpu")
    assert got.shape == (KINDS[kind][1], 24, 40) and got.dtype == torch.float64
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    al = inflatox_torch.consistency_conditions.GeneralisedAL(
        art, device="cpu", validate_basis=False
    )
    getattr(al, kind)(args, *extent, 8, 8, progress=False)
    assert cuda_kernels.LAUNCHES == before


def test_scan_rejects_bad_arguments(models):
    _, art, args, extent, _ = models["doc"]
    with pytest.raises(ValueError):
        scan_cuda(art, "potential", args, extent, (8, 8), "cpu")
    with pytest.raises(ValueError):
        scan_cuda(art, "complete_analysis", np.ones(3), extent, (8, 8), "cpu")
    with pytest.raises(ValueError):
        scan_cuda(art, "complete_analysis", args, (0.0, 1.0, 0.0), (8, 8), "cpu")
    with pytest.raises(ValueError):
        scan_cuda(art, "complete_analysis", args, extent, (0, 8), "cpu")
    with pytest.raises(TypeError):
        scan_cuda(art, "complete_analysis", torch.ones(1, dtype=torch.float32),
                  extent, (8, 8), "cpu")


def test_scan_broadcasts_constant_model_outputs():
    """A linear potential on a flat metric lowers its Hesse components to
    constants; the scan still returns full (N0, N1) maps."""
    import sympy

    f1, f2, a, b = sympy.symbols("phi_1 phi_2 a b")
    model = inflatox_torch.InflationModelBuilder.new(
        [f1, f2], [[1, 0], [0, 1]], a * f1 + b * f2, "linear", silent=True
    ).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    out = scan_torch(art, "complete_analysis", [1.0, 2.0], (0.5, 1.0, 0.5, 1.0), (4, 6), "cpu")
    assert out.shape == (6, 4, 6)
    eps_v = 5.0 / (0.5 * torch.arange(4, dtype=torch.float64)[:, None] / 4 + 0.5
                   + 2.0 * (0.5 + 0.5 * torch.arange(6, dtype=torch.float64) / 6)) ** 2
    torch.testing.assert_close(out[1], eps_v, rtol=1e-13, atol=0)
