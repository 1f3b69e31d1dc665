"""The on-trajectory scans (``*_ot``) and kernel B5's plain version against
the JAX package.

The same (n, 2) points go through ``inflatox_tpu``'s ``engine="xla"``
on-trajectory scans and the port's ``engine="torch"`` (the plain version of
kernel B5, which is what a CPU device runs): a solved doc-model background,
and the reference's angular and EGNO trajectory fixtures
(tests/test_models.py).  Kernel B5 itself runs only on a card: its tests
are in tests/test_torch_cuda.py.

Tolerance: rtol 5e-10 with identical NaN/±inf masks, the repo's tolerance
for the analysis maps (tests/test_native.py), on the doc-model trajectory
and for ε_V on the angular one.  The angular and EGNO trajectories run through
points where the analysis cancels catastrophically (angular: |x| > 0.98,
next to the metric's singular circle; EGNO: the cancellation that needs
triple-f32 on the TPU), and there the JAX package's own two f64 engines,
XLA and the C oracle, part by up to 0.30 (angular η_∥) and 3.8e-4 (EGNO
consistency) relative.  There the port is held to the spread of those two
engines: its largest relative distance to the C oracle, per map, is at most
twice XLA's, with identical masks."""

import os

import numpy as np
import pytest
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch import background
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops import cuda_kernels
from inflatox_torch.ops.cuda_kernels import KINDS, POINT_KINDS, scan_points_cuda, scan_points_torch
from inflatox_torch.utils.errors import ShapeError

HERE = os.path.dirname(os.path.abspath(__file__))
TRAJ = os.path.join(HERE, "trajectories")
RTOL = 5e-10
OT_KINDS = ("complete_analysis_ot", "consistency_ot", "consistency_rapidturn_ot",
            "epsilon_v_ot")


def assert_maps_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for mask in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(mask(got), mask(want)), mask.__name__
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _egno_args(artifact):
    by_name = {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0}
    args = np.zeros(artifact.n_parameters)
    for name, slot in artifact.symbol_dictionary.items():
        if slot.startswith("args["):
            args[int(slot[5:-1])] = by_name[name]
    return args


@pytest.fixture(scope="module")
def cases(doc_model_artifact, tmp_path_factory):
    """name → (jax artifact, torch artifact, args, (n, 2) points)."""
    def port(jax_art, name):
        path = str(tmp_path_factory.mktemp("bundles") / f"{name}.json")
        jax_art.save(path)
        return inflatox_torch.CompiledModel.load(path)

    doc = port(doc_model_artifact, "doc")
    rows = background.solve_eom(doc, [1.0], 300, [2.0, 2.0], [0.0, 0.0],
                                solver="rkf", device="cpu")
    ang_model, ang_args = inflatox_tpu.models.angular()
    ang = inflatox_tpu.Compiler(ang_model, silent=True).compile()
    ang_pts = np.column_stack((np.load(f"{TRAJ}/angular_phix.npy"),
                               np.load(f"{TRAJ}/angular_phiy.npy")))
    egno = inflatox_tpu.CompiledModel.load(os.path.join(HERE, "fixtures", "egno_bundle.json"))
    egno_pts = np.column_stack((np.load(f"{TRAJ}/egno_r.npy"),
                                np.load(f"{TRAJ}/egno_theta.npy")))
    return {
        "doc": (doc_model_artifact, doc, np.array([1.0]), rows[:, :2]),
        "angular": (ang, port(ang, "angular"), ang_args, ang_pts),
        "egno": (egno, port(egno, "egno"), _egno_args(egno), egno_pts),
    }


def _al(artifact):
    return GeneralisedAL(artifact, device="cpu", validate_basis=False)


def _jax_al(artifact):
    return inflatox_tpu.consistency_conditions.GeneralisedAL(artifact, validate_basis=False)


@pytest.mark.parametrize("kind", OT_KINDS)
def test_ot_scans_match_jax_xla(cases, kind):
    jax_art, art, args, pts = cases["doc"]
    want = getattr(_jax_al(jax_art), kind)(args, pts, progress=False, engine="xla")
    got = getattr(_al(art), kind)(args, pts, progress=False)
    if kind == "complete_analysis_ot":
        assert len(got) == 6
        for g, w in zip(got, want):
            assert g.shape == (len(pts), 1)
            assert_maps_close(g, w)
    else:
        assert got.shape == (len(pts),)
        assert_maps_close(got, want)


def test_epsilon_v_ot_matches_jax_xla_on_angular(cases):
    jax_art, art, args, pts = cases["angular"]
    want = _jax_al(jax_art).epsilon_v_ot(args, pts, progress=False, engine="xla")
    assert_maps_close(_al(art).epsilon_v_ot(args, pts, progress=False), want)


def _oracle_ot(jax_art, args, pts):
    from inflatox_tpu.native import NativeModel, native_available

    if not native_available():
        pytest.skip("no C compiler for the native oracle")
    return np.asarray(NativeModel(jax_art.model).complete_analysis_ot(args, pts)).T


def test_complete_analysis_ot_matches_c_oracle(cases):
    """Against the JAX package's native C oracle (true IEEE f64, the
    reference's formulas) on the doc-model trajectory."""
    jax_art, art, args, pts = cases["doc"]
    want = _oracle_ot(jax_art, args, pts)
    got = _al(art).complete_analysis_ot(args, pts, progress=False)
    for k in range(6):
        assert_maps_close(got[k][:, 0], want[k])


@pytest.mark.parametrize("name", ["angular", "egno"])
def test_ill_conditioned_trajectories_within_the_jax_engines_spread(cases, name):
    jax_art, art, args, pts = cases[name]
    oracle = _oracle_ot(jax_art, args, pts)
    xla = _jax_al(jax_art).complete_analysis_ot(args, pts, progress=False, engine="xla")
    got = _al(art).complete_analysis_ot(args, pts, progress=False)
    for k in range(6):
        g, x, o = got[k][:, 0], np.asarray(xla[k])[:, 0], oracle[k]
        assert g.shape == (len(pts),)
        for mask in (np.isnan, np.isposinf, np.isneginf):
            assert np.array_equal(mask(g), mask(o)) and np.array_equal(mask(x), mask(o))
        finite = np.isfinite(o) & (o != 0)
        dist = np.max(np.abs(g - o)[finite] / np.abs(o[finite]))
        spread = np.max(np.abs(x - o)[finite] / np.abs(o[finite]))
        assert dist <= 2.0 * spread + RTOL, (k, dist, spread)


@pytest.mark.parametrize("kind", sorted(POINT_KINDS))
def test_scan_points_cuda_on_cpu_is_the_plain_version(cases, kind):
    _, art, args, pts = cases["doc"]
    x = torch.from_numpy(np.ascontiguousarray(pts))
    before = cuda_kernels.launches()
    got = scan_points_cuda(art, kind, args, x)
    want = scan_points_torch(art, kind, args, x)
    assert got.shape == (KINDS[kind][1], len(pts)) and got.dtype == torch.float64
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    getattr(_al(art), kind + "_ot")(args, pts, progress=False)
    assert cuda_kernels.launches() == before


def test_points_match_the_grid_scan(cases):
    """A grid flattened to points gives the grid scan's maps exactly."""
    from inflatox_torch.ops.cuda_kernels import scan_torch
    from inflatox_torch.ops.grid import grid_coords

    _, art, args, _ = cases["doc"]
    extent = (0.5, 2.5, 0.25, 3.0)
    grid = scan_torch(art, "complete_analysis", args, extent, (12, 9), "cpu")
    x0, x1 = grid_coords(((0.5, 2.5), (0.25, 3.0)), (12, 9), torch.device("cpu"))
    pts = torch.stack(torch.broadcast_tensors(x0, x1), dim=-1).reshape(-1, 2)
    got = scan_points_torch(art, "complete_analysis", args, pts)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(grid.reshape(6, -1)))


def test_ot_accepts_a_tensor_and_rejects_bad_shapes(cases):
    _, art, args, pts = cases["doc"]
    al = _al(art)
    ref = al.epsilon_v_ot(args, pts, progress=False)
    np.testing.assert_array_equal(al.epsilon_v_ot(args, torch.from_numpy(pts), progress=False), ref)
    with pytest.raises(ShapeError):
        al.complete_analysis_ot(args, pts[:, :1], progress=False)
    with pytest.raises(ShapeError):
        al.consistency_ot(args, pts.ravel(), progress=False)
    with pytest.raises(ShapeError):
        al.epsilon_v_ot(np.ones(2), pts, progress=False)
    with pytest.raises(ValueError, match="B5a"):
        al.complete_analysis_ot(args, pts, progress=False, engine="cuda")
    with pytest.raises(ValueError, match="JAX-package"):
        al.complete_analysis_ot(args, pts, progress=False, engine="xla")
    with pytest.raises(TypeError):
        scan_points_torch(art, "epsilon_v", args, torch.from_numpy(pts).float())
    with pytest.raises(ValueError):
        scan_points_torch(art, "epsilon_v", args, torch.zeros(4, 3, dtype=torch.float64))
