"""The port's multi-device surface (``inflatox_torch.parallel``: meshes,
``sharded_scan``, ``sharded_scan_ot``, ``sharded_solve_eom_batch``,
``parameter_sweep(mesh=)``, ``distributed``; the ``mesh=`` of
``background`` and ``inference``) on meshes of CPU slots
(``[torch.device("cpu")] * 8``), where every slot runs the plain versions
of the kernels.  The doc model of tests/test_parallel.py is built through
the port and carried to the JAX package as a bundle.

Each sharded call is held to the port's unsharded call bit for bit (shape,
dtype and every byte, NaNs included): grid rows keep their global index
(``rows=`` of the scans), points, trajectories and parameter sets are
computed alone, and the plain solver pads its batch to whole SIMD vectors
on the CPU.  Where the JAX call is cheap it is also held to the JAX
package's sharded call on conftest's 8 virtual devices, at the JAX test's
tolerance, rtol 1e-12, for the surfaces (``potential``, ``hesse``,
``gradient``) and the flags; at the port's own tolerances against XLA where
those are wider: the analysis maps (``complete_analysis``, ``consistency``,
``consistency_rapidturn``, ``epsilon_v``) at 5e-10, as
tests/test_torch_conditions.py holds them (XLA fuses their arithmetic: ε_H
is 1.1e-10 and ε_V 1.4e-12 apart on the 64 × 16 grid), and the solves and
the survey at 1e-6, as tests/test_torch_background.py holds them (XLA's
f64 ``pow``: the times 1.1e-9 apart after 16 rows, where the JAX test holds
its own sharded solve to 1e-9).

The two-process test runs this file as a script: two workers join a gloo
process group on a free local port, each gives the mesh 4 CPU slots, and
each checks the gathered results against its own single-device calls.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch import background as tb
from inflatox_torch import inference as tinf
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops.cuda_kernels import KINDS, evaluate_points, scan_points_torch, scan_torch
from inflatox_torch.ops.dd import DD, two_prod
from inflatox_torch.parallel import (
    default_mesh,
    distributed,
    make_mesh,
    parameter_sweep,
    sharded_scan,
    sharded_scan_ot,
    sharded_solve_eom_batch,
)
from inflatox_torch.parallel.sweep import _SWEEP_KINDS
from inflatox_torch.utils.errors import ShapeError

PARAMS = np.array([1.0])
EXTENT = (0.5, 2.5, 0.25, 3.0)
CPU = torch.device("cpu")
SLOTS = [CPU] * 8
NUMERIC_KINDS = [k for k in _SWEEP_KINDS if k != "flag_quantum_dif"]
WORKER_TIMEOUT_S = 300


def doc_model():
    r, theta, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = inflatox_torch.InflationModelBuilder.new([r, theta], g, V, silent=True).build()
    return inflatox_torch.Compiler(model, silent=True).compile()


@pytest.fixture(scope="module")
def doc(tmp_path_factory):
    """(JAX GeneralisedAL, port GeneralisedAL on the CPU, port artifact,
    JAX artifact)."""
    art = doc_model()
    path = str(tmp_path_factory.mktemp("bundles") / "doc.json")
    art.save(path)
    jart = inflatox_tpu.CompiledModel.load(path)
    jal = inflatox_tpu.consistency_conditions.GeneralisedAL(jart, validate_basis=False)
    return jal, GeneralisedAL(art, device="cpu", validate_basis=False), art, jart


def jax_mesh(axis):
    from inflatox_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(axis_names=(axis,), devices=jax.devices())


def host(value):
    return value.cpu().numpy() if torch.is_tensor(value) else np.asarray(value)


def assert_bits(got, want):
    got, want = np.ascontiguousarray(host(got)), np.ascontiguousarray(host(want))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def assert_close(got, want, rtol, atol=0.0):
    got, want = host(got), host(want)
    assert got.shape == want.shape
    for mask in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(mask(got), mask(want)), mask.__name__
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


ANALYSIS_KINDS = ("complete_analysis", "consistency", "consistency_rapidturn", "epsilon_v")


def assert_maps_match_jax(got, want, kind):
    assert_close(got, want, 5e-10 if kind in ANALYSIS_KINDS else 1e-12)


# ----------------------------------------------------------------------- #
# meshes and the process group                                             #
# ----------------------------------------------------------------------- #


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(devices=SLOTS)
    assert mesh.axis_names == ("sweep", "grid")
    assert mesh.shape == {"sweep": 1, "grid": 8} and mesh.size == 8
    assert mesh.devices.shape == (1, 8) and mesh.home == CPU and not mesh.multi_process
    two = make_mesh(("sweep", "grid"), (2, 4), SLOTS)
    assert two.shape["sweep"] == 2 and len(two.axis_slots("grid")) == 4
    assert len(two.all_slots()) == 8
    grid = default_mesh(SLOTS[:3])
    assert grid.axis_names == ("grid",) and grid.shape == {"grid": 3}
    with pytest.raises(ValueError, match="does not match device count"):
        make_mesh(("sweep", "grid"), (3, 3), SLOTS)
    with pytest.raises(ValueError, match="no axis 'solve'"):
        grid.axis_slots("solve")


def test_default_devices_are_the_cuda_devices():
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="pass devices="):
        make_mesh()


@pytest.mark.parametrize("entry", ["sharded_scan", "sharded_scan_ot",
                                   "sharded_solve_eom_batch"])
def test_mesh_must_be_a_mesh(doc, entry):
    _, al, art, _ = doc
    with pytest.raises(TypeError, match="make_mesh"):
        if entry == "sharded_scan":
            sharded_scan(al, PARAMS, EXTENT, (8, 8), object())
        elif entry == "sharded_scan_ot":
            sharded_scan_ot(al, PARAMS, np.ones((4, 2)), object())
        else:
            sharded_solve_eom_batch(art, PARAMS, 4, np.ones((2, 2)), np.zeros((2, 2)),
                                    object())


def test_mesh_decides_the_device_type(doc):
    _, _, art, _ = doc
    mesh = make_mesh(("solve",), devices=SLOTS)
    f0 = np.full((4, 2), 2.0)
    with pytest.raises(ValueError, match="decides the devices"):
        tb.solve_eom_batch(art, PARAMS, 4, f0, np.zeros_like(f0), mesh=mesh, device="cuda")


def test_initialize_leaves_a_single_process_alone(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    distributed.initialize()
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert not distributed.is_multi_host()


# ----------------------------------------------------------------------- #
# the row offset of the grid scans                                         #
# ----------------------------------------------------------------------- #


def _old_axis(start, stop, n, precision):
    """The coordinates of the scan before the row offset: start + i·spacing
    for i = 0 .. n-1 (ops/grid.py's formula, written out)."""
    spacing = (stop - start) / n
    if precision == "f32":
        i = torch.arange(n, dtype=torch.float32)
        return float(np.float32(start)) + i * float(np.float32(spacing))
    i = torch.arange(n, dtype=torch.float64)
    if precision == "dd":
        return DD(start, 0.0) + DD(*two_prod(i, spacing))
    return start + i * spacing


@pytest.mark.parametrize("precision", ["f64", "f32", "dd"])
def test_row_offset_keeps_the_whole_grid_bits(doc, precision):
    """The single scan is what it was (its coordinates rebuilt here from
    i = 0), and a range of rows equals those rows of the whole grid."""
    _, _, art, _ = doc
    n = (24, 8)
    whole = scan_torch(art, "complete_analysis", PARAMS, EXTENT, n, CPU, precision)
    x0 = _old_axis(EXTENT[0], EXTENT[1], n[0], precision)
    x1 = _old_axis(EXTENT[2], EXTENT[3], n[1], precision)
    if precision == "dd":
        xs = (DD(x0.hi[:, None].expand(n), x0.lo[:, None].expand(n)),
              DD(x1.hi[None].expand(n), x1.lo[None].expand(n)))
    else:
        xs = (x0[:, None].expand(n), x1[None].expand(n))
    assert_bits(whole, evaluate_points(art, "complete_analysis", PARAMS, xs, precision))
    for first, count in ((0, 24), (5, 7), (23, 1)):
        part = scan_torch(art, "complete_analysis", PARAMS, EXTENT, n, CPU, precision,
                          rows=(first, count))
        assert_bits(part, whole[:, first:first + count])
    with pytest.raises(ValueError, match="rows"):
        scan_torch(art, "potential", PARAMS, EXTENT, n, CPU, precision, rows=(20, 5))


# ----------------------------------------------------------------------- #
# sharded_scan                                                              #
# ----------------------------------------------------------------------- #


def test_sharded_scan_matches_single_device(doc):
    jal, al, _, _ = doc
    mesh = make_mesh(("grid",), devices=SLOTS)
    n = (64, 16)
    got = sharded_scan(al, PARAMS, EXTENT, n, mesh)
    single = al.complete_analysis(PARAMS, *EXTENT, *n, progress=False, output="f64_device")
    assert_bits(got, torch.stack(single))
    from inflatox_tpu.parallel import sharded_scan as jax_sharded_scan

    want = np.asarray(jax_sharded_scan(jal, PARAMS, EXTENT, n, jax_mesh("grid")))
    assert_maps_match_jax(host(got), want, "complete_analysis")


def test_sharded_scan_row_divisibility(doc):
    _, al, _, _ = doc
    mesh = make_mesh(("grid",), devices=SLOTS)
    with pytest.raises(ValueError, match="divisible"):
        sharded_scan(al, PARAMS, EXTENT, (30, 16), mesh)  # 30 % 8 != 0


@pytest.mark.parametrize("precision", ["f64", "f32", "dd"])
@pytest.mark.parametrize("kind", NUMERIC_KINDS)
def test_sharded_scan_every_kind_and_precision(doc, kind, precision):
    _, al, art, _ = doc
    mesh = make_mesh(("grid",), devices=SLOTS)
    n = (32, 16)
    got = sharded_scan(al, PARAMS, EXTENT, n, mesh, kind=kind, precision=precision)
    assert got.shape == (KINDS[kind][1], *n)
    assert_bits(got, scan_torch(art, kind, PARAMS, EXTENT, n, CPU, precision))


@pytest.mark.parametrize("kind", ["consistency", "consistency_rapidturn", "epsilon_v",
                                  "potential", "hesse"])
def test_sharded_scan_kinds_match_jax(doc, kind):
    jal, al, _, _ = doc
    from inflatox_tpu.parallel import sharded_scan as jax_sharded_scan

    n = (32, 16)
    got = sharded_scan(al, PARAMS, EXTENT, n, make_mesh(("grid",), devices=SLOTS), kind=kind)
    want = np.asarray(jax_sharded_scan(jal, PARAMS, EXTENT, n, jax_mesh("grid"), kind=kind))
    assert_maps_match_jax(host(got), want, kind)


def test_sharded_scan_gradient_and_flag(doc):
    jal, al, _, _ = doc
    from inflatox_tpu.parallel import sharded_scan as jax_sharded_scan

    mesh = make_mesh(("grid",), devices=SLOTS)
    n = (32, 16)
    grads = sharded_scan(al, PARAMS, EXTENT, n, mesh, kind="gradient")
    want = np.asarray(jax_sharded_scan(jal, PARAMS, EXTENT, n, jax_mesh("grid"),
                                       kind="gradient"))
    assert_maps_match_jax(host(grads), want, "gradient")
    acc = float(np.median(np.abs(host(grads))))  # a threshold that splits the grid
    flag = sharded_scan(al, PARAMS, EXTENT, n, mesh, kind="flag_quantum_dif", accuracy=acc)
    assert flag.shape == (1, *n) and flag.dtype == torch.bool
    single = al.flag_quantum_dif(PARAMS, *EXTENT, *n, progress=False, accuracy=acc)
    assert_bits(flag[0], single)
    jflag = jax_sharded_scan(jal, PARAMS, EXTENT, n, jax_mesh("grid"), kind="flag_quantum_dif",
                             accuracy=acc)
    assert_bits(flag, np.asarray(jflag))
    assert 0 < host(flag).mean() < 1


@pytest.mark.parametrize("precision", ["f64", "dd"])
def test_sharded_scan_output_formats(doc, precision):
    _, al, _, _ = doc
    mesh = make_mesh(("grid",), devices=SLOTS)
    n = (32, 16)
    ref = sharded_scan(al, PARAMS, EXTENT, n, mesh, precision=precision)
    got = sharded_scan(al, PARAMS, EXTENT, n, mesh, precision=precision, output="f64")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert_bits(got, ref)
    pairs = sharded_scan(al, PARAMS, EXTENT, n, mesh, precision=precision, output="pair")
    single = al.complete_analysis(PARAMS, *EXTENT, *n, progress=False, output="pair",
                                  precision=precision)
    assert len(pairs) == 6
    for (hi, lo), (hi1, lo1) in zip(pairs, single):
        assert hi.dtype == lo.dtype == torch.float32 and hi.shape == n
        assert_bits(hi, hi1)
        assert_bits(lo, lo1)


def test_sharded_scan_output_validation(doc):
    _, al, _, _ = doc
    mesh = make_mesh(("grid",), devices=SLOTS)
    with pytest.raises(ValueError, match="compensated"):
        sharded_scan(al, PARAMS, EXTENT, (32, 16), mesh, output="pair", precision="f32")
    with pytest.raises(ValueError, match="compensated"):
        sharded_scan(al, PARAMS, EXTENT, (32, 16), mesh, kind="flag_quantum_dif",
                     output="pair")
    with pytest.raises(ValueError, match="output"):
        sharded_scan(al, PARAMS, EXTENT, (32, 16), mesh, output="bogus")
    with pytest.raises(ValueError, match="unknown scan kind"):
        sharded_scan(al, PARAMS, EXTENT, (8, 8), mesh, kind="not_a_kind")
    with pytest.raises(ValueError, match="JAX-package engine"):
        sharded_scan(al, PARAMS, EXTENT, (8, 8), mesh, engine="pallas_df64")


# ----------------------------------------------------------------------- #
# sharded_scan_ot                                                           #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("precision", ["f64", "dd"])
def test_sharded_scan_ot_matches_single_device(doc, precision):
    jal, al, art, _ = doc
    from inflatox_tpu.parallel import sharded_scan_ot as jax_sharded_scan_ot

    mesh = make_mesh(("grid",), devices=SLOTS)
    rng = np.random.default_rng(3)
    x = np.stack([rng.uniform(0.5, 2.5, 101), rng.uniform(0.25, 3.0, 101)], 1)
    got = sharded_scan_ot(al, PARAMS, x, mesh, precision=precision)
    assert got.shape == (6, 101)
    assert_bits(got, scan_points_torch(art, "complete_analysis", PARAMS,
                                       torch.from_numpy(x), precision))
    if precision == "f64":
        single = al.complete_analysis_ot(PARAMS, x, progress=False)
        assert_bits(got, np.stack([s[:, 0] for s in single]))
        want = np.asarray(jax_sharded_scan_ot(jal, PARAMS, x, jax_mesh("grid")))
        assert_maps_match_jax(host(got), want, "complete_analysis")
    with pytest.raises(ValueError, match="f32"):
        sharded_scan_ot(al, PARAMS, x, mesh, precision="f32")


def test_sharded_scan_ot_flag(doc):
    jal, al, _, _ = doc
    from inflatox_tpu.parallel import sharded_scan_ot as jax_sharded_scan_ot

    mesh = make_mesh(("grid",), devices=SLOTS)
    rng = np.random.default_rng(7)
    x = np.stack([rng.uniform(0.5, 2.5, 33), rng.uniform(0.25, 3.0, 33)], 1)
    g = sharded_scan_ot(al, PARAMS, x, mesh, kind="gradient")
    assert g.shape == (2, 33)
    want = np.asarray(jax_sharded_scan_ot(jal, PARAMS, x, jax_mesh("grid"), kind="gradient"))
    assert_maps_match_jax(host(g), want, "gradient")
    one = sharded_scan_ot(al, PARAMS, x, make_mesh(("grid",), devices=[CPU]), kind="gradient")
    assert_bits(g, one)
    acc = float(np.median(np.abs(host(g))))
    flag = sharded_scan_ot(al, PARAMS, x, mesh, kind="flag_quantum_dif", accuracy=acc)
    assert flag.shape == (1, 33) and flag.dtype == torch.bool
    assert_bits(flag[0], np.all(np.abs(host(g)) <= acc, axis=0))


# ----------------------------------------------------------------------- #
# parameter_sweep(mesh=)                                                    #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("precision", ["f64", "f32", "dd"])
def test_parameter_sweep_sharded_matches_single_device(doc, precision):
    jal, al, _, _ = doc
    mesh = make_mesh(("sweep",), devices=SLOTS)
    batch = np.linspace(0.5, 2.0, 11)[:, None]  # 11 % 8 != 0: the padding path
    got = parameter_sweep(al, batch, EXTENT, (8, 8), mesh=mesh, progress=False,
                          precision=precision)
    assert_bits(got, parameter_sweep(al, batch, EXTENT, (8, 8), progress=False,
                                     precision=precision))
    if precision == "f64":
        from inflatox_tpu.parallel import parameter_sweep as jax_parameter_sweep

        want = np.asarray(jax_parameter_sweep(jal, batch, EXTENT, (8, 8),
                                              mesh=jax_mesh("sweep"), progress=False,
                                              engine="xla"))
        assert_close(got, want, 5e-10)


@pytest.mark.parametrize("kind", ["consistency", "epsilon_v"])
def test_parameter_sweep_sharded_kinds(doc, kind):
    jal, al, _, _ = doc
    from inflatox_tpu.parallel import parameter_sweep as jax_parameter_sweep

    batch = np.linspace(0.5, 2.0, 8)[:, None]
    got = parameter_sweep(al, batch, EXTENT, (8, 8), mesh=make_mesh(("sweep",), devices=SLOTS),
                          progress=False, kind=kind)
    assert got.shape == (8, 1, 8, 8)
    assert_bits(got, parameter_sweep(al, batch, EXTENT, (8, 8), progress=False, kind=kind))
    want = jax_parameter_sweep(jal, batch, EXTENT, (8, 8), mesh=jax_mesh("sweep"),
                               progress=False, engine="xla", kind=kind)
    assert_close(got, np.asarray(want), 1e-12)


def test_parameter_sweep_sharded_flag_and_reduce(doc):
    jal, al, _, _ = doc
    from inflatox_tpu.parallel import parameter_sweep as jax_parameter_sweep

    mesh = make_mesh(("sweep",), devices=SLOTS)
    batch = np.linspace(0.5, 2.0, 10)[:, None]
    flag = parameter_sweep(al, batch, EXTENT, (8, 8), mesh=mesh, progress=False,
                           kind="flag_quantum_dif", accuracy=0.05)
    assert flag.shape == (10, 1, 8, 8) and flag.dtype == bool
    assert_bits(flag, parameter_sweep(al, batch, EXTENT, (8, 8), progress=False,
                                      kind="flag_quantum_dif", accuracy=0.05))
    want = jax_parameter_sweep(jal, batch, EXTENT, (8, 8), mesh=jax_mesh("sweep"),
                               progress=False, engine="xla", kind="flag_quantum_dif",
                               accuracy=0.05)
    assert_bits(flag, np.asarray(want))
    counts = parameter_sweep(al, batch, EXTENT, (8, 8), mesh=mesh, progress=False,
                             kind="flag_quantum_dif", accuracy=0.05,
                             reduce_fn=lambda m: m.sum())
    np.testing.assert_array_equal(counts, flag.sum(axis=(1, 2, 3)))

    def nanmin(maps):
        return torch.where(torch.isnan(maps[0]), torch.inf, maps[0]).min()

    reduced = parameter_sweep(al, batch, EXTENT, (8, 8), mesh=mesh, progress=False,
                              reduce_fn=nanmin)
    assert_bits(reduced, parameter_sweep(al, batch, EXTENT, (8, 8), progress=False,
                                         reduce_fn=nanmin))


def test_sharded_sweep_resumes_on_another_mesh(doc, tmp_path):
    """The mesh is not in the manifest (as in the JAX package): chunks
    written on one mesh resume on another, or on none."""
    _, al, _, _ = doc
    batch = np.linspace(0.5, 2.0, 6)[:, None]
    ckpt = str(tmp_path / "sweep")
    first = parameter_sweep(al, batch, EXTENT, (8, 8), mesh=make_mesh(("sweep",), devices=SLOTS),
                            chunk_size=2, checkpoint_dir=ckpt, progress=False)
    assert sorted(os.listdir(ckpt)) == ["chunk_000000.npy", "chunk_000001.npy",
                                        "chunk_000002.npy", "manifest.json"]
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert "mesh" not in json.load(f)
    os.remove(os.path.join(ckpt, "chunk_000001.npy"))
    again = parameter_sweep(al, batch, EXTENT, (8, 8), chunk_size=2, checkpoint_dir=ckpt,
                            progress=False, mesh=make_mesh(("sweep",), devices=SLOTS[:3]))
    assert_bits(again, first)
    unsharded = parameter_sweep(al, batch, EXTENT, (8, 8), chunk_size=2, checkpoint_dir=ckpt,
                                progress=False)
    assert_bits(unsharded, first)


# ----------------------------------------------------------------------- #
# sharded background solves and the survey                                  #
# ----------------------------------------------------------------------- #


def _starts(batch, seed=7):
    rng = np.random.default_rng(seed)
    f0 = np.column_stack([rng.uniform(1.8, 2.4, batch), rng.uniform(1.7, 2.3, batch)])
    return f0, np.zeros_like(f0)


def test_sharded_solve_matches_single_device(doc):
    """B = 11 over 8 slots: the pad-and-trim path."""
    _, _, art, jart = doc
    from inflatox_tpu import background as jb
    from inflatox_tpu.parallel import make_mesh as jax_make_mesh

    f0, d0 = _starts(11)
    mesh = make_mesh(("solve",), devices=SLOTS)
    rows, times = tb.solve_eom_batch(art, PARAMS, 16, f0, d0, solver="rkf", return_time=True,
                                     mesh=mesh, device="cpu")
    single, t_single = tb.solve_eom_batch(art, PARAMS, 16, f0, d0, solver="rkf",
                                          return_time=True, device="cpu")
    assert rows.shape == (11, 16, 5)
    assert_bits(rows, single)
    assert_bits(times, t_single)
    want, t_want = jb.solve_eom_batch(jart, PARAMS, 16, f0, d0, solver="rkf", return_time=True,
                                      mesh=jax_make_mesh(axis_names=("solve",),
                                                         devices=jax.devices()))
    assert_close(rows, want, 1e-6)
    assert_close(times, t_want, 1e-6)


def test_sharded_solve_per_trajectory_params(doc):
    _, _, art, jart = doc
    from inflatox_tpu.parallel import sharded_solve_eom_batch as jax_sharded

    f0 = np.tile([[2.0, 2.0]], (8, 1))
    pars = np.linspace(0.8, 1.2, 8)[:, None]
    mesh = make_mesh(("solve",), devices=SLOTS)
    got = sharded_solve_eom_batch(art, pars, 12, f0, np.zeros_like(f0), mesh, solver="rkf")
    assert_bits(got, tb.solve_eom_batch(art, pars, 12, f0, np.zeros_like(f0), solver="rkf",
                                        device="cpu"))
    want = jax_sharded(jart, pars, 12, f0, np.zeros_like(f0), jax_mesh("solve"), solver="rkf")
    assert_close(got, want, 1e-6)


def test_sharded_solve_combine_device(doc):
    """combine="device": tensors on the mesh's first device, bit for bit the
    host path, laid out as the unsharded launch's (B = 10: the trim)."""
    _, _, art, _ = doc
    f0, d0 = _starts(10, seed=3)
    mesh = make_mesh(("solve",), devices=SLOTS)
    rows_d, times_d = sharded_solve_eom_batch(art, PARAMS, 12, f0, d0, mesh, solver="rkf",
                                              combine="device")
    assert torch.is_tensor(rows_d) and rows_d.shape == (10, 12, 5) and times_d.shape == (10, 12)
    assert rows_d.stride() == (1, 6 * 10, 10)  # the (steps, 2n+2, B) buffer's views
    rows_h, times_h = sharded_solve_eom_batch(art, PARAMS, 12, f0, d0, mesh, solver="rkf",
                                              return_time=True)
    assert_bits(rows_d, rows_h)
    assert_bits(times_d, times_h)
    with pytest.raises(ValueError, match="combine"):
        sharded_solve_eom_batch(art, PARAMS, 12, f0, d0, mesh, combine="nope")


def test_sharded_solve_jax_only_options_raise(doc):
    _, _, art, _ = doc
    f0, d0 = _starts(8)
    mesh = make_mesh(("solve",), devices=SLOTS)
    with pytest.raises(ValueError, match='"rkf"'):
        tb.solve_eom_batch(art, PARAMS, 12, f0, d0, solver="rkf_pallas", mesh=mesh,
                           device="cpu")
    with pytest.raises(ValueError, match='"rkf"'):
        sharded_solve_eom_batch(art, PARAMS, 12, f0, d0, mesh, solver="rkf_pallas")
    with pytest.raises(ValueError, match="interpret"):
        sharded_solve_eom_batch(art, PARAMS, 12, f0, d0, mesh, interpret=True)


def test_sharded_solve_validates_parameter_shapes(doc):
    _, _, art, _ = doc
    f0, d0 = _starts(8)
    mesh = make_mesh(("solve",), devices=SLOTS)
    with pytest.raises(ShapeError, match="n_parameters"):
        sharded_solve_eom_batch(art, np.array([1.0, 2.0]), 8, f0, d0, mesh)
    with pytest.raises(ShapeError, match="n_parameters"):
        sharded_solve_eom_batch(art, np.ones((8, 2)), 8, f0, d0, mesh)
    with pytest.raises(ShapeError, match="n_parameters"):
        tb.solve_eom_batch(art, np.array([1.0, 2.0]), 8, f0, d0, mesh=mesh, device="cpu")


def test_survey_on_mesh_matches_single_device(doc, trivial_artifact, tmp_path):
    """The quadratic model's survey of tests/test_torch_background.py (16
    starts, 14 of which end inflation in 400 rows) over 8 slots, against
    the JAX package's mesh survey (tests/test_background.py:466); and the
    doc model's B = 10 over 8 slots (the padding path)."""
    from inflatox_tpu import background as jb
    from inflatox_tpu.parallel import make_mesh as jax_make_mesh

    path = str(tmp_path / "trivial.json")
    trivial_artifact.save(path)
    art = inflatox_torch.CompiledModel.load(path)
    m = np.array([1.0, 0.7])
    gx, gy = np.meshgrid(np.linspace(3.0, 24.0, 4), np.linspace(0.0, 6.0, 4))
    f0 = np.stack([gx.ravel(), gy.ravel()], axis=1)
    mesh = make_mesh(("solve",), devices=SLOTS)
    got = tb.survey_initial_conditions(art, m, 400, f0, [0.0, 0.0], max_err=1e-8, mesh=mesh,
                                       device="cpu")
    single = tb.survey_initial_conditions(art, m, 400, f0, [0.0, 0.0], max_err=1e-8,
                                          device="cpu")
    for key in single:
        assert_bits(got[key], single[key])
    assert got["ended"].any() and not got["ended"].all()
    want = jb.survey_initial_conditions(trivial_artifact, m, 400, f0, [0.0, 0.0],
                                        max_err=1e-8,
                                        mesh=jax_make_mesh(axis_names=("solve",)))
    np.testing.assert_array_equal(got["ended"], want["ended"])
    for key in ("N_inflation", "H_end", "x_end", "N_span"):
        assert_close(got[key], want[key], 1e-6)
    _, _, doc_art, _ = doc
    f10, _ = _starts(10)
    a = tb.survey_initial_conditions(doc_art, PARAMS, 60, f10, [0.0, 0.0], mesh=mesh,
                                     device="cpu")
    b = tb.survey_initial_conditions(doc_art, PARAMS, 60, f10, [0.0, 0.0], device="cpu")
    for key in b:
        assert_bits(a[key], b[key])


# ----------------------------------------------------------------------- #
# the chains of sample_posterior                                            #
# ----------------------------------------------------------------------- #


def test_sample_posterior_sharded_chains():
    """tests/test_inference.py:122's case on 8 slots: the chains split over
    the mesh, the random block drawn once for all of them, so the draws are
    the unsharded run's bit for bit (the density is elementwise within a
    chain; a batched matrix product may round otherwise with the batch's
    size).  HMC, and a short NUTS run."""
    mesh = make_mesh(devices=SLOTS)

    def logp(q):
        return -0.5 * torch.sum(q * q)

    kw = dict(num_samples=200, num_warmup=100, num_chains=8, num_leapfrog=16, seed=7,
              device="cpu")
    out = tinf.sample_posterior(logp, np.zeros(2), mesh=mesh, **kw)
    single = tinf.sample_posterior(logp, np.zeros(2), **kw)
    for key in ("samples", "log_prob", "accept_rate", "inv_mass"):
        assert_bits(out[key], single[key])
    assert out["step_size"] == single["step_size"]
    s = out["samples"].reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(s.var(0), 1.0, atol=0.2)
    nuts = dict(num_samples=20, num_warmup=20, num_chains=8, seed=3, algorithm="nuts",
                max_tree_depth=4, device="cpu")
    assert_bits(tinf.sample_posterior(logp, np.zeros(2), mesh=mesh, **nuts)["samples"],
                tinf.sample_posterior(logp, np.zeros(2), **nuts)["samples"])
    with pytest.raises(ValueError, match="multiple of the mesh"):
        tinf.sample_posterior(logp, np.zeros(2), num_samples=10, num_warmup=10, num_chains=9,
                              num_leapfrog=4, mesh=mesh, device="cpu")


# ----------------------------------------------------------------------- #
# two processes                                                            #
# ----------------------------------------------------------------------- #


def _two_process_worker(address, rank, ckpt):
    """One of the two processes: 4 CPU slots each, one 8-slot mesh; the
    gathered results against this process's single-device calls."""
    distributed.initialize(coordinator_address=address, num_processes=2, process_id=rank)
    assert distributed.is_multi_host()
    art = doc_model()
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    mesh = make_mesh(("grid",), devices=[CPU] * 4)
    assert mesh.size == 8 and mesh.multi_process
    assert list(mesh.ranks.ravel()) == [0] * 4 + [1] * 4
    n = (64, 32)
    single = scan_torch(art, "complete_analysis", PARAMS, EXTENT, n, CPU)
    assert_bits(sharded_scan(al, PARAMS, EXTENT, n, mesh, output="f64"), single)
    assert_bits(sharded_scan(al, PARAMS, EXTENT, n, mesh), single)
    f0, d0 = _starts(11)
    solve_mesh = make_mesh(("solve",), devices=[CPU] * 4)
    rows, times = tb.solve_eom_batch(art, PARAMS, 16, f0, d0, solver="rkf", return_time=True,
                                     mesh=solve_mesh, device="cpu")
    want, t_want = tb.solve_eom_batch(art, PARAMS, 16, f0, d0, solver="rkf", return_time=True,
                                      device="cpu")
    assert_bits(rows, want)
    assert_bits(times, t_want)
    batch = np.linspace(0.5, 2.0, 6)[:, None]
    sweep_mesh = make_mesh(("sweep",), devices=[CPU] * 4)
    got = parameter_sweep(al, batch, EXTENT, (8, 8), mesh=sweep_mesh, chunk_size=4,
                          checkpoint_dir=ckpt, progress=False)
    assert_bits(got, parameter_sweep(al, batch, EXTENT, (8, 8), progress=False))
    torch.distributed.barrier()
    assert sorted(os.listdir(ckpt)) == ["chunk_000000.npy", "chunk_000001.npy",
                                        "manifest.json"]
    torch.distributed.destroy_process_group()
    print(f"OK process {rank}", flush=True)


def test_two_process_distributed_sharded_scan(tmp_path):
    """tests/test_parallel.py:715's case: two processes join one process
    group (gloo, a free local port), each gives the mesh 4 CPU slots, and
    each process's gathered sharded scan (and solve, and checkpointed sweep)
    is bit for bit its own single-device call."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = str(tmp_path / "sweep")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), f"localhost:{port}",
                          str(rank), ckpt], cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out}"
        assert f"OK process {rank}" in out, out


if __name__ == "__main__":
    _two_process_worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
