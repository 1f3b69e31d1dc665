"""The ``mesh=`` of ``inflatox_torch.perturbations`` on meshes of CPU slots
(``[torch.device("cpu")] * 8``, shaped (2, 4) as ("solve", "grid")): the
port counterparts of tests/test_perturbations.py's four sharded tests
(:204, :279, :345, :571), the other sweep and ``squeezed_fnl``, and
``pivot_axis``.

The δN routes split their batched solves over the mesh's first axis
("solve", 2 slots: every plain CPU solve pays its per-step cost once a
slot, so the 8-slot axis would take four times as long); the mode and
transport routes split their pivot axis over ``pivot_axis`` ("grid", 4
slots, or the first axis by default).  Each sharded call is held to the
port's unsharded call at rtol 1e-12, identical NaN masks: the solves are
bit for bit (the plain solver pads its batch to whole SIMD vectors on the
CPU), but the RK4 loops' batched products may round otherwise with the
number of pivots a slot takes.  The mode and transport routes are also held
to the JAX package's sharded call on the JAX package's base rows (fed to
both), at the port's parity tolerances of
tests/test_torch_perturbations_modes.py: spectra rtol 1e-10, the tilts and
cos Δ atol 1e-9 (the JAX tests hold its own sharded calls at 1e-10, P_iso
1e-8 / atol 1e-25).  The δN routes' parity with the JAX package on the same
trajectories is tests/test_torch_perturbations_dn.py's.
"""

import numpy as np
import pytest
import torch

import inflatox_torch
from inflatox_torch import perturbations as tp
from inflatox_torch.parallel import make_mesh
from inflatox_tpu import background as jbg
from inflatox_tpu import perturbations as jp

CPU = "cpu"
M = np.array([1.0, 1.0])
RTOL_SHARDED = 1e-12
RTOL_SPECTRA = 1e-10
ATOL_TILTS = 1e-9
TILTS = ("n_s", "n_t", "alpha_s", "cos_delta")
# the solves at max_err 1e-6, where 600 rows reach the end of inflation
DN = dict(pivots=4, N_margin_start=5.0, N_margin_end=8.0, steps=600, max_err=1e-6)
MODES = dict(pivots=4, N_margin_start=5.0, N_margin_end=8.0, dense_steps=800,
             tail_steps=400)
SWEEP = dict(pivots=3, N_margin_start=5.0, N_margin_end=8.0, dense_steps=800,
             tail_steps=300, steps=600, max_err=1e-6)
PARS = np.array([[1.0, 1.0], [1.05, 1.0]])


@pytest.fixture(scope="module")
def quadratic(trivial_artifact, tmp_path_factory):
    """(JAX artifact, port artifact from its bundle, the JAX package's base
    rows and times): the φ² axis, m1 = m2 = 1, φ₀ = 12."""
    path = str(tmp_path_factory.mktemp("spectra_bundles") / "quadratic.json")
    trivial_artifact.save(path)
    rows, times = jbg.solve_eom(trivial_artifact, M, 2000, [12.0, 0.0], [0.0, 0.0],
                                max_err=1e-9, solver="rkf", return_time=True)
    return trivial_artifact, inflatox_torch.CompiledModel.load(path), rows, times


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(("solve", "grid"), (2, 4), [torch.device("cpu")] * 8)


def jax_mesh():
    import jax

    from inflatox_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(axis_names=("solve",), devices=jax.devices())


def assert_results(got, want, rtol, tilts_atol=None):
    """Every array of a spectrum dict at ``rtol`` (the tilts and cos Δ at
    ``tilts_atol`` absolute when given), identical NaN masks; the rest
    equal."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, list):
            assert g == w, key
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, key
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        assert np.array_equal(np.isnan(g), np.isnan(w)), key
        if tilts_atol is not None and key in TILTS:
            np.testing.assert_allclose(g, w, rtol=0, atol=tilts_atol, equal_nan=True,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, equal_nan=True, err_msg=key)


def test_spectra_sharded_match_single_device(quadratic, mesh):
    """δN shards the perturbed-trajectory batch, mode_spectrum the pivot
    axis (tests/test_perturbations.py:204)."""
    jart, art, rows, times = quadratic
    dn1 = tp.delta_n_spectrum(art, M, rows, times, mesh=mesh, device=CPU, **DN)
    dn0 = tp.delta_n_spectrum(art, M, rows, times, device=CPU, **DN)
    assert_results(dn1, dn0, RTOL_SHARDED)
    ms1 = tp.mode_spectrum(art, M, rows, times, mesh=mesh, pivot_axis="grid", device=CPU,
                           **MODES)
    ms0 = tp.mode_spectrum(art, M, rows, times, device=CPU, **MODES)
    assert_results(ms1, ms0, RTOL_SHARDED)
    want = jp.mode_spectrum(jart, M, rows, times, mesh=jax_mesh(), **MODES)
    assert_results(ms1, want, RTOL_SPECTRA, ATOL_TILTS)


def test_delta_n_sweep_sharded_matches_single_device(quadratic, mesh):
    """The sweep's two batched solves split over the mesh
    (tests/test_perturbations.py:279), order 2 (the widened stencil)."""
    _, art, _, _ = quadratic
    kw = dict(DN, order=2)
    sw1 = tp.delta_n_sweep(art, PARS, [12.0, 0.0], [0.0, 0.0], mesh=mesh, device=CPU, **kw)
    sw0 = tp.delta_n_sweep(art, PARS, [12.0, 0.0], [0.0, 0.0], device=CPU, **kw)
    assert sw1["ok"].all()
    assert_results(sw1, sw0, RTOL_SHARDED)


@pytest.mark.parametrize("entry", ["mode_sweep", "transport_sweep"])
def test_sweeps_sharded_match_single_device(quadratic, mesh, entry):
    """The base solves split over the first axis, the concatenated pivot
    axis of every set over ``pivot_axis`` (tests/test_perturbations.py:345
    for the mode sweep)."""
    _, art, _, _ = quadratic
    fn = getattr(tp, entry)
    sw1 = fn(art, PARS, [12.0, 0.0], [0.0, 0.0], mesh=mesh, pivot_axis="grid", device=CPU,
             **SWEEP)
    sw0 = fn(art, PARS, [12.0, 0.0], [0.0, 0.0], device=CPU, **SWEEP)
    assert sw1["ok"].all()
    assert_results(sw1, sw0, RTOL_SHARDED)


def test_transport_sharded_matches_single_device(quadratic, mesh):
    """Pivot-axis sharding of the transport route
    (tests/test_perturbations.py:571), against the JAX package's."""
    jart, art, rows, times = quadratic
    tr1 = tp.transport_spectrum(art, M, rows, times, mesh=mesh, pivot_axis="grid",
                                device=CPU, **MODES)
    tr0 = tp.transport_spectrum(art, M, rows, times, device=CPU, **MODES)
    assert_results(tr1, tr0, RTOL_SHARDED)
    want = jp.transport_spectrum(jart, M, rows, times, mesh=jax_mesh(), **MODES)
    assert_results(tr1, want, RTOL_SPECTRA, ATOL_TILTS)


def test_pivot_axis_picks_the_mesh_axis(quadratic, mesh):
    """``pivot_axis`` names the axis the pivots split over (the first by
    default: 2 slots here, "grid" 4); 5 pivots pad to each (the last pivot
    repeated, trimmed after the loops)."""
    _, art, rows, times = quadratic
    kw = dict(MODES, pivots=5)
    single = tp.mode_spectrum(art, M, rows, times, device=CPU, **kw)
    for axis in (None, "solve", "grid"):
        got = tp.mode_spectrum(art, M, rows, times, mesh=mesh, pivot_axis=axis, device=CPU, **kw)
        assert got["P_zeta"].shape == (5,)
        assert_results(got, single, RTOL_SHARDED)
    with pytest.raises(ValueError, match="no axis 'pivots'"):
        tp.mode_spectrum(art, M, rows, times, mesh=mesh, pivot_axis="pivots", device=CPU, **kw)


def test_squeezed_fnl_sharded_matches_single_device(quadratic, mesh):
    _, art, rows, times = quadratic
    kw = dict(N_long_before_end=28.0, N_short_before_end=(18.0, 12.0), steps=600,
              max_err=1e-6, N_margin_start=2.0, N_margin_end=5.0)
    got = tp.squeezed_fnl(art, M, rows, times, mesh=mesh, device=CPU, **kw)
    assert_results(got, tp.squeezed_fnl(art, M, rows, times, device=CPU, **kw), RTOL_SHARDED)
