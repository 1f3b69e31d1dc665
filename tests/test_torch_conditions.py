"""The port's user-facing scans (GeneralisedAL) against the JAX package: the
golden anchor of tests/test_doc.py, the four grid scans against
``engine="xla"``, basis validation, and the device/engine/output rules."""

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.utils.errors import BasisNormError, BasisOrthogonalityError

GOLDEN_V = 1.9166666666666667  # tests/test_doc.py
GOLDEN_H = np.array([[0.41206897, -1.05517241], [-1.05517241, -0.07873563]])
KINDS = ["complete_analysis", "consistency", "consistency_rapidturn", "epsilon_v"]


def assert_maps_close(got, want, rtol=5e-10):
    """rtol with atol 0, identical NaN and ±inf masks (tests/test_native.py)."""
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
def doc_artifact():
    """The doc model built and compiled by the port itself."""
    r, theta, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = inflatox_torch.InflationModelBuilder.new([r, theta], g, V, silent=True).build()
    return inflatox_torch.Compiler(model, silent=True).compile()


@pytest.fixture(scope="module")
def models(doc_model_artifact, trivial_artifact, tmp_path_factory):
    """name → (jax artifact, torch artifact, args, extent)."""
    ang_model, ang_args = inflatox_tpu.models.angular()
    ang = inflatox_tpu.Compiler(ang_model, silent=True).compile()
    table = {
        "doc": (doc_model_artifact, np.array([1.0]), (0.5, 2.5, 0.25, 3.0)),
        "trivial": (trivial_artifact, np.array([0.7, 1.9]), (-2.0, 2.0, -1.5, 1.5)),
        # inside the disc, and off the symmetry axes x = 0, where XLA's fused
        # grid arithmetic and IEEE f64 round a coordinate differently
        "angular": (ang, ang_args, (-0.55, 0.65, -0.6, 0.5)),
    }
    return {
        name: (j, _port(j, tmp_path_factory, name), args, extent)
        for name, (j, args, extent) in table.items()
    }


def test_golden_anchor(doc_artifact):
    al = GeneralisedAL(doc_artifact, device="cpu", validation_seed=7)
    params = np.array([1.0])
    x = np.array([2.0, -2.0])
    assert np.isclose(al.calc_V(x, params), GOLDEN_V, rtol=1e-12)
    assert np.allclose(al.calc_H(x, params), GOLDEN_H)
    maps = al.complete_analysis(params, 0.0, 2.5, 0.0, np.pi, progress=False)
    assert len(maps) == 6
    assert maps[0].shape == (1000, 1000)
    assert all(isinstance(m, np.ndarray) and m.dtype == np.float64 for m in maps)
    assert np.nanmax(maps[0]) <= 1


def test_point_values_match_jax(models):
    jax_art, art, args, _ = models["doc"]
    ref = inflatox_tpu.consistency_conditions.GeneralisedAL(jax_art, validate_basis=False)
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    for x in ([2.0, -2.0], [0.7, 1.1], [1.9, 0.3]):
        assert np.isclose(al.calc_V(x, args), ref.calc_V(np.array(x), args), rtol=1e-12)
        np.testing.assert_allclose(al.calc_H(x, args), ref.calc_H(np.array(x), args),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("shape", [(32, 16), (64, 48)])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["doc", "trivial", "angular"])
def test_scans_match_jax_xla(models, name, kind, shape):
    jax_art, art, args, extent = models[name]
    ref_al = inflatox_tpu.consistency_conditions.GeneralisedAL(jax_art, validate_basis=False)
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    ref = getattr(ref_al, kind)(args, *extent, *shape, progress=False, engine="xla")
    got = getattr(al, kind)(args, *extent, *shape, progress=False)
    if kind == "complete_analysis":
        assert len(got) == 6
        for g, r in zip(got, ref):
            assert_maps_close(g, r)
    else:
        assert_maps_close(got, ref)


def test_f64_device_output_and_threads(models):
    _, art, args, extent = models["doc"]
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    maps = al.complete_analysis(args, *extent, 8, 6, progress=False, threads=4,
                                output="f64_device", engine="torch")
    assert all(torch.is_tensor(m) and m.dtype == torch.float64 for m in maps)
    cons = al.consistency(args, *extent, 8, 6, progress=False, output="f64_device")
    assert torch.is_tensor(cons) and cons.shape == (8, 6)
    host = al.complete_analysis(args, *extent, 8, 6, progress=False)
    for m, h in zip(maps, host):
        assert np.array_equal(m.numpy(), h, equal_nan=True)


def test_progress_messages(models, capsys):
    _, art, args, extent = models["doc"]
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    al.epsilon_v(args, *extent, 4, 4, progress=True)
    err = capsys.readouterr().err
    assert "Calculating potential slow-roll parameter" in err
    assert "Calculation finished" in err


# --------------------------------------------------------------------------- #
# basis validation: the same raise/warn behaviour as the JAX package           #
# --------------------------------------------------------------------------- #


def _outcome(fn, capsys):
    try:
        fn()
        exc = None
    except (BasisNormError, BasisOrthogonalityError,
            inflatox_tpu.utils.errors.BasisNormError,
            inflatox_tpu.utils.errors.BasisOrthogonalityError) as e:
        exc = e
    return exc, capsys.readouterr().err


def _same_outcome(ours, ref):
    exc, err = ours
    ref_exc, ref_err = ref
    assert err == ref_err
    assert type(exc).__name__ == type(ref_exc).__name__
    if exc is not None:
        assert exc.point == ref_exc.point
        if hasattr(exc, "vector"):
            assert exc.vector == ref_exc.vector
            assert np.isclose(exc.norm, ref_exc.norm, rtol=1e-12)
        else:
            assert exc.vectors == ref_exc.vectors
            assert np.isclose(exc.inner_prod, ref_exc.inner_prod, rtol=1e-12)


# angular seed 1 is left out: it draws a point within 1e-3 of the metric's
# singular circle, where the JAX package's jitted check reports a norm of
# 0.99625 (a violation) while a 60-digit evaluation gives 1 and the port
# 0.99928 (no violation) — the reference's rounding, not the model
@pytest.mark.parametrize("name,seed", [
    ("doc", 0), ("doc", 1), ("doc", 2), ("trivial", 0), ("trivial", 1),
    ("angular", 0), ("angular", 2), ("angular", 3), ("angular", 4),
])
def test_random_basis_validation_matches_jax(models, capsys, name, seed):
    jax_art, art, _, _ = models[name]
    ref = _outcome(lambda: inflatox_tpu.consistency_conditions.GeneralisedAL(
        jax_art, validation_seed=seed), capsys)
    ours = _outcome(lambda: GeneralisedAL(art, device="cpu", validation_seed=seed), capsys)
    _same_outcome(ours, ref)


@pytest.mark.parametrize("stop", [0.6, 1.2])
def test_domain_basis_validation_matches_jax(models, capsys, stop):
    jax_art, art, args, _ = models["angular"]
    ref_al = inflatox_tpu.consistency_conditions.GeneralisedAL(jax_art, validate_basis=False)
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    ref = _outcome(lambda: ref_al.validate_basis_on_domain(
        args, [-stop, -stop], [stop, stop], N=9), capsys)
    ours = _outcome(lambda: al.validate_basis_on_domain(
        args, [-stop, -stop], [stop, stop], N=9), capsys)
    _same_outcome(ours, ref)


def test_broken_basis_raises_like_jax(doc_model_artifact, capsys):
    model = doc_model_artifact.model
    fields = dict(
        model_name="broken",
        coordinates=model.coordinates,
        tangents=model.coordinate_tangents,
        basis=[[sympy.Integer(2), sympy.Integer(0)], [sympy.Integer(0), sympy.Integer(1)]],
        eom_fields=model.eom_fields,
        eom_h=model.eom_h,
        eom_hdot=model.eom_hdot,
        potential=model.potential,
        metric=model.metric,
        gradient_square=model.gradient_square,
        hesse_cmp=model.hesse_cmp,
    )
    jax_art = inflatox_tpu.Compiler(inflatox_tpu.InflationModel(**fields), silent=True).compile()
    art = inflatox_torch.Compiler(inflatox_torch.InflationModel(**fields), silent=True).compile()
    ref = _outcome(lambda: inflatox_tpu.consistency_conditions.GeneralisedAL(
        jax_art, validation_seed=5), capsys)
    ours = _outcome(lambda: GeneralisedAL(art, device="cpu", validation_seed=5), capsys)
    assert isinstance(ours[0], BasisNormError)
    _same_outcome(ours, ref)


# --------------------------------------------------------------------------- #
# device, engine, output and dtype rules                                       #
# --------------------------------------------------------------------------- #


def test_cuda_engine_on_cpu_device_raises(models):
    _, art, args, extent = models["doc"]
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    with pytest.raises(ValueError, match="cuda"):
        al.complete_analysis(args, *extent, 8, 8, progress=False, engine="cuda")


def test_cuda_device_without_cuda_raises(models):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, art, _, _ = models["doc"]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GeneralisedAL(art, validate_basis=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GeneralisedAL(art, device="cuda", validate_basis=False)


@pytest.mark.parametrize("engine", ["pallas", "pallas_df64", "pallas_edf64",
                                    "pallas_tf64", "xla", "bogus"])
def test_jax_engines_raise(models, engine):
    _, art, args, extent = models["doc"]
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    with pytest.raises(ValueError, match="B1" if engine.startswith("pallas_") else engine):
        al.complete_analysis(args, *extent, 8, 8, progress=False, engine=engine)


def test_pair_output_and_f32_raise(models):
    """output="pair" and the f32 scan exist, but not together; a dtype that
    contradicts the precision, or an unknown output, raises."""
    _, art, args, extent = models["doc"]
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    pairs = al.complete_analysis(args, *extent, 8, 8, progress=False, output="pair")
    assert len(pairs) == 6 and all(hi.dtype == lo.dtype == torch.float32 for hi, lo in pairs)
    maps = al.complete_analysis(args, *extent, 8, 8, progress=False, dtype=torch.float32)
    assert all(m.dtype == np.float32 for m in maps)
    with pytest.raises(ValueError, match="pair"):
        al.complete_analysis(args, *extent, 8, 8, progress=False, output="pair",
                             dtype=torch.float32)
    with pytest.raises(ValueError, match="conflicts"):
        al.complete_analysis(args, *extent, 8, 8, progress=False, dtype=np.float32,
                             precision="dd")
    with pytest.raises(ValueError):
        al.complete_analysis(args, *extent, 8, 8, progress=False, output="f32")
    # float64 is accepted explicitly
    al.complete_analysis(args, *extent, 8, 8, progress=False, dtype=torch.float64)


def test_two_field_and_argument_validation(models):
    from inflatox_torch.utils.errors import ShapeError

    _, art, args, extent = models["doc"]
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    with pytest.raises(ShapeError):
        al.complete_analysis(np.ones(2), *extent, 8, 8, progress=False)
    with pytest.raises(ShapeError):
        al.calc_V([1.0, 2.0, 3.0], args)
    phi, m = sympy.symbols("phi m")
    one = inflatox_torch.InflationModelBuilder.new(
        [phi], [[sympy.Integer(1)]], m**2 * phi**2, silent=True
    ).build(guesses=[])
    al1 = GeneralisedAL(inflatox_torch.Compiler(one, silent=True).compile(),
                        device="cpu", validate_basis=False)
    with pytest.raises(ShapeError):
        al1.complete_analysis(np.array([1.0]), 0, 1, 0, 1, 4, 4, progress=False)
