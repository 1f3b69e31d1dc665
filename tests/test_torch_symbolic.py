"""The port's symbolic stage and bundles against the JAX package: models
built in both packages serialize identically, and bundles cross between
them in both directions."""

import json
import os

import numpy as np
import pytest
import sympy

import inflatox_torch
import inflatox_tpu
from inflatox_torch.utils.errors import SchemaVersionError

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _doc(pkg):
    r, theta, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    return pkg.InflationModelBuilder.new([r, theta], g, V, silent=True).build()


def _trivial(pkg):
    f1, f2 = sympy.symbols("phi_1 phi_2")
    m1, m2 = sympy.symbols("m_1 m_2")
    V = (m1 * f1) ** 2 + (m2 * f2) ** 2
    return pkg.InflationModelBuilder.new(
        [f1, f2], [[1, 0], [0, 1]], V, "trivial", silent=True
    ).build()


@pytest.fixture(scope="module")
def angular_pair():
    """models.angular built once in each package (the slowest build here)."""
    return inflatox_tpu.models.angular()[0], inflatox_torch.models.angular()[0]


@pytest.mark.parametrize("build", [_doc, _trivial], ids=["doc", "trivial"])
def test_to_dict_matches_jax(build):
    assert build(inflatox_torch).to_dict() == build(inflatox_tpu).to_dict()


def test_angular_to_dict_matches_jax(angular_pair):
    jax_model, torch_model = angular_pair
    assert torch_model.to_dict() == jax_model.to_dict()


def test_angular_registry_matches_jax(angular_pair):
    from inflatox_torch.lowering.registry import SymbolRegistry
    from inflatox_tpu.lowering.registry import SymbolRegistry as JaxRegistry

    jax_model, torch_model = angular_pair
    ours = SymbolRegistry.from_model(torch_model)
    ref = JaxRegistry.from_model(jax_model)
    assert ours.symbol_dictionary == ref.symbol_dictionary
    assert ours.symbol_dictionary["alpha"] == "args[0]"


@pytest.mark.parametrize("bundle", ["egno_bundle.json", "d5_bundle.json"])
def test_fixture_bundles_load(bundle):
    path = os.path.join(FIXTURES, bundle)
    ours = inflatox_torch.CompiledModel.load(path)
    ref = inflatox_tpu.CompiledModel.load(path)
    assert ours.symbol_dictionary == ref.symbol_dictionary
    assert (ours.n_fields, ours.n_parameters) == (ref.n_fields, ref.n_parameters)
    assert ours.model.to_dict() == ref.model.to_dict()


def test_bundle_round_trip_torch_to_jax(tmp_path):
    art = inflatox_torch.Compiler(_doc(inflatox_torch), silent=True).compile()
    path = str(tmp_path / "torch.json")
    art.save(path)
    ref = inflatox_tpu.CompiledModel.load(path)
    assert ref.symbol_dictionary == art.symbol_dictionary
    al = inflatox_tpu.consistency_conditions.GeneralisedAL(ref, validate_basis=False)
    assert np.isclose(al.calc_V(np.array([2.0, -2.0]), np.array([1.0])),
                      1.9166666666666667, rtol=1e-12)


def test_bundle_round_trip_jax_to_torch(tmp_path):
    ref = inflatox_tpu.Compiler(_doc(inflatox_tpu), silent=True).compile()
    path = str(tmp_path / "jax.json")
    ref.save(path)
    art = inflatox_torch.CompiledModel.load(path)
    assert art.symbol_dictionary == ref.symbol_dictionary
    al = inflatox_torch.consistency_conditions.GeneralisedAL(
        art, device="cpu", validate_basis=False
    )
    assert np.isclose(al.calc_V(np.array([2.0, -2.0]), np.array([1.0])),
                      1.9166666666666667, rtol=1e-12)
    # and back again: what the port re-saves is what the JAX package reads
    # from the same bundle
    path2 = str(tmp_path / "again.json")
    art.save(path2)
    with open(path2) as f:
        again = json.load(f)
    assert again["model"] == inflatox_tpu.CompiledModel.load(path).model.to_dict()


def test_schema_version_guard(tmp_path):
    art = inflatox_torch.Compiler(_trivial(inflatox_torch), silent=True).compile()
    path = tmp_path / "bundle.json"
    art.save(str(path))
    bundle = json.loads(path.read_text())
    major = int(bundle["schema_version"].split(".")[0])
    bundle["schema_version"] = f"{major + 1}.0.0"
    path.write_text(json.dumps(bundle))
    with pytest.raises(SchemaVersionError):
        inflatox_torch.CompiledModel.load(str(path))


def test_symbol_lookup_matches_jax():
    model = _doc(inflatox_torch)
    art = inflatox_torch.Compiler(model, silent=True).compile()
    ref = inflatox_tpu.Compiler(_doc(inflatox_tpu), silent=True).compile()
    for sym in [*model.coordinates, sympy.Symbol("m"), sympy.Symbol("nope")]:
        assert art.lookup_symbol(sym) == ref.lookup_symbol(sym)


def test_time_limit_raises_after_a_swallowed_alarm():
    """A guarded body that swallows its own SimplificationTimeOut (as a GC
    or C-level callback does) and returns after the limit still makes
    ``_time_limit`` raise: the deadline is checked again on the way out."""
    import time

    from inflatox_torch.symbolic import (
        SimplificationTimeOut,
        _time_limit,
        _timeouts_supported,
    )

    assert _timeouts_supported(), "tests run on the main thread of a POSIX process"
    swallowed = 0
    with pytest.raises(SimplificationTimeOut):
        with _time_limit(0.05):
            end = time.monotonic() + 0.25
            while time.monotonic() < end:
                try:
                    time.sleep(0.01)
                except SimplificationTimeOut:
                    swallowed += 1
    assert swallowed == 1


def test_time_limit_lets_a_prompt_body_through():
    from inflatox_torch.symbolic import _time_limit

    with _time_limit(5.0):
        value = sum(range(10))
    assert value == 45
