"""The port's sympy → torch lowering against the JAX lowering, at seeded
points, and torch's f64 libm against mpmath.

Both packages lower the same sympy expressions (the torch artifact is loaded
from the JAX artifact's bundle), so any difference is the lowering's.
Tolerance: rtol 1e-12, the repo's point-value tolerance
(tests/test_native.py, tests/test_doc.py)."""

import os

import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

import inflatox_torch
import inflatox_tpu

RTOL = 1e-12
QUANTITIES = [
    "potential", "hesse", "grad_square", "grad", "basis", "metric",
    "eom", "eom_h", "eom_hdot",
]


def _port(jax_artifact, tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp("bundles") / f"{name}.json")
    jax_artifact.save(path)
    return inflatox_torch.CompiledModel.load(path)


@pytest.fixture(scope="module")
def pairs(doc_model_artifact, trivial_artifact, tmp_path_factory):
    """(jax artifact, torch artifact, args, seeded points) per model."""
    rng = np.random.default_rng(20240611)
    n = 16
    out = {}
    doc_pts = np.stack([rng.uniform(0.3, 3.0, n), rng.uniform(-3.0, 3.0, n)])
    out["doc"] = (doc_model_artifact, np.array([1.3]), doc_pts)
    triv_pts = rng.uniform(-2.0, 2.0, (2, n))
    out["trivial"] = (trivial_artifact, np.array([0.7, 1.9]), triv_pts)
    model, args = inflatox_tpu.models.angular()
    ang = inflatox_tpu.Compiler(model, silent=True).compile()
    radius = np.sqrt(rng.uniform(0.0, 0.8, n))  # inside |x|² < 0.8
    phase = rng.uniform(0.0, 2 * np.pi, n)
    out["angular"] = (ang, args, np.stack([radius * np.cos(phase), radius * np.sin(phase)]))
    return {
        name: (j, _port(j, tmp_path_factory, name), args, pts)
        for name, (j, args, pts) in out.items()
    }


def _evaluate(artifact, quantity, x, xdot, args, lib):
    fn = getattr(artifact, quantity)
    if quantity.startswith("eom"):
        out = fn(x, xdot, args)
    else:
        out = fn(x, args)
    if isinstance(out, tuple):
        out = [np.asarray(o.cpu() if lib is torch else o) for o in out]
        return np.stack([np.broadcast_to(o, x[0].shape) for o in out])
    out = out.cpu() if lib is torch and torch.is_tensor(out) else out
    return np.broadcast_to(np.asarray(out), np.shape(np.asarray(out)))


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("model", ["doc", "trivial", "angular"])
def test_lowered_functions_match_jax(pairs, model, quantity):
    jax_art, torch_art, args, pts = pairs[model]
    rng = np.random.default_rng(7)
    xdot = rng.uniform(-0.5, 0.5, pts.shape)
    ref = _evaluate(
        jax_art, quantity, tuple(jnp.asarray(c) for c in pts),
        tuple(jnp.asarray(c) for c in xdot), jnp.asarray(args), jnp,
    )
    got = _evaluate(
        torch_art, quantity, tuple(torch.from_numpy(c) for c in pts),
        tuple(torch.from_numpy(c) for c in xdot), torch.from_numpy(args), torch,
    )
    ref = np.broadcast_to(ref, got.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("model", ["doc", "angular"])
def test_point_evaluation_matches_jax(pairs, model):
    """1-D point tensors (the calc_V / calc_H path) give the same values."""
    jax_art, torch_art, args, pts = pairs[model]
    for k in range(3):
        x = pts[:, k]
        v = torch_art.potential(torch.from_numpy(x), torch.from_numpy(args))
        h = torch_art.hesse(torch.from_numpy(x), torch.from_numpy(args))
        assert h.shape == (2, 2)
        assert np.isclose(float(v), float(jax_art.potential(jnp.asarray(x), jnp.asarray(args))),
                          rtol=RTOL, atol=0)
        np.testing.assert_allclose(
            h.numpy(), np.asarray(jax_art.hesse(jnp.asarray(x), jnp.asarray(args))),
            rtol=RTOL, atol=0,
        )


def test_egno_potential_matches_jax():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "egno_bundle.json")
    ref = inflatox_tpu.CompiledModel.load(path)
    ours = inflatox_torch.CompiledModel.load(path)
    sd = ours.symbol_dictionary
    values = {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0}
    args = np.zeros(ours.n_parameters)
    for name, slot in sd.items():
        if slot.startswith("args["):
            args[int(slot[5:-1])] = values[name]
    rng = np.random.default_rng(3)
    # r < 0.56 keeps the base of (2r − c(1−2r)⁴)^(3α) positive: for a
    # negative base the JAX package's software pow returns NaN, while
    # torch.pow follows C pow (finite for the integral runtime exponent 3α)
    pts = np.stack([rng.uniform(0.45, 0.56, 32), rng.uniform(-0.2, 0.2, 32)])
    want = np.asarray(ref.potential(tuple(jnp.asarray(c) for c in pts), jnp.asarray(args)))
    got = ours.potential(tuple(torch.from_numpy(c) for c in pts), torch.from_numpy(args))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    beyond = (torch.tensor([0.6], dtype=torch.float64), torch.tensor([0.1], dtype=torch.float64))
    assert torch.isfinite(ours.potential(beyond, torch.from_numpy(args))).all()


def test_constant_outputs_broadcast_to_the_grid():
    """A linear potential on a flat metric has a Hesse matrix of constant
    zeros: the lowering returns numbers, the stacked helpers broadcast them
    to the grid shape as float64."""
    import sympy

    f1, f2, a, b = sympy.symbols("phi_1 phi_2 a b")
    model = inflatox_torch.InflationModelBuilder.new(
        [f1, f2], [[1, 0], [0, 1]], a * f1 + b * f2, "linear", silent=True
    ).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    assert art.hesse_tuple((0.0, 0.0), None) == (0, 0, 0, 0)
    x = (torch.zeros(3, 4, dtype=torch.float64), torch.ones(3, 4, dtype=torch.float64))
    args = torch.tensor([0.7, 1.9], dtype=torch.float64)
    h = art.hesse(x, args)
    assert h.shape == (2, 2, 3, 4) and h.dtype == torch.float64
    assert (h == 0).all()
    g = art.metric(x, args)
    assert g.shape == (2, 2, 3, 4) and g.dtype == torch.float64
    assert (g[0, 0] == 1).all() and (g[0, 1] == 0).all()


def test_special_functions_wait_for_a8():
    """The special functions that waited for ROADMAP A8 now lower (through
    inflatox_torch.lowering.special) and evaluate against scipy."""
    import scipy.special as sps
    import sympy

    from inflatox_torch.lowering import SymbolRegistry, lower

    x = sympy.Symbol("x")
    reg = SymbolRegistry([x], [sympy.Symbol("xd")])
    t = np.linspace(0.3, 4.0, 9)
    for expr, want in ((sympy.besselj(1, x), sps.jv(1, t)), (sympy.erf(x), sps.erf(t)),
                       (sympy.gamma(x), sps.gamma(t))):
        reg.register_exprs([expr])
        fn = lower(expr, reg)
        assert "_special." in fn.source
        got = fn((torch.from_numpy(t),), torch.zeros(0, dtype=torch.float64))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)


def test_numeric_subexpressions_are_float_literals():
    import sympy

    from inflatox_torch.lowering import SymbolRegistry, lower

    x = sympy.Symbol("x")
    reg = SymbolRegistry([x], [sympy.Symbol("xd")])
    expr = sympy.sqrt(2) * x + sympy.pi + sympy.Max(x, sympy.log(3))
    reg.register_exprs([expr])
    fn = lower(expr, reg)
    assert "math." not in fn.source
    t = torch.tensor([0.5, 2.0], dtype=torch.float64)
    got = fn((t,), torch.zeros(0, dtype=torch.float64))
    want = np.sqrt(2) * t.numpy() + np.pi + np.maximum(t.numpy(), np.log(3))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


# --------------------------------------------------------------------------- #
# torch's f64 libm against mpmath (replaces the JAX package's accmath)         #
# --------------------------------------------------------------------------- #

_LIBM = {
    "exp": (torch.exp, mpmath.exp, (-30.0, 30.0)),
    "atan": (torch.atan, mpmath.atan, (-50.0, 50.0)),
    "sinh": (torch.sinh, mpmath.sinh, (-20.0, 20.0)),
    "cosh": (torch.cosh, mpmath.cosh, (-20.0, 20.0)),
    "acos": (torch.acos, mpmath.acos, (-1.0, 1.0)),
}


def _ulps(got: np.ndarray, want) -> np.ndarray:
    want = np.asarray([float(w) for w in want])
    return np.abs(got - want) / np.spacing(np.abs(want))


@pytest.mark.parametrize("name", sorted(_LIBM))
def test_torch_libm_within_4_ulp(name):
    fn, ref, (lo, hi) = _LIBM[name]
    x = np.random.default_rng(11).uniform(lo, hi, 2000)
    got = fn(torch.from_numpy(x)).numpy()
    with mpmath.workdps(40):
        want = [ref(mpmath.mpf(float(v))) for v in x]
    assert _ulps(got, want).max() <= 4


def test_torch_pow_within_4_ulp():
    rng = np.random.default_rng(12)
    base = rng.uniform(0.01, 50.0, 2000)
    expo = rng.uniform(-6.0, 6.0, 2000)
    got = torch.pow(torch.from_numpy(base), torch.from_numpy(expo)).numpy()
    with mpmath.workdps(40):
        want = [mpmath.power(mpmath.mpf(float(b)), mpmath.mpf(float(e)))
                for b, e in zip(base, expo)]
    assert _ulps(got, want).max() <= 4
