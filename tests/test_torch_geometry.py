"""Field-space geometry (``inflatox_torch.geometry``) against the JAX
package's ``inflatox_tpu.geometry`` and textbook analytics, on the CPU.

Every test of tests/test_geometry.py has a counterpart here, run on the
port with CPU tensors.  Models cross by the shared bundle: the JAX package
builds and saves each model, the port loads it, so both lower the same
sympy expressions.  The side-by-side comparisons put the same seeded numpy
grids through both packages.  Tolerances, each with its reason:

* analytic values: the JAX test's own (rtol 1e-12 or 1e-13);
* the geometry surfaces against the JAX package on grids: rtol 1e-12 with
  an absolute floor of 1e-13 of each surface's largest value (components
  that cancel to zero, such as a flat metric's Riemann in polar
  coordinates, are rounding noise on both sides);
* a metric with a Bessel function: rtol 1e-10, the special functions'
  tolerance against the JAX package (tests/test_torch_special_models.py:
  the same f64 algorithms, not the same libm)."""

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu

X = np.array([1.2, -0.8])
ARGS = np.array([1.0, 0.7])


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _grid(xs):
    return [_t(v) for v in xs]


def _pair(fields, metric, potential, path, **build):
    """(JAX artifact, port artifact loaded from its bundle)."""
    model = inflatox_tpu.InflationModelBuilder.new(
        fields, metric, potential, silent=True, **build
    ).build()
    jax_art = inflatox_tpu.Compiler(model, silent=True).compile()
    jax_art.save(path)
    return jax_art, inflatox_torch.CompiledModel.load(path)


@pytest.fixture(scope="module")
def pairs(doc_model_artifact, trivial_artifact, tmp_path_factory):
    """name → (JAX artifact, port artifact): the JAX test's models, the
    α-attractor and a metric with a Bessel function."""
    root = tmp_path_factory.mktemp("geometry_bundles")

    def port(jax_art, name):
        path = str(root / f"{name}.json")
        jax_art.save(path)
        return jax_art, inflatox_torch.CompiledModel.load(path)

    r, th, m = sympy.symbols("r theta m", positive=True)
    sth, ph = sympy.symbols("theta phi", positive=True)
    hx, hy = sympy.symbols("x y", positive=True)
    qx, qy = sympy.symbols("xx yy", positive=True)
    bx, by, ba = sympy.symbols("bx by ba")
    quadratic = lambda a, b: sympy.Rational(1, 2) * m**2 * (a**2 + b**2)  # noqa: E731
    model, alpha_args = inflatox_tpu.models.alpha_attractor()
    return {
        "alpha_args": alpha_args,
        "trivial": port(trivial_artifact, "trivial"),
        "doc": port(doc_model_artifact, "doc"),
        "polar": _pair([r, th], [[sympy.Integer(1), 0], [0, r**2]], quadratic(r, th),
                       str(root / "polar.json")),
        "sphere": _pair([sth, ph], [[sympy.Integer(1), 0], [0, sympy.sin(sth) ** 2]],
                        quadratic(sth, ph), str(root / "sphere.json")),
        "hyperbolic": _pair([hx, hy], [[sympy.Integer(1), 0], [0, sympy.sinh(hx) ** 2]],
                            quadratic(hx, hy), str(root / "hyperbolic.json")),
        "x4": _pair([qx, qy], [[sympy.Integer(1), 0], [0, qx**4]], quadratic(qx, qy),
                    str(root / "x4.json")),
        "alpha_attractor": port(inflatox_tpu.Compiler(model, silent=True).compile(),
                                "alpha_attractor"),
        "bessel": _pair([bx, by], [[sympy.Integer(1), 0], [0, sympy.besselj(0, bx) ** 2 + 1]],
                        ba * (bx**2 + by**2), str(root / "bessel.json"),
                        simplify=False, assertions=False),
    }


# ----------------------------------------------------------------------- #
# the JAX package's tests, on the port                                      #
# ----------------------------------------------------------------------- #


def test_flat_metric_geometry(pairs):
    geo = pairs["trivial"][1].geometry
    x, a = _t(X), _t(ARGS)
    assert torch.equal(geo.christoffels(x, a), torch.zeros(2, 2, 2, dtype=torch.float64))
    assert torch.equal(geo.riemann(x, a), torch.zeros(2, 2, 2, 2, dtype=torch.float64))
    assert float(geo.ricci_scalar(x, a)) == 0.0
    # coordinate covariant Hesse == plain Hessian of V = (m1 x1)² + (m2 x2)²
    np.testing.assert_allclose(
        geo.hesse(x, a).numpy(), np.diag([2 * ARGS[0] ** 2, 2 * ARGS[1] ** 2]), rtol=1e-13
    )


def test_flat_metric_geometry_grid_shape_contract(pairs):
    """A flat metric lowers every component to a literal constant — the
    result must STILL carry the documented trailing grid axes and a float
    dtype (a caller indexing gamma[..., iy, ix] would otherwise crash)."""
    art = pairs["trivial"][1]
    geo = art.geometry
    xg = _grid([np.linspace(1.0, 2.0, 6), np.linspace(0.5, 1.5, 6)])
    gam = geo.christoffels(xg, _t(ARGS))
    assert gam.shape == (2, 2, 2, 6) and gam.dtype == torch.float64
    assert geo.riemann(xg, _t(ARGS)).shape == (2, 2, 2, 2, 6)
    ric = geo.ricci_scalar(xg, _t(ARGS))
    assert ric.shape == (6,) and ric.dtype == torch.float64
    # a fully-constant metric honors the same contract
    gm = art.metric(xg, _t(ARGS))
    assert gm.shape == (2, 2, 6) and gm.dtype == torch.float64


def test_polar_christoffels_and_flatness(pairs):
    geo = pairs["polar"][1].geometry
    r = 1.7
    x, a = _t([r, 0.6]), _t([1.0])
    expect = np.zeros((2, 2, 2))
    expect[0, 1, 1] = -r          # Γ^r_θθ = −r
    expect[1, 0, 1] = expect[1, 1, 0] = 1.0 / r  # Γ^θ_rθ = 1/r
    np.testing.assert_allclose(geo.christoffels(x, a).numpy(), expect, rtol=1e-13, atol=1e-15)
    # polar coordinates on the flat plane: curvature vanishes identically
    np.testing.assert_allclose(geo.riemann(x, a).numpy(), 0.0, atol=1e-13)
    assert abs(float(geo.ricci_scalar(x, a))) < 1e-13


@pytest.mark.parametrize("point", [(0.7, 0.3), (1.2, 2.0), (2.4, 0.1)])
def test_sphere_ricci_scalar(pairs, point):
    geo = pairs["sphere"][1].geometry
    np.testing.assert_allclose(float(geo.ricci_scalar(_t(point), _t([1.0]))), 2.0, rtol=1e-12)


def test_hyperbolic_ricci_scalar_and_riemann(pairs):
    geo = pairs["hyperbolic"][1].geometry
    x, a = _t([0.9, 1.4]), _t([1.0])
    np.testing.assert_allclose(float(geo.ricci_scalar(x, a)), -2.0, rtol=1e-12)
    # constant-curvature identity: R^a_{bcd} = K (δ^a_c g_{db} − δ^a_d g_{cb})
    riem = geo.riemann(x, a).numpy()
    g = np.diag([1.0, np.sinh(0.9) ** 2])
    K = -1.0
    expect = np.zeros((2, 2, 2, 2))
    for i in range(2):
        for b in range(2):
            for c in range(2):
                for d in range(2):
                    expect[i, b, c, d] = K * ((i == c) * g[d, b] - (i == d) * g[c, b])
    np.testing.assert_allclose(riem, expect, rtol=1e-12, atol=1e-14)


def test_coordinate_hesse_matches_projected(pairs):
    """Contracting the coordinate covariant Hesse with the vielbein must
    reproduce the projected Hesse the scan kernels evaluate."""
    art = pairs["doc"][1]
    x, a = _t([2.0, -2.0]), _t([1.0])
    h_coord = art.geometry.hesse(x, a)
    basis = art.basis(x, a)  # basis[i]^a, contravariant
    proj = torch.einsum("ia,jb,ab->ij", basis, basis, h_coord)
    np.testing.assert_allclose(proj.numpy(), art.hesse(x, a).numpy(), rtol=1e-12)


def test_geometry_broadcasts_over_grids(pairs):
    geo = pairs["hyperbolic"][1].geometry
    xs = np.linspace(0.5, 2.0, 7)
    grid = _grid([xs, np.zeros(7)])
    # constant-curvature space: sympy collapses R to the literal −2; the
    # port still returns it as a float64 tensor of the grid's shape
    ric = geo.ricci_scalar(grid, _t([1.0]))
    assert ric.shape == (7,)
    np.testing.assert_allclose(ric.numpy(), -2.0, rtol=1e-12)
    gam = geo.christoffels(grid, _t([1.0]))
    assert gam.shape == (2, 2, 2, 7)
    np.testing.assert_allclose(gam[1, 0, 1].numpy(), np.cosh(xs) / np.sinh(xs), rtol=1e-12)
    # position-dependent curvature broadcasts over the grid: g = diag(1, x⁴)
    # has R = −4/x² (K = −(√g₂₂)''/√g₂₂ = −2/x²)
    ric = pairs["x4"][1].geometry.ricci_scalar(grid, _t([1.0]))
    assert ric.shape == (7,)
    np.testing.assert_allclose(ric.numpy(), -4.0 / xs**2, rtol=1e-12)


def test_geometry_on_loaded_bundle(tmp_path, trivial_artifact):
    """Geometry lowers lazily from the model, so a bundle the JAX package
    wrote gets the surfaces in the port without any schema change."""
    path = str(tmp_path / "bundle.json")
    trivial_artifact.save(path)
    art = inflatox_torch.CompiledModel.load(path)
    assert float(art.geometry.ricci_scalar(_t(X), _t(ARGS))) == 0.0
    assert art.geometry is art.geometry  # lowered once, then cached


# ----------------------------------------------------------------------- #
# the port against the JAX package, side by side                            #
# ----------------------------------------------------------------------- #

SURFACES = ("christoffels", "riemann", "ricci_scalar", "hesse")
GRID_CASES = {  # name → (lower/upper corner of the grid, args)
    "polar": ((0.5, -1.0), (2.5, 1.0), [1.3]),
    "sphere": ((0.3, -1.0), (2.8, 1.0), [1.3]),
    "hyperbolic": ((0.4, -1.0), (2.0, 1.0), [1.3]),
    "x4": ((0.5, -1.0), (2.0, 1.0), [1.3]),
    "doc": ((0.5, 0.25), (2.5, 3.0), [1.0]),
    "alpha_attractor": ((0.05, 0.0), (0.95, 6.2), None),
}


def _jax_surface(jax_art, surface, grid, args):
    import jax.numpy as jnp

    fn = getattr(jax_art.geometry, surface)
    return np.asarray(fn([jnp.asarray(g) for g in grid], jnp.asarray(args)))


def _assert_surface_close(got, want, rtol):
    want = np.broadcast_to(want, got.shape)
    floor = 1e-13 * np.max(np.abs(want)) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


@pytest.mark.parametrize("surface", SURFACES)
@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_surfaces_match_the_jax_package_on_grids(pairs, name, surface):
    jax_art, art = pairs[name]
    lo, hi, args = GRID_CASES[name]
    if args is None:
        args = pairs["alpha_args"]
    rng = np.random.default_rng(7)
    grid = [rng.uniform(lo[i], hi[i], (5, 6)) for i in range(2)]
    got = getattr(art.geometry, surface)(_grid(grid), _t(args))
    assert got.dtype == torch.float64 and got.shape[-2:] == (5, 6)
    _assert_surface_close(got.numpy(), _jax_surface(jax_art, surface, grid, np.asarray(args)),
                          rtol=1e-12)


@pytest.mark.parametrize("surface", SURFACES)
def test_special_function_metric_lowers_through_the_port(pairs, surface):
    """g = diag(1, J₀(x)² + 1): the Christoffels, Riemann, Ricci scalar and
    Hesse call J₀, J₁ and J₂, lowered through
    ``inflatox_torch.lowering.special`` as the projected Hesse is."""
    jax_art, art = pairs["bessel"]
    rng = np.random.default_rng(11)
    grid = [rng.uniform(0.3, 4.0, (4, 5)), rng.uniform(-1.0, 1.0, (4, 5))]
    args = np.array([0.8])
    got = getattr(art.geometry, surface)(_grid(grid), _t(args)).numpy()
    key = "hesse_coord" if surface == "hesse" else surface
    assert "_special." in art.geometry._fns[key].source
    _assert_surface_close(got, _jax_surface(jax_art, surface, grid, args), rtol=1e-10)


def test_geometry_on_a_model_the_port_compiled():
    """CompiledModel.geometry on an artifact the port built itself (not a
    loaded bundle): the unit 2-sphere's Ricci scalar, at a point and on a
    grid."""
    th, ph, m = sympy.symbols("theta phi m", positive=True)
    model = inflatox_torch.InflationModelBuilder.new(
        [th, ph], [[sympy.Integer(1), 0], [0, sympy.sin(th) ** 2]],
        sympy.Rational(1, 2) * m**2 * (th**2 + ph**2), silent=True,
    ).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    grid = _grid([np.linspace(0.3, 2.8, 9), np.linspace(-1.0, 1.0, 9)])
    np.testing.assert_allclose(art.geometry.ricci_scalar(grid, _t([1.0])).numpy(), 2.0,
                               rtol=1e-12)
    gam = art.geometry.christoffels(_t([1.1, 0.2]), _t([1.0])).numpy()
    np.testing.assert_allclose(gam[0, 1, 1], -np.sin(1.1) * np.cos(1.1), rtol=1e-13)
    np.testing.assert_allclose(gam[1, 0, 1], np.cos(1.1) / np.sin(1.1), rtol=1e-13)
