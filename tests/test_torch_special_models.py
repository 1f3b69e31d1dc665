"""The models that call special functions, on the CPU: bench cfg4b's
1F1/2F1/erf·Γ potential (S1), a·J₀(x)² + K₁(x+2)·y² + 2 (S2) and
a·J_{3/10}(x)² + K_{5/2}(x+2)·y² + 2 (S3) — ``chip_smoke.py``'s phases
23-26 at small sizes — and C9's Piecewise and sinc models.

Tolerances, each with its reason:

* S1-S3 ``complete_analysis`` against the JAX package's ``engine="xla"``:
  rtol 1e-10, the same f64 algorithms (the largest gap at 12 × 16 is
  7.5e-13, S3's ω); S1's model functions against 40-digit mpmath at 1e-12;
* f32 (kernel B2's plain version) against the JAX package's f32 kernel,
  ``engine="pallas"`` in Pallas interpret mode, for S1 and S3: the six
  maps at rtol 1e-4 plus 1e-6 of each map's largest value where the JAX
  package's f32 and f64 maps agree within 1e-4 (measured: 2.8e-7 absolute
  at most, S3's ω where 3 − ε_H cancels to 4e-3), and each map's median
  error against f64 at most twice the JAX f32 engine's.  S2's J₀ is NaN
  in that kernel (C11), so all three are also held to the port's own f64,
  V and the Hesse: rtol 2e-4 with an absolute floor of 2e-5 of the
  largest value;
* C9 and sinc: the JAX package's values (2.25, 2.09062196353626) to 1e-15,
  and the maps in f64 and double-double at rtol 1e-10, f32 at 1e-3;
* S2's solve against the JAX package's ``"rkf"``: rtol 1e-6, row 0 at
  1e-12 (as tests/test_torch_background.py); the solver header's
  ``inflx_deriv`` against the EoM functions at 1e-13 (host libm against
  torch's CPU functions).
"""

import ctypes

import mpmath
import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.lowering import cuda_codegen
from inflatox_torch.ops.cuda_kernels import scan_torch

S1_EXTENT = (0.3, 2.0, 0.2, 1.2)  # bench cfg4b
S2_EXTENT = (0.5, 3.0, 0.2, 1.5)
ARGS = np.array([2.0])


def _t(values, dtype=torch.float64):
    return torch.tensor(np.asarray(values, dtype=np.float64), dtype=dtype)


def _np(value):
    return np.asarray(value)


# --------------------------------------------------------------------------- #
# the models S1-S3 (chip_smoke.py phase 23), C9's Piecewise and sinc           #
# --------------------------------------------------------------------------- #


def _potentials(x, y, a):
    half, th, fh = sympy.Rational(1, 2), sympy.Rational(3, 2), sympy.Rational(5, 2)
    return {
        "S1": (a * sympy.hyper((half,), (th,), -(x**2)) + sympy.hyper((half, th), (fh,), y**2 / 4)
               / 10 + sympy.erf(x) * sympy.gamma(y + 2) / 50 + 2),
        "S2": a * sympy.besselj(0, x) ** 2 + sympy.besselk(1, x + 2) * y**2 + 2,
        "S3": (a * sympy.besselj(sympy.Rational(3, 10), x) ** 2
               + sympy.besselk(sympy.Rational(5, 2), x + 2) * y**2 + 2),
        "C9": sympy.Piecewise((a * x**2, x > 0), (a * x**4, True)) + y**2,
        "sinc": a * sympy.sinc(x) + y**2,
    }


def _build(package, name):
    x, y, a = sympy.symbols("x y a")
    model = package.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], _potentials(x, y, a)[name], silent=True, simplify=False,
        assertions=False).build()
    return package.Compiler(model, silent=True).compile()


@pytest.fixture(scope="module")
def models():
    return {name: (_build(inflatox_tpu, name), _build(inflatox_torch, name))
            for name in ("S1", "S2", "S3", "C9", "sinc")}


@pytest.fixture(scope="module")
def jax_maps(models):
    """The JAX package's ``complete_analysis`` of a model on its 12 × 16
    grid with an engine, each computed once."""
    cache = {}

    def maps(name, engine):
        if (name, engine) not in cache:
            extent = S1_EXTENT if name == "S1" else S2_EXTENT
            al = inflatox_tpu.consistency_conditions.GeneralisedAL(models[name][0],
                                                                   validate_basis=False)
            cache[name, engine] = np.stack(al.complete_analysis(
                ARGS, *extent, 12, 16, progress=False, engine=engine)).astype(np.float64)
        return cache[name, engine]

    return maps


@pytest.mark.parametrize("name,point,value", [("C9", (-1.0, 0.5), 2.25),
                                              ("sinc", (0.7, 0.5), 2.09062196353626)])
def test_piecewise_and_sinc_values(models, name, point, value):
    jax_art, art = models[name]
    got = GeneralisedAL(art, device="cpu", validate_basis=False).calc_V(np.array(point), ARGS)
    want = inflatox_tpu.consistency_conditions.GeneralisedAL(
        jax_art, validate_basis=False).calc_V(np.array(point), ARGS)
    assert got == pytest.approx(value, rel=1e-15) and want == pytest.approx(value, rel=1e-15)
    assert "torch.where" in art.potential.source


@pytest.mark.parametrize("name", ["C9", "sinc"])
def test_piecewise_maps_match_jax_in_every_precision(models, name):
    """The grid holds x = 0 (where C9 changes branch and sinc's Piecewise
    takes its limit) but not the line y = 0, where V_vw ≡ 0 and the port's
    tail and the JAX package's XLA one part for every model (C14)."""
    jax_art, art = models[name]
    extent, shape = (-1.5, 1.5, -1.0, 1.1), (12, 10)
    want = np.stack(inflatox_tpu.consistency_conditions.GeneralisedAL(
        jax_art, validate_basis=False).complete_analysis(ARGS, *extent, *shape, progress=False,
                                                         engine="xla"))
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    for precision, rtol in (("f64", 1e-10), ("dd", 1e-10), ("f32", 1e-3)):
        got = np.stack(al.complete_analysis(ARGS, *extent, *shape, progress=False,
                                            precision=precision)).astype(np.float64)
        assert np.array_equal(np.isnan(got), np.isnan(want)), precision
        fin = np.isfinite(want) & (np.abs(want) > 1e-6 * np.nanmax(np.abs(want)))
        assert np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin])) < rtol, precision


@pytest.mark.parametrize("name", ["S1", "S2", "S3"])
def test_special_models_match_jax_xla(models, jax_maps, name):
    _, art = models[name]
    extent = S1_EXTENT if name == "S1" else S2_EXTENT
    shape = (12, 16)
    want = jax_maps(name, "xla")
    got = np.stack(GeneralisedAL(art, device="cpu", validate_basis=False).complete_analysis(
        ARGS, *extent, *shape, progress=False))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0, equal_nan=True)


def test_s1_model_functions_match_mpmath(models):
    """S1 through the port's f64 lowering against sympy's expressions at 40
    digits: V, the projected Hesse and |∇V|² within 1e-12."""
    _, art = models["S1"]
    m = art.model
    exprs = [m.potential, m.hesse_cmp[0][0], m.hesse_cmp[1][0], m.hesse_cmp[1][1],
             m.gradient_square]
    x, y, a = sympy.symbols("x y a")
    rng = np.random.default_rng(8)
    pts = np.stack([rng.uniform(0.3, 2.0, 8), rng.uniform(0.2, 1.2, 8)], 1)
    xs = (_t(pts[:, 0]), _t(pts[:, 1]))
    p = _t(ARGS)
    h = art.hesse_tuple(xs, p)
    got = np.stack([_np(art.potential(xs, p)), _np(h[0]), _np(h[2]), _np(h[3]),
                    _np(art.grad_square(xs, p))])
    with mpmath.workdps(40):
        for k, e in enumerate(exprs):
            f = sympy.lambdify((x, y, a), e, modules="mpmath")
            want = np.array([float(f(mpmath.mpf(u), mpmath.mpf(v), mpmath.mpf(2)))
                             for u, v in pts])
            np.testing.assert_allclose(got[k], want, rtol=1e-12, atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("name", ["S1", "S2", "S3"])
def test_special_models_f32_near_f64(models, name):
    """V and the Hesse in f32 (kernel B2's plain version) against the
    port's own f64 (the JAX package's f32 kernel is NaN wherever J_n
    enters, C11)."""
    _, art = models[name]
    extent = S1_EXTENT if name == "S1" else S2_EXTENT
    shape = (12, 16)
    for kind in ("potential", "hesse"):
        f64 = scan_torch(art, kind, ARGS, extent, shape, "cpu").numpy()
        f32 = scan_torch(art, kind, ARGS, extent, shape, "cpu", "f32").double().numpy()
        assert np.isfinite(f32).all()
        np.testing.assert_allclose(f32, f64, rtol=2e-4, atol=2e-5 * np.abs(f64).max())


@pytest.mark.parametrize("name", ["S1", "S3"])
def test_special_models_f32_match_jax_pallas(models, jax_maps, name):
    """The port's f32 maps against the JAX package's f32 kernel in
    interpret mode, where that kernel is finite (S1, S3; not S2, C11)."""
    _, art = models[name]
    extent = S1_EXTENT if name == "S1" else S2_EXTENT
    maps = GeneralisedAL(art, device="cpu", validate_basis=False).complete_analysis(
        ARGS, *extent, 12, 16, progress=False, precision="f32")
    for g, w32, w64 in zip(maps, jax_maps(name, "pallas"), jax_maps(name, "xla")):
        assert g.dtype == np.float32 and np.array_equal(np.isnan(g), np.isnan(w32))
        g = g.astype(np.float64)
        settled = np.isfinite(w64) & (np.abs(w32 - w64) <= 1e-4 * np.abs(w64))
        assert settled.sum() >= 0.9 * np.isfinite(w64).sum()
        floor = 1e-6 * np.nanmax(np.abs(w32))
        assert (np.abs(g - w32)[settled] <= 1e-4 * np.abs(w32[settled]) + floor).all()
        finite = np.isfinite(w64) & (w64 != 0)
        err, jax_err = (np.median(np.abs(a[finite] - w64[finite]) / np.abs(w64[finite]))
                        for a in (g, w32))
        assert err <= 2 * jax_err + 1e-7


def _special_stages(art, call):
    """{stage: its x slots} of the nodes that call B8's ``call`` over the
    four grid functions."""
    slots = {}
    for _, attr, n_out in cuda_codegen._GRID_FUNCTIONS:
        dag, _, st = cuda_codegen._grid_fn(getattr(art, attr), n_out, "f64")
        for stage, nodes in (("row", st.row), ("col", st.col), ("point", st.point)):
            for k in nodes:
                if dag.text[k].startswith(call + "<"):
                    slots.setdefault(stage, set()).update(dag.slots[k])
    return slots


def test_s1_header_places_special_calls_by_coordinate(models):
    """1F1 and erf read x only: row stage; 2F1, Γ and ψ read y only: column
    stage; none is left in a point stage."""
    _, art = models["S1"]
    for call, stage, slot in (("inflx_hyp1f1", "row", "0"), ("inflx_erf", "row", "0"),
                              ("inflx_hyp2f1", "col", "1"), ("inflx_gamma", "col", "1"),
                              ("inflx_polygamma", "col", "1")):
        assert _special_stages(art, call) == {stage: {slot}}, call
    # B8 calls: 1F1(3/2; 5/2), 1F1(5/2; 7/2) and erf in the rows; 2F1(3/2, 5/2; 7/2),
    # 2F1(5/2, 7/2; 9/2), Γ, ψ and ψ′ in the columns
    ops = cuda_codegen.grid_stage_ops(art, "f64")["f_hesse"]
    assert ops["row"]["special"] == 3 and ops["col"]["special"] == 5
    assert "special" not in ops["point"]
    assert art.uses_special_functions


def test_double_double_raises_naming_the_function(models):
    _, art = models["S1"]
    with pytest.raises(NotImplementedError, match="special function 'erf'.*precision='f64'"):
        art.cuda_source("dd")
    al = GeneralisedAL(art, device="cpu", validate_basis=False)
    with pytest.raises(NotImplementedError, match="special function"):
        al.complete_analysis(ARGS, *S1_EXTENT, 4, 4, progress=False, precision="dd")


def test_s2_solve_matches_jax_rkf(models):
    jax_art, art = models["S2"]
    f0 = np.array([[0.7, 0.5], [1.4, 1.1], [2.6, 0.3]])
    d0 = np.zeros_like(f0)
    steps = 40
    want, t_want = inflatox_tpu.background.solve_eom_batch(jax_art, ARGS, steps, f0, d0,
                                                           solver="rkf", return_time=True)
    got, t_got = inflatox_torch.background.solve_eom_batch(art, ARGS, steps, f0, d0,
                                                           solver="rkf", return_time=True,
                                                           device="cpu")
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(t_got, t_want, rtol=1e-6, atol=0)


def test_s2_solver_header_derivative_is_solve_torchs(models, tmp_path):
    """The solver header's inflx_deriv (B8 inside, host-built) against the
    functions solve_torch's derivative evaluates (the EoM and Ḣ): within
    1e-13 (host libm against torch's CPU functions in the Bessel routes'
    exp and log; on the card both are CUDA's)."""
    import test_torch_staged as staged

    _, art = models["S2"]
    rng = np.random.default_rng(5)
    x = rng.uniform(0.5, 2.5, (64, 2))
    xd = rng.uniform(-0.3, 0.3, (64, 2))
    p = np.ascontiguousarray(ARGS)
    out = np.zeros((64, 5))
    dll = staged._build(art.cuda_solver_source(), staged._DERIV_HARNESS, tmp_path)
    dll.deriv_all(ctypes.c_int64(64), staged._ptr(x), staged._ptr(xd), staged._ptr(p),
                  staged._ptr(out))
    xs = [_t(x[:, a]) for a in range(2)]
    xds = [_t(xd[:, a]) for a in range(2)]
    want = [*xds, *art.eom(xs, xds, _t(p)), art.eom_hdot(xs, xds, _t(p))]
    for k, w in enumerate(want):
        w = np.broadcast_to(np.asarray(w, dtype=np.float64), (64,))
        np.testing.assert_allclose(out[:, k], w, rtol=1e-13, atol=1e-15, err_msg=str(k))


def test_shared_memory_check():
    """The grid kernel's row stages live in static shared memory,
    rows[16][nr]: codegen refuses a model whose kinds need more than 48 KB."""
    fns = ("f_V", "f_hesse", "f_gsq", "f_grad")
    cuda_codegen._check_shared(None, "f64", dict.fromkeys(fns, 100))  # 300 × 16 × 8 bytes
    with pytest.raises(ValueError, match=r"56320 bytes of static shared memory"):
        cuda_codegen._check_shared(None, "dd", {"f_V": 50, "f_hesse": 100, "f_gsq": 70,
                                                "f_grad": 1})  # 220 × 16 × 16 bytes
    with pytest.raises(ValueError, match="big"):
        cuda_codegen._check_shared(type("M", (), {"model_name": "big"})(), "f64",
                                   {"f_V": 1, "f_hesse": 1, "f_gsq": 1, "f_grad": 400})
