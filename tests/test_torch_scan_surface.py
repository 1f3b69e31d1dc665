"""The rest of the port's scan surface against the JAX package on the CPU:
the raw kinds (``potential``, ``hesse``, ``gradient``), ``calc_V_array``,
``calc_H_array``, ``calc_H_array_nd`` (a 3-field model too),
``flag_quantum_dif``, ``output="pair"``, D5 at f64, and the rule that a CPU
device never launches a kernel.

Tolerances: rtol 1e-12 with identical NaN/±inf masks against
``engine="xla"`` for the raw surfaces (the repo's tolerance for point
values, tests/test_native.py); identical boolean maps for
``flag_quantum_dif`` at an ``accuracy`` that no |∂V| lies within 1e-9 of.

D5 (from ``tests/fixtures/d5_bundle.json``) runs on bench cfg4's extent at
16 × 15 points: with 15 columns θ2 = 0 is the only multiple of π on the
grid.  On that column ∂_θ V = 0 and the projected Hesse is 0/0, and the JAX
package's two f64 engines part (XLA returns finite values, the C oracle NaN,
ROADMAP C7), so the Hesse-based checks leave it out.  V and ε_V are held
against XLA at rtol 1e-12 on the whole grid, V_vv and ε_H off θ2 = 0, ω
where XLA and the C oracle agree within 1e-12.  Every map and Hesse
component is also held against 40-digit mpmath at every point off θ2 = 0
(sympy's expressions of the model):

* V_vv, V_ww, ε_V, ε_H and ω within 1e-12 (XLA's V_ww lies 1.4e-11 from
  mpmath at one point, so V_ww is held against mpmath only);
* V_vw and the maps built on it (consistency, η_∥, δ) cancel
  catastrophically in f64: there the port's largest error may be no larger
  than the largest of XLA's and the C oracle's;
* the port's double-double (``precision="dd"``) within 1e-12 on every one
  of them, at its exact coordinates x0a + i·dx0.
"""

import os

import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops import cuda_kernels
from inflatox_torch.ops.cuda_kernels import KINDS, scan_cuda, scan_torch
from inflatox_torch.ops.grid import axis_coords
from inflatox_torch.utils.errors import ShapeError

HERE = os.path.dirname(os.path.abspath(__file__))
DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)
D5_EXTENT = (0.1, 36.0, 0.0, 4 * np.pi)  # bench.py cfg4
D5_SHAPE = (16, 15)
D5_ARGS = {"V0": -1.17e-8, "N": 1000.0, "g_s": 0.01, "l_s": 501.961, "u": 50 * 501.961,
           "q": 1.0, "p": 5.0, "a0": 0.001, "a1": 0.0005, "b1": 0.001}


def assert_maps_close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for mask in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(mask(got), mask(want)), mask.__name__
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _carry(art, tmp_path_factory, name):
    """The JAX package's artifact of a model the port built (one bundle)."""
    path = str(tmp_path_factory.mktemp("bundles") / f"{name}.json")
    art.save(path)
    return inflatox_tpu.CompiledModel.load(path)


@pytest.fixture(scope="module")
def doc(tmp_path_factory):
    """(jax artifact, torch artifact, args) of the doc model."""
    model, args = inflatox_torch.models.hyperinflation()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    return _carry(art, tmp_path_factory, "doc"), art, args


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    """The 3-field quadratic model chip_smoke.py solves."""
    a, b, c, m = sympy.symbols("a3 b3 c3 m3")
    model = inflatox_torch.InflationModelBuilder.new(
        [a, b, c], [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        sympy.Rational(1, 2) * m**2 * (a**2 + 2 * b**2 + 3 * c**2), silent=True,
    ).build(guesses=[[0, 1, 0], [0, 0, 1]])
    art = inflatox_torch.Compiler(model, silent=True).compile()
    return _carry(art, tmp_path_factory, "three"), art, np.array([1.3])


@pytest.fixture(scope="module")
def d5():
    """D5 in both packages; the JAX package lowers the expressions the port
    parsed from the bundle (the same ones its own loader would parse)."""
    art = inflatox_torch.CompiledModel.load(os.path.join(HERE, "fixtures", "d5_bundle.json"))
    m = art.model
    jax_model = inflatox_tpu.InflationModel(
        model_name=m.model_name, coordinates=m.coordinates, tangents=m.coordinate_tangents,
        basis=m.basis, eom_fields=m.eom_fields, eom_h=m.eom_h, eom_hdot=m.eom_hdot,
        potential=m.potential, metric=m.metric, gradient_square=m.gradient_square,
        hesse_cmp=m.hesse_cmp)
    jax_art = inflatox_tpu.Compiler(jax_model, silent=True, cse=True).compile()
    return jax_art, art, inflatox_torch.models._args_by_symbol(art.model, D5_ARGS)


def _al(art):
    return GeneralisedAL(art, device="cpu", validate_basis=False)


def _jax_al(art):
    return inflatox_tpu.consistency_conditions.GeneralisedAL(art, validate_basis=False)


# --------------------------------------------------------------------------- #
# the raw kinds and the array calls                                            #
# --------------------------------------------------------------------------- #


def _jax_surface(jax_art, kind, args, extent, shape):
    from inflatox_tpu.ops.grid import grid_coords

    start, stop = extent[::2], extent[1::2]
    jal = _jax_al(jax_art)
    if kind == "potential":
        return np.asarray(jal.calc_V_array(args, start, stop, shape, engine="xla"))[None]
    if kind == "hesse":
        return np.asarray(jal.calc_H_array_nd(args, start, stop, shape, engine="xla")).reshape(
            4, *shape)
    xs = grid_coords(list(zip(start, stop)), shape, np.float64)
    return np.asarray(jax_art.grad(xs, np.asarray(args)))


@pytest.mark.parametrize("kind", ["potential", "hesse", "gradient"])
def test_raw_kinds_match_jax_xla(doc, kind):
    jax_art, art, args = doc
    got = scan_torch(art, kind, args, DOC_EXTENT, (24, 40), "cpu").numpy()
    assert got.shape == (KINDS[kind][1], 24, 40)
    assert_maps_close(got, _jax_surface(jax_art, kind, args, DOC_EXTENT, (24, 40)))


def test_calc_v_and_h_arrays_match_jax(doc):
    jax_art, art, args = doc
    al, jal = _al(art), _jax_al(jax_art)
    start, stop = [0.5, 0.25], [2.5, 3.0]
    assert_maps_close(al.calc_V_array(args, start, stop, [24, 40]),
                      jal.calc_V_array(args, start, stop, [24, 40], engine="xla"))
    h = al.calc_H_array(args, 0.5, 2.5, 0.25, 3.0, [24, 40])
    assert h.shape == (2, 2, 24, 40)
    assert_maps_close(h, jal.calc_H_array_nd(args, start, stop, [24, 40], engine="xla"))
    np.testing.assert_array_equal(al.calc_H_array_nd(args, start, stop, [24, 40]), h)
    np.testing.assert_array_equal(
        al.calc_H_array(args, 0.5, 2.5, 0.25, 3.0, [24, 40], engine="torch", precision="f64"), h)


def test_arrays_of_a_three_field_model_match_jax(three):
    """Any field count but 2 runs the plain f64 version (the JAX package's
    only path there too); the kernels and other precisions raise."""
    jax_art, art, args = three
    al, jal = _al(art), _jax_al(jax_art)
    start, stop, n = [-0.9, -0.5, 0.2], [1.1, 0.5, 1.4], [6, 5, 4]  # no coordinate 0
    v = al.calc_V_array(args, start, stop, n)
    assert v.shape == (6, 5, 4)
    assert_maps_close(v, jal.calc_V_array(args, start, stop, n, engine="xla"))
    h = al.calc_H_array_nd(args, start, stop, n)
    assert h.shape == (3, 3, 6, 5, 4)
    assert_maps_close(h, jal.calc_H_array_nd(args, start, stop, n, engine="xla"))
    with pytest.raises(ValueError, match="2-field"):
        al.calc_V_array(args, start, stop, n, engine="cuda")
    with pytest.raises(ValueError, match="2-field"):
        al.calc_H_array_nd(args, start, stop, n, precision="dd")
    with pytest.raises(ShapeError):
        al.calc_H_array(args, 0, 1, 0, 1, [4, 4])
    with pytest.raises(ShapeError):
        al.calc_V_array(args, start[:2], stop[:2], n[:2])


def test_flag_quantum_dif_matches_jax(doc):
    jax_art, art, args = doc
    grads = np.abs(scan_torch(art, "gradient", args, DOC_EXTENT, (24, 40), "cpu").numpy())
    largest = np.sort(grads.max(axis=0).ravel())
    gaps = np.diff(largest)
    k = int(np.argmax(np.where(np.arange(gaps.size) > gaps.size // 4, gaps, 0)))
    accuracy = 0.5 * (largest[k] + largest[k + 1])  # no |∂V| within 1e-9 of it
    assert np.min(np.abs(grads - accuracy)) > 1e-9
    got = _al(art).flag_quantum_dif(args, *DOC_EXTENT, 24, 40, progress=False,
                                    accuracy=accuracy)
    want = _jax_al(jax_art).flag_quantum_dif(args, *DOC_EXTENT, 24, 40, progress=False,
                                             accuracy=accuracy, engine="xla")
    assert got.dtype == bool and got.shape == (24, 40) and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, np.asarray(want))


# --------------------------------------------------------------------------- #
# output="pair"                                                                #
# --------------------------------------------------------------------------- #


def test_pair_output_is_the_jax_split(doc):
    """Per quantity (hi, lo) float32 tensors: exactly the JAX package's
    off-TPU split (pallas_kernels.py:1394-1398) of the f64 result, and
    hi + lo as close to the JAX package's own pairs as the f64 maps are."""
    import jax.numpy as jnp
    from inflatox_tpu.ops.pallas_kernels import scan_pallas_df64

    jax_art, art, args = doc
    al = _al(art)
    f64 = al.complete_analysis(args, *DOC_EXTENT, 16, 12, progress=False)
    pairs = al.complete_analysis(args, *DOC_EXTENT, 16, 12, progress=False, output="pair")
    ref = scan_pallas_df64(jax_art, "complete_analysis", args, DOC_EXTENT, (16, 12),
                           output="pair")
    for k, ((hi, lo), o, (rhi, rlo)) in enumerate(zip(pairs, f64, ref)):
        j = jnp.asarray(o)
        want_hi = np.asarray(j.astype(jnp.float32))
        want_lo = np.asarray((j - j.astype(jnp.float32).astype(jnp.float64)).astype(jnp.float32))
        np.testing.assert_array_equal(hi.numpy(), want_hi)
        np.testing.assert_array_equal(lo.numpy(), want_lo)
        combined = hi.double() + lo.double()
        ref_combined = np.asarray(rhi, np.float64) + np.asarray(rlo, np.float64)
        # ε_H at the double-f32 tail's own tolerance (tests/test_pallas.py)
        assert_maps_close(combined.numpy(), ref_combined, rtol=1e-6 if k == 2 else 5e-10)
    hi, lo = al.consistency(args, *DOC_EXTENT, 16, 12, progress=False, output="pair",
                            precision="dd")
    assert hi.shape == lo.shape == (16, 12) and hi.dtype == torch.float32


# --------------------------------------------------------------------------- #
# D5 at f64 (the TPU's range-extended engine maps onto the f64 kernel)         #
# --------------------------------------------------------------------------- #


def _mp_maps(art, args):
    """The complete analysis's six maps and V_vv, V_vw, V_ww of the model at
    40 digits (sympy's expressions through mpmath, the tail's formulas as
    csrc/anguelova.cuh writes them), as a function of two mpf coordinates;
    NaN where the f64 formulas take the square root of a negative."""
    import mpmath as mp

    m = art.model
    exprs = [m.potential, m.hesse_cmp[0][0], m.hesse_cmp[1][0], m.hesse_cmp[1][1],
             m.gradient_square]
    symbols = sorted(set().union(*(e.free_symbols for e in exprs)), key=str)
    fn = sympy.lambdify(symbols, exprs, modules="mpmath", cse=True)
    slots = [art.symbol_dictionary[str(s)] for s in symbols]

    def run(x0, x1):
        v, v00, v10, v11, gsq = fn(*(
            mp.mpf(float(args[int(slot[5:-1])])) if slot.startswith("args[")
            else (x0, x1)[int(slot[2:-1])] for slot in slots))
        lhs, q0010, q1000 = v11 / v, v00 / v10, v10 / v00
        rhs = 3 + 3 * q0010**2 + (v00 / v) * q1000**2
        eps_v = gsq / v**2
        vtt = (v00 * v10**2 + v11 * v00**2 - 2 * v00 * v10**2) / (v00**2 + v10**2)
        vt2 = eps_v / (1 + q0010**2)
        eps_h = 3 * (eps_v - vt2) / (eps_v + abs(vtt) / v - vt2)
        square = (vtt / v) * (3 - eps_h)
        omega = mp.sqrt(square) if square >= 0 else mp.nan
        return [min(abs(lhs - rhs) / (abs(lhs) + abs(rhs)), 1), eps_v, eps_h,
                omega * abs(q1000) - 3, mp.atan(abs(q1000)), omega, v00, v10, v11]

    return run


def _worst(got, want, where):
    """Largest relative error of got against the mpf values want at the
    points where (NaN where want is NaN: the masks must agree)."""
    import mpmath as mp

    worst = 0.0
    for (i, j), w in zip(where, want):
        g = float(got[i, j])
        if mp.isnan(w):
            assert np.isnan(g), (i, j)
            continue
        worst = max(worst, float(abs((mp.mpf(g) - w) / w)))
    return worst


def test_d5_f64_matches_jax_and_the_c_oracle(d5):
    import mpmath as mp
    from inflatox_tpu.native import NativeModel, native_available

    jax_art, art, args = d5
    al, jal = _al(art), _jax_al(jax_art)
    (n0, n1), start, stop = D5_SHAPE, D5_EXTENT[::2], D5_EXTENT[1::2]
    assert_maps_close(al.calc_V_array(args, start, stop, [n0, n1]),
                      jal.calc_V_array(args, start, stop, [n0, n1], engine="xla"))
    got = al.complete_analysis(args, *D5_EXTENT, n0, n1, progress=False)
    xla = [np.asarray(m) for m in jal.complete_analysis(args, *D5_EXTENT, n0, n1,
                                                         progress=False, engine="xla")]
    assert_maps_close(got[1], xla[1])  # ε_V
    off = np.s_[:, 1:]  # off θ2 = 0 (ROADMAP C7)
    h = al.calc_H_array(args, *D5_EXTENT, [n0, n1])
    jh = np.asarray(jal.calc_H_array_nd(args, start, stop, [n0, n1], engine="xla"))
    assert_maps_close(h[0, 0][off], jh[0, 0][off])  # V_vv
    assert_maps_close(got[2][off], xla[2][off])  # ε_H

    # every map and Hesse component against 40-digit mpmath off θ2 = 0
    dd = al.complete_analysis(args, *D5_EXTENT, n0, n1, progress=False, precision="dd")
    h_dd = al.calc_H_array(args, *D5_EXTENT, [n0, n1], precision="dd")
    def stack(maps, hesse):
        return [*maps, hesse[0, 0], hesse[0, 1], hesse[1, 1]]

    names = ("consistency", "ε_V", "ε_H", "η_∥", "δ", "ω", "V_vv", "V_vw", "V_ww")
    x0, x1 = (np.asarray(axis_coords(D5_EXTENT[2 * a], D5_EXTENT[2 * a + 1], n))
              for a, n in enumerate(D5_SHAPE))
    dx0, dx1 = (D5_EXTENT[1] - D5_EXTENT[0]) / n0, (D5_EXTENT[3] - D5_EXTENT[2]) / n1
    where = [(i, j) for i in range(n0) for j in range(1, n1)]
    truth = _mp_maps(art, args)
    with mp.workdps(40):
        rounded = [truth(mp.mpf(x0[i]), mp.mpf(x1[j])) for i, j in where]
        exact = [truth(mp.mpf(D5_EXTENT[0]) + i * mp.mpf(dx0),
                       mp.mpf(D5_EXTENT[2]) + j * mp.mpf(dx1)) for i, j in where]
        err = {name: _worst(m, [t[k] for t in rounded], where)
               for k, (name, m) in enumerate(zip(names, stack(got, h)))}
        err_dd = {name: _worst(m, [t[k] for t in exact], where)
                  for k, (name, m) in enumerate(zip(names, stack(dd, h_dd)))}
        err_xla = {name: _worst(m, [t[k] for t in rounded], where)
                   for k, (name, m) in enumerate(zip(names, stack(xla, jh)))}
    for name in ("V_vv", "V_ww", "ε_V", "ε_H", "ω"):
        assert err[name] <= 1e-12, (name, err[name])
    assert max(err_dd.values()) <= 1e-12, err_dd
    assert err["V_vw"] <= err_xla["V_vw"], (err["V_vw"], err_xla["V_vw"])

    if not native_available():
        pytest.skip("no C compiler for the native oracle")
    oracle = [np.asarray(m) for m in NativeModel(jax_art.model).complete_analysis(
        args, *D5_EXTENT, n0, n1)]
    agree = np.abs(xla[5] - oracle[5]) <= 1e-12 * np.abs(xla[5])
    assert agree[off].mean() > 0.5
    assert_maps_close(got[5][agree], xla[5][agree])  # ω
    with mp.workdps(40):
        for k, name in ((0, "consistency"), (3, "η_∥"), (4, "δ")):
            err_c = _worst(oracle[k], [t[k] for t in rounded], where)
            assert err[name] <= max(err_xla[name], err_c), (name, err[name], err_xla[name], err_c)


# --------------------------------------------------------------------------- #
# no silent CPU work                                                           #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("precision", ["f64", "f32", "dd"])
def test_cpu_device_never_launches_and_cuda_engine_raises(doc, precision):
    _, art, args = doc
    al = _al(art)
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    for kind in KINDS:
        got = scan_cuda(art, kind, args, DOC_EXTENT, (6, 5), "cpu", precision)
        want = scan_torch(art, kind, args, DOC_EXTENT, (6, 5), "cpu", precision)
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    calls = [
        lambda **kw: al.complete_analysis(args, *DOC_EXTENT, 6, 5, progress=False, **kw),
        lambda **kw: al.calc_V_array(args, DOC_EXTENT[::2], DOC_EXTENT[1::2], [6, 5], **kw),
        lambda **kw: al.calc_H_array(args, *DOC_EXTENT, [6, 5], **kw),
        lambda **kw: al.flag_quantum_dif(args, *DOC_EXTENT, 6, 5, progress=False, **kw),
    ]
    if precision != "f32":
        pts = np.array([[1.0, 0.5], [2.0, 1.5]])
        calls.append(lambda **kw: al.epsilon_v_ot(args, pts, progress=False, **kw))
        scan_cuda_points = cuda_kernels.scan_points_cuda
        scan_cuda_points(art, "epsilon_v", args, torch.from_numpy(pts), precision)
    for call in calls:
        call(precision=precision)
        with pytest.raises(ValueError, match="cuda"):
            call(precision=precision, engine="cuda")
    assert cuda_kernels.LAUNCHES_BY_KERNEL == before
