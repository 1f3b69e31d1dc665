"""The port's ``parameter_sweep`` (kernels B7a, B7b, B7d's plain versions on
the CPU) against the JAX package's, on the doc model of
tests/test_parallel.py (built through the port, carried to the JAX package
as a bundle).

Tolerances:

* f64 against ``engine="xla"``: every kind at rtol 1e-12 with identical NaN
  masks, the repo's tolerance for the f64 engines, but ε_H of
  ``complete_analysis`` at 5e-10, the repo's tolerance for the maps (its
  condition number reaches 1e4 on this grid, and XLA fuses its arithmetic:
  1.1e-10 apart at one point in 320); ``flag_quantum_dif``'s boolean mask
  exact.
* f32 against ``engine="pallas"`` with ``dtype=float32`` (Pallas interpret
  mode, whose coordinates are kernel B2's, ``x0a + i·dx0`` in f32): the
  surfaces at rtol 1e-5, as tests/test_torch_precision.py holds B2's, on the
  points where the JAX package's f32 surface lies within 1e-5 of its f64
  one (at least 99 %); at the others (V_vv cancels to 1e-3 of its terms
  there) the port's f32 no further from the f64 surface than twice the JAX
  package's f32.
* double-double against ``engine="pallas_tf64"`` (its eager path on the
  CPU): at least 99 % of each map's finite values within rtol 1e-10 (ε_H
  1e-6), NaN masks identical except where V_vv is 0 (ROADMAP C4), the B4
  parity rule of tests/test_torch_precision.py.
* the plain batched version against S separate ``scan_torch`` calls: rtol
  1e-13 with identical NaN masks; torch's vectorised libm on the CPU may
  round a last bit differently by position (on the card each set is bit for
  bit its own scan).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import sympy
import torch

import inflatox_torch
import inflatox_tpu
from inflatox_torch.consistency_conditions import GeneralisedAL
from inflatox_torch.ops.cuda_kernels import KINDS, scan_batch_cuda, scan_batch_torch, scan_torch
from inflatox_torch.parallel import parameter_sweep
from inflatox_torch.parallel.sweep import _SWEEP_KINDS, _reduce_fingerprint
from inflatox_tpu.parallel import parameter_sweep as jax_parameter_sweep

EXTENT = (0.5, 2.5, 0.25, 3.0)
BATCH = np.linspace(0.5, 2.0, 5)[:, None]  # 5 values of m


@pytest.fixture(scope="module")
def doc(tmp_path_factory):
    """(JAX GeneralisedAL, port GeneralisedAL on the CPU)."""
    r, theta, m = sympy.symbols("r θ m")
    V = sympy.Rational(1, 2) * m**2 * (theta**2 - sympy.Rational(2, 3) / r**2)
    g = [[sympy.Rational(1, 2), 0], [0, sympy.Rational(1, 2) * r**2]]
    model = inflatox_torch.InflationModelBuilder.new([r, theta], g, V, silent=True).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    path = str(tmp_path_factory.mktemp("bundles") / "doc.json")
    art.save(path)
    jal = inflatox_tpu.consistency_conditions.GeneralisedAL(
        inflatox_tpu.CompiledModel.load(path), validate_basis=False)
    return jal, GeneralisedAL(art, device="cpu", validate_basis=False)


def assert_close_masks(got, want, rtol):
    assert got.shape == want.shape and got.dtype == want.dtype
    for mask in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(mask(got), mask(want)), mask.__name__
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def consistency_nanmin(maps):
    c = maps[0]
    return torch.where(torch.isnan(c), torch.inf, c).min()


def test_port_has_the_jax_kinds():
    from inflatox_tpu.parallel.sweep import _SWEEP_KINDS as jax_kinds

    assert _SWEEP_KINDS == jax_kinds


@pytest.mark.parametrize("kind", _SWEEP_KINDS)
def test_f64_sweep_matches_jax_xla(doc, kind):
    jal, al = doc
    got = parameter_sweep(al, BATCH, EXTENT, (8, 8), progress=False, kind=kind, accuracy=0.3)
    want = np.asarray(jax_parameter_sweep(jal, BATCH, EXTENT, (8, 8), progress=False,
                                          engine="xla", kind=kind, accuracy=0.3))
    if kind == "flag_quantum_dif":
        assert got.dtype == bool and got.shape == (5, 1, 8, 8)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 1  # the threshold splits the grid
    else:
        assert got.shape == (5, KINDS[kind][1], 8, 8)
        for k in range(got.shape[1]):
            rtol = 5e-10 if (kind == "complete_analysis" and k == 2) else 1e-12
            assert_close_masks(got[:, k], want[:, k], rtol)


@pytest.mark.parametrize("kind", ["potential", "hesse", "gradient"])
def test_f32_sweep_matches_jax_pallas(doc, kind):
    jal, al = doc
    batch = BATCH[1:4]
    got = parameter_sweep(al, batch, EXTENT, (8, 128), progress=False, kind=kind,
                          dtype=torch.float32)
    want = np.asarray(jax_parameter_sweep(jal, batch, EXTENT, (8, 128), progress=False,
                                          engine="pallas", dtype=jnp.float32, kind=kind))
    f64 = np.asarray(jax_parameter_sweep(jal, batch, EXTENT, (8, 128), progress=False,
                                         engine="xla", kind=kind))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    got, want = got.astype(np.float64), want.astype(np.float64)
    settled = np.isfinite(f64) & (np.abs(want - f64) <= 1e-5 * np.abs(f64))
    assert settled.mean() >= 0.99
    np.testing.assert_allclose(got[settled], want[settled], rtol=1e-5, atol=0)
    rest = np.isfinite(f64) & ~settled
    assert (np.abs(got - f64)[rest] <= 2 * np.abs(want - f64)[rest]).all()


def test_dd_sweep_matches_jax_tf64(doc):
    jal, al = doc
    batch = BATCH[1:4]
    got = parameter_sweep(al, batch, EXTENT, (8, 8), progress=False, precision="dd")
    want = np.asarray(jax_parameter_sweep(jal, batch, EXTENT, (8, 8), progress=False,
                                          engine="pallas_tf64"))
    v00 = scan_batch_torch(al.artifact, "hesse", batch, EXTENT, (8, 8), "cpu", "dd")[:, 0]
    assert got.shape == want.shape == (3, 6, 8, 8)
    for k in range(6):
        g, w = got[:, k].ravel(), want[:, k].ravel()
        c4 = v00.numpy().ravel() == 0
        assert np.array_equal(np.isnan(g)[~c4], np.isnan(w)[~c4]), k
        finite = np.isfinite(g) & np.isfinite(w) & (w != 0)
        assert finite.mean() > 0.3  # η_∥ and ω are NaN at two thirds of the points
        rtol = 1e-6 if k == 2 else 1e-10
        assert np.mean(np.abs(g[finite] - w[finite]) <= rtol * np.abs(w[finite])) >= 0.99, k


@pytest.mark.parametrize("precision", ["f64", "f32", "dd"])
def test_plain_batch_matches_separate_scans(doc, precision):
    _, al = doc
    for kind in KINDS:
        got = scan_batch_torch(al.artifact, kind, BATCH, EXTENT, (8, 12), "cpu", precision)
        assert got.shape == (5, KINDS[kind][1], 8, 12)
        for s in range(len(BATCH)):
            want = scan_torch(al.artifact, kind, BATCH[s], EXTENT, (8, 12), "cpu", precision)
            assert_close_masks(got[s].numpy(), want.numpy(), 1e-13)
    # the wrapper takes the plain version for a CPU device
    got = scan_batch_cuda(al.artifact, "consistency", BATCH, EXTENT, (8, 12), "cpu", precision)
    want = scan_batch_torch(al.artifact, "consistency", BATCH, EXTENT, (8, 12), "cpu", precision)
    assert torch.equal(got, want)


def test_plain_batch_model_without_parameters():
    x, y = sympy.symbols("x y")
    model = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[1, 0], [0, 1]], (x**2 + 2 * y**2 + 1) / 3, silent=True).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    assert art.n_parameters == 0
    got = scan_batch_torch(art, "complete_analysis", np.zeros((3, 0)), EXTENT, (6, 7), "cpu")
    want = scan_torch(art, "complete_analysis", [], EXTENT, (6, 7), "cpu")
    for s in range(3):
        assert_close_masks(got[s].numpy(), want.numpy(), 0)


def test_reduce_fn(doc):
    jal, al = doc
    out = parameter_sweep(al, BATCH, EXTENT, (8, 8), progress=False,
                          reduce_fn=consistency_nanmin)
    assert out.shape == (5,)
    full = parameter_sweep(al, BATCH, EXTENT, (8, 8), progress=False)
    np.testing.assert_array_equal(out, np.nanmin(full[:, 0], axis=(1, 2)))
    want = np.asarray(jax_parameter_sweep(jal, BATCH, EXTENT, (8, 8), progress=False,
                                          engine="xla",
                                          reduce_fn=lambda m: jnp.nanmin(m[0])))
    np.testing.assert_allclose(out, want, rtol=1e-12)

    def min_and_argmin(maps):  # a stacked pair, as scripts/sweep_rehearsal.py
        c = torch.where(torch.isnan(maps[0]), torch.inf, maps[0])
        return torch.stack([c.min(), c.argmin().to(c.dtype)])

    pairs = parameter_sweep(al, BATCH, EXTENT, (8, 8), progress=False, chunk_size=2,
                            reduce_fn=min_and_argmin)
    assert pairs.shape == (5, 2)
    flat = np.where(np.isnan(full[:, 0]), np.inf, full[:, 0]).reshape(5, -1)
    np.testing.assert_array_equal(pairs[:, 1], flat.argmin(axis=1))
    counts = parameter_sweep(al, BATCH, EXTENT, (8, 8), progress=False,
                             kind="flag_quantum_dif", accuracy=0.3,
                             reduce_fn=lambda m: m.sum())
    flags = parameter_sweep(al, BATCH, EXTENT, (8, 8), progress=False,
                            kind="flag_quantum_dif", accuracy=0.3)
    np.testing.assert_array_equal(counts, flags.sum(axis=(1, 2, 3)))
    with pytest.raises(TypeError, match="single array"):
        parameter_sweep(al, BATCH, EXTENT, (8, 8), progress=False,
                        reduce_fn=lambda m: (m[0].min(), m[0].argmin()))


def test_chunk_size_not_dividing_the_batch(doc):
    _, al = doc
    whole = parameter_sweep(al, BATCH, EXTENT, (8, 8), progress=False)
    chunked = parameter_sweep(al, BATCH, EXTENT, (8, 8), chunk_size=2, progress=True)
    np.testing.assert_array_equal(chunked, whole)
    assert np.array_equal(parameter_sweep(al, BATCH, EXTENT, (8, 8), chunk_size=9,
                                          progress=False), whole, equal_nan=True)


def test_checkpoint_resume(doc, tmp_path):
    _, al = doc
    ckpt = str(tmp_path / "sweep")
    first = parameter_sweep(al, BATCH, EXTENT, (8, 8), chunk_size=2, checkpoint_dir=ckpt,
                            progress=False)
    assert sorted(os.listdir(ckpt)) == ["chunk_000000.npy", "chunk_000001.npy",
                                        "chunk_000002.npy", "manifest.json"]
    for ci, lo in enumerate((0, 2, 4)):
        saved = np.load(os.path.join(ckpt, f"chunk_{ci:06d}.npy"))
        assert np.array_equal(saved, first[lo:lo + 2], equal_nan=True)
    # a chunk deleted, a temp file left by a killed writer: the resume
    # recomputes the one, removes the other, and loads the others unchanged
    os.remove(os.path.join(ckpt, "chunk_000001.npy"))
    open(os.path.join(ckpt, "chunk_000001.npy.tmp.99999"), "wb").close()
    kept = {name: os.stat(os.path.join(ckpt, name)).st_ino
            for name in ("chunk_000000.npy", "chunk_000002.npy")}
    resumed = parameter_sweep(al, BATCH, EXTENT, (8, 8), chunk_size=2, checkpoint_dir=ckpt,
                              progress=False)
    assert np.array_equal(resumed, first, equal_nan=True)
    assert sorted(os.listdir(ckpt)) == ["chunk_000000.npy", "chunk_000001.npy",
                                        "chunk_000002.npy", "manifest.json"]
    assert all(os.stat(os.path.join(ckpt, n)).st_ino == ino for n, ino in kept.items())
    # a chunk loaded from disk is not recomputed: a marked one comes back
    marked = np.load(os.path.join(ckpt, "chunk_000000.npy"))
    marked[0, 0, 0, 0] = 12345.0
    np.save(os.path.join(ckpt, "chunk_000000.npy"), marked)
    again = parameter_sweep(al, BATCH, EXTENT, (8, 8), chunk_size=2, checkpoint_dir=ckpt,
                            progress=False)
    assert again[0, 0, 0, 0] == 12345.0


@pytest.mark.parametrize("change", [
    {"args_batch": BATCH + 0.1}, {"kind": "consistency"}, {"precision": "dd"},
    {"chunk_size": 3}, {"reduce_fn": consistency_nanmin},
], ids=["args", "kind", "precision", "chunk_size", "reduce_fn"])
def test_a_different_sweep_refuses_to_resume(doc, tmp_path, change):
    _, al = doc
    ckpt = str(tmp_path / "sweep")
    call = {"args_batch": BATCH, "chunk_size": 2}
    parameter_sweep(al, extent=EXTENT, shape=(4, 4), checkpoint_dir=ckpt, progress=False,
                    **call)
    with pytest.raises(ValueError, match="different sweep.*refusing to resume"):
        parameter_sweep(al, extent=EXTENT, shape=(4, 4), checkpoint_dir=ckpt,
                        progress=False, **{**call, **change})


def test_flag_accuracy_is_in_the_manifest(doc, tmp_path):
    _, al = doc
    ckpt = str(tmp_path / "sweep")
    parameter_sweep(al, BATCH, EXTENT, (4, 4), checkpoint_dir=ckpt, progress=False,
                    kind="flag_quantum_dif", accuracy=0.3)
    with pytest.raises(ValueError, match="refusing to resume"):
        parameter_sweep(al, BATCH, EXTENT, (4, 4), checkpoint_dir=ckpt, progress=False,
                        kind="flag_quantum_dif", accuracy=0.2)


def test_reduce_fingerprint_reproducible_for_captured_functions():
    ns1, ns2, ns3 = {}, {}, {}
    src = ("def user(m):\n    return m + 1\n"
           "def outer(m, _u=user):\n    return _u(m)\n")
    exec(src, ns1)
    exec(src, ns2)  # the same code, other function objects and addresses
    exec(src.replace("m + 1", "m + 2"), ns3)
    assert _reduce_fingerprint(ns1["outer"]) == _reduce_fingerprint(ns2["outer"])
    assert _reduce_fingerprint(ns1["outer"]) != _reduce_fingerprint(ns3["outer"])


@pytest.mark.parametrize("engine", ["xla", "pallas", "pallas_df64", "pallas_edf64",
                                    "pallas_tf64"])
def test_jax_engine_names_raise(doc, engine):
    _, al = doc
    with pytest.raises(ValueError, match="JAX-package engine.*B7"):
        parameter_sweep(al, BATCH, EXTENT, (4, 4), progress=False, engine=engine)


def test_what_the_port_does_not_take_raises(doc):
    _, al = doc
    with pytest.raises(TypeError, match="make_mesh"):
        parameter_sweep(al, BATCH, EXTENT, (4, 4), progress=False, mesh=object())
    with pytest.raises(ValueError, match='engine="cuda"'):
        parameter_sweep(al, BATCH, EXTENT, (4, 4), progress=False, engine="cuda")
    with pytest.raises(ValueError, match="unknown scan kind"):
        parameter_sweep(al, BATCH, EXTENT, (4, 4), progress=False, kind="nope")
    with pytest.raises(ValueError, match="conflicts"):
        parameter_sweep(al, BATCH, EXTENT, (4, 4), progress=False, dtype=torch.float32,
                        precision="dd")
    with pytest.raises(ValueError, match="args_batch"):
        parameter_sweep(al, BATCH[:, 0], EXTENT, (4, 4), progress=False)
    with pytest.raises(ValueError, match="chunk_size"):
        parameter_sweep(al, BATCH, EXTENT, (4, 4), progress=False, chunk_size=-2)


def test_cuda_device_without_cuda_raises(doc):
    _, al = doc
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GeneralisedAL(al.artifact, device="cuda", validate_basis=False)
    with pytest.raises(RuntimeError):  # no card, no nvcc: no silent plain version
        scan_batch_cuda(al.artifact, "consistency", BATCH, EXTENT, (4, 4), "cuda")
