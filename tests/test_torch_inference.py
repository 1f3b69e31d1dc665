"""Bayesian inference (``inflatox_torch.inference``) against the JAX
package's ``inflatox_tpu.inference``, on the CPU.

The deterministic pieces are held to the JAX package on the same inputs:
the trivial quadratic model crosses by the shared bundle (the JAX package
saves, the port loads), seeded numpy arrays go through both.  The samplers
cannot reproduce ``jax.random``'s draws, so a transition is held to a plain
numpy leapfrog driven by the JAX package's gradient on the port's own
pre-drawn block, and the samplers themselves to the statistical cases of
tests/test_inference.py with a seeded ``torch.Generator``.  Tolerances,
each with its reason:

* ``observable_log_posterior``'s value and gradient against
  ``jax.value_and_grad``: rtol 1e-12 (the same f64 operations);
* ``r_hat`` and ``effective_sample_size``: bit for bit (the same numpy
  code on the same arrays);
* ``log_evidence_laplace`` on the same samples and density: rtol 1e-12;
* one HMC transition against the numpy leapfrog: positions, log-density
  and acceptance at rtol 1e-12;
* the statistical cases: the JAX tests' own sizes and tolerances.
NUTS is in tests/test_torch_inference_nuts.py, the Fisher forecast in
tests/test_torch_inference_fisher.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inflatox_torch
from inflatox_torch import inference as tinf
from inflatox_tpu import inference as jinf
from inflatox_tpu import observables as job

CPU = "cpu"
X = np.array([14.0, 6.0])
THETA = np.array([1.0, 0.7])
PRIOR_SIG = 0.05
SIGMA = {"n_s": 0.004, "r": 0.01}


@pytest.fixture(scope="module")
def pair(trivial_artifact, tmp_path_factory):
    """(JAX artifact, the port's artifact loaded from its bundle, the (n_s,
    r) pseudo-data of tests/test_inference.py at THETA)."""
    path = str(tmp_path_factory.mktemp("inference_bundle") / "trivial.json")
    trivial_artifact.save(path)
    sr = job.slow_roll(trivial_artifact)(jnp.asarray(X), jnp.asarray(THETA))
    data = {"n_s": float(sr["n_s"]), "r": float(sr["r"])}
    return trivial_artifact, inflatox_torch.CompiledModel.load(path), data


def jax_prior(th):
    return -0.5 * jnp.sum(((th - THETA) / PRIOR_SIG) ** 2)


def torch_prior(th):
    return -0.5 * torch.sum(((th - torch.tensor(THETA)) / PRIOR_SIG) ** 2)


def posteriors(pair, with_prior=True):
    """The JAX package's ``value_and_grad`` of its log-posterior and the
    port's log-posterior, on the same model, data and prior."""
    jart, art, data = pair
    jl = jinf.observable_log_posterior(jart, X, data, SIGMA,
                                       prior=jax_prior if with_prior else None)
    tl = tinf.observable_log_posterior(art, X, data, SIGMA,
                                       prior=torch_prior if with_prior else None, device=CPU)
    return jax.jit(jax.value_and_grad(jl)), tl


def correlated_gaussian():
    cov = np.array([[1.0, 0.6, 0.0], [0.6, 2.0, 0.3], [0.0, 0.3, 0.5]])
    prec = torch.tensor(np.linalg.inv(cov))
    mean = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)

    def logp(q):
        r = q - mean
        return -0.5 * r @ prec @ r

    return cov, mean.numpy(), logp


# ----------------------------------------------------------------------- #
# against the JAX package                                                  #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("with_prior", [False, True], ids=["flat", "prior"])
def test_log_posterior_value_and_gradient_match_jax(pair, with_prior):
    jvg, tl = posteriors(pair, with_prior)
    rng = np.random.default_rng(11)
    for theta in THETA + rng.normal(0.0, 0.05, (3, 2)):
        value, grad = jvg(jnp.asarray(theta))
        th = torch.tensor(theta, requires_grad=True)
        lp = tl(th)
        (g,) = torch.autograd.grad(lp, th)
        assert lp.dtype == torch.float64 and lp.shape == ()
        np.testing.assert_allclose(lp.item(), float(value), rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), np.asarray(grad), rtol=1e-12)


def test_batched_density_equals_each_chain(pair):
    """The chains' batch under ``vmap`` gives each chain's own value and
    gradient."""
    _, tl = posteriors(pair)
    density = tinf._Density(tl)
    q = torch.tensor(THETA + np.random.default_rng(3).normal(0.0, 0.05, (5, 2)))
    lp, g = density(q)
    assert density.route == "vmap"
    for c in range(5):
        th = q[c].clone().requires_grad_(True)
        one = tl(th)
        np.testing.assert_allclose(lp[c].item(), one.item(), rtol=1e-12)
        np.testing.assert_allclose(g[c].numpy(), torch.autograd.grad(one, th)[0].numpy(),
                                   rtol=1e-12)


def test_density_falls_back_chain_by_chain():
    """A density with a loop on data cannot run under ``vmap``: it runs
    chain by chain, with the same values; an error chain by chain raises."""
    def logp(q):
        total = -0.5 * torch.sum(q * q)
        while total < -10.0:  # data-dependent control flow
            total = total / 2.0
        return total

    density = tinf._Density(logp)
    q = torch.tensor([[0.5, -1.0], [3.0, 4.0]], dtype=torch.float64)
    lp, g = density(q)
    assert density.route == "chain by chain"
    np.testing.assert_allclose(lp.numpy(), [-0.625, -6.25], rtol=1e-15)
    np.testing.assert_allclose(g.numpy(), [[-0.5, 1.0], [-1.5, -2.0]], rtol=1e-15)

    def broken(q):
        raise RuntimeError("broken density")

    with pytest.raises(RuntimeError, match="broken density"):
        tinf._Density(broken)(q)


def _diagnostic_arrays():
    rng = np.random.default_rng(17)
    a = rng.normal(size=(4, 400, 3))
    a[:, :, 1] += 0.3 * np.arange(4)[:, None]  # one parameter poorly mixed
    b = np.cumsum(rng.normal(size=(3, 257, 2)), axis=1)  # strongly correlated
    b[:, :, 1] = 2.5  # a constant parameter: NaN ESS and R-hat
    return a, b


@pytest.mark.parametrize("which", [0, 1], ids=["4x400x3", "3x257x2"])
def test_diagnostics_bit_for_bit(which):
    s = _diagnostic_arrays()[which]
    np.testing.assert_array_equal(tinf.r_hat(s), jinf.r_hat(s))
    np.testing.assert_array_equal(tinf.effective_sample_size(s),
                                  jinf.effective_sample_size(s))
    if which == 1:
        assert np.isnan(tinf.effective_sample_size(s)[1])


def test_log_evidence_laplace_matches_jax(pair):
    jart, art, data = pair
    jl = jinf.observable_log_posterior(jart, X, data, SIGMA, prior=jax_prior)
    _, tl = posteriors(pair)
    rng = np.random.default_rng(23)
    cov = np.array([[2.4e-3, 6e-5], [6e-5, 2.4e-3]])
    samples = rng.multivariate_normal(THETA, cov, size=(4, 300))
    got = tinf.log_evidence_laplace(tl, samples, device=CPU)
    np.testing.assert_allclose(got, jinf.log_evidence_laplace(jl, samples), rtol=1e-12)


def test_hmc_transition_matches_a_numpy_leapfrog_on_jax(pair):
    """One HMC transition from a pre-drawn block against a plain numpy
    leapfrog driven by the JAX package's ``value_and_grad``."""
    jvg, tl = posteriors(pair)
    chains, steps, eps = 4, 24, 0.3
    inv_mass = np.array([2.4e-3, 2.5e-3])
    gen = torch.Generator().manual_seed(5)
    draws = tinf._hmc_draws(gen, chains, 2, steps, CPU)
    q0 = THETA + np.random.default_rng(5).normal(0.0, 0.05, (chains, 2))
    density = tinf._Density(tl)
    lp0, g0 = density(torch.tensor(q0))
    q, lp, g, acc, n = tinf._hmc_kernel(density, steps)(
        torch.tensor(q0), lp0, g0, draws, torch.tensor(eps, dtype=torch.float64),
        torch.tensor(inv_mass))

    z, n_steps, u = (t.numpy() for t in draws)
    np.testing.assert_array_equal(n.numpy(), n_steps)
    assert n_steps.min() >= steps // 2 and n_steps.max() <= steps
    for c in range(chains):
        lp_c, g_c = (np.asarray(v) for v in jvg(jnp.asarray(q0[c])))
        p = z[c] / np.sqrt(inv_mass)
        h_old = -lp_c + 0.5 * np.sum(inv_mass * p * p)
        qc, pc = q0[c], p + 0.5 * eps * g_c
        for _ in range(n_steps[c] - 1):
            qc = qc + eps * inv_mass * pc
            pc = pc + eps * np.asarray(jvg(jnp.asarray(qc))[1])
        qc = qc + eps * inv_mass * pc
        lp_new, g_new = (np.asarray(v) for v in jvg(jnp.asarray(qc)))
        pc = pc + 0.5 * eps * g_new
        h_new = -lp_new + 0.5 * np.sum(inv_mass * pc * pc)
        log_accept = min(0.0, h_old - h_new) if np.isfinite(h_new) else -np.inf
        accept = np.log(u[c]) < log_accept
        np.testing.assert_allclose(acc[c].item(), np.exp(log_accept), rtol=1e-12)
        np.testing.assert_allclose(q[c].numpy(), qc if accept else q0[c], rtol=1e-12)
        np.testing.assert_allclose(lp[c].item(), lp_new if accept else lp_c, rtol=1e-12)
        np.testing.assert_allclose(g[c].numpy(), g_new if accept else g_c, rtol=1e-12)


# ----------------------------------------------------------------------- #
# the statistical cases of tests/test_inference.py                         #
# ----------------------------------------------------------------------- #


def test_hmc_recovers_correlated_gaussian():
    cov, mean, logp = correlated_gaussian()
    out = tinf.sample_posterior(
        logp, np.zeros(3), num_samples=2000, num_warmup=800,
        num_chains=4, num_leapfrog=24, seed=1, device=CPU,
    )
    s = out["samples"].reshape(-1, 3)
    np.testing.assert_allclose(s.mean(0), mean, atol=0.08)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.25)
    assert np.all(out["r_hat"] < 1.02)
    assert np.all(out["ess"] > 200)
    assert out["accept_rate"].mean() > 0.6


def test_inference_error_paths(pair):
    _, art, _ = pair
    with pytest.raises(ValueError, match="sigma missing"):
        tinf.observable_log_posterior(art, X, {"n_s": 0.96}, {}, device=CPU)
    with pytest.raises(ValueError, match="target_accept"):
        tinf.sample_posterior(lambda q: -q @ q, np.zeros(2), target_accept=1.5,
                              device=CPU)
    with pytest.raises(ValueError, match="num_chains"):
        tinf.sample_posterior(
            lambda q: -q @ q, np.zeros((3, 2)), num_chains=4,
            num_samples=10, num_warmup=10, device=CPU,
        )


def test_log_evidence_laplace_exact_on_gaussian():
    """For a Gaussian likelihood N(data; θ, σ²) with prior N(θ; 0, τ²)
    the evidence is the closed-form convolution N(data; 0, σ² + τ²) —
    Laplace is exact there, so the sampled estimate must land on it."""
    data, sig, tau = 0.7, 0.3, 1.5

    def logp(q):
        return (
            -0.5 * ((data - q[0]) / sig) ** 2
            - np.log(sig * np.sqrt(2 * np.pi))
            - 0.5 * (q[0] / tau) ** 2
            - np.log(tau * np.sqrt(2 * np.pi))
        )

    out = tinf.sample_posterior(
        logp, np.zeros(1), num_samples=4000, num_warmup=600,
        num_chains=4, num_leapfrog=8, seed=5, device=CPU,
    )
    ln_z = tinf.log_evidence_laplace(logp, out["samples"], device=CPU)
    v = sig**2 + tau**2
    ln_z_exact = -0.5 * data**2 / v - 0.5 * np.log(2 * np.pi * v)
    np.testing.assert_allclose(ln_z, ln_z_exact, atol=0.02)
    with pytest.raises(ValueError, match="positive definite"):
        tinf.log_evidence_laplace(logp, np.zeros((2, 10, 1)), device=CPU)


def test_diagnostics_shapes():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4, 400, 3))
    rh = tinf.r_hat(s)
    ess = tinf.effective_sample_size(s)
    assert rh.shape == (3,) and np.all(rh < 1.05)
    # independent draws: ESS ≈ the sample count
    assert np.all(ess > 0.5 * 4 * 400)


# ----------------------------------------------------------------------- #
# the port's own cases                                                     #
# ----------------------------------------------------------------------- #


def test_mesh_raises_and_names_the_multi_device_slice():
    with pytest.raises(TypeError, match="make_mesh"):
        tinf.sample_posterior(lambda q: -q @ q, np.zeros(2), num_samples=10,
                              num_warmup=10, mesh=object(), device=CPU)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the error is for a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.sample_posterior(lambda q: -q @ q, np.zeros(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.log_evidence_laplace(lambda q: -q @ q, np.arange(4.0).reshape(1, 4, 1))


def test_same_seed_same_samples():
    _, _, logp = correlated_gaussian()
    kw = dict(num_samples=60, num_warmup=40, num_chains=3, num_leapfrog=8, device=CPU)
    runs = [tinf.sample_posterior(logp, np.zeros(3), seed=s, **kw) for s in (9, 9, 10)]
    assert runs[0]["samples"].shape == (3, 60, 3) and runs[0]["log_prob"].shape == (3, 60)
    for key in ("samples", "log_prob", "accept_rate", "inv_mass", "r_hat", "ess"):
        np.testing.assert_array_equal(runs[0][key], runs[1][key])
    assert runs[0]["step_size"] == runs[1]["step_size"]
    assert not np.array_equal(runs[0]["samples"], runs[2]["samples"])

