"""The No-U-Turn sampler of ``inflatox_torch.inference`` on the CPU.

The statistical cases of tests/test_inference.py (:44, :67, :86) with a
seeded ``torch.Generator``, at the JAX tests' sizes and tolerances; and the
batched transitions' own contract: given its pre-drawn block a transition is
a deterministic function of the state, and the chains of one batch, which
stop at different depths, each give what they give alone (positions,
log-density, gradient and acceptance at rtol 1e-12, leaf counts exactly).
The HMC transition is held to the same contract."""

import numpy as np
import pytest
import torch

from inflatox_torch import inference as tinf

CPU = "cpu"
COV = np.array([[1.0, 0.6, 0.0], [0.6, 2.0, 0.3], [0.0, 0.3, 0.5]])
MEAN = np.array([1.0, -2.0, 0.5])


def correlated_gaussian(q):
    r = q - torch.tensor(MEAN)
    return -0.5 * r @ torch.tensor(np.linalg.inv(COV)) @ r


def test_nuts_recovers_correlated_gaussian():
    """The NUTS kernel must reproduce the same correlated Gaussian as HMC —
    same target, adaptive trajectory lengths."""
    out = tinf.sample_posterior(
        correlated_gaussian, np.zeros(3), num_samples=1500, num_warmup=600,
        num_chains=4, seed=2, algorithm="nuts", max_tree_depth=7, device=CPU,
    )
    s = out["samples"].reshape(-1, 3)
    np.testing.assert_allclose(s.mean(0), MEAN, atol=0.08)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.25)
    assert np.all(out["r_hat"] < 1.02)
    assert np.all(out["ess"] > 200)
    assert out["accept_rate"].mean() > 0.5


def test_nuts_handles_anisotropic_scales():
    """A 100:1 scale ratio: NUTS's adaptive trajectory length + the warmup
    mass matrix must still mix every direction."""
    sig = torch.tensor([10.0, 0.1], dtype=torch.float64)

    def logp(q):
        return -0.5 * torch.sum((q / sig) ** 2)

    out = tinf.sample_posterior(
        logp, np.array([1.0, 0.1]), num_samples=1500, num_warmup=600,
        num_chains=4, seed=4, algorithm="nuts", max_tree_depth=8, device=CPU,
    )
    s = out["samples"].reshape(-1, 2)
    np.testing.assert_allclose(s.std(0), sig.numpy(), rtol=0.15)
    assert np.all(out["r_hat"] < 1.05)
    assert np.all(out["ess"] > 150)


def test_nuts_bad_algorithm_raises():
    with pytest.raises(ValueError, match="algorithm"):
        tinf.sample_posterior(lambda q: -q @ q, np.zeros(2), algorithm="mala",
                              device=CPU)


# ----------------------------------------------------------------------- #
# one transition from a pre-drawn block                                    #
# ----------------------------------------------------------------------- #

CHAINS, DEPTH, STEPS = 6, 6, 12


def transition(algorithm, rows=slice(None), seed=7):
    """One transition of the chains ``rows`` of a seeded batch: the start,
    the block of draws and the step all made for the whole batch, then the
    rows taken, so that a chain alone sees its own row of the same draws."""
    density = tinf._Density(correlated_gaussian)
    gen = torch.Generator().manual_seed(seed)
    if algorithm == "nuts":
        kernel = tinf._nuts_kernel(density, DEPTH)
        draws = tinf._nuts_draws(gen, CHAINS, 3, DEPTH, CPU)
    else:
        kernel = tinf._hmc_kernel(density, STEPS)
        draws = tinf._hmc_draws(gen, CHAINS, 3, STEPS, CPU)
    # starts from the mode to far out in its tails: trajectories of
    # different lengths
    rng = np.random.default_rng(seed)
    q = torch.tensor(MEAN + rng.normal(size=(CHAINS, 3)) * np.linspace(0.1, 4.0, CHAINS)[:, None])
    q = q[rows]
    lp, g = density(q)
    eps = torch.tensor(0.35, dtype=torch.float64)
    inv_mass = torch.tensor([1.0, 1.5, 0.6], dtype=torch.float64)
    return kernel(q, lp, g, tuple(d[rows] for d in draws), eps, inv_mass)


@pytest.mark.parametrize("algorithm", ["nuts", "hmc"])
def test_transition_is_deterministic_given_its_draws(algorithm):
    first, second = transition(algorithm), transition(algorithm)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algorithm", ["nuts", "hmc"])
def test_each_chain_of_a_batch_gives_what_it_gives_alone(algorithm):
    q, lp, g, acc, evaluations = transition(algorithm)
    # the chains' trajectories end at different lengths in the one batch
    assert len(set(evaluations.tolist())) > 2, evaluations
    if algorithm == "nuts":
        assert (evaluations < 2**DEPTH - 1).any()
    for c in range(CHAINS):
        alone = transition(algorithm, slice(c, c + 1))
        for got, want in zip((q, lp, g, acc), alone[:4]):
            np.testing.assert_allclose(got[c].numpy(), want[0].numpy(), rtol=1e-12, atol=1e-14)
        assert evaluations[c] == alone[4][0]
