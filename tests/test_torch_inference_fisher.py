"""The loop-closing physics case of tests/test_inference.py (:92) on the
port, on the CPU: the HMC posterior over the trivial quadratic model's
masses, given (n_s, r) pseudo-data, against the port's own Cramér–Rao
forecast (``inflatox_torch.observables.fisher_matrix``) — the same
likelihood at the same point, two independent computations (forward-mode
Jacobians against MCMC).

The JAX test's tolerances (the mean at atol 5e-3, four standard errors at
σ ≈ 0.05 and N_eff ≳ 2000; the diagonal variance at rtol 0.15; R̂ < 1.02)
and its 12,000 pooled draws after 1000 warmup transitions at 24 leapfrog
steps.  The draws are spread over 24 chains × 500 instead of 4 × 3000:
every chain is a row of one batch, and a batch of 24 costs the CPU about
what one of 4 does, so the same pooled draws take a sixth of the
transitions."""

import numpy as np
import sympy
import torch

import inflatox_torch
from inflatox_torch import inference, observables

CPU = "cpu"
X = np.array([14.0, 6.0])
THETA = np.array([1.0, 0.7])
PRIOR_SIG = 0.05


def test_posterior_matches_fisher_forecast():
    f1, f2 = sympy.symbols("phi_1 phi_2")
    m1, m2 = sympy.symbols("m_1 m_2")
    model = inflatox_torch.InflationModelBuilder.new(
        [f1, f2], [[1, 0], [0, 1]], (m1 * f1) ** 2 + (m2 * f2) ** 2, "trivial", silent=True
    ).build()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    sr = observables.slow_roll(art, device=CPU)(X, THETA)
    data = {"n_s": float(sr["n_s"]), "r": float(sr["r"])}
    sigma = {"n_s": 0.004, "r": 0.01}
    theta_t = torch.tensor(THETA)

    def prior(th):
        return -0.5 * torch.sum(((th - theta_t) / PRIOR_SIG) ** 2)

    logp = inference.observable_log_posterior(art, X, data, sigma, prior=prior, device=CPU)
    out = inference.sample_posterior(
        logp, THETA, num_samples=500, num_warmup=1000,
        num_chains=24, num_leapfrog=24, seed=3, device=CPU,
    )
    s = out["samples"].reshape(-1, 2)
    assert s.shape == (12_000, 2)
    f = observables.fisher_matrix(art, X, THETA, np.array([sigma["n_s"], sigma["r"]]),
                                  device=CPU)
    cov_pred = np.linalg.inv(f + np.eye(2) / PRIOR_SIG**2)
    np.testing.assert_allclose(s.mean(0), THETA, atol=5e-3)
    np.testing.assert_allclose(np.diag(np.cov(s.T)), np.diag(cov_pred), rtol=0.15)
    assert np.all(out["r_hat"] < 1.02)
