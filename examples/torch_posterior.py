"""Bayesian posterior over model parameters with gradient-based MCMC, in PyTorch.

Run with `python examples/torch_posterior.py [--device cuda|cpu]` — the
chains run on the NVIDIA GPU by default; `--device cpu` runs them on the CPU.

The `inflatox_torch` version of examples/posterior.py.  Every observable is
a differentiable torch function of the parameters, so Hamiltonian Monte
Carlo — whose proposals follow ∇log p — samples the actual posterior:

1. generate (n_s, r) "data" from a fiducial two-field quadratic model,
2. build the Gaussian-likelihood log-posterior over the two masses
   (a Gaussian prior pins the overall potential normalization, to which
   all slow-roll observables are exactly blind),
3. sample 4 HMC chains as one batch on the device,
4. check the posterior against the analytic Fisher/Cramér–Rao forecast —
   two independent routes (autodiff Jacobians vs MCMC) to one constraint.
"""

import argparse

try:  # installed wheel, or repo checkout
    import inflatox_torch  # noqa: F401
except ModuleNotFoundError:
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import sympy
import torch

import inflatox_torch as inflatox
from inflatox_torch import inference, observables

PRIOR_SIG = 0.05


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--num-samples", type=int, default=3000, help="draws per chain")
    parser.add_argument("--num-warmup", type=int, default=1000, help="warmup transitions")
    opts = parser.parse_args(argv)
    device = opts.device

    # ---- 1. fiducial model and pseudo-data -------------------------------- #
    f1, f2 = sympy.symbols("phi_1 phi_2")
    m1, m2 = sympy.symbols("m_1 m_2")
    V = (m1 * f1) ** 2 + (m2 * f2) ** 2
    model = inflatox.InflationModelBuilder.new(
        [f1, f2], [[1, 0], [0, 1]], V, silent=True
    ).build()
    artifact = inflatox.Compiler(model, silent=True).compile()

    x_pivot = np.array([14.0, 6.0])          # horizon-exit field point
    theta_true = np.array([1.0, 0.7])        # fiducial masses
    sr = observables.slow_roll(artifact, device)(x_pivot, theta_true)
    data = {"n_s": float(sr["n_s"]), "r": float(sr["r"])}
    sigma = {"n_s": 0.004, "r": 0.01}        # Planck-like uncertainties
    print(f"data: n_s = {data['n_s']:.4f} ± {sigma['n_s']}, "
          f"r = {data['r']:.4f} ± {sigma['r']}")

    # ---- 2. log-posterior -------------------------------------------------- #
    theta_t = torch.tensor(theta_true, device=device)

    def prior(theta):
        # slow-roll observables are invariant under V → λV: without a prior
        # the posterior has an exactly flat direction along (m1, m2) → λ(m1, m2)
        return -0.5 * torch.sum(((theta - theta_t) / PRIOR_SIG) ** 2)

    logp = inference.observable_log_posterior(artifact, x_pivot, data, sigma,
                                              prior=prior, device=device)

    # ---- 3. sample ---------------------------------------------------------- #
    # (pass algorithm="nuts" to let trajectory lengths adapt per transition —
    # preferable when a good fixed num_leapfrog is unknown)
    out = inference.sample_posterior(
        logp, theta_true, num_samples=opts.num_samples, num_warmup=opts.num_warmup,
        num_chains=4, num_leapfrog=24, seed=0, device=device,
    )
    s = out["samples"].reshape(-1, 2)
    print(f"sampled {s.shape[0]} draws on {device}, "
          f"accept = {out['accept_rate'].mean():.2f}, "
          f"R-hat = {out['r_hat'].max():.4f}, min ESS = {out['ess'].min():.0f}")
    print("posterior mean:", np.array2string(s.mean(0), precision=4),
          " (truth:", theta_true, ")")
    print("posterior std :", np.array2string(s.std(0), precision=4))

    # ---- 4. close the loop against the Fisher forecast --------------------- #
    fisher = observables.fisher_matrix(
        artifact, x_pivot, theta_true, np.array([sigma["n_s"], sigma["r"]]),
        device=device,
    )
    cov_pred = np.linalg.inv(fisher + np.eye(2) / PRIOR_SIG**2)
    ratio = np.diag(np.cov(s.T)) / np.diag(cov_pred)
    print("posterior var / Cramér-Rao forecast:",
          np.array2string(ratio, precision=3))
    assert np.all(np.abs(ratio - 1) < 0.2), "posterior disagrees with Fisher"
    print("MCMC posterior matches the autodiff Fisher forecast")


if __name__ == "__main__":
    main()
