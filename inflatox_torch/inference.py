"""Gradient-based Bayesian inference over model parameters.

The port of ``inflatox_tpu/inference.py``.  Every observable of
:mod:`~inflatox_torch.observables` is a torch function of the parameters,
differentiable under autograd, so Hamiltonian Monte Carlo — whose proposals
follow ∇log p — samples the posterior directly, with every chain a row of
one batch on the device.

Pieces:

* :func:`observable_log_posterior` — a Gaussian-likelihood log-posterior
  over parameters from the slow-roll observables, with an optional
  differentiable prior.
* :func:`sample_posterior` — adaptive HMC (or NUTS): leapfrog proposals
  with a dual-averaging step size (Hoffman & Gelman 2014 schedule, target
  accept 0.8) and a diagonal mass matrix estimated in the second half of
  the first warmup window.  The chains are the leading dimension of every
  state tensor; the density is evaluated for all of them at once under
  ``torch.func.vmap`` (chain by chain where it cannot run under ``vmap``)
  and differentiated through the chains' sum.  Returns samples plus
  convergence diagnostics (acceptance rate, split-R̂, effective sample
  size).
* :func:`log_evidence_laplace` — the Laplace-approximation evidence.
* :func:`r_hat` / :func:`effective_sample_size` — the standard split-R̂ and
  initial-positive-sequence autocorrelation ESS, host-side numpy.

Random numbers come from one ``torch.Generator`` on the chains' device,
seeded by ``seed``, in a block of fixed size per transition (the momenta,
then the leapfrog count and acceptance uniform for HMC; the directions, the
merge uniforms and one uniform a leaf for NUTS).  Given its block, a
transition is a deterministic function of the state, so one transition on
the card and on the CPU can be held to each other.  The draws are not
``jax.random``'s: the samplers agree with the JAX package in distribution,
not draw for draw.

HMC needs an everywhere-differentiable log-density: sample bounded or
positive parameters in an unconstrained space (e.g. log-space) and fold
the Jacobian into the prior.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .observables import slow_roll
from .parallel.mesh import check_mesh_device, gather_shards, launch_shards
from .utils.devices import resolve_device
from .utils.logging import log_warn

__all__ = [
    "observable_log_posterior",
    "sample_posterior",
    "log_evidence_laplace",
    "r_hat",
    "effective_sample_size",
]

_F64 = torch.float64


def observable_log_posterior(
    artifact,
    x,
    data: dict,
    sigma: dict,
    prior: Callable | None = None,
    device="cuda",
) -> Callable:
    """Gaussian-likelihood log-posterior over parameters at a field point.

    ``data``/``sigma`` map observable names (keys of
    :func:`~inflatox_torch.observables.slow_roll`: ``epsilon_v``, ``eta_v``,
    ``n_s``, ``r``) to measured values and uncertainties; the returned
    ``logp(theta)`` is ``−½ Σ ((obs_k(x, θ) − data_k)/σ_k)²`` plus
    ``prior(theta)`` (any differentiable log-prior in torch operations;
    omit for improper flat).  ``logp`` takes a (k,) float64 tensor on
    ``device`` and returns a 0-d float64 tensor that autograd
    differentiates; it runs under ``torch.func.vmap`` — feed it to
    :func:`sample_posterior` with the same ``device``.
    """
    fn = slow_roll(artifact, device)
    keys = tuple(data.keys())
    missing = [k for k in keys if k not in sigma]
    if missing:
        raise ValueError(f"sigma missing entries for {missing}")
    device = resolve_device(device)
    x = torch.as_tensor(x, dtype=_F64, device=device)
    d_vec = torch.tensor([float(data[k]) for k in keys], dtype=_F64, device=device)
    s_vec = torch.tensor([float(sigma[k]) for k in keys], dtype=_F64, device=device)

    def logp(theta):
        sr = fn(x, theta)
        vals = torch.stack([sr[k] for k in keys])
        ll = -0.5 * torch.sum(((vals - d_vec) / s_vec) ** 2)
        return ll + (prior(theta) if prior is not None else 0.0)

    return logp


# ----------------------------------------------------------------------- #
# the density over a batch of chains                                       #
# ----------------------------------------------------------------------- #


class _Density:
    """``logp`` of one (d,) parameter vector, evaluated with its gradient
    for a (chains, d) batch: ``density(q) -> (logp (chains,), ∇logp
    (chains, d))``, both detached.

    The chains run under ``torch.func.vmap``, and the gradient is that of
    the chains' sum (each chain's value depends on its own row only).  A
    density whose code cannot run under ``vmap`` (a loop on data, as the
    special functions have) is evaluated chain by chain on the same device
    from its first failure on; an error that chain by chain also raises
    propagates.  ``route`` names the route that ran last."""

    def __init__(self, logp: Callable):
        self.logp = logp
        self.route = "vmap"

    def __call__(self, q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = None
            if self.route == "vmap":
                try:
                    lp = torch.func.vmap(self.logp)(q)
                except RuntimeError:
                    self.route = "chain by chain"
            if lp is None:
                lp = torch.stack([self.logp(q[c]) for c in range(q.shape[0])])
            (g,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), g


def _col(mask):
    """A (chains,) mask or value broadcast over the parameter axis."""
    return mask[:, None]


# ----------------------------------------------------------------------- #
# adaptive HMC                                                             #
# ----------------------------------------------------------------------- #


def _hmc_draws(gen, chains: int, d: int, steps: int, device) -> tuple:
    """One HMC transition's random numbers: standard-normal momenta
    (chains, d), the leapfrog count (chains,) uniform in [⌈steps/2⌉,
    steps], and the acceptance uniform (chains,)."""
    z = torch.randn((chains, d), generator=gen, dtype=_F64, device=device)
    n = torch.randint(max(1, (int(steps) + 1) // 2), int(steps) + 1, (chains,),
                      generator=gen, device=device)
    u = torch.rand((chains,), generator=gen, dtype=_F64, device=device)
    return z, n, u


def _hmc_kernel(density, steps):
    """One HMC transition for every chain: ``kernel(q, lp, g, draws, eps,
    inv_mass) -> (q, lp, g, accept_stat, n_steps)``, ``draws`` from
    :func:`_hmc_draws`.

    The chain state carries ∇logp(q), so a transition of L leapfrog steps
    costs exactly L gradient evaluations (adjacent half-kicks fused into
    full kicks; the final half-kick's evaluation supplies both the
    acceptance logp and the next state's gradient — the naive
    half-kick/half-kick loop costs 2L+1).

    The leapfrog count is jittered uniformly in [⌈steps/2⌉, steps] per
    chain and transition — fixed-length HMC resonates on near-Gaussian
    targets (after mass adaptation a harmonic mode rotates ~ε per step, so
    a fixed ε·L near a multiple of 2π barely moves).  The batch runs
    ``steps`` evaluations; a chain whose count is spent is frozen (its
    position evaluated again, its state kept), so no count is read on the
    host."""
    steps = int(steps)

    def kernel(q, lp, g, draws, eps, inv_mass):
        z, n_steps, u = draws
        p = z / torch.sqrt(inv_mass)
        h_old = -lp + 0.5 * torch.sum(inv_mass * p * p, dim=-1)

        q_new = q
        p_new = p + 0.5 * eps * g
        for k in range(steps - 1):
            live = _col(k < n_steps - 1)
            q_new = torch.where(live, q_new + eps * inv_mass * p_new, q_new)
            p_new = torch.where(live, p_new + eps * density(q_new)[1], p_new)
        q_new = q_new + eps * inv_mass * p_new
        lp_new, g_new = density(q_new)
        p_new = p_new + 0.5 * eps * g_new

        h_new = -lp_new + 0.5 * torch.sum(inv_mass * p_new * p_new, dim=-1)
        # NaN-safe: a diverged trajectory is always rejected
        log_accept = torch.where(torch.isfinite(h_new),
                                 torch.clamp(h_old - h_new, max=0.0), -math.inf)
        accept = torch.log(u) < log_accept
        q = torch.where(_col(accept), q_new, q)
        lp = torch.where(accept, lp_new, lp)
        g = torch.where(_col(accept), g_new, g)
        return q, lp, g, torch.exp(log_accept), n_steps

    return kernel


# ----------------------------------------------------------------------- #
# No-U-Turn                                                                #
# ----------------------------------------------------------------------- #


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _trailing_ones(x: int) -> int:
    n = 0
    while x & 1:
        x >>= 1
        n += 1
    return n


def _nuts_draws(gen, chains: int, d: int, max_depth: int, device) -> tuple:
    """One NUTS transition's random numbers: standard-normal momenta
    (chains, d), a direction ±1 and a merge uniform per doubling (chains,
    max_depth), and a uniform per leaf (chains, 2^max_depth)."""
    z = torch.randn((chains, d), generator=gen, dtype=_F64, device=device)
    dirs = torch.rand((chains, max_depth), generator=gen, dtype=_F64, device=device)
    dirs = torch.where(dirs < 0.5, 1.0, -1.0).to(_F64)
    merge = torch.rand((chains, max_depth), generator=gen, dtype=_F64, device=device)
    leaf = torch.rand((chains, 1 << max_depth), generator=gen, dtype=_F64, device=device)
    return z, dirs, merge, leaf


def _nuts_kernel(density, max_depth=8, max_delta_energy=1000.0):
    """One No-U-Turn transition for every chain with the state contract of
    :func:`_hmc_kernel`: ``kernel(q, lp, g, draws, eps, inv_mass) -> (q,
    lp, g, accept_stat, n_leaf)``, ``draws`` from :func:`_nuts_draws`.

    Iterative multinomial NUTS (Hoffman & Gelman 2014 termination;
    Betancourt 2017 multinomial leaf sampling; the iterative subtree
    U-turn bookkeeping of Phan & Pradhan's numpyro formulation, which
    needs only a ``max_depth``-deep checkpoint stack instead of
    recursion): the trajectory doubles in a random direction until a
    sub- or whole-trajectory U-turn or a divergence; the proposal is drawn
    ∝ exp(−ΔH) progressively within subtrees and biased-progressively
    across doublings.  Per transition ≤ 2^max_depth − 1 gradient
    evaluations; accept_stat is the trajectory-mean min(1, e^{−ΔH}),
    which feeds the same dual-averaging schedule as HMC.

    The chains run in lockstep.  A chain still going at doubling j has
    taken 2^j − 1 leaves before it, so every live chain is at the same
    leaf of the same subtree: the leaf index, its checkpoint slots and its
    uniform are shared, and a chain that has turned, diverged or finished
    is frozen by masks (its position at the transition's start evaluated
    in its place).  The one host read is whether any chain is still going,
    once a doubling."""
    max_depth = int(max_depth)

    def kernel(q, lp, g, draws, eps, inv_mass):
        z, dirs, u_merge, u_leaf = draws
        chains, d = q.shape
        p0 = z / torch.sqrt(inv_mass)

        def ke(p):
            return 0.5 * torch.sum(inv_mass * p * p, dim=-1)

        def uturn(dq, p_a, p_b):
            return (torch.sum(dq * inv_mass * p_a, dim=-1) < 0.0) | (
                torch.sum(dq * inv_mass * p_b, dim=-1) < 0.0)

        h0 = -lp + ke(p0)
        # trajectory edges (physical left/right), current proposal, total
        # multinomial log-weight, flags, accept-stat sums
        ql, pl, gl, lpl = q, p0, g, lp
        qr, pr, gr, lpr = q, p0, g, lp
        qp, lpp, gp = q, lp, g
        log_w = torch.zeros_like(lp)
        s_acc = torch.zeros_like(lp)
        n_leaf = torch.zeros(chains, dtype=torch.int64, device=q.device)
        turning = torch.zeros(chains, dtype=torch.bool, device=q.device)
        diverged = torch.zeros_like(turning)

        for depth in range(max_depth):
            alive = ~turning & ~diverged
            if not bool(alive.any()):
                break
            dirn = dirs[:, depth]
            right = dirn > 0
            qq = torch.where(_col(right), qr, ql)
            pp = torch.where(_col(right), pr, pl)
            gg = torch.where(_col(right), gr, gl)
            llp = torch.where(right, lpr, lpl)
            e = _col(eps * dirn)

            # ---- build one subtree of 2^depth leaves --------------------- #
            qsp, lpsp, gsp = qq, llp, gg
            lws = torch.full_like(lp, -math.inf)
            sacc = torch.zeros_like(lp)
            s_turn = torch.zeros_like(turning)
            s_div = torch.zeros_like(turning)
            cq = q.new_zeros((chains, max_depth + 1, d))
            cp = q.new_zeros((chains, max_depth + 1, d))
            live = alive
            first = (1 << depth) - 1  # leaves every live chain took before
            for i in range(1 << depth):
                p1 = pp + 0.5 * e * gg
                q1 = qq + e * inv_mass * p1
                lp1, g1 = density(torch.where(_col(live), q1, q))
                p1 = p1 + 0.5 * e * g1
                de = -lp1 + ke(p1) - h0
                div = ~torch.isfinite(de) | (de > max_delta_energy)
                lw_leaf = torch.where(div, -math.inf, -de)
                new_tot = torch.logaddexp(lws, lw_leaf)
                take = live & (torch.log(u_leaf[:, first + i]) < lw_leaf - new_tot)
                qsp = torch.where(_col(take), q1, qsp)
                lpsp = torch.where(take, lp1, lpsp)
                gsp = torch.where(_col(take), g1, gsp)
                sacc = sacc + torch.where(live & torch.isfinite(de),
                                          torch.clamp(torch.exp(-de), max=1.0), 0.0)
                n_leaf = n_leaf + live
                lws = torch.where(live, new_tot, lws)
                qq = torch.where(_col(live), q1, qq)
                pp = torch.where(_col(live), p1, pp)
                gg = torch.where(_col(live), g1, gg)
                llp = torch.where(live, lp1, llp)
                # checkpoint stack (numpyro's leaf→slot map): even leaves
                # push their state at slot popcount(i >> 1); odd leaves
                # U-turn-check against slots [idx_max − trailing_ones(i)
                # + 1, idx_max]
                idx_max = _popcount(i >> 1)
                if i & 1 == 0:
                    cq[:, idx_max] = torch.where(_col(live), q1, cq[:, idx_max])
                    cp[:, idx_max] = torch.where(_col(live), p1, cp[:, idx_max])
                    turn = torch.zeros_like(live)
                else:
                    slots = slice(idx_max - _trailing_ones(i) + 1, idx_max + 1)
                    dq = dirn[:, None, None] * (q1[:, None] - cq[:, slots])
                    turn = uturn(dq, cp[:, slots], p1[:, None]).any(dim=-1)
                s_turn = s_turn | (live & turn)
                s_div = s_div | (live & div)
                live = live & ~turn & ~div

            # ---- merge the subtree into the trajectory ------------------ #
            ok = alive & ~s_turn & ~s_div
            # biased progressive: take the subtree's proposal with
            # probability min(1, W_sub / W_total)
            take = ok & (torch.log(u_merge[:, depth]) < lws - log_w)
            qp = torch.where(_col(take), qsp, qp)
            lpp = torch.where(take, lpsp, lpp)
            gp = torch.where(_col(take), gsp, gp)
            log_w = torch.where(ok, torch.logaddexp(log_w, lws), log_w)
            # advance the grown edge (only meaningful when the subtree
            # completed; a turning/diverged subtree ends the trajectory)
            grow_r = _col(ok & right)
            grow_l = _col(ok & ~right)
            qr = torch.where(grow_r, qq, qr)
            pr = torch.where(grow_r, pp, pr)
            gr = torch.where(grow_r, gg, gr)
            lpr = torch.where(grow_r[:, 0], llp, lpr)
            ql = torch.where(grow_l, qq, ql)
            pl = torch.where(grow_l, pp, pl)
            gl = torch.where(grow_l, gg, gl)
            lpl = torch.where(grow_l[:, 0], llp, lpl)
            whole_turn = ok & uturn(qr - ql, pl, pr)
            turning = turning | (alive & (s_turn | whole_turn))
            diverged = diverged | s_div
            s_acc = s_acc + sacc

        accept_stat = s_acc / torch.clamp(n_leaf, min=1)
        return qp, lpp, gp, accept_stat, n_leaf

    return kernel


# ----------------------------------------------------------------------- #
# the sampler                                                              #
# ----------------------------------------------------------------------- #


def _chains_over(mesh, kernel, chains):
    """``kernel`` (a transition of :func:`_hmc_kernel`'s contract) with the
    chains split over every slot of ``mesh``: slot i runs the transition on
    its block of chains (and of the random block) on its device, and the
    blocks are joined on the mesh's first device."""
    slots = mesh.all_slots()
    if chains % len(slots):
        raise ValueError(
            f"num_chains = {chains} must be a multiple of the mesh size {len(slots)}"
        )
    per = chains // len(slots)

    def sharded(q, lp, g, draws, eps, inv_mass):
        def launch(i, device):
            sl = slice(i * per, (i + 1) * per)
            return kernel(q[sl].to(device), lp[sl].to(device), g[sl].to(device),
                          tuple(x[sl].to(device) for x in draws), eps.to(device),
                          inv_mass.to(device))

        return gather_shards(mesh, launch_shards(mesh, slots, launch, False))

    return sharded


def sample_posterior(
    logp: Callable,
    x0,
    *,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_chains: int = 4,
    num_leapfrog: int = 32,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    jitter: float = 0.01,
    seed: int = 0,
    mesh=None,
    algorithm: str = "hmc",
    max_tree_depth: int = 8,
    device="cuda",
) -> dict:
    """Adaptive Hamiltonian Monte Carlo over a differentiable log-density.

    ``logp(theta)`` must be a scalar function of a ``(d,)`` float64 tensor
    on ``device``, differentiable under autograd
    (:func:`observable_log_posterior` builds one from measured observables;
    any hand-written density in torch operations works).  ``x0`` ((d,) or
    (num_chains, d)) seeds the chains; with one row, chains start at
    ``x0`` plus N(0, ``jitter``²) scatter.

    Warmup (``num_warmup`` transitions total, split 3:1) adapts the step
    size by dual averaging (Hoffman & Gelman 2014, target acceptance
    ``target_accept``) under unit mass, estimates a diagonal mass matrix
    (inverse posterior variances) from that window's second half, then
    re-adapts the step size under the estimated mass.  A transition of L
    jittered leapfrog steps costs L gradient evaluations (the state
    carries ∇logp); all chains run as one batch on ``device`` (``"cuda"``
    by default; on a host without CUDA that raises — pass ``"cpu"``), the
    adaptation state stays there, and the draws come back to numpy once,
    at the end.  ``seed`` seeds the one ``torch.Generator`` of the run.

    ``mesh=`` (a :func:`~inflatox_torch.parallel.make_mesh` mesh, whose
    devices take the place of ``device``, which must name their type)
    splits the chains over every slot of the mesh: ``num_chains`` must be a
    multiple of the mesh size.  Each transition's random block is still
    drawn once, for all chains, from the one generator on the mesh's first
    device, and its rows go to the slots; each slot runs the transition on
    its chains on its device, and the chains come back to the first device,
    where dual averaging takes their mean in the unsharded order.  So for
    the same ``seed`` a sharded run gives the unsharded draws.

    ``algorithm="nuts"`` swaps the fixed-length kernel for the No-U-Turn
    sampler (:func:`_nuts_kernel`): trajectory lengths adapt per
    transition up to ``max_tree_depth`` doublings, ``num_leapfrog`` is
    ignored, and the same dual-averaging/mass-adaptation machinery drives
    the step size off the trajectory-mean acceptance statistic.

    Returns ``{"samples" (num_chains, num_samples, d), "log_prob"
    (num_chains, num_samples), "accept_rate" (num_chains,), "step_size",
    "inv_mass" (d,), "r_hat" (d,), "ess" (d,)}`` — numpy.  A warning is
    logged when split-R̂ exceeds 1.05 or the acceptance rate collapses.
    """
    if not 0.0 < target_accept < 1.0:
        raise ValueError(f"target_accept must be in (0, 1), got {target_accept}")
    device = resolve_device(device) if mesh is None else check_mesh_device(mesh, device).home
    x0 = torch.atleast_2d(torch.as_tensor(x0, dtype=_F64, device=device))
    d = x0.shape[-1]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if x0.shape[0] == 1 and num_chains > 1:
        x0 = x0 + float(jitter) * torch.randn((num_chains, d), generator=gen,
                                              dtype=_F64, device=device)
    elif x0.shape[0] != num_chains:
        raise ValueError(
            f"x0 has {x0.shape[0]} rows but num_chains = {num_chains} — "
            "pass one row (auto-jittered) or one per chain"
        )
    chains = x0.shape[0]

    density = _Density(logp)
    if algorithm == "nuts":
        depth = int(max_tree_depth)
        kernel = _nuts_kernel(density, depth)

        def draws():
            return _nuts_draws(gen, chains, d, depth, device)
    elif algorithm == "hmc":
        kernel = _hmc_kernel(density, int(num_leapfrog))

        def draws():
            return _hmc_draws(gen, chains, d, int(num_leapfrog), device)
    else:
        raise ValueError(
            f'algorithm must be "hmc" or "nuts", got {algorithm!r}')
    if mesh is not None:
        kernel = _chains_over(mesh, kernel, chains)

    # dual-averaging constants (Hoffman & Gelman 2014, §3.2); warmup budget
    # splits 3:1 between the unit-mass window (mass estimated from its
    # second half) and the re-adaptation window under the estimated mass
    gamma, t0, kappa = 0.05, 10.0, 0.75
    p2 = max(1, int(num_warmup) // 4)
    p1 = max(0, int(num_warmup) - p2)

    def adapt(state, n, inv_mass, eps0, mu, kept=None):
        """``n`` warmup transitions dual-averaging log ε towards ``mu``
        from ``eps0`` (every value a tensor on the device); the positions
        of the second half go to ``kept``.  Returns the state and the
        averaged log ε."""
        q, lp, g = state
        log_eps = log_eps_bar = torch.log(eps0)
        h_bar = torch.zeros_like(log_eps)
        for i in range(n):
            q, lp, g, acc, _ = kernel(q, lp, g, draws(), torch.exp(log_eps), inv_mass)
            # dual averaging on the chain-mean acceptance
            t = i + 1.0
            h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (
                (float(target_accept) - acc.mean()) / (t + t0)
            )
            log_eps = mu - math.sqrt(t) / gamma * h_bar
            w = t ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            if kept is not None and i >= n // 2:
                kept[i - n // 2] = q
        return (q, lp, g), log_eps_bar

    # phase 1: dual-average the step size under unit mass, estimate the
    # diagonal mass from the second half; phase 2: re-adapt the step size
    # under the estimated mass (a step size tuned to one metric is
    # miscalibrated for another — Stan's windowed adaptation, two windows).
    # Total transitions = num_warmup exactly.
    state = (x0, *density(x0))
    eps0 = torch.tensor(float(initial_step_size), dtype=_F64, device=device)
    kept = x0.new_empty((p1 - p1 // 2, chains, d))
    state, log_eps_bar = adapt(state, p1, torch.ones(d, dtype=_F64, device=device), eps0,
                               torch.log(10.0 * eps0), kept)
    # floored — a parameter phase 1 never moved must not give a 0 mass
    inv_mass = torch.clamp(torch.var(kept.reshape(-1, d), dim=0, correction=0), min=1e-12)
    # rescale the phase-1 step into the new metric as the starting guess:
    # proposal scale in q-space is ~ eps·√(inv_mass)
    eps_guess = torch.exp(log_eps_bar) / torch.sqrt(torch.max(inv_mass))
    state, log_eps_bar = adapt(state, p2, inv_mass, eps_guess, torch.log(10.0 * eps_guess))
    eps = torch.exp(log_eps_bar)

    q, lp, g = state
    qs = x0.new_empty((int(num_samples), chains, d))
    lps = x0.new_empty((int(num_samples), chains))
    accs = x0.new_empty((int(num_samples), chains))
    for i in range(int(num_samples)):
        q, lp, g, accs[i], _ = kernel(q, lp, g, draws(), eps, inv_mass)
        qs[i] = q
        lps[i] = lp

    samples = np.moveaxis(qs.cpu().numpy(), 0, 1)      # (chains, draws, d)
    log_prob = lps.cpu().numpy().T
    accept = accs.cpu().numpy().mean(axis=0)
    rh = r_hat(samples)
    ess = effective_sample_size(samples)
    if np.any(rh > 1.05):
        log_warn(
            f"sample_posterior: split-R-hat up to {rh.max():.3f} > 1.05 — "
            "chains have not mixed; raise num_warmup/num_samples or "
            "reparameterize"
        )
    if accept.mean() < 0.5 * target_accept:
        log_warn(
            f"sample_posterior: acceptance {accept.mean():.2f} far below "
            f"the {target_accept} target — the step-size adaptation "
            "failed; try a smaller initial_step_size"
        )
    return {
        "samples": samples,
        "log_prob": log_prob,
        "accept_rate": accept,
        "step_size": float(eps),
        "inv_mass": inv_mass.cpu().numpy(),
        "r_hat": rh,
        "ess": ess,
    }


def log_evidence_laplace(logp: Callable, samples, device="cuda") -> float:
    """Laplace-approximation log-evidence ln Z from posterior samples.

    Fits a Gaussian to the samples (pooled mean μ and covariance Σ) and
    evaluates

        ln Z ≈ logp(μ) + (d/2) ln 2π + ½ ln det Σ,

    exact when the posterior is Gaussian and the standard O(1/N)
    approximation otherwise — enough for Bayes-factor comparisons between
    inflationary models whose posteriors HMC has already mapped.  ``logp``
    must be the SAME (unnormalized) log-density that was sampled; it is
    evaluated once, at μ as a float64 tensor on ``device``.  ``samples`` is
    (chains, draws, d) from :func:`sample_posterior` (or any (N, d)
    array)."""
    device = resolve_device(device)
    s = np.asarray(samples, dtype=float).reshape(-1, np.shape(samples)[-1])
    mu = s.mean(axis=0)
    cov = np.atleast_2d(np.cov(s.T))
    d = s.shape[1]
    sign, logdet = np.linalg.slogdet(cov)
    if sign <= 0:
        raise ValueError(
            "posterior sample covariance is not positive definite — the "
            "chains have not explored (or a parameter is exactly pinned)"
        )
    lp_mu = float(logp(torch.as_tensor(mu, dtype=_F64, device=device)))
    return lp_mu + 0.5 * d * np.log(2.0 * np.pi) + 0.5 * logdet


# ----------------------------------------------------------------------- #
# diagnostics (host-side numpy)                                            #
# ----------------------------------------------------------------------- #


def r_hat(samples) -> np.ndarray:
    """Split-R̂ (Gelman–Rubin with halved chains) per parameter.

    ``samples`` is (chains, draws, d); values ≈ 1 indicate mixing."""
    s = np.asarray(samples, dtype=float)
    c, n, d = s.shape
    half = n // 2
    s = np.concatenate([s[:, :half], s[:, half : 2 * half]], axis=0)
    m, n = s.shape[0], s.shape[1]
    chain_mean = s.mean(axis=1)                      # (m, d)
    chain_var = s.var(axis=1, ddof=1)                # (m, d)
    b = n * chain_mean.var(axis=0, ddof=1)
    w = chain_var.mean(axis=0)
    var_plus = (n - 1) / n * w + b / n
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.sqrt(var_plus / w)


def effective_sample_size(samples) -> np.ndarray:
    """ESS per parameter via the initial-positive-sequence estimator on the
    chain-averaged autocorrelation (Geyer 1992 / Stan's formulation,
    simplified to within-chain correlations)."""
    s = np.asarray(samples, dtype=float)
    c, n, d = s.shape
    ess = np.empty(d)
    for j in range(d):
        rho_sum = 0.0
        x = s[:, :, j] - s[:, :, j].mean(axis=1, keepdims=True)
        var = (x * x).mean()
        if var == 0.0:
            ess[j] = np.nan
            continue
        # cap the lag sweep: a pathological (near-constant-drift) chain
        # would otherwise cost O(n²); past n/4 lags the estimator is
        # unreliable anyway and the partial sum already implies ESS ≪ n
        t = 1
        while t < min(n - 1, max(64, n // 4)):
            rho_t = (x[:, : n - t] * x[:, t:]).mean() / var
            rho_t1 = (
                (x[:, : n - t - 1] * x[:, t + 1 :]).mean() / var
                if t + 1 < n else 0.0
            )
            if rho_t + rho_t1 <= 0.0:
                break
            rho_sum += rho_t + rho_t1
            t += 2
        ess[j] = c * n / (1.0 + 2.0 * rho_sum)
    return ess
