"""Parallel tempering (replica exchange) over vmapped HMC rungs.

Round-4 measured a hard sampler limitation: the tightly-trained
(12000-epoch) mixed-lambda WHVI posterior defeats every linearly
preconditioned sampler — identity, adapted-diagonal AND dense-metric
NUTS all park at ESS ~ 2 (CPU and accelerator, any precision, 3x warmup;
docs/RESULTS.md round 4) — and attributed it to mode structure the
momentum cannot cross. Parallel tempering is the standard test
of that hypothesis: K replicas ("rungs") sample the geometric path

    p_k(q)  ∝  exp(beta_k * logp(q)),      1 = beta_0 > ... > beta_{K-1}

and adjacent rungs propose state swaps with the Metropolis probability

    min(1, exp((beta_i - beta_j) * (logp(q_j) - logp(q_i))))

so hot (small-beta, flattened) rungs cross barriers freely and feed
decorrelated states down the ladder to the cold beta = 1 rung, whose
draws are exact posterior samples.

Accelerator shape: the K rungs advance as ONE vmapped HMC update per
round (every rung is the same static program at a different traced
``beta``), swaps are a vectorized even/odd alternation (deterministic
even-odd scheme — Okabe et al. 2001), and the whole (warmup + sampling)
ladder runs in a single ``lax.scan``. ``pt_sample`` has the exact
sampler signature ``(log_prob_fn, init_position, key, config)`` of
``hmc_sample``/``nuts_sample``, so ``pt_sample_chains`` rides the same
structural-cached, vmapped/mesh-sharded chain driver (mcmc.chains) —
rung-parallelism times chain-parallelism is exactly what this engine is
good at.

Per-rung adaptation during warmup: dual-averaging step size (Hoffman &
Gelman 2014, Alg. 5) and Stan-style windowed diagonal mass estimation
(mcmc.adapt), each rung with its own state — the hot rungs' wider
posteriors genuinely need larger steps and masses. Step size and metric
stay with the RUNG on a swap (standard: they belong to the tempered
density, not the walker).

No reference counterpart (the reference has no sampler at all); this is
the SURVEY section 7.7 capability tier, round-5 VERDICT item #3.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.flatten_util
import jax.numpy as jnp

__all__ = ["PTConfig", "pt_sample", "pt_sample_chains"]


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """One "round" = one vmapped HMC update on every rung + one
    alternating-parity adjacent-swap sweep."""

    n_samples: int = 1000  # kept rounds (rung-0 draws)
    n_warmup: int = 500  # adaptation rounds, discarded
    n_rungs: int = 8
    # hottest inverse temperature; betas are geometric from 1 down to
    # this. 0.05 flattens a barrier of height h to 0.05 h — enough for
    # the toy bimodal targets; tighten toward 1 for mildly multimodal
    # posteriors, lower for glassy ones.
    beta_min: float = 0.05
    n_leapfrog: int = 16
    init_step_size: float = 1e-2
    target_accept: float = 0.8
    adapt: bool = True
    mass_adapt: bool = True
    # per-round uniform step-size jitter (+-fraction): fixed-length HMC
    # resonance guard, same rationale as HMCConfig.jitter_eps
    jitter_eps: float = 0.3


def pt_sample(
    log_prob_fn: Callable[[Any], jax.Array],
    init_position: Any,
    key: jax.Array,
    config: PTConfig = PTConfig(),
):
    """Run one parallel-tempering ladder; returns ``(samples, stats)``.

    ``samples``: pytree like ``init_position`` with a leading
    ``n_samples`` axis — the post-warmup draws of the cold (beta = 1)
    rung only.

    ``stats``: ``accept_rate (K,)`` per-rung post-warmup HMC acceptance;
    ``swap_rate (K-1,)`` acceptance of each adjacent pair's swap
    proposals (the ladder health check — a pair near 0 is a bottleneck,
    fix by raising ``n_rungs`` or ``beta_min``); ``step_size (K,)``;
    ``inv_mass (K, dim)``; ``betas (K,)``; ``divergences`` (cold-rung
    count, the one that taints kept draws) and ``divergences_any``
    (all rungs).
    """
    from whvi_tpu.mcmc import adapt as _adapt
    from whvi_tpu.mcmc.adapt import warmup_schedule

    cfg = config
    K = cfg.n_rungs
    betas = jnp.asarray(
        jnp.geomspace(1.0, cfg.beta_min, K), jnp.float32
    )
    q0_vec, unflat = jax.flatten_util.ravel_pytree(init_position)
    dim = q0_vec.size

    def logp_vec(qv):
        return log_prob_fn(unflat(qv))

    grad_vec = jax.grad(logp_vec)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    total = cfg.n_warmup + cfg.n_samples
    acc_mask, end_mask = (
        warmup_schedule(cfg.n_warmup)
        if (cfg.adapt and cfg.mass_adapt)
        else (jnp.zeros(cfg.n_warmup, bool), jnp.zeros(cfg.n_warmup, bool))
    )
    pad = jnp.zeros(cfg.n_samples, bool)
    acc_mask = jnp.concatenate([jnp.asarray(acc_mask), pad])
    end_mask = jnp.concatenate([jnp.asarray(end_mask), pad])

    def one_hmc(q, logp_raw, beta, k, log_eps, m_inv, jit_u):
        """One HMC proposal on the beta-tempered density.

        Stores/returns the UNtempered ``logp_raw`` (swaps need it);
        the potential is ``-beta * logp_raw`` and the tempered gradient
        is ``beta * grad logp``.
        """
        k_mom, k_acc = jax.random.split(k)
        xi = jax.random.normal(k_mom, (dim,))
        p = xi * jax.lax.rsqrt(m_inv)
        eps = jnp.exp(log_eps) * (
            1.0 + cfg.jitter_eps * (2.0 * jit_u - 1.0)
        )

        def body(_, qp):
            q, p = qp
            p = p + 0.5 * eps * beta * grad_vec(q)
            q = q + eps * (m_inv * p)
            p = p + 0.5 * eps * beta * grad_vec(q)
            return (q, p)

        q_new, p_new = jax.lax.fori_loop(0, cfg.n_leapfrog, body, (q, p))
        logp_new = logp_vec(q_new)
        kin = lambda pv: 0.5 * jnp.dot(pv, m_inv * pv)
        h_old = -beta * logp_raw + kin(p)
        h_new = -beta * logp_new + kin(p_new)
        accept_prob = jnp.exp(jnp.minimum(0.0, -(h_new - h_old)))
        accept_prob = jnp.where(
            jnp.isfinite(accept_prob), accept_prob, 0.0
        )
        # divergence semantics match hmc.py: blown-up trajectories are
        # rejected and feed accept_stat = 0 into dual averaging
        divergent = jnp.logical_or(
            ~jnp.isfinite(h_new), (h_new - h_old) > 1000.0
        )
        accept_prob = jnp.where(divergent, 0.0, accept_prob)
        take = (jax.random.uniform(k_acc) < accept_prob) & ~divergent
        q = jnp.where(take, q_new, q)
        logp_raw = jnp.where(take, logp_new, logp_raw)
        return q, logp_raw, accept_prob, divergent

    v_hmc = jax.vmap(one_hmc)
    v_welford = jax.vmap(_adapt.welford_update, in_axes=(0, 0, None))
    v_window = jax.vmap(_adapt.window_update, in_axes=(0, 0, None))
    idx = jnp.arange(K)

    def step(carry, inp):
        (q, logp_raw, mu, log_eps, log_eps_bar, h_bar, da_t, m_inv, wf,
         i) = carry
        key, w_acc, w_end = inp
        k_hmc, k_swap, k_jit = jax.random.split(key, 3)
        jit_u = jax.random.uniform(k_jit, (K,))
        q, logp_raw, accept_prob, divergent = v_hmc(
            q, logp_raw, betas, jax.random.split(k_hmc, K), log_eps,
            m_inv, jit_u,
        )

        # per-rung dual averaging (all elementwise over the rung axis)
        in_warmup = i < cfg.n_warmup
        t = da_t.astype(jnp.float32) + 1.0
        h_bar_new = (1.0 - 1.0 / (t + t0)) * h_bar + (
            cfg.target_accept - accept_prob
        ) / (t + t0)
        log_eps_new = mu - jnp.sqrt(t) / gamma * h_bar_new
        w = t ** (-kappa)
        log_eps_bar_new = w * log_eps_new + (1.0 - w) * log_eps_bar
        da_on = in_warmup & cfg.adapt
        log_eps = jnp.where(da_on, log_eps_new, log_eps_bar)
        log_eps_bar = jnp.where(da_on, log_eps_bar_new, log_eps_bar)
        h_bar = jnp.where(da_on, h_bar_new, h_bar)
        da_t = da_t + 1

        # per-rung mass windows (shared schedule, per-rung estimates)
        wf = v_welford(wf, q, w_acc)
        wf, m_inv = v_window(wf, m_inv, w_end)
        mu = jnp.where(w_end, jnp.log(10.0) + log_eps, mu)
        log_eps_bar = jnp.where(w_end, log_eps, log_eps_bar)
        h_bar = jnp.where(w_end, 0.0, h_bar)
        da_t = jnp.where(w_end, 0, da_t)

        # deterministic even-odd swap sweep: round parity picks the
        # pairing ((0,1),(2,3),... vs (1,2),(3,4),...); each pair
        # swaps states w.p. min(1, exp((b_i - b_j)(L_j - L_i))) —
        # symmetric in (i, j), so computing it "from the left" and
        # sharing the uniform within the pair applies the swap to both
        # members consistently.
        parity = i % 2
        is_left = (idx % 2) == parity
        partner = jnp.where(is_left, idx + 1, idx - 1)
        valid = (partner >= 0) & (partner < K)
        partner_c = jnp.clip(partner, 0, K - 1)
        delta = (betas - betas[partner_c]) * (
            logp_raw[partner_c] - logp_raw
        )
        u = jax.random.uniform(k_swap, (K,))
        u_shared = jnp.where(is_left, u, u[partner_c])
        accept_swap = valid & (jnp.log(u_shared) < delta)
        q = jnp.where(accept_swap[:, None], q[partner_c], q)
        logp_raw = jnp.where(accept_swap, logp_raw[partner_c], logp_raw)
        # pair (j, j+1) is attempted on rounds with parity == j % 2;
        # record its attempt/accept at the LEFT index
        attempted_left = (valid & is_left)[:-1]
        accepted_left = (accept_swap & is_left)[:-1]

        out = (
            q[0],
            accept_prob,
            divergent,
            attempted_left,
            accepted_left,
        )
        carry = (
            q, logp_raw, mu, log_eps, log_eps_bar, h_bar, da_t, m_inv,
            wf, i + 1,
        )
        return carry, out

    keys = jax.random.split(key, total)
    q_init = jnp.tile(q0_vec[None], (K, 1))
    logp0 = logp_vec(q0_vec)
    carry0 = (
        q_init,
        jnp.full((K,), logp0),
        jnp.full((K,), jnp.log(10.0 * cfg.init_step_size)),
        jnp.full((K,), jnp.log(cfg.init_step_size)),
        jnp.full((K,), jnp.log(cfg.init_step_size)),
        jnp.zeros((K,)),
        jnp.zeros((K,), jnp.int32),
        jnp.ones((K, dim)),
        _adapt.WelfordState(
            count=jnp.zeros((K,)),
            mean=jnp.zeros((K, dim)),
            m2=jnp.zeros((K, dim)),
        ),
        jnp.asarray(0, jnp.int32),
    )
    carry, (q0s, accepts, divs, att, acc) = jax.lax.scan(
        step, carry0, (keys, acc_mask, end_mask)
    )
    keep = slice(cfg.n_warmup, None)
    samples = jax.vmap(unflat)(q0s[keep])
    att_n = jnp.sum(att[keep].astype(jnp.float32), axis=0)
    acc_n = jnp.sum(acc[keep].astype(jnp.float32), axis=0)
    stats = {
        "accept_rate": jnp.mean(accepts[keep], axis=0),
        "warmup_accept_rate": jnp.mean(accepts[: cfg.n_warmup], axis=0),
        "swap_rate": acc_n / jnp.maximum(att_n, 1.0),
        "step_size": jnp.exp(carry[4]),
        "divergences": jnp.sum(divs[keep, 0].astype(jnp.int32)),
        "divergences_any": jnp.sum(divs[keep].astype(jnp.int32)),
        "inv_mass": carry[7],
        "betas": betas,
    }
    return samples, stats


def pt_sample_chains(
    log_prob_fn: Callable[[Any], jax.Array],
    init_position: Any,
    key: jax.Array,
    config: PTConfig = PTConfig(),
    n_chains: int = 4,
    jitter: float = 0.1,
    inits=None,
    mesh=None,
):
    """``n_chains`` independent tempering ladders (for split-R-hat/ESS
    over the cold-rung draws), through the same structural-cached /
    vmapped / mesh-sharded driver as the HMC and NUTS chains — rungs
    vmap inside each chain, chains shard across the mesh."""
    from whvi_tpu.mcmc.chains import run_chains

    return run_chains(
        pt_sample,
        log_prob_fn,
        init_position,
        key,
        config,
        n_chains,
        jitter,
        inits,
        mesh,
    )
