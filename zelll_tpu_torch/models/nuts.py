"""Samplers for the surface-sampling workload.

PyTorch counterpart of ``zelll_tpu/models/nuts.py``. The reference drives
``nuts-rs`` with a CpuLogpFunc wrapping the SDF gradient
(surface-sampling/src/surface.rs, examples/cli.rs:87-122), one chain on one
core. Three samplers:

* `hmc_sample_batched`: the production path. C independent chains advance
  in lockstep (each chain samples one surface point), with jittered
  trajectory lengths and dual-averaging step-size adaptation in burn-in.
* `nuts_sample_batched`: the No-U-Turn sampler for C chains in lockstep.
  Each draw doubles its trajectory iteratively (a loop over tree depths
  with 2^d leapfrog steps per doubling, the checkpoint bit-trick for the
  within-subtree U-turn checks, multinomial proposals); each chain stops
  at its own U-turn, and a draw costs the deepest chain's tree.
* `nuts_sample`: the classic single-chain NUTS (Hoffman & Gelman, alg. 3,
  slice sampling) with tree recursion on the host, for parity with the
  reference CLI.

The batched samplers run on the device of their start positions, draw
from an explicit `torch.Generator` (or a seed), and take a batched
``value_and_grad_fn`` ``(C, D) -> (logp (C,), grad (C, D))`` such as
`SmoothDistanceField.hmc_vgrad_fn` (one K12 launch per leapfrog step for
all chains on the card), or else differentiate ``logdensity_fn`` (a
batched ``(C, D) -> (C,)`` torch function) with autograd. The JAX
package's ``lax`` loops are Python loops over device tensors: HMC reads
nothing back until its samples; NUTS reads one "any chain still running"
flag per leapfrog step and per doubling. torch cannot reproduce JAX's
random streams, so the samplers match the JAX package in distribution,
not draw by draw. `nuts_sample` draws from numpy's generator, as the JAX
package's does.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

__all__ = ["hmc_sample_batched", "nuts_sample", "nuts_sample_batched"]

# dual averaging (Hoffman & Gelman 2014, sec. 3.2)
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75


def _generator(generator, device) -> torch.Generator:
    """``generator`` itself, or a new one on ``device`` seeded with it."""
    if isinstance(generator, torch.Generator):
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(int(generator))
    return g


def _autograd_vgrad(logdensity_fn: Callable) -> Callable:
    """Batched (logp, grad) of a batched log density by torch autograd."""

    def vgrad(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            lp = logdensity_fn(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g

    return vgrad


def _kinetic(p, minv):
    return 0.5 * (p * p * minv).sum(-1)


def _dual_average(state, accept_prob, t: float, mu: float, target: float):
    """One dual-averaging update of (log_eps, h_bar, log_eps_bar)."""
    q, log_eps, h_bar, log_eps_bar, minv = state
    tt = t + 1.0
    h_bar = (1 - 1 / (tt + _T0)) * h_bar + (target - accept_prob) / (tt + _T0)
    log_eps = mu - math.sqrt(tt) / _GAMMA * h_bar
    w = tt ** (-_KAPPA)
    log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
    return q, log_eps, h_bar, log_eps_bar, minv


# -- batched HMC --------------------------------------------------------------


def hmc_sample_batched(logdensity_fn: Callable | None, initial_positions,
                       generator, *, num_warmup: int = 300,
                       num_samples: int = 500, num_leapfrog: int = 16,
                       target_accept: float = 0.8, init_step_size: float = 0.1,
                       value_and_grad_fn: Callable | None = None):
    """Run C independent HMC chains in lockstep; returns (samples, accept).

    samples: (num_samples, C, D), accept: (num_samples, C). Warm-up adapts,
    per chain, the step size by dual averaging and a diagonal mass matrix
    from the Welford variance of the draws over the middle of warm-up
    (frozen at 3/4 of it, with Stan-style shrinkage toward unit mass), as
    nuts-rs does for the reference CLI (cli.rs:87-111). Trajectory lengths
    are jittered per chain (each chain stops its leapfrog at its own
    length; a step costs the longest). A proposal at logp = -inf (outside
    the grid) is rejected: the reference's recoverable SurfaceSdfError
    (surface.rs:10-14).

    ``generator`` is a `torch.Generator` on the positions' device or a
    seed. ``value_and_grad_fn``, when given, is used in place of autograd
    through ``logdensity_fn``, which may then be None.
    """
    q0 = torch.as_tensor(initial_positions)
    C, D = q0.shape
    gen = _generator(generator, q0.device)
    vgrad = value_and_grad_fn or _autograd_vgrad(logdensity_fn)
    mu = math.log(10.0 * init_step_size)
    kw = dict(device=q0.device, dtype=q0.dtype)

    def leapfrog(q, p, g, lp, eps, minv, n_steps):
        """Every chain runs num_leapfrog iterations in lockstep but chain c
        freezes after its own n_steps[c]. The gradient at a step's start is
        the one computed at the previous step's end, so each iteration
        costs one vgrad call."""
        for i in range(num_leapfrog):
            active = (i < n_steps)[:, None]
            p1 = p + 0.5 * eps[:, None] * g
            q1 = q + eps[:, None] * (minv * p1)
            lp1, g1 = vgrad(q1)
            p1 = p1 + 0.5 * eps[:, None] * g1
            q = torch.where(active, q1, q)
            p = torch.where(active, p1, p)
            g = torch.where(active, g1, g)
            lp = torch.where(active[:, 0], lp1, lp)
        return q, p, g, lp

    def step(state, adapt: bool, t: float):
        q, log_eps, h_bar, log_eps_bar, minv = state
        # momentum ~ N(0, M) with M = 1/minv (diagonal)
        p = torch.randn(q.shape, generator=gen, **kw) / torch.sqrt(minv)
        lp0, g0 = vgrad(q)
        h0 = lp0 - _kinetic(p, minv)
        eps = torch.exp(log_eps)
        # per-chain jittered trajectory length: 1..num_leapfrog steps
        n_steps = torch.randint(1, num_leapfrog + 1, (C,), generator=gen,
                                device=q.device)
        q_new, p_new, _, lp1 = leapfrog(q, p, g0, lp0, eps, minv, n_steps)
        h1 = lp1 - _kinetic(p_new, minv)
        accept_prob = torch.exp(torch.clamp(h1 - h0, max=0.0))
        accept_prob = torch.nan_to_num(accept_prob, nan=0.0)
        u = torch.rand((C,), generator=gen, **kw)
        q = torch.where((u < accept_prob)[:, None], q_new, q)
        state = (q, log_eps, h_bar, log_eps_bar, minv)
        if adapt:
            state = _dual_average(state, accept_prob, t, mu, target_accept)
        return state, (q, accept_prob)

    return _adaptive_run(step, q0, num_warmup, num_samples, init_step_size)


def _adaptive_run(step, q0, num_warmup: int, num_samples: int,
                  init_step_size: float):
    """Warm-up and sampling loops shared by the batched samplers.

    ``step(state, adapt, t) -> (state, (q, accept_prob))`` with state =
    (q (C, D), log_eps (C,), h_bar (C,), log_eps_bar (C,), minv (C, D)).
    Warm-up adapts the step size every draw (the step's own dual
    averaging) and a diagonal mass matrix from the Welford variance of the
    draws over [warmup/4, 3 warmup/4), frozen at 3/4 of warm-up with
    Stan-style shrinkage toward unit mass."""
    C, D = q0.shape
    kw = dict(device=q0.device, dtype=q0.dtype)
    t_collect = num_warmup // 4  # Welford window start
    t_freeze = max(num_warmup * 3 // 4, t_collect + 1)  # mass freeze
    log0 = math.log(init_step_size)
    state = (q0, torch.full((C,), log0, **kw), torch.zeros((C,), **kw),
             torch.full((C,), log0, **kw), torch.ones((C, D), **kw))
    mean = torch.zeros((C, D), **kw)
    m2 = torch.zeros((C, D), **kw)
    cnt = 0.0
    for t in range(num_warmup):
        state, _ = step(state, True, float(t))
        q = state[0]
        # Welford variance of the warm-up draws in [t_collect, t_freeze)
        if t_collect <= t < t_freeze:
            cnt += 1.0
            delta = q - mean
            mean = mean + delta / cnt
            m2 = m2 + delta * (q - mean)
        if t == t_freeze:
            # var n/(n+5) + 1e-3 5/(n+5), unit mass if nothing was collected
            var = m2 / max(cnt - 1.0, 1.0)
            reg = var * (cnt / (cnt + 5.0)) + 1e-3 * (5.0 / (cnt + 5.0))
            minv = reg if cnt > 1.0 else torch.ones_like(reg)
            state = (*state[:4], minv)
    # sample at the averaged step size
    q, _, h_bar, log_eps_bar, minv = state
    state = (q, log_eps_bar, h_bar, log_eps_bar, minv)
    samples, accept = [], []
    for _ in range(num_samples):
        state, (qs, ap) = step(state, False, 0.0)
        samples.append(qs)
        accept.append(ap)
    if not samples:
        return torch.zeros((0, C, D), **kw), torch.zeros((0, C), **kw)
    return torch.stack(samples), torch.stack(accept)


# -- batched NUTS -------------------------------------------------------------


def _popcount(x: int) -> int:
    return bin(x).count("1")


def nuts_sample_batched(logdensity_fn: Callable | None, initial_positions,
                        generator, *, num_warmup: int = 300,
                        num_samples: int = 500, max_treedepth: int = 8,
                        target_accept: float = 0.8, init_step_size: float = 0.1,
                        value_and_grad_fn: Callable | None = None):
    """C No-U-Turn chains in lockstep on the positions' device.

    Multinomial NUTS (Betancourt 2017) with iterative tree doubling, the
    form of the reference's nuts-rs sampler (cli.rs:87-122): the d-th
    doubling runs 2^d leapfrog steps, and the checkpoint bit-trick
    (popcount and trailing ones of the leaf index) gives the
    within-subtree generalised U-turn checks. Each chain stops doubling at
    its own U-turn or divergence; finished chains are masked while the rest
    go on. Divergences (energy error > 1000) and logp = -inf proposals
    (outside the grid, surface.rs:10-14) end the doubling without
    contributing.

    Warm-up matches `hmc_sample_batched`. ``generator`` and
    ``value_and_grad_fn`` as there. Returns (samples (num_samples, C, D),
    accept_stat (num_samples, C)).
    """
    q_init = torch.as_tensor(initial_positions)
    C, D = q_init.shape
    gen = _generator(generator, q_init.device)
    vgrad = value_and_grad_fn or _autograd_vgrad(logdensity_fn)
    mu = math.log(10.0 * init_step_size)
    max_delta_energy = 1000.0
    kw = dict(device=q_init.device, dtype=q_init.dtype)

    def uniform():
        return torch.rand((C,), generator=gen, **kw)

    def is_turning(rho, p_l, p_r, minv):
        """Generalised no-U-turn criterion over a trajectory segment: rho
        is the sum of its momenta, p_l/p_r its end momenta; turning when
        the segment's net direction (M^-1 rho) opposes either end's
        velocity."""
        v_l = (rho * (minv * p_l)).sum(-1)
        v_r = (rho * (minv * p_r)).sum(-1)
        return (v_l < 0) | (v_r < 0)

    def leapfrog(q, p, g, eps_signed, minv):
        """One step with the start-point gradient carried in: one vgrad
        call per leapfrog step."""
        p1 = p + 0.5 * eps_signed[:, None] * g
        q1 = q + eps_signed[:, None] * (minv * p1)
        lp, g1 = vgrad(q1)
        p1 = p1 + 0.5 * eps_signed[:, None] * g1
        return q1, p1, lp, g1

    def build_subtree(depth, q0, p0, g0, eps_signed, h0, minv, active):
        """2^depth leapfrog steps from (q0, p0) with gradient g0. Returns
        the subtree's end point and its gradient, momentum sum,
        multinomial proposal, log sum weight, invalid flag (an inner
        U-turn or a divergence) and acceptance-statistic sums, all (C, ...)
        and masked by ``active``."""
        neg_inf = torch.full((C,), float("-inf"), **kw)
        # (momentum, running momentum sum) at the subtrees' first leaves
        ckpt_p = torch.zeros((max_treedepth, C, D), **kw)
        ckpt_rho = torch.zeros((max_treedepth, C, D), **kw)
        qc, pc, gc = q0, p0, g0
        rho = torch.zeros_like(q0)
        prop, lw = q0, neg_inf
        alpha = torch.zeros((C,), **kw)
        n_alpha = torch.zeros((C,), **kw)
        invalid = torch.zeros((C,), dtype=torch.bool, device=q0.device)
        alive = active
        i = 0
        while i < (1 << depth) and bool(alive.any()):
            q1, p1, lp, g1 = leapfrog(qc, pc, gc, eps_signed, minv)
            h = lp - _kinetic(p1, minv)
            div = ~torch.isfinite(h) | (h0 - h > max_delta_energy)
            lw_leaf = torch.where(div, neg_inf, h - h0)

            # progressive multinomial proposal within the subtree
            lw_new = torch.logaddexp(lw, lw_leaf)
            ref = torch.where(lw_new == float("-inf"), torch.zeros_like(lw_new),
                              lw_new)
            take = alive & (torch.log(uniform()) < lw_leaf - ref) & ~div
            rho1 = rho + p1

            # the leaf index's bits say which balanced subtrees end here
            idx_max = _popcount(i >> 1)
            trailing_ones = _popcount(i ^ (i + 1)) - 1
            idx_min = idx_max - trailing_ones + 1
            turning = torch.zeros((C,), dtype=torch.bool, device=q0.device)
            if i % 2 == 0:
                # an even leaf opens a balanced subtree: store (p, rho)
                ckpt_p[idx_max] = p1
                ckpt_rho[idx_max] = rho1
            else:
                # an odd leaf closes the subtrees [idx_min, idx_max]
                for k in range(idx_min, idx_max + 1):
                    seg_rho = rho1 - ckpt_rho[k] + ckpt_p[k]
                    turning = turning | is_turning(seg_rho, ckpt_p[k], p1, minv)

            alpha_leaf = torch.where(torch.isfinite(h),
                                     torch.exp(torch.clamp(h - h0, max=0.0)),
                                     torch.zeros_like(h))
            upd = alive[:, None]
            qc = torch.where(upd, q1, qc)
            pc = torch.where(upd, p1, pc)
            gc = torch.where(upd, g1, gc)
            rho = torch.where(upd, rho1, rho)
            prop = torch.where(take[:, None], q1, prop)
            lw = torch.where(alive, lw_new, lw)
            alpha = alpha + torch.where(alive, alpha_leaf, torch.zeros_like(alpha_leaf))
            n_alpha = n_alpha + alive.to(alpha.dtype)
            invalid = invalid | (alive & (div | turning))
            alive = alive & ~(div | turning)
            i += 1
        return qc, pc, gc, rho, prop, lw, invalid, alpha, n_alpha

    def transition(q, log_eps, minv):
        """One NUTS draw for all chains; returns (q', accept_stat)."""
        p0 = torch.randn(q.shape, generator=gen, **kw) / torch.sqrt(minv)
        lp0, g0 = vgrad(q)
        g0 = torch.where(torch.isfinite(g0), g0, torch.zeros_like(g0))
        h0 = lp0 - _kinetic(p0, minv)
        finite0 = torch.isfinite(h0)
        h0 = torch.where(finite0, h0, torch.zeros_like(h0))
        eps = torch.exp(log_eps)

        done = ~finite0
        zl_q, zl_p, zl_g = q, p0, g0
        zr_q, zr_p, zr_g = q, p0, g0
        rho, prop = p0, q
        lw = torch.zeros((C,), **kw)
        alpha = torch.zeros((C,), **kw)
        n_alpha = torch.zeros((C,), **kw)
        depth = 0
        while depth < max_treedepth and bool((~done).any()):
            fwd = uniform() < 0.5
            fw = fwd[:, None]
            qs = torch.where(fw, zr_q, zl_q)
            ps = torch.where(fw, zr_p, zl_p)
            gs = torch.where(fw, zr_g, zl_g)
            sgn = torch.where(fwd, 1.0, -1.0).to(q.dtype)
            (q_end, p_end, g_end, rho_sub, prop_sub, lw_sub, invalid, a_sub,
             na_sub) = build_subtree(depth, qs, ps, gs, sgn * eps, h0, minv,
                                     ~done)

            # biased progressive sampling between the old tree and the new
            # subtree: take the subtree's proposal with min(1, e^(lw_sub - lw))
            grows = ~done & ~invalid
            take = grows & (torch.log(uniform()) < lw_sub - lw)
            prop = torch.where(take[:, None], prop_sub, prop)
            lw = torch.where(grows, torch.logaddexp(lw, lw_sub), lw)

            grow = grows[:, None]
            left, right = grow & ~fw, grow & fw
            zl_q = torch.where(left, q_end, zl_q)
            zl_p = torch.where(left, p_end, zl_p)
            zl_g = torch.where(left, g_end, zl_g)
            zr_q = torch.where(right, q_end, zr_q)
            zr_p = torch.where(right, p_end, zr_p)
            zr_g = torch.where(right, g_end, zr_g)
            rho = torch.where(grow, rho + rho_sub, rho)
            turning = is_turning(rho, zl_p, zr_p, minv)

            alpha = alpha + a_sub
            n_alpha = n_alpha + na_sub
            done = done | invalid | (~done & turning)
            depth += 1
        q_new = torch.where(finite0[:, None], prop, q)
        return q_new, alpha / torch.clamp(n_alpha, min=1.0)

    def step(state, adapt: bool, t: float):
        q, log_eps, h_bar, log_eps_bar, minv = state
        q, accept_prob = transition(q, log_eps, minv)
        state = (q, log_eps, h_bar, log_eps_bar, minv)
        if adapt:
            state = _dual_average(state, accept_prob, t, mu, target_accept)
        return state, (q, accept_prob)

    return _adaptive_run(step, q_init, num_warmup, num_samples, init_step_size)


# -- single-chain NUTS with host recursion -------------------------------------


def nuts_sample(value_and_grad_fn: Callable, initial_position: np.ndarray, *,
                num_warmup: int = 200, num_samples: int = 300,
                max_treedepth: int = 8, target_accept: float = 0.8,
                seed: int = 0):
    """Single-chain No-U-Turn sampler (Hoffman & Gelman 2014, alg. 3).

    ``value_and_grad_fn(q) -> (logp, grad)`` takes and returns numpy (or
    numbers); the recursion runs on the host like the reference's nuts-rs
    chain loop (cli.rs:115-122), and the draws come from
    ``numpy.random.default_rng(seed)``. Returns (samples (num_samples, D),
    acceptance statistics).
    """
    rng = np.random.default_rng(seed)
    q = np.asarray(initial_position, np.float64)
    D = q.shape[0]

    eps = _find_reasonable_epsilon(value_and_grad_fn, q, rng)
    mu = math.log(10 * eps)
    log_eps_bar, h_bar = 0.0, 0.0

    def leapfrog(q, p, g, eps):
        """Start-point gradient carried in: one value_and_grad call per
        leapfrog step."""
        p = p + 0.5 * eps * np.asarray(g)
        q = q + eps * p
        lp, g1 = value_and_grad_fn(q)
        p = p + 0.5 * eps * np.asarray(g1)
        return q, p, float(lp), g1

    def build_tree(q, p, g, log_u, v, depth, eps, h0):
        if depth == 0:
            q1, p1, lp1, g1 = leapfrog(q, p, g, v * eps)
            joint = lp1 - 0.5 * float(p1 @ p1)
            n1 = int(log_u <= joint)
            s1 = int(log_u < joint + 1000.0) and np.isfinite(joint)
            a1 = (min(1.0, math.exp(min(joint - h0, 0.0)))
                  if np.isfinite(joint) else 0.0)
            return q1, p1, g1, q1, p1, g1, q1, n1, s1, a1, 1
        qm, pm, gm, qp, pp, gp, q1, n1, s1, a1, na1 = build_tree(
            q, p, g, log_u, v, depth - 1, eps, h0)
        if s1:
            if v == -1:
                qm, pm, gm, _, _, _, q2, n2, s2, a2, na2 = build_tree(
                    qm, pm, gm, log_u, v, depth - 1, eps, h0)
            else:
                _, _, _, qp, pp, gp, q2, n2, s2, a2, na2 = build_tree(
                    qp, pp, gp, log_u, v, depth - 1, eps, h0)
            if n1 + n2 > 0 and rng.random() < n2 / (n1 + n2):
                q1 = q2
            a1, na1 = a1 + a2, na1 + na2
            dq = qp - qm
            s1 = s2 and (dq @ pm >= 0) and (dq @ pp >= 0)
            n1 = n1 + n2
        return qm, pm, gm, qp, pp, gp, q1, n1, s1, a1, na1

    samples = []
    accept_stats = []
    for t in range(num_warmup + num_samples):
        p0 = rng.standard_normal(D)
        lp0, g0 = value_and_grad_fn(q)
        h0 = float(lp0) - 0.5 * float(p0 @ p0)
        log_u = h0 + math.log(rng.random() + 1e-300)

        qm, qp, pm, pp = q.copy(), q.copy(), p0.copy(), p0.copy()
        gm, gp = np.asarray(g0), np.asarray(g0)
        n, s, depth = 1, True, 0
        alpha, n_alpha = 0.0, 1
        while s and depth < max_treedepth:
            v = 1 if rng.random() < 0.5 else -1
            if v == -1:
                qm, pm, gm, _, _, _, q1, n1, s1, a, na = build_tree(
                    qm, pm, gm, log_u, v, depth, eps, h0)
            else:
                _, _, _, qp, pp, gp, q1, n1, s1, a, na = build_tree(
                    qp, pp, gp, log_u, v, depth, eps, h0)
            if s1 and rng.random() < min(1.0, n1 / n):
                q = q1
            n += n1
            dq = qp - qm
            s = s1 and (dq @ pm >= 0) and (dq @ pp >= 0)
            depth += 1
            alpha, n_alpha = alpha + a, n_alpha + na

        # dual averaging
        if t < num_warmup:
            tt = t + 1
            h_bar = (1 - 1 / (tt + _T0)) * h_bar + (
                target_accept - alpha / n_alpha) / (tt + _T0)
            log_eps = mu - math.sqrt(tt) / _GAMMA * h_bar
            w = tt ** (-_KAPPA)
            log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
            eps = math.exp(log_eps)
        elif t == num_warmup:
            eps = math.exp(log_eps_bar)
        if t >= num_warmup:
            samples.append(q.copy())
            accept_stats.append(alpha / n_alpha)
    return np.asarray(samples), np.asarray(accept_stats)


def _find_reasonable_epsilon(vg, q, rng):
    eps = 1.0
    p = rng.standard_normal(q.shape[0])
    lp, g = vg(q)
    h0 = float(lp) - 0.5 * float(p @ p)
    q1 = q + eps * (p + 0.5 * eps * np.asarray(g))
    p1 = p + 0.5 * eps * np.asarray(g)
    lp1, g1 = vg(q1)
    p1 = p1 + 0.5 * eps * np.asarray(g1)
    h1 = float(lp1) - 0.5 * float(p1 @ p1)
    if not np.isfinite(h1):
        return 0.1
    a = 1.0 if h1 - h0 > math.log(0.5) else -1.0
    for _ in range(20):
        eps *= 2.0**a
        q1 = q + eps * p
        lp1, _ = vg(q1)
        h1 = float(lp1) - 0.5 * float(p @ p)
        if not np.isfinite(h1) or a * (h1 - h0) <= a * math.log(0.5):
            break
    return max(min(eps, 10.0), 1e-4)
