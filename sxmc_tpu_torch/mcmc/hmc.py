"""Hamiltonian Monte Carlo over the extended-ML posterior (port of
``sxmc_tpu/mcmc/hmc.py``).

Semantics, as the JAX package's:
  * source rates move in log space (q = log r) with the Jacobian term,
    ``U(q) = nll(r(q)) - sum(q)`` over the free rates, so rates stay
    positive; systematic coefficients move as they are (their NLL
    gradient is 0: the histograms are piecewise constant in theta);
  * a step draws a momentum ``p ~ N(0, 1 / inv_mass)``, runs
    ``num_leapfrog`` (16) leapfrogs, and accepts where ``u <
    min(1, exp(H0 - H1))`` and the new potential is finite (the 1e18
    barrier is finite and never accepted);
  * warmup: dual averaging of the step size to ``target_accept`` (0.8),
    Hoffman & Gelman 2014 algorithm 5 with JAX's damped constants (t0 =
    10, kappa = 0.75, mu = log 1, gamma 1), its state in float32; then
    the diagonal inverse mass from the variance of the second half of
    warmup;
  * the recorded NLL is ``U + jacobian`` in float32.

Gradients come from autograd of the port's plain NLL in the parameters
(``ops.nll``), as the MLE's do: the LUT and norms (binned: the
histograms) come from the kernels at ``theta.detach()`` and are
constants to autograd, so the event term's gradient in the systematic
coefficients is exactly 0, as JAX's floor-based binning gives, except
in the rows of KDE signals that a systematic acts on: ``PdfStack``
makes those from theta itself by plain PyTorch (grid rows, and
``kde_exact`` rows at the events), once an evaluation, so the gradient
flows through them as ``jax.grad`` does through ``EvalKDE`` (hmc.py:
21-29; the KDE's blocks are checkpointed, their backward recomputes
them); the
constraint term keeps its gradient, and the float64 sums pass a gradient
of 1 per element (JAX's custom JVP of ``df_sum``).  Every evaluation
returns the potential and its gradient together: 17 a step at 16
leapfrogs (the gradient at the start, then one a leapfrog, the last one
also giving the proposal's potential), each one B1 + B2 (unbinned,
floating systematics), B1 (binned), or plain torch ops on the LUT built
once (fixed or no systematics); lock-step chains take B1-batched.

Lock-step chains (``nchains``) run as one batch, each chain with its own
step size and mass.  The draws of a phase (0 warmup, 1 sampling) come
from a ``torch.Generator`` on the device, or are injected by a
presampler (how the tests feed both packages the JAX streams).
"""

from __future__ import annotations

import math
import types
from typing import Callable, Optional, Sequence, Tuple

import torch

from sxmc_tpu_torch.mcmc import metropolis
from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

EPS0 = 0.1          # the initial step size (hmc.py:231)

# (phase 0 warmup / 1 sampling, nsteps) -> the phase's draws, leading
# axis the step: HMC's (momentum normals (n, [nchains,] npar), accept
# uniforms (n, [nchains])); NUTS's in nuts.py.
Presampler = Callable[[int, int], Tuple[torch.Tensor, ...]]


def warmup_keep(nsteps: int, burnin_fraction: float) -> Tuple[int, int]:
    """The warmup and sampling step counts (hmc.py:70-71)."""
    warmup = max(int(nsteps * burnin_fraction), 10)
    return warmup, max(nsteps - warmup, 1)


class HMC(MCMC):
    """The HMC fit, with the call contract of :class:`MCMC`."""

    def __init__(self, *args, num_leapfrog: int = 16,
                 target_accept: float = 0.8, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_leapfrog = int(num_leapfrog)
        self.target_accept = float(target_accept)
        self.last_evaluations = None
        self.last_leapfrogs_per_step = None

    def _fns(self, read_bins: torch.Tensor):
        return _make_hmc_fns(self, read_bins)

    def presample(self, gen: torch.Generator, n: int, nchains: int = 1):
        """A phase's draws from ``gen`` on this fit's device: momentum
        normals ``(n, [nchains,] npar)`` and accept uniforms ``(n,
        [nchains])``."""
        lead = (n,) + ((nchains,) if nchains > 1 else ())
        mom = torch.randn(lead + (self.nparameters,), generator=gen,
                          device=self.device, dtype=torch.float32)
        u = torch.rand(lead, generator=gen, device=self.device,
                       dtype=torch.float32)
        return mom, u

    def draw_shapes(self, n: int, nchains: int = 1):
        lead = (n,) + ((nchains,) if nchains > 1 else ())
        return (lead + (self.nparameters,), lead)

    def __call__(
        self,
        data,
        nsteps: int,
        burnin_fraction: float = 0.1,
        debug_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        nchains: int = 1,
        presampler: Optional[Presampler] = None,
    ) -> LikelihoodSpace:
        """Warmup then sampling; returns the sampling phase's states,
        chains pooled chain-major.  ``debug_mode`` is accepted for the
        ensemble runner and ignored, as in the JAX package.  The draws
        come from ``generator`` (on this fit's device), or from
        ``presampler`` when given."""
        del debug_mode
        if nchains < 1:
            raise ValueError(f"nchains={nchains} must be at least 1")
        self.stack.set_data(data)
        warmup, keep = warmup_keep(nsteps, burnin_fraction)
        if presampler is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or a presampler")
            gen = generator

            def presampler(phase, n):
                return self.presample(gen, n, nchains)

        fns = self._fns(self.stack.read_bins)
        carry = initial_warm_carry(self, self.stack.read_bins, fns, nchains)
        carry, warm_qs = warmup_segment(
            self, carry, self.stack.read_bins,
            _checked(self, presampler(0, warmup), warmup, nchains), fns)
        q, u_q, _, log_eps_bar, _, _ = carry
        eps = torch.exp(log_eps_bar)
        inv_mass = mass_from_warmup(self, warm_qs)
        _, (samples, nlls, accepts) = main_segment(
            self, q, u_q, eps, inv_mass, self.stack.read_bins,
            _checked(self, presampler(1, keep), keep, nchains), fns)
        self.last_accept_rate = float(accepts.mean())
        self.last_evaluations = fns.evaluations
        self.last_leapfrogs_per_step = fns.leapfrogs / (
            (warmup + keep) * nchains)
        if nchains > 1:
            samples = samples.transpose(0, 1)
            nlls = nlls.T
        return LikelihoodSpace.from_arrays(
            samples.reshape(-1, self.nparameters).cpu().numpy(),
            nlls.reshape(-1).cpu().numpy(), self.parameter_names)


def _checked(sampler, draws: Sequence[torch.Tensor], n: int, nchains: int):
    want = sampler.draw_shapes(n, nchains)
    got = tuple(tuple(t.shape) for t in draws)
    if got != want:
        raise ValueError(f"draws of {n} steps have shapes {got}; this "
                         f"sampler takes {want}")
    return tuple(draws)


def _target(sampler: MCMC, read_bins: torch.Tensor):
    """The potential over q and what the gradient samplers share
    (hmc.py:100-157): ``value(q)`` and ``value_and_grad(q)`` for q
    ``(npar,)`` or ``(nchains, npar)``, the starting point, the initial
    inverse mass, the transforms, and the count of evaluations."""
    dev = sampler.device
    ns, npar = sampler.nsources, sampler.nparameters
    free = torch.as_tensor(~sampler.parameter_fixed, device=dev)
    is_rate = torch.arange(npar, device=dev) < ns
    rate_free = is_rate & free
    evaluate, evaluate_batch, pair = metropolis._nll_backend(sampler,
                                                            read_bins)
    dst = sampler.nll_spec.consts
    syst_float = metropolis._syst_float(sampler)
    if not syst_float:
        theta0 = torch.as_tensor(sampler.parameter_means[ns:], device=dev)
        state0 = evaluate(theta0)
    t = types.SimpleNamespace(evaluations=0, leapfrogs=0, free=free)

    def params_nll(params):
        if syst_float:
            theta = params[..., ns:]
            state = (evaluate_batch(theta) if theta.dim() == 2
                     else evaluate(theta))
        else:
            state = state0
        hi, lo = pair(params, *state, dst)
        return hi + lo

    def to_unconstrained(params):
        safe = torch.clamp_min(params, 1e-10)
        return torch.where(is_rate, torch.log(safe), params)

    def to_constrained(q):
        return torch.where(is_rate, torch.exp(q), q)

    def jacobian(q):
        # A flat prior in r-space: minus sum(log r) over the free rates.
        return torch.where(rate_free, q, torch.zeros_like(q)).sum(-1)

    def value(q):
        t.evaluations += 1
        with torch.no_grad():
            return params_nll(to_constrained(q)) - jacobian(q)

    def value_and_grad(q):
        t.evaluations += 1
        with torch.enable_grad():
            q = q.detach().requires_grad_(True)
            u = params_nll(to_constrained(q)) - jacobian(q)
            (g,) = torch.autograd.grad(u.sum(), q)
        return u.detach(), g

    t.value, t.value_and_grad = value, value_and_grad
    t.to_constrained, t.jacobian = to_constrained, jacobian
    t.q0 = to_unconstrained(torch.as_tensor(sampler.parameter_means,
                                            device=dev))
    w0 = torch.as_tensor(sampler.initial_jump_widths(), device=dev)
    t.inv_mass0 = torch.where(free, torch.clamp_min(w0, 1e-4) ** 2,
                              torch.zeros_like(w0))
    return t


def kinetic(p, inv_mass):
    return 0.5 * (inv_mass * p * p).sum(-1)


def momentum(mom, inv_mass):
    """Normals -> a momentum of covariance ``1 / inv_mass`` (0 where the
    mass is infinite: fixed parameters)."""
    sigma = torch.sqrt(torch.where(
        inv_mass > 0, 1.0 / torch.clamp_min(inv_mass, 1e-20),
        torch.zeros_like(inv_mass)))
    return mom * sigma


def warm_body(step, inv_mass0, target_accept: float):
    """A warmup step with dual averaging of the step size (hmc.py:
    188-206), its state float32: ``step(q, U, eps, inv_mass, xs)`` gives
    ``(q, U, accept statistic)``."""
    mu = float(math.log(10.0 * 0.1))

    def body(carry, xs):
        q, u_q, log_eps, log_eps_bar, h_bar, t = carry
        eps = torch.exp(log_eps)
        q, u_q, a_prob = step(q, u_q, eps, inv_mass0, xs)
        t = t + 1.0
        # t0 = 10, kappa = 0.75, gamma damped to 1 (hmc.py:196-200).
        eta = 1.0 / (t + 10.0)
        h_bar = (1.0 - eta) * h_bar + eta * (target_accept - a_prob)
        log_eps = mu - torch.sqrt(t) * h_bar
        pow_t = t ** (-0.75)
        log_eps_bar = pow_t * log_eps + (1.0 - pow_t) * log_eps_bar
        return (q, u_q, log_eps, log_eps_bar, h_bar, t), q

    return body


def _make_hmc_fns(hmc: HMC, read_bins: torch.Tensor):
    """HMC's warm and sampling bodies over the potential of
    :func:`_target` (hmc.py:100-225)."""
    t = _target(hmc, read_bins)
    free, q0 = t.free, t.q0
    nlf = hmc.num_leapfrog

    def leapfrog(q, p, eps, inv_mass):
        e = eps[..., None]
        _, g = t.value_and_grad(q)
        p = p - 0.5 * e * g
        for k in range(nlf):
            q = q + e * inv_mass * p
            q = torch.where(free, q, q0)
            u_new, g = t.value_and_grad(q)
            p = p - (e if k < nlf - 1 else 0.5 * e) * g
        t.leapfrogs += nlf * (q.shape[0] if q.dim() == 2 else 1)
        return q, p, u_new

    def hmc_step(q, u_q, eps, inv_mass, xs):
        mom, u = xs
        p = momentum(mom, inv_mass)
        k0 = kinetic(p, inv_mass)
        q_new, p_new, u_new = leapfrog(q, p, eps, inv_mass)
        k_new = kinetic(p_new, inv_mass)
        log_accept = (u_q + k0) - (u_new + k_new)
        accept_prob = torch.minimum(
            torch.exp(torch.minimum(log_accept, torch.zeros_like(log_accept))),
            torch.ones_like(log_accept))
        take = (u < accept_prob) & torch.isfinite(u_new)
        q = torch.where(take[..., None], q_new, q)
        u_q = torch.where(take, u_new, u_q)
        return q, u_q, accept_prob, take

    def warm_step(q, u_q, eps, inv_mass, xs):
        q, u_q, a_prob, _ = hmc_step(q, u_q, eps, inv_mass, xs)
        return q, u_q, a_prob

    def main_body(eps, inv_mass):
        def body(carry, xs):
            q, u_q = carry
            q, u_q, _, take = hmc_step(q, u_q, eps, inv_mass, xs)
            # The NLL from U without another evaluation.
            return ((q, u_q), (t.to_constrained(q), u_q + t.jacobian(q),
                               take.to(torch.float32)))
        return body

    t.warm_body = warm_body(warm_step, t.inv_mass0, hmc.target_accept)
    t.main_body = main_body
    return t


def scan(body, carry, xs):
    """Run ``body`` over the leading axis of the draws ``xs`` (JAX's
    ``lax.scan``): ``(carry, stacked outputs)``."""
    outs = []
    for k in range(xs[0].shape[0]):
        carry, out = body(carry, tuple(x[k] for x in xs))
        outs.append(out if isinstance(out, tuple) else (out,))
    return carry, tuple(torch.stack(o) for o in zip(*outs))


def initial_warm_carry(sampler: HMC, read_bins: torch.Tensor, fns=None,
                       nchains: int = 1):
    """A fresh dual-averaging warmup carry ``(q, U, log_eps, log_eps_bar,
    h_bar, t)`` (hmc.py:287-297): one evaluation of the potential."""
    fns = fns or sampler._fns(read_bins)
    q = fns.q0
    if nchains > 1:
        q = q.expand(nchains, -1).contiguous()
    u0 = fns.value(q)
    z = torch.zeros_like(u0)
    log_eps0 = torch.log(torch.full_like(u0, EPS0))
    return (q, u0, log_eps0, log_eps0.clone(), z, z.clone())


def warmup_segment(sampler: HMC, carry, read_bins: torch.Tensor, draws,
                   fns=None):
    """One checkpointable slice of warmup (hmc.py:256-272): ``draws`` the
    segment's (leading axis the step); returns ``(carry, warm_qs (n,
    [nchains,] npar))``."""
    fns = fns or sampler._fns(read_bins)
    carry, (warm_qs,) = scan(fns.warm_body, carry, draws)
    return carry, warm_qs


def main_segment(sampler: HMC, q, u_q, eps, inv_mass,
                 read_bins: torch.Tensor, draws, fns=None):
    """One checkpointable slice of sampling (hmc.py:275-284): returns
    ``((q, U), (samples (n, [nchains,] npar), nlls (n, [nchains]),
    accepts (n, [nchains])))``, the accept statistic NUTS's mean tree
    acceptance."""
    fns = fns or sampler._fns(read_bins)
    return scan(fns.main_body(eps, inv_mass), (q, u_q), draws)


def mass_from_warmup(sampler: HMC, warm_qs: torch.Tensor) -> torch.Tensor:
    """The diagonal inverse mass from the variance of the second half of
    warmup ``(n, [nchains,] npar)`` (hmc.py:300-305), taken in float64
    and rounded once to float32 (JAX takes it in float32)."""
    free = torch.as_tensor(~sampler.parameter_fixed, device=warm_qs.device)
    half = warm_qs[warm_qs.shape[0] // 2:]
    var = half.to(torch.float64).var(dim=0, correction=0).to(torch.float32)
    return torch.where(free, torch.clamp_min(var, 1e-8),
                       torch.zeros_like(var))
