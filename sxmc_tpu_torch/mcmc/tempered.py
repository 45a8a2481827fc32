"""Parallel-tempered (replica-exchange) Metropolis on one device (port of
``sxmc_tpu/mcmc/tempered.py``).

A ladder of ``ntemps`` replicas samples the posterior annealed by
inverse temperatures beta_k (beta_0 = 1 is the physical posterior;
hotter replicas see a flattened landscape and cross likelihood barriers).
Adjacent replicas propose to exchange states every ``swap_every`` steps
with the detailed-balance probability

    min(1, exp((beta_i - beta_j) * (NLL_i - NLL_j))),

alternating the pairings (0,1)(2,3)... and (1,2)(3,4)...; only the cold
chain's samples are returned.  Proposal widths scale as 1/sqrt(beta),
and every replica retunes from the cold chain's burn-in RMS.

Two routes, as the JAX package chooses them (tempered.py:377-384):
  * **fused** (floating systematics, unbinned): each full swap interval
    is ONE launch of B4's tempered form (``kernels.
    fused_segment_tempered``: the ladder as lock-step chains, beta in
    the accept, the 1/sqrt(beta) widening in the width rows), then the
    exchange as torch ops on the device; a phase's remainder steps run
    as one more launch without a swap.  The swap cadence counts phase-
    local intervals, and the exchange's state overwrites the interval's
    last cold sample (tempered.py:227-358).  Nothing is read back to the
    host per interval: the swap counts stay on the device until the fit
    ends.
  * **stepper** (fixed systematics, or the binned likelihood): a loop of
    torch ops per step (tempered.py:121-202), the ladder's NLLs through
    the split path (``_chain_nll`` without the fused kernels, as the
    JAX package's ``_chain_nll_batch`` without ``allow_fused``), accept
    ``u <= exp(beta * delta)``, the exchange at every ``swap_every``-th
    step of a global step count.

The initial ladder NLL always takes the split path (B1-batched, then B2,
then ``nll_pair``), as in the JAX package (tempered.py:374).

Streams: a presampler hands out, per phase of ``n`` steps, ``noise (n,
ntemps, npar)``, ``u (n, ntemps)`` and ``swap_u (n, ntemps)``: one
vector of exchange uniforms per step (the fused route reads the one of
each interval's last step; pair (i, j) reads entry min(i, j)).  Tests
inject the JAX package's streams through it (``interop``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.mcmc import metropolis
from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.ops.nll import df_diff
from sxmc_tpu_torch.signal import Observable, Signal, Source, Systematic
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

# (phase index 0/1/2, nsteps) -> (noise (n, ntemps, npar), u (n, ntemps),
# swap_u (n, ntemps)) float32, u and swap_u ~ U[0, 1).
TemperedPresampler = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]]


def temperature_ladder(ntemps: int, tmax: float) -> np.ndarray:
    """Geometric inverse-temperature ladder: beta_0 = 1 .. 1/tmax."""
    if ntemps == 1:
        return np.ones(1, np.float32)
    return np.asarray(tmax ** (-np.arange(ntemps) / (ntemps - 1)),
                      np.float32)


def swap_partners(ntemps: int) -> np.ndarray:
    """``(2, ntemps)`` partner of each replica in pairing 0, (0,1)(2,3)...,
    and pairing 1, (1,2)(3,4)...; an unpaired replica is its own partner.
    With two replicas both pairings are (0,1): the odd one would attempt
    nothing (tempered.py:135-147)."""
    idx = np.arange(ntemps)
    p0 = idx ^ 1
    p0[p0 >= ntemps] = idx[p0 >= ntemps]
    p1 = np.where(idx == 0, 0, ((idx - 1) ^ 1) + 1)
    p1[p1 >= ntemps] = idx[p1 >= ntemps]
    if ntemps == 2:
        p1 = p0
    return np.stack([p0, p1])


def presample_tempered(gen: torch.Generator, n: int, ntemps: int, npar: int,
                       device) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """A phase's streams drawn on the device from ``gen``: ``noise`` ~
    N(0, 1) ``(n, ntemps, npar)``, ``u`` and ``swap_u`` ~ U[0, 1) ``(n,
    ntemps)``."""
    noise = torch.randn((n, ntemps, npar), generator=gen, device=device,
                        dtype=torch.float32)
    u = torch.rand((n, ntemps), generator=gen, device=device,
                   dtype=torch.float32)
    swap_u = torch.rand((n, ntemps), generator=gen, device=device,
                        dtype=torch.float32)
    return noise, u, swap_u


class _Exchange:
    """The replica exchange of one pairing, as device ops with no host
    synchronisation (tempered.py:171-190, 266-283)."""

    def __init__(self, beta: torch.Tensor):
        ntemps = beta.shape[0]
        dev = beta.device
        idx = np.arange(ntemps)
        self.tables = []
        for partner in swap_partners(ntemps):
            p = torch.as_tensor(partner, device=dev)
            self.tables.append((
                p, torch.as_tensor(np.minimum(idx, partner), device=dev),
                torch.as_tensor(partner != idx, device=dev),
                torch.as_tensor(idx < partner, device=dev),
                beta - beta[p], max(int((partner > idx).sum()), 1)))

    def npairs(self, pairing: int) -> int:
        return self.tables[pairing][5]

    def __call__(self, pairing: int, params, hi, lo, swap_u):
        """``(params, hi, lo, nswaps)`` after the exchange; ``nswaps``
        counts each accepted pair once (a 0-dim device tensor)."""
        partner, low, paired, lower, bdiff, _ = self.tables[pairing]
        hp, lp = hi[partner], lo[partner]
        log_a = bdiff * df_diff(hi, lo, hp, lp)
        ok = paired & ((log_a >= 0) | (swap_u[low] <= torch.exp(log_a)))
        return (torch.where(ok[:, None], params[partner], params),
                torch.where(ok, hp, hi), torch.where(ok, lp, lo),
                (ok & lower).sum())


def _fused_phase(mcmc: MCMC, read_bins: torch.Tensor, debug_mode: bool,
                 beta: torch.Tensor, swap_every: int, exchange: _Exchange):
    """Phase runner on B4's tempered form, keyed by a global step count
    ``istep`` as the stepper is: the exchange follows step k where
    ``(istep + k) % swap_every == swap_every - 1``, with pairing
    ``((istep + k) // swap_every) % 2``, and each launch runs up to the
    next such step (or the end of the phase).  The exchange's state
    overwrites that step's cold sample (tempered.py:285-358).
    :func:`run_tempered` keys it by its phase-local interval count
    (``istep = intervals * swap_every`` at each phase start), the
    checkpointed ladder (:func:`tempered_segment`) by the global step
    count, so that a segment boundary inside an interval ends a launch
    early and the exchange still waits for the cadence."""
    stack, spec = mcmc.stack, mcmc.nll_spec
    sqrt_beta = torch.sqrt(beta)[:, None]
    npar = mcmc.nparameters

    def run_phase(carry, noise, u, swap_u):
        params, (hi, lo), width, istep = carry
        n = noise.shape[0]
        w_eff = width / sqrt_beta
        log_u = torch.log(u)
        dev = params.device
        cold_s = torch.empty((n, npar), dtype=torch.float32, device=dev)
        cold_n = torch.empty((n, 2), dtype=torch.float32, device=dev)
        cold_a = torch.empty(n, dtype=torch.float32, device=dev)
        frac = torch.zeros(n, dtype=torch.float32, device=dev)
        att = torch.zeros(n, dtype=torch.float32, device=dev)

        def segment(a, b):
            nll0 = torch.stack([hi, lo], dim=-1)
            s, nl, acc = stack.fused_segment_tempered(
                params, nll0, w_eff, beta, read_bins, noise[a:b],
                log_u[a:b], spec, debug_mode)
            cold_s[a:b] = s[:, 0]
            cold_n[a:b] = nl[:, 0]
            cold_a[a:b] = acc[:, 0]
            return s[-1], nl[-1, :, 0], nl[-1, :, 1]

        a = 0
        while a < n:
            k = a + swap_every - 1 - (istep + a) % swap_every
            b = min(k + 1, n)
            params, hi, lo = segment(a, b)
            if k < n:
                pairing = ((istep + k) // swap_every) % 2
                params, hi, lo, nswaps = exchange(pairing, params, hi, lo,
                                                  swap_u[k])
                frac[k] = nswaps.to(torch.float32) / exchange.npairs(pairing)
                att[k] = 1.0
                # The post-swap state is the interval's last recorded step.
                cold_s[k] = params[0]
                cold_n[k, 0] = hi[0]
                cold_n[k, 1] = lo[0]
            a = b
        return ((params, (hi, lo), width, istep + n), cold_s,
                (cold_n[:, 0], cold_n[:, 1]), cold_a, (frac, att))

    return run_phase


def _stepper_phase(mcmc: MCMC, batch_nll, debug_mode: bool,
                   beta: torch.Tensor, swap_every: int, exchange: _Exchange):
    """Phase runner of torch ops per step (tempered.py:149-202): the
    annealed Metropolis move of every replica, then, at every
    ``swap_every``-th step of the global count, the exchange."""
    sqrt_beta = torch.sqrt(beta)[:, None]
    npar = mcmc.nparameters

    def run_phase(carry, noise, u, swap_u):
        params, (cur_hi, cur_lo), width, istep = carry
        n = noise.shape[0]
        dev = params.device
        samples = torch.empty((n, npar), dtype=torch.float32, device=dev)
        hist_hi = torch.empty(n, dtype=torch.float32, device=dev)
        hist_lo, accs = torch.empty_like(hist_hi), torch.empty_like(hist_hi)
        frac = torch.zeros(n, dtype=torch.float32, device=dev)
        att = torch.zeros(n, dtype=torch.float32, device=dev)
        wpos = torch.clamp_min(width, 0.0)
        for k in range(n):
            nz = noise[k] * wpos / sqrt_beta
            proposed = torch.where(width > 0, params + nz, params)
            prop_hi, prop_lo = batch_nll(proposed)
            delta = beta * df_diff(cur_hi, cur_lo, prop_hi, prop_lo)
            accept = (delta > 0) | (u[k] <= torch.exp(delta))
            if debug_mode:
                accept = torch.ones_like(accept)
            params, cur_hi, cur_lo = metropolis._take(
                accept, proposed, prop_hi, prop_lo, params, cur_hi, cur_lo)
            if istep % swap_every == swap_every - 1:
                pairing = (istep // swap_every) % 2
                params, cur_hi, cur_lo, nsw = exchange(
                    pairing, params, cur_hi, cur_lo, swap_u[k])
                frac[k] = nsw.to(torch.float32) / exchange.npairs(pairing)
                att[k] = 1.0
            samples[k], hist_hi[k], hist_lo[k] = params[0], cur_hi[0], cur_lo[0]
            accs[k] = accept[0]
            istep += 1
        return ((params, (cur_hi, cur_lo), width, istep), samples,
                (hist_hi, hist_lo), accs, (frac, att))

    return run_phase


def run_tempered(mcmc: MCMC, read_bins: torch.Tensor, nsteps: int,
                 burnin_steps: int, debug_mode: bool, betas: Sequence[float],
                 swap_every: int, presampler: TemperedPresampler):
    """The lock-step tempered walk through the three phases (JAX
    ``_run_tempered``, tempered.py:361-430): two burn-in phases, each
    followed by a retune of every replica from the cold chain's RMS
    (fixed parameters get -1), then the main phase.

    Returns ``(samples (nkeep, npar), (hi, lo), accept_rate,
    swap_rate)``: the cold chain's post-step states of the recorded
    phases (the main one, and the burn-in ones in debug mode), its
    accept rate and the mean exchange acceptance over the attempts, the
    last two as 0-dim device tensors.
    """
    ntemps = len(betas)
    dev = mcmc.device
    if not (np.asarray(betas) > 0).all():
        raise ValueError(f"inverse temperatures must be > 0, got {betas}")
    beta = torch.as_tensor(np.asarray(betas, np.float32), device=dev)
    exchange = _Exchange(beta)
    batch_nll = metropolis._chain_nll(mcmc, read_bins, allow_fused=False)
    if metropolis._fused_ok(mcmc):
        by_step = _fused_phase(mcmc, read_bins, debug_mode, beta,
                               swap_every, exchange)

        def run_phase(carry, noise, u, swap_u):
            # The swap cadence counts phase-local intervals (carry[3]).
            out = by_step(carry[:3] + (carry[3] * swap_every,), noise, u,
                          swap_u)
            return ((out[0][:3] + (carry[3] + noise.shape[0] // swap_every,),)
                    + out[1:])
    else:
        run_phase = _stepper_phase(mcmc, batch_nll, debug_mode, beta,
                                   swap_every, exchange)
    npar = mcmc.nparameters
    params0 = torch.as_tensor(mcmc.parameter_means, device=dev).expand(
        ntemps, npar).contiguous()
    width0 = torch.as_tensor(mcmc.initial_jump_widths(), device=dev).expand(
        ntemps, npar).contiguous()
    carry = (params0, batch_nll(params0), width0, 0)

    def phase(k, n, carry):
        noise, u, swap_u = presampler(k, n)
        want = ((n, ntemps, npar), (n, ntemps), (n, ntemps))
        got = tuple(tuple(t.shape) for t in (noise, u, swap_u))
        if got != want:
            raise ValueError(f"phase {k} streams have shapes {got}; this "
                             f"ladder takes {want}")
        return run_phase(carry, noise, u, swap_u)

    outs = []
    if burnin_steps > 0:
        for k in (0, 1):
            carry, s, nl, a, sw = phase(k, burnin_steps, carry)
            carry = (carry[0], carry[1],
                     metropolis.retune_width(mcmc, carry[2], s), carry[3])
            if debug_mode:
                outs.append((s, nl, a, sw))
    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0 else 0),
                    0)
    if remaining > 0:
        carry, s, nl, a, sw = phase(2, remaining, carry)
        outs.append((s, nl, a, sw))

    samples = torch.cat([o[0] for o in outs])
    hi = torch.cat([o[1][0] for o in outs])
    lo = torch.cat([o[1][1] for o in outs])
    accepts = torch.cat([o[2] for o in outs])
    fracs = torch.cat([o[3][0] for o in outs])
    attempts = torch.cat([o[3][1] for o in outs])
    swap_rate = fracs.sum() / torch.clamp_min(attempts.sum(), 1.0)
    return samples, (hi, lo), accepts.mean(), swap_rate


def make_tempered_segment(mcmc: MCMC, read_bins: torch.Tensor,
                          debug_mode: bool, betas: Sequence[float],
                          swap_every: int):
    """The segment runner of the checkpointed ladder: ``run(carry, noise,
    u, swap_u)`` -> ``(carry, cold samples (n, npar), (hi (n,), lo
    (n,)), cold accepts (n,), (swap fractions (n,), attempts (n,)))``
    with ``carry = (params (ntemps, npar), (hi, lo), width, istep)`` and
    ``istep`` the global step count, which sets the swap cadence and the
    pairing on both routes (the fused one ends a launch early at a
    segment boundary inside a swap interval).  Built once per fit: with
    fixed systematics the stepper's LUT is made here (B1 + B2)."""
    beta = torch.as_tensor(np.asarray(betas, np.float32),
                           device=mcmc.device)
    exchange = _Exchange(beta)
    if metropolis._fused_ok(mcmc):
        return _fused_phase(mcmc, read_bins, debug_mode, beta, swap_every,
                            exchange)
    batch_nll = metropolis._chain_nll(mcmc, read_bins, allow_fused=False)
    return _stepper_phase(mcmc, batch_nll, debug_mode, beta, swap_every,
                          exchange)


def tempered_segment(mcmc: MCMC, params, cur_nll, width, istep: int,
                     read_bins: torch.Tensor, noise, u, swap_u,
                     debug_mode: bool, betas: Sequence[float],
                     swap_every: int, run=None):
    """One fixed-width tempered segment from an explicit ladder state
    (JAX tempered.py:205-224): the streams ``noise (n, ntemps, npar)``,
    ``u`` and ``swap_u (n, ntemps)`` advance ``(params, (hi, lo),
    width)`` by ``n`` steps from global step ``istep``.  ``run`` is a
    :func:`make_tempered_segment` runner to reuse.  Returns ``(params,
    (hi, lo), istep, cold samples, (hi, lo) history, cold accepts (n,),
    (swap fractions (n,), attempts (n,)))``: the JAX package's accept
    and swap rates are ``accepts.mean()`` and ``fractions.sum() /
    max(attempts.sum(), 1)``."""
    if run is None:
        run = make_tempered_segment(mcmc, read_bins, debug_mode, betas,
                                    swap_every)
    carry, samples, nlls, accepts, swaps = run(
        (params, cur_nll, width, int(istep)), noise, u, swap_u)
    return carry[0], carry[1], carry[3], samples, nlls, accepts, swaps


class TemperedMCMC:
    """Replica-exchange wrapper around the Metropolis machinery: the
    constructor and call of :class:`MCMC`, plus the ladder geometry.
    ``__call__`` returns the cold chain's likelihood space;
    ``last_accept_rate`` and ``last_swap_rate`` record the cold chain's
    acceptance and the mean exchange acceptance."""

    def __init__(
        self,
        sources: Sequence[Source],
        signals: Sequence[Signal],
        systematics: Sequence[Systematic],
        observables: Sequence[Observable],
        ntemps: int = 8,
        tmax: float = 32.0,
        swap_every: int = 10,
        binned: bool = False,
        device="cuda",
    ):
        if ntemps < 1 or swap_every < 1:
            raise ValueError(f"ntemps={ntemps} and swap_every={swap_every} "
                             "must be at least 1")
        self.mcmc = MCMC(sources, signals, systematics, observables,
                         device=device, binned=binned)
        self.ntemps = int(ntemps)
        self.tmax = float(tmax)
        self.swap_every = int(swap_every)
        self.betas = temperature_ladder(self.ntemps, self.tmax)
        self.device = self.mcmc.device
        self.stack = self.mcmc.stack
        self.nparameters = self.mcmc.nparameters
        self.nsources = self.mcmc.nsources
        self.parameter_names = self.mcmc.parameter_names
        self.static = self.mcmc.static
        self.nll_spec = self.mcmc.nll_spec
        self.last_accept_rate = None
        self.last_swap_rate = None

    def __call__(
        self,
        data: np.ndarray,
        nsteps: int,
        burnin_fraction: float = 0.1,
        debug_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        nchains: int = 1,
        presampler: Optional[TemperedPresampler] = None,
    ) -> LikelihoodSpace:
        """Run the ladder on ``data`` ``(nevents, nobservables + 1)``.
        ``nchains`` is accepted for the ensemble driver and ignored (the
        ladder is not a set of chains, tempered.py:92).  The streams come
        from ``generator`` (a ``torch.Generator`` on this fit's device),
        or from ``presampler`` when given."""
        del nchains
        self.stack.set_data(data)
        burnin_steps = int(nsteps * burnin_fraction)
        if burnin_steps > 0 and nsteps <= 2 * burnin_steps \
                and not debug_mode:
            raise ValueError(
                f"nsteps={nsteps} leaves no post-burn-in samples "
                f"(two burn-in phases of {burnin_steps}); lower "
                f"burnin_fraction below 0.5 or raise nsteps")
        if presampler is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or a presampler")
            gen = generator

            def presampler(phase, n):
                return presample_tempered(gen, n, self.ntemps,
                                          self.nparameters, self.device)

        samples, nlls, accept, swap = run_tempered(
            self.mcmc, self.stack.read_bins, nsteps, burnin_steps,
            debug_mode, tuple(float(b) for b in self.betas),
            self.swap_every, presampler)
        self.last_accept_rate = float(accept)
        self.last_swap_rate = float(swap)
        return LikelihoodSpace.from_arrays(
            samples.cpu().numpy(), metropolis.nll_history_to_f64(nlls),
            self.parameter_names)
