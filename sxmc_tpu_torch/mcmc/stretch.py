"""Affine-invariant ensemble sampler, the Goodman & Weare (2010) stretch
move (port of ``sxmc_tpu/mcmc/stretch.py``).

An ensemble of walkers whose proposals are built from each other's
positions, so that no jump width is tuned.  For walker x_i of one half
and a partner x_j drawn from the other half:

    z ~ g(z) prop. 1/sqrt(z) on [1/a, a]   (z = ((a - 1) u + 1)^2 / a)
    y = x_j + z (x_i - x_j)                (free coordinates only)
    accept with prob min(1, z^(d - 1) exp(nll(x_i) - nll(y)))

with d the number of free parameters; the two halves move in turn, two
half-moves a step.  Each half-move is one batched NLL of half the
walkers through the split path (``metropolis._chain_nll(...,
allow_fused=False)``, the JAX package's ``_chain_nll_batch``): B1-batched
then B2 with floating systematics, the binned NLL on B1-batched, or
plain torch ops on the LUT built once with fixed ones.  ``nchains``
independent ensembles run as one batch: ``nchains x nwalkers / 2``
thetas a half-move.

The first ``nsteps * burnin_fraction`` steps are dropped; the rest pool
every walker of every ensemble (ensemble-major, then step, then walker).
Draws of a step (:func:`presample`): per half-move the z uniforms, the
partner indices and the accept uniforms; the initial cloud from its own
normals (:func:`initial_walkers`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.mcmc import metropolis
from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.ops.nll import df_diff
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

# nsteps -> (z uniforms (n, 2, [nchains,] half), partner indices (n, 2,
# [nchains,] half) int64 in [0, half), accept uniforms (n, 2, [nchains,]
# half)); axis 1 is the half-move (0: the first half moves).
StretchPresampler = Callable[[int], Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]]


class StretchSampler(MCMC):
    """Ensemble sampler with the call contract of :class:`MCMC`:
    ``nchains`` independent ensembles of ``nwalkers`` walkers (default
    ``max(2 * npar + 2, 16)``, rounded up to an even count)."""

    def __init__(self, *args, nwalkers: int = 0, a: float = 2.0, **kwargs):
        super().__init__(*args, **kwargs)
        if nwalkers <= 0:
            nwalkers = max(2 * self.nparameters + 2, 16)
        self.nwalkers = nwalkers + (nwalkers % 2)
        self.a = float(a)
        self.last_evaluations = None

    def __call__(
        self,
        data,
        nsteps: int,
        burnin_fraction: float = 0.1,
        debug_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        nchains: int = 1,
        presampler: Optional[StretchPresampler] = None,
        init_noise: Optional[torch.Tensor] = None,
    ) -> LikelihoodSpace:
        """Run ``nchains`` ensembles ``nsteps`` steps from clouds around
        the means; the draws come from ``generator`` (on this fit's
        device), or from ``presampler`` and ``init_noise`` ``([nchains,]
        nwalkers, npar)`` when given."""
        if nchains < 1:
            raise ValueError(f"nchains={nchains} must be at least 1")
        self.stack.set_data(data)
        burnin = int(nsteps * burnin_fraction)
        if presampler is None or init_noise is None:
            if generator is None:
                raise ValueError("pass a torch.Generator, or a presampler "
                                 "and init_noise")
        if init_noise is None:
            init_noise = walker_noise(self, generator, nchains)
        if presampler is None:
            gen = generator

            def presampler(n):
                return presample(self, gen, n, nchains)

        rb = self.stack.read_bins
        nll_batch = metropolis._chain_nll(self, rb, allow_fused=False)
        walkers, wnll = initial_walkers(self, init_noise, rb, nll_batch)
        _, (hist, hist_nll, acc) = stretch_segment(
            self, walkers, wnll, rb, presampler(nsteps), debug_mode,
            nll_batch)
        self.last_accept_rate = float(acc)
        self.last_evaluations = 1 + 2 * nsteps
        npar = self.nparameters
        kept = hist[burnin:]
        hi, lo = hist_nll[0][burnin:], hist_nll[1][burnin:]
        if nchains > 1:  # (n, nchains, K, ...) -> ensemble-major
            kept = kept.transpose(0, 1)
            hi, lo = hi.transpose(0, 1), lo.transpose(0, 1)
        return LikelihoodSpace.from_arrays(
            kept.reshape(-1, npar).cpu().numpy(),
            metropolis.nll_history_to_f64((hi, lo)).reshape(-1),
            self.parameter_names)


def walker_noise(s: StretchSampler, gen: torch.Generator,
                 nchains: int = 1) -> torch.Tensor:
    """The initial cloud's normals ``([nchains,] nwalkers, npar)`` from
    ``gen``."""
    lead = ((nchains,) if nchains > 1 else ()) + (s.nwalkers,)
    return torch.randn(lead + (s.nparameters,), generator=gen,
                       device=s.device, dtype=torch.float32)


def presample(s: StretchSampler, gen: torch.Generator, n: int,
              nchains: int = 1):
    """``n`` steps' draws from ``gen`` (see ``StretchPresampler``)."""
    half = s.nwalkers // 2
    lead = (n, 2) + ((nchains,) if nchains > 1 else ()) + (half,)
    z_u = torch.rand(lead, generator=gen, device=s.device,
                     dtype=torch.float32)
    pick = torch.randint(0, half, lead, generator=gen, device=s.device)
    acc_u = torch.rand(lead, generator=gen, device=s.device,
                       dtype=torch.float32)
    return z_u, pick, acc_u


def _flat_nll(nll_batch, x):
    """The NLL pairs of walkers ``(..., npar)`` in one batched call."""
    hi, lo = nll_batch(x.reshape(-1, x.shape[-1]))
    return hi.reshape(x.shape[:-1]), lo.reshape(x.shape[:-1])


def initial_walkers(s: StretchSampler, noise: torch.Tensor,
                    read_bins: torch.Tensor, nll_batch=None):
    """The initial cloud and its NLL pairs (stretch.py:91-111): the means
    plus ``noise`` times the initial jump widths on the free parameters,
    free rates floored at ``1e-4 * max(|mean|, 1)`` (negative rates are
    the barrier region).  One batched NLL of every walker."""
    if nll_batch is None:
        nll_batch = metropolis._chain_nll(s, read_bins, allow_fused=False)
    dev = s.device
    npar = s.nparameters
    free = torch.as_tensor(~s.parameter_fixed, device=dev)
    means = torch.as_tensor(s.parameter_means, device=dev)
    w0 = torch.clamp_min(torch.as_tensor(s.initial_jump_widths(),
                                         device=dev), 0.0)
    walkers = means + torch.where(free, noise * w0, torch.zeros_like(noise))
    is_rate = torch.arange(npar, device=dev) < s.nsources
    floor = 1e-4 * torch.clamp_min(torch.abs(means), 1.0)
    walkers = torch.where(is_rate & free, torch.maximum(walkers, floor),
                          walkers)
    return walkers, _flat_nll(nll_batch, walkers)


def stretch_segment(s: StretchSampler, walkers, wnll,
                    read_bins: torch.Tensor, draws,
                    debug_mode: bool = False, nll_batch=None):
    """Advance the ensemble(s) ``walkers ([nchains,] nwalkers, npar)`` by
    the steps of ``draws`` (stretch.py:114-163).  Returns ``((walkers,
    (hi, lo)), (history (n, [nchains,] nwalkers, npar), (hi, lo)
    histories, accept rate))``, the rate a 0-dim device tensor."""
    if nll_batch is None:
        nll_batch = metropolis._chain_nll(s, read_bins, allow_fused=False)
    half = s.nwalkers // 2
    dev = s.device
    free = torch.as_tensor(~s.parameter_fixed, device=dev)
    d = float(np.float32(max(s.nfloat, 1)))
    a = s.a
    z_u, pick, acc_u = draws
    n = z_u.shape[0]

    def half_update(active, active_nll, other, zu, idx, au):
        z = ((a - 1.0) * zu + 1.0) ** 2 / a
        partners = torch.gather(
            other, -2, idx[..., None].expand(idx.shape + other.shape[-1:]))
        prop = partners + z[..., None] * (active - partners)
        prop = torch.where(free, prop, active)
        p_hi, p_lo = _flat_nll(nll_batch, prop)
        delta = df_diff(active_nll[0], active_nll[1], p_hi, p_lo)
        log_acc = (d - 1.0) * torch.log(z) + delta
        accept = torch.log(au) < log_acc
        if debug_mode:
            accept = torch.ones_like(accept)
        new = torch.where(accept[..., None], prop, active)
        return (new, (torch.where(accept, p_hi, active_nll[0]),
                      torch.where(accept, p_lo, active_nll[1])), accept)

    hist = torch.empty((n,) + tuple(walkers.shape), dtype=torch.float32,
                       device=dev)
    hist_hi = torch.empty((n,) + tuple(walkers.shape[:-1]),
                          dtype=torch.float32, device=dev)
    hist_lo = torch.empty_like(hist_hi)
    accs = torch.empty(n, dtype=torch.float32, device=dev)
    for k in range(n):
        w0, w1 = walkers[..., :half, :], walkers[..., half:, :]
        n0 = (wnll[0][..., :half], wnll[1][..., :half])
        n1 = (wnll[0][..., half:], wnll[1][..., half:])
        w0, n0, a0 = half_update(w0, n0, w1, z_u[k, 0], pick[k, 0],
                                 acc_u[k, 0])
        w1, n1, a1 = half_update(w1, n1, w0, z_u[k, 1], pick[k, 1],
                                 acc_u[k, 1])
        walkers = torch.cat([w0, w1], dim=-2)
        wnll = (torch.cat([n0[0], n1[0]], dim=-1),
                torch.cat([n0[1], n1[1]], dim=-1))
        hist[k], hist_hi[k], hist_lo[k] = walkers, wnll[0], wnll[1]
        accs[k] = torch.cat([a0, a1], dim=-1).to(torch.float32).mean()
    return (walkers, wnll), (hist, (hist_hi, hist_lo), accs.mean())
