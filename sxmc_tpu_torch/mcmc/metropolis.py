"""Adaptive Metropolis MCMC on one device (port of the single-chain
diagonal path of ``sxmc_tpu/mcmc/metropolis.py``).

Semantics (reference src/mcmc.{h,cpp}, nll_kernels.cpp:191-271):
  * parameter vector = source rates then systematic coefficients, with
    means/sigmas/fixed flattened identically (mcmc.cpp:47-81);
  * initial jump widths 0.1 * width * (2.4^2 / nfloat), fixed
    parameters pinned with width -1 (mcmc.cpp:197-228);
  * independent Gaussian proposals per parameter; the accept is the
    fused TPU path's log form ``delta > 0 or log(u) <= delta``
    (pallas_step.py:782-792), debug mode accepts everything;
  * three fixed-width phases: burn-in 1, burn-in 2, main, with the
    widths retuned from each burn-in phase's sample RMS, and the burn-in
    samples dropped unless debug (mcmc.cpp:273-311,
    metropolis.py:1221-1289).

Each phase is ONE launch of the whole-segment kernel (B4) and the
chain's initial NLL one launch of the fused NLL kernel (B3), through
``PdfStack``.  The proposal noise and accept uniforms of a phase are
drawn up front on the device from the chain's ``torch.Generator``
(:func:`presample`); a caller may inject other streams instead, which
is how the tests feed the JAX package's ``_presample`` streams to both
packages.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.ops.nll import NLLStatic
from sxmc_tpu_torch.pdf.stack import PdfStack
from sxmc_tpu_torch.signal import Observable, Signal, Source, Systematic
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

HAARIO = 2.4 * 2.4  # Haario et al. 2001 proposal scaling (mcmc.cpp:199)

# (phase index 0/1/2, nsteps) -> (noise (n, npar), log_u (n,)) float32.
Presampler = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


def nll_history_to_f64(nll_pair_hist) -> np.ndarray:
    """Chain NLL history (hi, lo) pair -> f64 values on the host."""
    hi, lo = nll_pair_hist
    return (np.asarray(hi.cpu(), np.float64)
            + np.asarray(lo.cpu(), np.float64))


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to sxmc_tpu_torch yet ({item})")


class MCMC:
    """The MCMC fit (reference: mcmc.h:41-77) on one device."""

    def __init__(
        self,
        sources: Sequence[Source],
        signals: Sequence[Signal],
        systematics: Sequence[Systematic],
        observables: Sequence[Observable],
        device="cpu",
        binned: bool = False,
    ):
        if binned:
            _not_ported("the binned likelihood",
                        "ROADMAP queue A, item 2")
        self.device = torch.device(device)
        self.nsources = len(sources)
        self.nsignals = len(signals)
        self.sources = list(sources)
        self.signals = list(signals)
        self.systematics = list(systematics)
        self.observables = list(observables)

        npars_syst = sum(s.npars for s in systematics)
        self.nparameters = self.nsources + npars_syst
        means = np.zeros(self.nparameters, np.float32)
        sigmas = np.zeros(self.nparameters, np.float32)
        fixed = np.zeros(self.nparameters, bool)
        names = []
        for i, src in enumerate(sources):
            means[i], sigmas[i], fixed[i] = src.mean, src.sigma, src.fixed
            names.append(src.name)
        k = self.nsources
        self.systematics_fixed = True
        for syst in systematics:
            if not syst.fixed:
                self.systematics_fixed = False
            for j in range(syst.npars):
                means[k], sigmas[k] = syst.means[j], syst.sigmas[j]
                fixed[k] = syst.fixed
                names.append(f"{syst.name}_{j}")
                k += 1
        self.parameter_means = means
        self.parameter_sigma = sigmas
        self.parameter_fixed = fixed
        self.parameter_names = names
        self.nfloat = int((~fixed).sum())
        self.nsystematics = len(systematics)
        if self.nsystematics == 0 or self.systematics_fixed:
            _not_ported(
                "a fit without a floating systematic (the split "
                "pallas_eval_lut path)", "ROADMAP queue B, kernel B2")

        self.stack = PdfStack(signals, observables, systematics,
                              self.device)
        self.static = NLLStatic(
            nexpected=np.asarray([s.nexpected for s in signals],
                                 np.float32),
            n_mc=np.asarray([s.n_mc for s in signals], np.float32),
            source_id=np.asarray([s.source.index for s in signals],
                                 np.int32),
            means=means.copy(), sigmas=sigmas.copy(),
            nsources=self.nsources)
        self.last_accept_rate = None

    def initial_jump_widths(self) -> np.ndarray:
        """0.1 * width * 2.4^2/nfloat; fixed -> -1 (mcmc.cpp:197-228)."""
        sf = HAARIO / max(self.nfloat, 1)
        w = np.empty(self.nparameters, np.float32)
        for i in range(self.nparameters):
            if self.parameter_fixed[i]:
                w[i] = -1.0
                continue
            mean = self.parameter_means[i]
            sigma = self.parameter_sigma[i]
            if sigma > 0:
                width = sigma
            elif i < self.nsources:
                m = max(mean, 10.0)
                width = np.sqrt(m) / m
            else:
                width = np.sqrt(max(mean, 1.0))
            w[i] = 0.1 * width * sf
        return w

    def __call__(
        self,
        data: np.ndarray,
        nsteps: int,
        burnin_fraction: float = 0.1,
        debug_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        nchains: int = 1,
        rate_substeps: int = 0,
        proposal: str = "diagonal",
        presampler: Optional[Presampler] = None,
    ) -> LikelihoodSpace:
        """Run the random walk; returns the likelihood space.

        ``data`` is ``(nevents, nobservables + 1)`` with dataset tags.
        The noise comes from ``generator`` (a ``torch.Generator`` on
        this MCMC's device), or from ``presampler`` when given.
        """
        if nchains != 1:
            _not_ported("nchains > 1 (lock-step batched chains)",
                        "ROADMAP queue A, item 5")
        if rate_substeps:
            _not_ported("rate_substeps > 0 (blocked Metropolis-within-"
                        "Gibbs)", "ROADMAP queue A, item 6, kernel B5")
        if proposal == "full_cov":
            _not_ported("proposal 'full_cov'", "ROADMAP queue A, item 6")
        if proposal != "diagonal":
            raise ValueError(f"unknown proposal {proposal!r}")
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
                return presample(gen, n, self.nparameters, self.device)

        samples, nlls, accept_rate = run_chain(
            self, self.stack.read_bins, nsteps, burnin_steps, debug_mode,
            presampler)
        self.last_accept_rate = float(accept_rate)
        return LikelihoodSpace.from_arrays(
            samples.cpu().numpy(), nll_history_to_f64(nlls),
            self.parameter_names)


def presample(gen: torch.Generator, n: int, npar: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A phase's proposal noise ``(n, npar)`` ~ N(0, 1) and accept
    ``log(u)`` ``(n,)``, u ~ U[0, 1), drawn on the device from ``gen``."""
    noise = torch.randn((n, npar), generator=gen, device=device,
                        dtype=torch.float32)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    return noise, torch.log(u)


def initial_state(mcmc: MCMC, read_bins: torch.Tensor):
    """Initial ``(params, (hi, lo), width)`` of a chain (kernel B3)."""
    dev = mcmc.device
    params0 = torch.as_tensor(mcmc.parameter_means, device=dev)
    nll0 = mcmc.stack.fused_nll_pair(params0, read_bins, mcmc.static)
    width0 = torch.as_tensor(mcmc.initial_jump_widths(), device=dev)
    return params0, nll0, width0


def retune_width(mcmc: MCMC, width: torch.Tensor,
                 phase_samples: torch.Tensor) -> torch.Tensor:
    """Jump-width rescale from a burn-in phase (mcmc.cpp:279-305).

    The sample RMS is taken in f64 and rounded once to f32 (the JAX
    package takes it in f32; the two agree to an ulp).
    """
    sf = HAARIO / max(mcmc.nfloat, 1)
    fixed = torch.as_tensor(mcmc.parameter_fixed, device=width.device)
    rms = phase_samples.to(torch.float64).std(dim=0, correction=0).to(
        torch.float32)
    new = torch.where(rms > 0, sf * rms, width)
    return torch.where(fixed, torch.full_like(new, -1.0), new)


def run_segment(mcmc: MCMC, params, cur_nll, width, read_bins,
                noise: torch.Tensor, log_u: torch.Tensor,
                debug_mode: bool = False):
    """One fixed-width segment as ONE whole-segment kernel launch.

    ``cur_nll`` is the (hi, lo) pair of ``params``.  Returns
    ``(params, (hi, lo), samples (n, npar), (hi (n,), lo (n,)),
    accepts (n,))``: the carry and the scan history of the JAX
    package's ``run_segment``.
    """
    nll0 = torch.stack([cur_nll[0], cur_nll[1]]).to(torch.float32)
    samples, nlls, accs = mcmc.stack.fused_segment(
        params, nll0, width, read_bins, noise, log_u, mcmc.static,
        debug_mode)
    carry_nll = (nlls[-1, 0], nlls[-1, 1])
    return samples[-1], carry_nll, samples, (nlls[:, 0], nlls[:, 1]), accs


def run_chain(mcmc: MCMC, read_bins: torch.Tensor, nsteps: int,
              burnin_steps: int, debug_mode: bool,
              presampler: Presampler):
    """One chain through its three phases (metropolis.py:1221-1289).

    Returns ``(samples, (hi, lo), accept_rate)`` of the recorded steps
    (the main phase, plus the burn-in phases in debug mode).
    """
    params, cur, width = initial_state(mcmc, read_bins)

    def phase(k, n, params, cur, width):
        noise, log_u = presampler(k, n)
        return run_segment(mcmc, params, cur, width, read_bins, noise,
                           log_u, debug_mode)

    outs = []
    if burnin_steps > 0:
        for k in (0, 1):
            params, cur, s, n, a = phase(k, burnin_steps, params, cur,
                                         width)
            width = retune_width(mcmc, width, s)
            if debug_mode:
                outs.append((s, n, a))
    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0 else 0),
                    0)
    if remaining > 0:
        params, cur, s, n, a = phase(2, remaining, params, cur, width)
        outs.append((s, n, a))

    samples = torch.cat([o[0] for o in outs])
    nlls = (torch.cat([o[1][0] for o in outs]),
            torch.cat([o[1][1] for o in outs]))
    accepts = torch.cat([o[2] for o in outs])
    return samples, nlls, accepts.mean()
