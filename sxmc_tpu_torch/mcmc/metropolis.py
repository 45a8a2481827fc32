"""Adaptive Metropolis MCMC on one device (port of
``sxmc_tpu/mcmc/metropolis.py``: one chain or lock-step chains, with
diagonal or full-covariance proposals, joint or blocked updates).

Semantics (reference src/mcmc.{h,cpp}, nll_kernels.cpp:191-271):
  * parameter vector = source rates then systematic coefficients, with
    means/sigmas/fixed flattened identically (mcmc.cpp:47-81);
  * initial jump widths 0.1 * width * (2.4^2 / nfloat), fixed
    parameters pinned with width -1 (mcmc.cpp:197-228);
  * independent Gaussian proposals per parameter; debug mode accepts
    everything;
  * three fixed-width phases: burn-in 1, burn-in 2, main, with the
    widths retuned from each burn-in phase's sample RMS (per chain),
    and the burn-in samples dropped unless debug (mcmc.cpp:273-311,
    metropolis.py:1221-1289); lock-step chains are pooled chain-major
    into ``(nchains * nkeep, npar)`` (metropolis.py:228-233).

Two options of the JAX package change the moves:
  * ``proposal="full_cov"``: Haario full-covariance proposals ``cur + L
    @ z``; the first burn-in phase walks with ``L = diag(widths)``, and
    each retune replaces L with the Cholesky factor of the scaled phase
    covariance (:func:`retune_scale_tril`, metropolis.py:519-592);
  * ``rate_substeps = M > 0`` (blocked Metropolis-within-Gibbs, with a
    floating systematic and a source): each recorded cycle is one
    systematic-block move (every parameter but the rates; a rebuild)
    and M rate-block moves against the current histograms
    (metropolis.py:783-862); ``nsteps`` counts cycles.

Two routes, chosen as the JAX package chooses them (``_fused_ok``,
metropolis.py:378-390):
  * **fused** (floating systematics, unbinned likelihood): each phase is
    ONE launch of a whole-segment kernel -- B4 (``fused_segment``; its
    tril form for full_cov) or B5 (``blocked_segment``) -- and the
    initial NLL one launch of B3, in their batched forms for lock-step
    chains; accept ``delta > 0 or log(u) <= delta``, as the TPU kernels
    (pallas_step.py:782-792);
  * **stepper** (every systematic fixed or none at all, or the binned
    likelihood): a Python loop of torch ops on the device with no host
    synchronisation and no branch on tensor values, the JAX scan
    path's steps (``_make_step``, ``_make_step_cov``,
    ``_make_blocked_step``) with their accept ``delta > 0 or u <=
    exp(delta)``.  With fixed systematics the LUT is built once at the
    means (B1, then B2) and every step is plain torch NLL math (the JAX
    package's jnp outside any kernel); binned, every rebuild is B1 (or
    B1-batched for chains) and the binned NLL.

The proposal noise and accept uniforms of a phase are drawn up front on
the device from the chain's ``torch.Generator`` (:func:`presample`); a
caller may inject other streams instead, which is how the tests feed
the JAX package's ``_presample`` / ``phase_xs`` streams to both
packages.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.ops.nll import (NLLStatic, binned_nll_pair, df_diff,
                                    nll_pair)
from sxmc_tpu_torch.pdf.stack import PdfStack
from sxmc_tpu_torch.signal import Observable, Signal, Source, Systematic
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace
from sxmc_tpu_torch.utils import resolve_device

HAARIO = 2.4 * 2.4  # Haario et al. 2001 proposal scaling (mcmc.cpp:199)

# (phase index 0/1/2, nsteps) -> (noise (n, [M + 1,] [nchains,] npar), u
# (n, [M + 1,] [nchains])) float32, u ~ U[0, 1); the M + 1 axis for
# blocked cycles (see presample).
Presampler = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


def nll_history_to_f64(nll_pair_hist) -> np.ndarray:
    """Chain NLL history (hi, lo) pair -> f64 values on the host."""
    hi, lo = nll_pair_hist
    return (np.asarray(hi.cpu(), np.float64)
            + np.asarray(lo.cpu(), np.float64))


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to sxmc_tpu_torch yet ({item})")


def flatten_parameters(sources: Sequence[Source],
                       systematics: Sequence[Systematic]):
    """The parameter vector's ``(means, sigmas, fixed, names)``: source
    rates, then each systematic's coefficients (mcmc.cpp:47-81)."""
    means, sigmas, fixed, names = [], [], [], []
    for src in sources:
        means.append(src.mean)
        sigmas.append(src.sigma)
        fixed.append(src.fixed)
        names.append(src.name)
    for syst in systematics:
        for j in range(syst.npars):
            means.append(syst.means[j])
            sigmas.append(syst.sigmas[j])
            fixed.append(syst.fixed)
            names.append(f"{syst.name}_{j}")
    return (np.asarray(means, np.float32), np.asarray(sigmas, np.float32),
            np.asarray(fixed, bool), names)


def nll_static(sources: Sequence[Source], signals: Sequence[Signal],
               systematics: Sequence[Systematic]) -> NLLStatic:
    """The NLL's constants of a fit (mcmc.cpp:93-98)."""
    means, sigmas, _, _ = flatten_parameters(sources, systematics)
    return NLLStatic(
        nexpected=np.asarray([s.nexpected for s in signals], np.float32),
        n_mc=np.asarray([s.n_mc for s in signals], np.float32),
        source_id=np.asarray([s.source.index for s in signals], np.int32),
        means=means, sigmas=sigmas, nsources=len(sources))


def check_proposal(proposal: str, rate_substeps: int = 0,
                   pool_adaptation: bool = False) -> None:
    """The JAX package's ValueErrors (metropolis.py:207-213)."""
    if proposal not in ("diagonal", "full_cov"):
        raise ValueError(f"unknown proposal {proposal!r}")
    if proposal == "full_cov" and (rate_substeps or pool_adaptation):
        raise ValueError("proposal='full_cov' is incompatible with "
                         "rate_substeps / pool_adaptation")


class MCMC:
    """The MCMC fit (reference: mcmc.h:41-77) on one device."""

    def __init__(
        self,
        sources: Sequence[Source],
        signals: Sequence[Signal],
        systematics: Sequence[Systematic],
        observables: Sequence[Observable],
        device="cuda",
        binned: bool = False,
    ):
        """``device`` is the card unless the caller asks for the CPU
        (without CUDA the default raises).  ``binned=True`` takes the
        exact binned regrouping of the NLL (ops.nll.binned_nll_pair) for
        every evaluation."""
        self.binned = bool(binned)
        self.device = resolve_device(device)
        self.nsources = len(sources)
        self.nsignals = len(signals)
        self.sources = list(sources)
        self.signals = list(signals)
        self.systematics = list(systematics)
        self.observables = list(observables)

        means, sigmas, fixed, names = flatten_parameters(sources,
                                                         systematics)
        self.nparameters = len(names)
        self.systematics_fixed = all(s.fixed for s in systematics)
        self.parameter_means = means
        self.parameter_sigma = sigmas
        self.parameter_fixed = fixed
        self.parameter_names = names
        self.nfloat = int((~fixed).sum())
        self.nsystematics = len(systematics)

        self.stack = PdfStack(signals, observables, systematics,
                              self.device)
        self.static = nll_static(sources, signals, systematics)
        # The constants on the device, made once: the fused kernels' spec
        # carries them for the plain versions and the stepper route.
        self.nll_spec = self.stack.nll_spec(self.static)
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
        pool_adaptation: bool = False,
        presampler: Optional[Presampler] = None,
    ) -> LikelihoodSpace:
        """Run the random walk; returns the likelihood space.

        ``data`` is ``(nevents, nobservables + 1)`` with dataset tags.
        ``nchains > 1`` runs lock-step chains, each retuned on its own,
        and pools their post-burn-in samples.  ``rate_substeps > 0``
        takes blocked Metropolis-within-Gibbs cycles (``nsteps`` then
        counts cycles); ``proposal="full_cov"`` Haario full-covariance
        proposals, incompatible with both ``rate_substeps`` and
        ``pool_adaptation``.  The noise comes from ``generator`` (a
        ``torch.Generator`` on this MCMC's device), or from
        ``presampler`` when given.
        """
        if nchains < 1:
            raise ValueError(f"nchains={nchains} must be at least 1")
        check_proposal(proposal, rate_substeps, pool_adaptation)
        if pool_adaptation and nchains > 1:
            _not_ported("pool_adaptation (pooled burn-in retuning)",
                        "ROADMAP queue A, item 5")
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
            m = rate_substeps if _blocked_enabled(self, rate_substeps) else 0

            def presampler(phase, n):
                return presample(gen, n, self.nparameters, self.device,
                                 nchains, m)

        samples, nlls, accept_rate = run_chain(
            self, self.stack.read_bins, nsteps, burnin_steps, debug_mode,
            presampler, nchains, rate_substeps, proposal)
        self.last_accept_rate = float(accept_rate)
        return LikelihoodSpace.from_arrays(
            samples.cpu().numpy(), nll_history_to_f64(nlls),
            self.parameter_names)


def _stream_shape(n: int, nchains: int, m: int) -> Tuple[int, ...]:
    return (n,) + ((m + 1,) if m else ()) + ((nchains,) if nchains > 1
                                             else ())


def presample(gen: torch.Generator, n: int, npar: int, device,
              nchains: int = 1, m: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A phase's proposal noise ~ N(0, 1) and accept uniforms ``u`` ~
    U[0, 1), drawn on the device from ``gen``: ``(n, npar)`` and
    ``(n,)``; with ``nchains > 1``, ``(n, nchains, npar)`` and ``(n,
    nchains)``; for blocked cycles (``m`` rate moves) ``(n, m + 1[,
    nchains], npar)`` and ``(n, m + 1[, nchains])``, row 0 of the ``m +
    1`` axis the systematic-block move (B5's layout)."""
    lead = _stream_shape(n, nchains, m)
    noise = torch.randn(lead + (npar,), generator=gen, device=device,
                        dtype=torch.float32)
    u = torch.rand(lead, generator=gen, device=device, dtype=torch.float32)
    return noise, u


def _syst_float(mcmc: MCMC) -> bool:
    return mcmc.nsystematics > 0 and not mcmc.systematics_fixed


def _fused_ok(mcmc: MCMC) -> bool:
    """True when the fused kernels (B3/B4/B5) replace the split rebuild
    -> LUT -> nll_pair chain: floating systematics (else there is no
    per-step rebuild to fuse), the unbinned likelihood, and a stack with
    a dynamic segment (metropolis.py:378-390)."""
    return (_syst_float(mcmc) and not mcmc.binned
            and mcmc.stack.supports_fused)


def _blocked_fused_ok(mcmc: MCMC) -> bool:
    """The blocked kernel B5 additionally needs an unweighted stack (its
    rate moves reuse integer in-domain counts; metropolis.py:422-426):
    a weighted blocked fit takes the blocked stepper."""
    return _fused_ok(mcmc) and not mcmc.stack.has_weights


def _blocked_enabled(mcmc: MCMC, rate_substeps: int) -> bool:
    """Blocked updates apply with a floating systematic (else the LUT
    never changes and the joint step already skips rebuilds) and a rate
    block to sub-step (metropolis.py:783-788); otherwise the joint step
    runs."""
    return rate_substeps > 0 and _syst_float(mcmc) and mcmc.nsources > 0


def _nll_backend(mcmc: MCMC, read_bins: torch.Tensor):
    """Likelihood-mode dispatch (metropolis.py:333-375): ``(evaluate,
    evaluate_batch, pair)``.  Unbinned, ``evaluate`` is the LUT (B1,
    then B2) and ``pair`` :func:`nll_pair`; binned, ``evaluate`` is the
    histograms (B1) and ``pair`` the binned NLL against the data counts
    derived once from the read bins."""
    stack = mcmc.stack
    if not mcmc.binned:
        def evaluate(theta):
            return stack.evaluate(theta, read_bins)

        def evaluate_batch(thetas):
            return stack.evaluate_batch(thetas, read_bins)

        return evaluate, evaluate_batch, nll_pair

    counts = stack.counts_from_read_bins(read_bins)
    mask = torch.as_tensor(stack.dataset_mask, device=mcmc.device)
    bv = stack.bin_volume

    def pair(params, hists, norms, c):
        return binned_nll_pair(params, hists, norms, c, counts, mask, bv)

    return stack.histograms, stack.histograms_batch, pair


def _chain_nll(mcmc: MCMC, read_bins: torch.Tensor, allow_fused=True):
    """params ``(npar,)`` or ``(nchains, npar)`` -> the compensated
    ``(hi, lo)`` pair(s): the JAX package's ``_chain_nll`` and
    ``_chain_nll_batch`` in one (metropolis.py:393-419, 978-1013).
    Fused (unless ``allow_fused`` is false, as for the tempered ladder):
    B3 (or B3-batched).  Otherwise the state comes from
    ``_nll_backend``: built once at the means when no systematic floats,
    else at every call (``evaluate`` or ``evaluate_batch``)."""
    if allow_fused and _fused_ok(mcmc):
        stack, spec = mcmc.stack, mcmc.nll_spec

        def fused(params):
            if params.dim() == 2:
                return stack.fused_nll_pair_batch(params, read_bins, spec)
            return stack.fused_nll_pair(params, read_bins, spec)

        return fused
    evaluate, evaluate_batch, pair = _nll_backend(mcmc, read_bins)
    ns = mcmc.nsources
    dst = mcmc.nll_spec.consts
    if not _syst_float(mcmc):
        theta0 = torch.as_tensor(mcmc.parameter_means[ns:],
                                 device=mcmc.device)
        state0 = evaluate(theta0)

        def fixed(params):
            return pair(params, *state0, dst)

        return fixed

    def rebuilt(params):
        state = (evaluate_batch(params[:, ns:]) if params.dim() == 2
                 else evaluate(params[ns:]))
        return pair(params, *state, dst)

    return rebuilt


def _accept(cur_hi, cur_lo, prop_hi, prop_lo, u, debug_mode: bool):
    """The stepper's rule: ``delta > 0`` or ``u <= exp(delta)``, with
    df_diff's op order for delta."""
    delta = df_diff(cur_hi, cur_lo, prop_hi, prop_lo)
    accept = (delta > 0) | (u <= torch.exp(delta))
    return torch.ones_like(accept) if debug_mode else accept


def _take(accept, proposed, prop_hi, prop_lo, params, cur_hi, cur_lo):
    return (torch.where(accept[..., None], proposed, params),
            torch.where(accept, prop_hi, cur_hi),
            torch.where(accept, prop_lo, cur_lo))


def _make_step(chain_nll, debug_mode: bool, full_cov: bool = False):
    """One Metropolis step of the stepper route (metropolis.py:494-549,
    1054-1064), for ``(npar,)`` or ``(nchains, npar)`` params: propose
    ``where(width > 0, params + noise * max(width, 0), params)``, or
    with ``full_cov`` ``params + tril @ z`` (the carry holds the tril;
    zero rows pin), and accept where ``delta > 0`` or ``u <=
    exp(delta)``."""

    def step(carry, xs):
        params, (cur_hi, cur_lo), width = carry
        noise_raw, u = xs
        if full_cov:
            proposed = params + torch.matmul(
                width, noise_raw.unsqueeze(-1)).squeeze(-1)
        else:
            noise = noise_raw * torch.clamp_min(width, 0.0)
            proposed = torch.where(width > 0, params + noise, params)
        prop_hi, prop_lo = chain_nll(proposed)
        accept = _accept(cur_hi, cur_lo, prop_hi, prop_lo, u, debug_mode)
        params, cur_hi, cur_lo = _take(accept, proposed, prop_hi, prop_lo,
                                       params, cur_hi, cur_lo)
        return ((params, (cur_hi, cur_lo), width),
                (params, (cur_hi, cur_lo), accept.to(torch.float32)))

    return step


def _make_blocked_step(mcmc: MCMC, read_bins: torch.Tensor,
                       debug_mode: bool, m: int):
    """The stepper's blocked Metropolis-within-Gibbs cycle, single or
    lock-step chains (metropolis.py:791-862, 1066-1100): one
    systematic-block move (everything but the rates, with a rebuild),
    then ``m`` rate-block moves against the carried ``(lut, norms)`` of
    the current state.  Returns ``(step, init_extras)``; the carry is
    ``(params, (hi, lo), width, lut, norms)``."""
    evaluate, evaluate_batch, pair = _nll_backend(mcmc, read_bins)
    ns = mcmc.nsources
    dst = mcmc.nll_spec.consts
    rate = torch.arange(mcmc.nparameters, device=mcmc.device) < ns

    def rebuild(params):
        return (evaluate_batch(params[:, ns:]) if params.dim() == 2
                else evaluate(params[ns:]))

    def step(carry, xs):
        params, (cur_hi, cur_lo), width, lut, norms = carry
        noise_all, u_all = xs  # (m + 1, [nchains,] npar), (m + 1, ...)
        wpos = torch.clamp_min(width, 0.0)
        noise = noise_all[0] * wpos
        proposed = torch.where((width > 0) & ~rate, params + noise, params)
        plut, pnorms = rebuild(proposed)
        prop_hi, prop_lo = pair(proposed, plut, pnorms, dst)
        accept = _accept(cur_hi, cur_lo, prop_hi, prop_lo, u_all[0],
                         debug_mode)
        params, cur_hi, cur_lo = _take(accept, proposed, prop_hi, prop_lo,
                                       params, cur_hi, cur_lo)
        lut = torch.where(accept[..., None, None], plut, lut)
        norms = torch.where(accept[..., None], pnorms, norms)
        acc = accept.to(torch.float32)
        for k in range(1, m + 1):
            nz = noise_all[k] * wpos
            prop = torch.where((width > 0) & rate, params + nz, params)
            phi, plo = pair(prop, lut, norms, dst)
            a = _accept(cur_hi, cur_lo, phi, plo, u_all[k], debug_mode)
            params, cur_hi, cur_lo = _take(a, prop, phi, plo, params,
                                           cur_hi, cur_lo)
            acc = acc + a.to(torch.float32)
        return ((params, (cur_hi, cur_lo), width, lut, norms),
                (params, (cur_hi, cur_lo), acc / (m + 1)))

    return step, rebuild


def _loop(step, carry, noise, u):
    """Run ``step`` over a phase's streams (the JAX package's scan):
    ``(carry, samples, (hi, lo) history, accepts)``."""
    n = noise.shape[0]
    params, (cur_hi, _) = carry[0], carry[1]
    samples = torch.empty((n,) + tuple(params.shape), dtype=torch.float32,
                          device=params.device)
    hi = torch.empty((n,) + tuple(cur_hi.shape), dtype=torch.float32,
                     device=params.device)
    lo, accs = torch.empty_like(hi), torch.empty_like(hi)
    for k in range(n):
        carry, (p, (h, l), a) = step(carry, (noise[k], u[k]))
        samples[k], hi[k], lo[k], accs[k] = p, h, l, a
    return carry, samples, (hi, lo), accs


def _phase_runner(mcmc: MCMC, read_bins: torch.Tensor, chain_nll,
                  debug_mode: bool, m: int = 0, full_cov: bool = False):
    """``(run, init_extras)``: ``run(carry, noise, u)`` -> ``(carry,
    samples (n, ..., npar), (hi (n, ...), lo (n, ...)), accepts (n,
    ...))`` for one fixed-proposal phase, with ``carry = (params, (hi,
    lo), width or tril, *extras)`` and ``init_extras(params)`` the
    extras of a chain's start (the blocked stepper's ``(lut, norms)``).

    Fused route: one launch per phase of B4 (diagonal or tril) or, for
    ``m`` blocked rate moves on an unweighted stack, B5, all fed
    ``log(u)``.  Stepper route: a loop of :func:`_make_step` or the
    blocked cycle."""
    no_extras = lambda params: ()  # noqa: E731
    fused = _blocked_fused_ok(mcmc) if m else _fused_ok(mcmc)
    if fused:
        stack = mcmc.stack
        if m:
            segments = (stack.blocked_segment, stack.blocked_segment_batch)
        elif full_cov:
            segments = (stack.fused_segment_tril,
                        stack.fused_segment_tril_batch)
        else:
            segments = (stack.fused_segment, stack.fused_segment_batch)

        def fused(carry, noise, u):
            params, cur, width = carry
            nll0 = torch.stack([cur[0], cur[1]], dim=-1).to(torch.float32)
            segment = segments[params.dim() - 1]
            samples, nlls, accs = segment(
                params, nll0, width, read_bins, noise, torch.log(u),
                mcmc.nll_spec, debug_mode)
            return ((samples[-1], (nlls[-1, ..., 0], nlls[-1, ..., 1]),
                     width),
                    samples, (nlls[..., 0], nlls[..., 1]), accs)

        return fused, no_extras
    if m:
        step, init_extras = _make_blocked_step(mcmc, read_bins, debug_mode,
                                               m)
    else:
        step, init_extras = (_make_step(chain_nll, debug_mode, full_cov),
                             no_extras)

    def stepped(carry, noise, u):
        return _loop(step, carry, noise, u)

    return stepped, init_extras


def initial_state(mcmc: MCMC, read_bins: torch.Tensor, nchains: int = 1,
                  chain_nll=None):
    """Initial ``(params, (hi, lo), width)``: the means and the initial
    widths, ``(nchains, npar)`` for lock-step chains, and their NLL
    (B3 or B3-batched on the fused route)."""
    dev = mcmc.device
    params0 = torch.as_tensor(mcmc.parameter_means, device=dev)
    width0 = torch.as_tensor(mcmc.initial_jump_widths(), device=dev)
    if nchains > 1:
        params0 = params0.expand(nchains, -1).contiguous()
        width0 = width0.expand(nchains, -1).contiguous()
    if chain_nll is None:
        chain_nll = _chain_nll(mcmc, read_bins)
    return params0, chain_nll(params0), width0


def retune_width(mcmc: MCMC, width: torch.Tensor,
                 phase_samples: torch.Tensor) -> torch.Tensor:
    """Jump-width rescale from a burn-in phase (mcmc.cpp:279-305), per
    chain for ``(n, nchains, npar)`` samples.

    The sample RMS is taken in f64 and rounded once to f32 (the JAX
    package takes it in f32; the two agree to an ulp).
    """
    sf = HAARIO / max(mcmc.nfloat, 1)
    fixed = torch.as_tensor(mcmc.parameter_fixed, device=width.device)
    rms = phase_samples.to(torch.float64).std(dim=0, correction=0).to(
        torch.float32)
    new = torch.where(rms > 0, sf * rms, width)
    return torch.where(fixed, torch.full_like(new, -1.0), new)


def _initial_scale_tril(mcmc: MCMC, nchains: int = 1) -> torch.Tensor:
    """The first full_cov phase's ``diag(max(width, 0))`` (metropolis.py:
    590-592), ``(nchains, npar, npar)`` for lock-step chains."""
    w = torch.as_tensor(mcmc.initial_jump_widths(), device=mcmc.device)
    tril = torch.diag(torch.clamp_min(w, 0.0))
    if nchains > 1:
        tril = tril.expand(nchains, -1, -1).contiguous()
    return tril


def _tril_from_cov(mcmc: MCMC, tril: torch.Tensor,
                   cov: torch.Tensor) -> torch.Tensor:
    """Haario rescale of sample covariances ``(..., npar, npar)`` into
    proposal scales: ``L = chol((2.4^2 / d) * cov + jitter)``
    (metropolis.py:552-576).  Fixed parameters get zero rows; where the
    covariance is degenerate (no move in the phase) or the factorisation
    fails, the previous ``tril`` is kept.  No host synchronisation:
    ``cholesky_ex`` reports failure in a tensor, and the choice is a
    ``where``."""
    free = torch.as_tensor(~mcmc.parameter_fixed, device=cov.device)
    d = max(mcmc.nfloat, 1)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    # Unit diagonal on fixed entries keeps the Cholesky well-posed; their
    # L rows are zeroed below.
    fixed_diag = torch.diag((~free).to(cov.dtype))
    dmax = torch.diagonal(cov, dim1=-2, dim2=-1).amax(dim=-1)
    jitter = 1e-6 * torch.clamp_min(dmax, 1e-20)
    scaled = ((HAARIO / d) * cov + jitter[..., None, None] * eye * free
              + fixed_diag)
    new, info = torch.linalg.cholesky_ex(scaled)
    bad = (torch.isnan(new).flatten(-2).any(dim=-1) | (dmax <= 0)
           | (info != 0))
    return torch.where(bad[..., None, None], tril, new * free[:, None])


def retune_scale_tril(mcmc: MCMC, tril: torch.Tensor,
                      phase_samples: torch.Tensor) -> torch.Tensor:
    """Haario full-covariance retune from a phase's samples ``(n,
    npar)``, or per chain from ``(n, nchains, npar)`` with ``tril``
    ``(nchains, npar, npar)`` (metropolis.py:579-587): the two-pass
    float32 covariance over the free parameters, then
    :func:`_tril_from_cov`."""
    free = torch.as_tensor(~mcmc.parameter_fixed,
                           device=phase_samples.device)
    n = phase_samples.shape[0]
    xc = (phase_samples - phase_samples.mean(dim=0)) * free
    xc = xc.movedim(0, -1)  # (..., npar, n)
    cov = torch.matmul(xc, xc.transpose(-1, -2)) / float(max(n - 1, 1))
    return _tril_from_cov(mcmc, tril, cov)


def run_segment(mcmc: MCMC, params, cur_nll, width, read_bins,
                noise: torch.Tensor, u: torch.Tensor,
                debug_mode: bool = False, rate_substeps: int = 0,
                proposal: str = "diagonal"):
    """One fixed-proposal segment from presampled ``noise`` and accept
    uniforms ``u``: one whole-segment kernel launch on the fused route,
    the stepper loop otherwise (metropolis.py:255-310, 652-673).

    ``cur_nll`` is the (hi, lo) pair of ``params``; ``width`` the tril
    with ``proposal="full_cov"``; ``rate_substeps`` blocked cycles (the
    stepper's ``(lut, norms)`` rebuilt from ``params``).  Returns
    ``(params, (hi, lo), samples (n, npar), (hi (n,), lo (n,)), accepts
    (n,))``: the carry and the scan history of the JAX package's
    ``run_segment``.
    """
    check_proposal(proposal, rate_substeps)
    m = rate_substeps if _blocked_enabled(mcmc, rate_substeps) else 0
    run, init_extras = _phase_runner(
        mcmc, read_bins, _chain_nll(mcmc, read_bins), debug_mode, m,
        proposal == "full_cov")
    carry, samples, nlls, accs = run(
        (params, cur_nll, width) + tuple(init_extras(params)), noise, u)
    return carry[0], carry[1], samples, nlls, accs


def run_chain(mcmc: MCMC, read_bins: torch.Tensor, nsteps: int,
              burnin_steps: int, debug_mode: bool,
              presampler: Presampler, nchains: int = 1,
              rate_substeps: int = 0, proposal: str = "diagonal"):
    """One chain, or ``nchains`` lock-step chains, through the three
    phases (metropolis.py:595-780, 1020-1196, 1221-1289): retuning the
    widths, or with ``proposal="full_cov"`` the trils, after each
    burn-in phase.  ``rate_substeps`` takes blocked cycles where they
    apply (:func:`_blocked_enabled`); the presampler must then hand out
    the blocked layout (:func:`presample`).

    Returns ``(samples, (hi, lo), accept_rate)`` of the recorded steps
    (the main phase, plus the burn-in phases in debug mode), chains
    pooled chain-major: ``(nchains * nkeep, npar)``.
    """
    check_proposal(proposal, rate_substeps)
    full_cov = proposal == "full_cov"
    m = rate_substeps if _blocked_enabled(mcmc, rate_substeps) else 0
    chain_nll = _chain_nll(mcmc, read_bins)
    params, cur, width = initial_state(mcmc, read_bins, nchains, chain_nll)
    if full_cov:
        width = _initial_scale_tril(mcmc, nchains)
    retune = retune_scale_tril if full_cov else retune_width
    run, init_extras = _phase_runner(mcmc, read_bins, chain_nll, debug_mode,
                                     m, full_cov)
    carry = (params, cur, width) + tuple(init_extras(params))

    def phase(k, n, carry):
        noise, u = presampler(k, n)
        lead = _stream_shape(n, nchains, m)
        if tuple(noise.shape) != lead + (mcmc.nparameters,) \
                or tuple(u.shape) != lead:
            raise ValueError(
                f"phase {k} streams are noise {tuple(noise.shape)}, u "
                f"{tuple(u.shape)}; this chain takes "
                f"{lead + (mcmc.nparameters,)} and {lead}")
        return run(carry, noise, u)

    outs = []
    if burnin_steps > 0:
        for k in (0, 1):
            carry, s, n, a = phase(k, burnin_steps, carry)
            carry = carry[:2] + (retune(mcmc, carry[2], s),) + carry[3:]
            if debug_mode:
                outs.append((s, n, a))
    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0 else 0),
                    0)
    if remaining > 0:
        carry, s, n, a = phase(2, remaining, carry)
        outs.append((s, n, a))

    samples = torch.cat([o[0] for o in outs])
    hi = torch.cat([o[1][0] for o in outs])
    lo = torch.cat([o[1][1] for o in outs])
    accepts = torch.cat([o[2] for o in outs])
    if nchains > 1:
        # (nsteps, nchains, ...) -> chain-major pooled rows.
        samples = samples.transpose(0, 1).reshape(-1, mcmc.nparameters)
        hi, lo = hi.T.reshape(-1), lo.T.reshape(-1)
    return samples, (hi, lo), accepts.mean()
