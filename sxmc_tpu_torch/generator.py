"""Fake-experiment generation (port of ``sxmc_tpu/generator.py``).

Reference src/generator.{h,cpp}: for each signal the expected count is
``nexpected * efficiency`` at the nominal systematics, Poisson
fluctuated, and events are drawn from the signal's binned PDF
(bin-categorical + uniform within the bin, ROOT ``TH1::GetRandom``,
pdfz.cpp:817-922), with bins outside the observable bounds excluded;
each event is tagged with the signal's dataset id.

All signals' histograms come from one ``PdfStack.histograms`` call
(kernel B1 on the card).  One dataset's draws are a few thousand numbers
and run on the host, from an explicit CPU ``torch.Generator``; a batch
of toy datasets (:func:`make_fake_dataset_batch`, the front end of the
frequentist tier) is drawn on the stack's device, as batched tensor
ops, from a ``torch.Generator`` on that device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from sxmc_tpu_torch.ops import histogram as hist_ops
from sxmc_tpu_torch.signal import Observable, Signal, Systematic, \
    nominal_params


def bounded_probs(counts, nbins, lower, upper, uppers, lowers) -> np.ndarray:
    """Bin probabilities with out-of-bounds bins zeroed (the host-side
    equivalent of the reference's rejection loop, pdfz.cpp:853-914)."""
    probs = np.asarray(counts, np.float64).reshape(-1).copy()
    if uppers is not None and len(np.atleast_1d(uppers)):
        strides = hist_ops.bin_strides(nbins)
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        widths = (upper - lower) / np.asarray(nbins, np.float64)
        uppers = np.atleast_1d(np.asarray(uppers, np.float64))
        lowers = np.atleast_1d(np.asarray(lowers, np.float64))
        flat = np.arange(probs.shape[0])
        ok = np.ones(probs.shape[0], bool)
        for i, (st, nb) in enumerate(zip(strides, nbins)):
            axis_idx = (flat // st) % nb
            lo_edge = lower[i] + axis_idx * widths[i]
            hi_edge = lo_edge + widths[i]
            ok &= (hi_edge > lowers[i]) & (lo_edge < uppers[i])
        probs = np.where(ok, probs, 0.0)
    total = probs.sum()
    return probs / total if total > 0 else probs


def sample_from_counts(
    gen: torch.Generator,
    counts: np.ndarray,
    nbins: Sequence[int],
    lower: Sequence[float],
    upper: Sequence[float],
    nexpected: float,
    uppers=None,
    lowers=None,
    poisson: bool = False,
    dataset: float = 0.0,
) -> np.ndarray:
    """Draw events from histogram counts (TH1::GetRandom semantics).

    Returns ``(n, nobs + 1)`` float32 with the dataset tag last.  All
    draws come from ``gen`` (a CPU generator).
    """
    nobs = len(nbins)
    strides = hist_ops.bin_strides(nbins)
    lo = np.asarray(lower, np.float64)
    widths = (np.asarray(upper, np.float64) - lo) / np.asarray(nbins,
                                                               np.float64)
    if poisson:
        rate = torch.tensor([float(nexpected)], dtype=torch.float64)
        nobserved = int(torch.poisson(rate, generator=gen)[0])
    else:
        nobserved = int(np.floor(nexpected + 0.5))  # nint (utils.h)
    probs = bounded_probs(counts, nbins, lower, upper, uppers, lowers)
    if nobserved == 0 or probs.sum() <= 0:
        return np.zeros((0, nobs + 1), np.float32)
    bin_idx = torch.multinomial(torch.as_tensor(probs), nobserved,
                                replacement=True, generator=gen).numpy()
    u = torch.rand((nobserved, nobs), dtype=torch.float64,
                   generator=gen).numpy()
    events = np.empty((nobserved, nobs + 1), np.float32)
    for i, (st, nb) in enumerate(zip(strides, nbins)):
        axis_idx = (bin_idx // st) % nb
        events[:, i] = lo[i] + (axis_idx + u[:, i]) * widths[i]
    events[:, nobs] = float(dataset)
    return events


def make_fake_dataset(
    gen: torch.Generator,
    signals: Sequence[Signal],
    systematics: Sequence[Systematic],
    observables: Sequence[Observable],
    stack,
    poisson: bool = True,
    verbose: bool = False,
) -> np.ndarray:
    """Generate one fake dataset (reference: generator.cpp:9-48).

    Returns ``(nevents, nobservables + 1)`` float32 with dataset tags.
    ``stack`` is the fit's PdfStack (its device builds the histograms).
    """
    if not signals:
        return np.zeros((0, len(observables) + 1), np.float32)
    hists, norms = stack.histograms(nominal_params(systematics))
    hists = hists.cpu().numpy()
    norms = norms.cpu().numpy()
    uppers = [o.upper for o in observables]
    lowers = [o.lower for o in observables]

    chunks: List[np.ndarray] = []
    for i, sig in enumerate(signals):
        eff = float(norms[i]) / sig.n_mc
        nevents = sig.nexpected * eff
        events = sample_from_counts(
            gen, hists[i], stack.nbins, stack.lower_host, stack.upper_host,
            nevents, uppers=uppers, lowers=lowers, poisson=poisson,
            dataset=sig.dataset)
        if verbose:
            print(f"make_fake_dataset: {sig.name}: {events.shape[0]} "
                  f"events ({nevents} expected, efficiency = {eff})")
        chunks.append(events)
    return np.concatenate(chunks, axis=0)


def _bounded_mask(stack, observables) -> np.ndarray:
    """``(total_nbins,)`` bool: the bins inside the observables' bounds
    (the bins :func:`bounded_probs` keeps)."""
    ones = np.ones(stack.total_nbins)
    return bounded_probs(ones, stack.nbins, stack.lower_host,
                         stack.upper_host, [o.upper for o in observables],
                         [o.lower for o in observables]) > 0


def make_fake_dataset_batch(
    gen: torch.Generator,
    signals: Sequence[Signal],
    systematics: Sequence[Systematic],
    observables: Sequence[Observable],
    ntoys: int,
    stack,
    poisson: bool = True,
    rates=None,
    fluctuate_systematics: bool = False,
    theta=None,
) -> torch.Tensor:
    """``ntoys`` fake datasets as one padded batch (JAX
    generator.py:114-235): per signal, the Poisson counts of every toy,
    their bin choices (categorical over the bounded bins) and in-bin
    positions are each one tensor op on ``stack``'s device, from ``gen``
    (a ``torch.Generator`` on that device).

    ``rates`` maps signal names to rate multipliers on the expected
    count (default 1).  ``theta`` pins the systematic coefficients the
    toys are generated at (default nominal).  ``fluctuate_systematics``
    draws each toy's constrained coefficients from their Gaussian priors
    (fixed or unconstrained ones stay put) and generates that toy from
    the PDFs and efficiencies at its own theta: one B1-batched launch
    per 32 toys.

    Returns ``(ntoys, nev_max, nobs + 1)`` float32 on the device; padding
    rows carry dataset tag -1, which no signal reads (read bin -2 or -1).
    """
    dev = stack.device
    nobs = len(observables)
    if not signals:
        return torch.zeros((ntoys, 0, nobs + 1), dtype=torch.float32,
                           device=dev)
    theta = (nominal_params(systematics) if theta is None
             else np.asarray(theta, np.float32))
    sigmas = np.zeros_like(theta)
    for syst in systematics:
        if not syst.fixed:
            for j, pidx in enumerate(syst.pidx):
                sigmas[pidx] = syst.sigmas[j]
    fluctuate = fluctuate_systematics and bool((sigmas > 0).any())
    theta_t = torch.as_tensor(theta, device=dev)
    if fluctuate:
        z = torch.randn((ntoys, theta.shape[0]), generator=gen, device=dev,
                        dtype=torch.float32)
        hists, norms = stack.histograms_batch(
            theta_t[None] + z * torch.as_tensor(sigmas, device=dev)[None])
    else:
        hists, norms = stack.histograms(theta_t)
    inside = torch.as_tensor(_bounded_mask(stack, observables), device=dev)
    strides = hist_ops.bin_strides(stack.nbins)
    lo = np.asarray(stack.lower_host, np.float64)
    widths = (np.asarray(stack.upper_host, np.float64) - lo) / np.asarray(
        stack.nbins, np.float64)

    chunks = []
    for i, sig in enumerate(signals):
        rate = 1.0 if rates is None else float(rates.get(sig.name, 1.0))
        probs = torch.where(inside, hists[..., i, :].to(torch.float64), 0.0)
        if float(probs.sum()) <= 0:
            continue
        eff = norms[..., i].to(torch.float64) / sig.n_mc
        mu = (rate * sig.nexpected * eff).expand(ntoys).contiguous()
        n = (torch.poisson(mu, generator=gen) if poisson
             else torch.floor(mu + 0.5))
        nmax = max(int(n.max()), 1)
        if probs.dim() == 1:
            bin_idx = torch.multinomial(probs, ntoys * nmax, replacement=True,
                                        generator=gen).reshape(ntoys, nmax)
        else:
            # A toy whose bounded bins are all empty draws uniformly, as
            # a categorical over equal logits does.
            empty = probs.sum(-1, keepdim=True) <= 0
            probs = torch.where(empty, torch.ones_like(probs), probs)
            bin_idx = torch.multinomial(probs, nmax, replacement=True,
                                        generator=gen)
        u = torch.rand((ntoys, nmax, nobs), generator=gen, device=dev,
                       dtype=torch.float64)
        ev = torch.empty((ntoys, nmax, nobs + 1), dtype=torch.float32,
                         device=dev)
        for a, (st, nb) in enumerate(zip(strides, stack.nbins)):
            axis_idx = (bin_idx // st) % nb
            ev[..., a] = (lo[a] + (axis_idx + u[..., a]) * widths[a]).to(
                torch.float32)
        valid = torch.arange(nmax, device=dev)[None, :] < n[:, None]
        ev[..., nobs] = torch.where(valid, float(sig.dataset), -1.0)
        chunks.append(ev)
    if not chunks:
        return torch.zeros((ntoys, 0, nobs + 1), dtype=torch.float32,
                           device=dev)
    return torch.cat(chunks, dim=1)
