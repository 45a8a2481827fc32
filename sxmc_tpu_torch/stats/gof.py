"""Goodness of fit: saturated-likelihood chi2 and posterior-predictive
p-values (port of ``sxmc_tpu/stats/gof.py``).

  * Baker-Cousins saturated chi2 (NIM 221 (1984) 437): the data binned on
    the fit's grid per dataset against the best-fit model's expected
    counts mu_i = sum_j rate_j * nexpected_j * hists_j[i] / n_mc_j,

        chi2 = 2 * sum_i [ mu_i - n_i + n_i * ln(n_i / mu_i) ]

    asymptotically chi-square with (occupied bins - floating parameters)
    degrees of freedom.
  * An exact p-value by posterior-predictive simulation: ``ntoys``
    datasets drawn on the device from the best-fit model (rates and
    systematics pinned at the fit), each counted per bin by one offset
    bincount over every toy, the p-value the fraction of toys whose chi2
    exceeds the data's; with ``refit`` each toy's free rates are refit
    (one batched solve, the toys' LUT one B2 launch) and its chi2 taken
    against its own fitted expectation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from sxmc_tpu_torch.generator import make_fake_dataset_batch
from sxmc_tpu_torch.mcmc.metropolis import nll_static
from sxmc_tpu_torch.ops import histogram as hist_ops
from sxmc_tpu_torch.ops.nll import nll as nll_fn
from sxmc_tpu_torch.signal import Observable, Signal, Source, Systematic
from sxmc_tpu_torch.stats.mle import solve, toy_lut

MAXITER = 400  # the MLE's BFGS iteration cap


@dataclasses.dataclass
class GofResult:
    """Goodness-of-fit summary.

    chi2: Baker-Cousins saturated likelihood-ratio statistic on the data.
    ndof: occupied-model bins minus floating parameters.
    p_asymptotic: chi-square survival probability.
    p_toys: exact posterior-predictive p-value (None when ntoys == 0).
    chi2_toys: the toy statistics (empty when ntoys == 0).
    """

    chi2: float
    ndof: int
    p_asymptotic: Optional[float]
    p_toys: Optional[float] = None
    chi2_toys: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    def __str__(self) -> str:
        s = f"chi2/ndof = {self.chi2:.2f}/{self.ndof}"
        if self.p_asymptotic is not None:
            s += f", p(asymptotic) = {self.p_asymptotic:.3f}"
        if self.p_toys is not None:
            s += f", p(toys) = {self.p_toys:.3f}"
        return s


def _binned_counts(events: torch.Tensor, stack, datasets) -> np.ndarray:
    """``(ndatasets, ntoys, total_nbins)`` float64 counts of a batch of
    datasets ``(ntoys, nev, nobs + 1)``, with the NLL's bin-id math: one
    bincount per dataset over (toy, bin) keys."""
    ntoys, nev = events.shape[:2]
    flat = events.reshape(ntoys * nev, -1)
    nobs = stack.nobservables
    ids, valid = hist_ops.compute_bin_ids(flat[:, :nobs], stack.lower_host,
                                          stack.upper_host, stack.nbins)
    tags = flat[:, nobs]
    total = stack.total_nbins
    toy = torch.arange(ntoys, device=flat.device).repeat_interleave(nev)
    out = []
    for ds in datasets:
        sel = valid & (tags == float(ds))
        out.append(torch.bincount((toy * total + ids)[sel],
                                  minlength=ntoys * total).reshape(ntoys,
                                                                   total))
    return torch.stack(out).cpu().numpy().astype(np.float64)


def _expected_counts(params, stack, signals, nsources,
                     datasets) -> np.ndarray:
    """``(ndatasets, total_nbins)`` expected counts at ``params``: the
    NLL's expected-count weighting left unsummed over bins."""
    params = np.asarray(params, np.float32)
    hists, _ = stack.histograms(params[nsources:])
    hists = hists.cpu().numpy().astype(np.float64)
    out = np.zeros((len(datasets), stack.total_nbins), np.float64)
    for j, sig in enumerate(signals):
        d = datasets.index(sig.dataset)
        rate = float(params[sig.source.index])
        out[d] += rate * sig.nexpected * hists[j] / sig.n_mc
    return out


def baker_cousins_chi2(observed: np.ndarray, expected: np.ndarray) -> float:
    """2 * sum_i [mu_i - n_i + n_i ln(n_i / mu_i)] over occupied bins;
    mu == 0 with n > 0 is floored at 1e-12 (a huge chi2, not inf)."""
    mu = np.asarray(expected, np.float64).reshape(-1)
    n = np.asarray(observed, np.float64).reshape(-1)
    mu_safe = np.maximum(mu, 1e-12)
    ratio = np.where(n > 0, n / mu_safe, 1.0)
    terms = mu - n + n * np.log(ratio)
    return float(2.0 * np.where((mu > 0) | (n > 0), terms, 0.0).sum())


def _refit_toy_rates(sources, signals, systematics, best_params,
                     batch: torch.Tensor, stack, nsources) -> np.ndarray:
    """Each toy's free rates refit with the systematics pinned at the
    best fit: ``(ntoys, nsources)`` fitted rate vectors.  The PDFs are
    toy-invariant, so they are built once (B1) and every toy's LUT comes
    from one B2 launch; the fits are one batched solve."""
    dev = stack.device
    consts = stack.nll_spec(nll_static(sources, signals,
                                       systematics)).consts
    free_idx = tuple(i for i, s in enumerate(sources) if not s.fixed)
    pinned = torch.as_tensor(np.asarray(best_params, np.float32), device=dev)
    rb = stack.compute_read_bins(batch)
    ntoys = rb.shape[0]
    hists, norms = stack.histograms(pinned[nsources:])
    lut = toy_lut(stack, hists, norms, rb)
    if not free_idx:
        return pinned[:nsources].repeat(ntoys, 1).cpu().numpy()

    def nllf(params, lut_row, norms, extra):
        return nll_fn(params, lut_row, norms, consts)

    q0 = np.zeros(nsources, np.float32)
    q0[list(free_idx)] = np.log(np.maximum(
        np.asarray(best_params, np.float32)[list(free_idx)], 1e-4))
    x, _, _ = solve(nllf, MAXITER, free_idx, q0, pinned.repeat(ntoys, 1),
                    (lut, norms, None))
    rates = pinned[:nsources].repeat(ntoys, 1)
    rates[:, list(free_idx)] = torch.exp(x)
    return rates.cpu().numpy()


def goodness_of_fit(
    sources: Sequence[Source],
    signals: Sequence[Signal],
    systematics: Sequence[Systematic],
    observables: Sequence[Observable],
    data,
    best_params: np.ndarray,
    ntoys: int = 0,
    gen: Optional[torch.Generator] = None,
    stack=None,
    refit: bool = False,
    device="cuda",
    toys=None,
) -> GofResult:
    """Saturated-chi2 GOF of a fit result, optionally toy-calibrated.

    Args:
        best_params: the fitted parameter vector (rates then systematic
            coefficients).
        ntoys: when > 0, also simulate this many datasets from the
            best-fit model and report the exact p-value.
        gen: a ``torch.Generator`` on the stack's device for the toys
            (default seeded 20260819); ``toys(rates, ntoys)``, when
            given, supplies the batch instead.
        stack: the fit's PdfStack (else one is built on ``device``).
        refit: the full parametric bootstrap: each toy's free rates are
            refit (systematics pinned at the best fit) and its chi2 is
            taken against its own fitted expectation.
    """
    if stack is None:
        from sxmc_tpu_torch.pdf.stack import PdfStack

        stack = PdfStack(signals, observables, systematics, device)
    dev = stack.device
    nsources = len(sources)
    best_params = np.asarray(best_params, np.float32)
    datasets = sorted({s.dataset for s in signals})

    events = torch.as_tensor(np.asarray(data, np.float32), device=dev)
    observed = _binned_counts(events[None], stack, datasets)[:, 0]
    expected = _expected_counts(best_params, stack, signals, nsources,
                                datasets)
    chi2 = baker_cousins_chi2(observed, expected)
    nfloat = sum(1 for s in sources if not s.fixed) + sum(
        s.npars for s in systematics if not s.fixed)
    occupied = int(((expected > 0) | (observed > 0)).sum())
    ndof = max(occupied - nfloat, 1)
    from scipy.stats import chi2 as chi2_dist

    p_asym = float(chi2_dist.sf(chi2, ndof))

    p_toys = None
    chi2_toys = np.zeros(0)
    if ntoys > 0:
        rates = {sig.name: float(best_params[sig.source.index])
                 for sig in signals}
        if toys is not None:
            batch = torch.as_tensor(np.asarray(toys(rates, ntoys),
                                               np.float32), device=dev)
        else:
            if gen is None:
                gen = torch.Generator(dev).manual_seed(20260819)
            batch = make_fake_dataset_batch(
                gen, signals, systematics, observables, ntoys, stack,
                poisson=True, rates=rates, theta=best_params[nsources:])
        obs_toys = _binned_counts(batch, stack, datasets)
        total = stack.total_nbins
        if refit:
            rates_hat = _refit_toy_rates(sources, signals, systematics,
                                         best_params, batch, stack,
                                         nsources).astype(np.float64)
            hists_b, _ = stack.histograms(best_params[nsources:])
            hists_b = hists_b.cpu().numpy().astype(np.float64)
            exp_toys = np.zeros((len(datasets), ntoys, total), np.float64)
            for j, sig in enumerate(signals):
                d = datasets.index(sig.dataset)
                exp_toys[d] += (rates_hat[:, sig.source.index, None]
                                * sig.nexpected * hists_b[j][None, :]
                                / sig.n_mc)
        else:
            exp_toys = np.broadcast_to(expected[:, None, :],
                                       (len(datasets), ntoys, total))
        mu = np.maximum(exp_toys, 1e-12)
        n = obs_toys
        terms = exp_toys - n + n * np.log(np.where(n > 0, n / mu, 1.0))
        mask = (exp_toys > 0) | (n > 0)
        chi2_toys = 2.0 * np.where(mask, terms, 0.0).sum(axis=(0, 2))
        p_toys = float((chi2_toys >= chi2).mean())
    return GofResult(chi2=chi2, ndof=ndof, p_asymptotic=p_asym,
                     p_toys=p_toys, chi2_toys=chi2_toys)
