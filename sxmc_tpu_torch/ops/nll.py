"""Extended maximum-likelihood NLL (PyTorch, plain versions).

Port of ``sxmc_tpu/ops/nll.py`` (reference: src/nll_kernels.cpp:89-188).

  event term:  s_i = sum_j rate_j * nexpected_j * (norm_j / n_mc_j)
                          * lut[j, i]            (NaN lut values count 0)
               sum_events = sum_i log(s_i)       (only where s_i > 0)
  total:       nll = -sum_events + sum_j w_j
                     + sum_k 0.5 * ((p_k - mu_k) / sigma_k)^2  (sigma_k > 0)
  barrier:     f32(1e18) if any rate is negative or the event sum is
               not finite.

Every function takes leading chain axes (``pars`` ``(nchains,
nparams)``), the batched form the lock-step chains use.  ``binned_nll_pair``
is the exact binned regrouping of the same likelihood.

Precision.  The reference sums in double.  The TPU has no fast f64, so
the JAX package carries the sums as compensated (hi, lo) float32 pairs.
An H100 has native f64, so here the per-event values stay float32 (the
same values the JAX package computes) and the sums run in float64; the
result is split into the same (hi, lo) float32 pair at the end, because
the chain's NLL history and every interface downstream carry pairs
(``nll_history_to_f64``, metropolis.py:45-54).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

BARRIER = 1e18


def split_pair(total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 value -> float32 (hi, lo) with hi + lo ~= total."""
    hi = total.to(torch.float32)
    lo = (total - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def df_sum(x: torch.Tensor, dim=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum (of all elements, or over ``dim``) as a float32 (hi, lo)
    pair, summed in f64."""
    x = x.to(torch.float64)
    return split_pair(x.sum() if dim is None else x.sum(dim=dim))


def two_sum(a, b):
    """Branch-free Knuth TwoSum: a + b = s + err exactly (in f32)."""
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    return s, err


def df_add(hi_a, lo_a, hi_b, lo_b):
    """Double-float addition of two (hi, lo) pairs, renormalized."""
    hi, err = two_sum(hi_a, hi_b)
    lo = lo_a + lo_b + err
    return two_sum(hi, lo)


def df_diff(hi_a, lo_a, hi_b, lo_b):
    """Accurate (a - b) as one float32 value, in the JAX op order."""
    return (hi_a - hi_b) + (lo_a - lo_b)


class NLLStatic(NamedTuple):
    """Per-fit constants for the NLL, as host numpy arrays.

    Attributes:
        nexpected: ``(nsignals,)`` expected events per signal at unit rate.
        n_mc: ``(nsignals,)`` MC sample counts per signal.
        source_id: ``(nsignals,)`` int32 index of each signal's rate in
            the parameter vector (reference: mcmc.cpp:93-98).
        means: ``(nparams,)`` parameter means / expectations.
        sigmas: ``(nparams,)`` Gaussian constraint widths (0 = none).
        nsources: count of rate parameters at the head of the vector.
    """

    nexpected: np.ndarray
    n_mc: np.ndarray
    source_id: np.ndarray
    means: np.ndarray
    sigmas: np.ndarray
    nsources: int


class NLLConsts(NamedTuple):
    """An :class:`NLLStatic` as float32/int64 tensors on one device
    (:func:`device_consts`), made once per fit so that a step loop
    copies nothing from the host; every NLL function here takes it."""

    nexpected: torch.Tensor
    n_mc: torch.Tensor
    source_id: torch.Tensor
    means: torch.Tensor
    sig_safe: torch.Tensor   # sigmas, with 1 where a parameter is free
    sig_on: torch.Tensor     # sigma > 0: the parameter is constrained
    nsources: int


def device_consts(st: NLLStatic, device) -> NLLConsts:
    """``st`` on ``device``."""
    sig = np.asarray(st.sigmas, np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return NLLConsts(
        nexpected=f32(st.nexpected), n_mc=f32(st.n_mc),
        source_id=torch.as_tensor(np.asarray(st.source_id, np.int64),
                                  device=device),
        means=f32(st.means), sig_safe=f32(np.where(sig > 0, sig, 1.0)),
        sig_on=torch.as_tensor(sig > 0, device=device),
        nsources=int(st.nsources))


def signal_weights(pars: torch.Tensor, norms: torch.Tensor,
                   c: NLLConsts) -> torch.Tensor:
    """Per-signal event weight ``((rate * nexpected) * norm) / n_mc``.

    The association is the JAX package's (signal_weights and
    pallas_step.py:234-238), in float32.  ``pars`` ``(..., npar)`` and
    ``norms`` ``(..., nsignals)`` broadcast over leading chain axes.
    """
    rates = pars[..., c.source_id]
    return ((rates * c.nexpected) * norms) / c.n_mc


def constraint_term(pars: torch.Tensor, c: NLLConsts) -> torch.Tensor:
    """float64 ``sum 0.5 z^2`` over constrained parameters, with the
    float32 ``z = (p - mu) / sigma`` of finish_nll (nll.py:171-173)."""
    z = (pars - c.means) / c.sig_safe
    zz = torch.where(c.sig_on, z * z, torch.zeros_like(z))
    return 0.5 * zz.to(torch.float64).sum(dim=-1)


def finish_nll(pars: torch.Tensor, ev_hi, ev_lo, w: torch.Tensor,
               c: NLLConsts) -> Tuple[torch.Tensor, torch.Tensor]:
    """NLL epilogue: event pair + expected-count term + constraints +
    barrier -> (hi, lo) float32 pair.  Shared with the fused kernels'
    plain versions, which therefore finish with identical math.
    Leading axes of ``pars`` (``(..., npar)``) are chains."""
    ev = ev_hi.to(torch.float64) + ev_lo.to(torch.float64)
    total = -ev + w.to(torch.float64).sum(dim=-1) + constraint_term(pars, c)
    hi, lo = split_pair(total)
    neg_rate = (pars[..., :c.nsources] < 0).any(dim=-1)
    bad = neg_rate | ~torch.isfinite(ev_hi)
    hi = torch.where(bad, torch.full_like(hi, BARRIER), hi)
    lo = torch.where(bad, torch.zeros_like(lo), lo)
    return hi, lo


def event_logs(w: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Per-event ``log(sum_j w_j lut_j)`` (0 where the mixture is <= 0).

    Non-finite lut values (the NaN sentinel, 0/0 of an empty signal)
    count as 0; the mix is accumulated in ascending signal order, as
    the JAX package's unrolled mix (nll.py:211-230).  ``w`` is ``(...,
    nsignals)`` and ``lut`` ``(..., nsignals, nevents)``.
    """
    lut0 = torch.nan_to_num(lut, nan=0.0, posinf=0.0, neginf=0.0)
    s = w[..., 0, None] * lut0[..., 0, :]
    for j in range(1, lut.shape[-2]):
        s = s + w[..., j, None] * lut0[..., j, :]
    return _log_pos(s)


def _log_pos(s: torch.Tensor) -> torch.Tensor:
    pos = s > 0
    return torch.where(pos, torch.log(torch.where(pos, s, torch.ones_like(s))),
                       torch.zeros_like(s))


def nll_pair(pars: torch.Tensor, lut: torch.Tensor, norms: torch.Tensor,
             c: NLLConsts, weights: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full extended-ML NLL as a float32 (hi, lo) pair.

    Args:
        pars: ``(nparams,)`` float32 — rates then systematic
            coefficients — or ``(nchains, nparams)``.
        lut: ``(nsignals, nevents)`` float32 PDF values at the data
            points (NaN for out-of-domain points), or ``(nchains,
            nsignals, nevents)``.
        norms: ``(nsignals,)`` float32 in-domain MC counts (or
            ``(nchains, nsignals)``).
        c: fit constants on the device of ``pars``.
        weights: optional ``(..., nevents)`` float32 per-event weights on
            the log term (``sum_i w_i log s_i``): a weight of k is exactly
            k identical events, which is how an Asimov dataset is fitted
            (stats.asimov; JAX nll.py:202-206).
    """
    w = signal_weights(pars, norms, c)
    logs = event_logs(w, lut)
    if weights is not None:
        logs = logs * weights
    ev_hi, ev_lo = df_sum(logs, dim=-1)
    return finish_nll(pars, ev_hi, ev_lo, w, c)


def nll(pars, lut, norms, c: NLLConsts,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar float32 NLL (see :func:`nll_pair`).  Differentiable in
    ``pars`` (the float64 sums carry the gradient; the MLE takes it with
    ``torch.func``)."""
    hi, lo = nll_pair(pars, lut, norms, c, weights)
    return hi + lo


# Binned form of the same likelihood (JAX nll.py:250-).  The PDFs are
# piecewise constant on the bin grid, so the unbinned extended NLL
# regroups exactly by (dataset, bin):
#
#   sum_i log s(x_i)  ==  sum_{d,b} n_{d,b} * log s_{d,b}
#
# with n_{d,b} the data counts and s_{d,b} the mixture density in bin b
# of dataset d: the event term drops from O(nevents * nsignals) to
# O(ndatasets * nbins) per step, and the LUT gather goes away.


def binned_nll_pair(pars: torch.Tensor, hists: torch.Tensor,
                    norms: torch.Tensor, c: NLLConsts,
                    data_counts: torch.Tensor,
                    ds_mask: torch.Tensor, bin_volume: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extended-ML NLL from binned data counts (exact regrouping).

    Args:
        pars: ``(nparams,)`` or ``(nchains, nparams)``.
        hists: ``(..., nsignals, total_nbins)`` MC counts at the current
            systematics (``PdfStack.histograms`` / ``histograms_batch``).
        norms: ``(..., nsignals)`` in-domain MC counts.
        c: fit constants on the device of ``pars``.
        data_counts: ``(ndatasets, total_nbins)`` float32 data counts
            per dataset bin (``PdfStack.data_bin_counts`` or
            ``counts_from_read_bins``; out-of-domain and unknown-tag
            events excluded, as the -1/-2 sentinels exclude them).
        ds_mask: ``(ndatasets, nsignals)`` float32 0/1: signal j
            contributes to dataset row d.
        bin_volume: volume of one bin.

    Returns:
        The (hi, lo) pair, with :func:`nll_pair`'s barrier and
        constraints; the mix is unrolled in ascending signal order, as
        the JAX package's.
    """
    w = signal_weights(pars, norms, c)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    dens = hists / (safe.unsqueeze(-1) * float(np.float32(bin_volume)))
    mw = ds_mask * w.unsqueeze(-2)                # (..., nds, nsig)
    s = mw[..., :, 0, None] * dens[..., None, 0, :]
    for j in range(1, hists.shape[-2]):
        s = s + mw[..., :, j, None] * dens[..., None, j, :]
    ev_hi, ev_lo = df_sum(_log_pos(s) * data_counts, dim=(-2, -1))
    return finish_nll(pars, ev_hi, ev_lo, w, c)


def binned_nll(pars, hists, norms, c: NLLConsts, data_counts, ds_mask,
               bin_volume: float) -> torch.Tensor:
    """Scalar float32 form of :func:`binned_nll_pair`."""
    hi, lo = binned_nll_pair(pars, hists, norms, c, data_counts, ds_mask,
                             bin_volume)
    return hi + lo
