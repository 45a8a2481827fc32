"""Extended maximum-likelihood NLL (PyTorch, plain versions).

Port of ``sxmc_tpu/ops/nll.py`` (reference: src/nll_kernels.cpp:89-188).

  event term:  s_i = sum_j rate_j * nexpected_j * (norm_j / n_mc_j)
                          * lut[j, i]            (NaN lut values count 0)
               sum_events = sum_i log(s_i)       (only where s_i > 0)
  total:       nll = -sum_events + sum_j w_j
                     + sum_k 0.5 * ((p_k - mu_k) / sigma_k)^2  (sigma_k > 0)
  barrier:     f32(1e18) if any rate is negative or the event sum is
               not finite.

Precision.  The reference sums in double.  The TPU has no fast f64, so
the JAX package carries the sums as compensated (hi, lo) float32 pairs.
An H100 has native f64, so here the per-event values stay float32 (the
same values the JAX package computes) and the sums run in float64; the
result is split into the same (hi, lo) float32 pair at the end, because
the chain's NLL history and every interface downstream carry pairs
(``nll_history_to_f64``, metropolis.py:45-54).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

BARRIER = 1e18


def split_pair(total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 value -> float32 (hi, lo) with hi + lo ~= total."""
    hi = total.to(torch.float32)
    lo = (total - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def df_sum(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of all elements as a float32 (hi, lo) pair, summed in f64."""
    return split_pair(x.to(torch.float64).sum())


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


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def signal_weights(pars: torch.Tensor, norms: torch.Tensor,
                   st: NLLStatic) -> torch.Tensor:
    """Per-signal event weight ``((rate * nexpected) * norm) / n_mc``.

    The association is the JAX package's (signal_weights and
    pallas_step.py:234-238), in float32.
    """
    dev = pars.device
    rates = pars[torch.as_tensor(np.asarray(st.source_id, np.int64),
                                 device=dev)]
    return ((rates * _f32(st.nexpected, dev)) * norms) / _f32(st.n_mc, dev)


def constraint_term(pars: torch.Tensor, st: NLLStatic) -> torch.Tensor:
    """float64 ``sum 0.5 z^2`` over constrained parameters, with the
    float32 ``z = (p - mu) / sigma`` of finish_nll (nll.py:171-173)."""
    dev = pars.device
    sig = np.asarray(st.sigmas, np.float32)
    on = torch.as_tensor(sig > 0, device=dev)
    z = (pars - _f32(st.means, dev)) / _f32(np.where(sig > 0, sig, 1.0),
                                              dev)
    zz = torch.where(on, z * z, torch.zeros_like(z))
    return 0.5 * zz.to(torch.float64).sum()


def finish_nll(pars: torch.Tensor, ev_hi, ev_lo, w: torch.Tensor,
               st: NLLStatic) -> Tuple[torch.Tensor, torch.Tensor]:
    """NLL epilogue: event pair + expected-count term + constraints +
    barrier -> (hi, lo) float32 pair.  Shared with the fused kernels'
    plain versions, which therefore finish with identical math."""
    ev = ev_hi.to(torch.float64) + ev_lo.to(torch.float64)
    total = -ev + w.to(torch.float64).sum() + constraint_term(pars, st)
    hi, lo = split_pair(total)
    neg_rate = (pars[:st.nsources] < 0).any()
    bad = neg_rate | ~torch.isfinite(ev_hi)
    hi = torch.where(bad, torch.full_like(hi, BARRIER), hi)
    lo = torch.where(bad, torch.zeros_like(lo), lo)
    return hi, lo


def event_logs(w: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Per-event ``log(sum_j w_j lut_j)`` (0 where the mixture is <= 0).

    Non-finite lut values (the NaN sentinel, 0/0 of an empty signal)
    count as 0; the mix is accumulated in ascending signal order, as
    the JAX package's unrolled mix (nll.py:211-230).
    """
    lut0 = torch.nan_to_num(lut, nan=0.0, posinf=0.0, neginf=0.0)
    s = w[0] * lut0[0]
    for j in range(1, lut.shape[0]):
        s = s + w[j] * lut0[j]
    pos = s > 0
    return torch.where(pos, torch.log(torch.where(pos, s, torch.ones_like(s))),
                       torch.zeros_like(s))


def nll_pair(pars: torch.Tensor, lut: torch.Tensor, norms: torch.Tensor,
             st: NLLStatic) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full extended-ML NLL as a float32 (hi, lo) pair.

    Args:
        pars: ``(nparams,)`` float32 — rates then systematic coefficients.
        lut: ``(nsignals, nevents)`` float32 PDF values at the data
            points (NaN for out-of-domain points).
        norms: ``(nsignals,)`` float32 in-domain MC counts.
        st: fit constants.
    """
    w = signal_weights(pars, norms, st)
    ev_hi, ev_lo = df_sum(event_logs(w, lut))
    return finish_nll(pars, ev_hi, ev_lo, w, st)


def nll(pars, lut, norms, st) -> torch.Tensor:
    """Scalar float32 NLL (see :func:`nll_pair`)."""
    hi, lo = nll_pair(pars, lut, norms, st)
    return hi + lo
