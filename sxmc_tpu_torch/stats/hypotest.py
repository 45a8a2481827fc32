"""Hypothesis tests: discovery significance and CLs upper limits (port of
``sxmc_tpu/stats/hypotest.py``).

The profile-likelihood-ratio test statistics of Cowan, Cranmer, Gross &
Vitells (arXiv:1007.1727) on top of the gradient MLE:

  * q0   — discovery: q0 = 2 [NLL(r=0) - NLL(r-hat)], 0 if r-hat = 0;
           Z = sqrt(q0) asymptotically, or toy-exact.
  * q~r  — upper limits: q_r = 2 [NLL(r) - NLL(r-hat)], 0 if r-hat > r;
           CLs(r) = P(q >= q_obs | s+b) / P(q >= q_obs | b-only),
           limit at CLs = 1 - cl.

Every toy ensemble is one batched draw on the device and two batched
solves (feldman_cousins.toy_dnll_batch).  Toys come from a
``torch.Generator`` on the fit's device; every construction also takes
``toys(rates, ntoys)``, a caller's replacement for the generator (the
tests feed both packages the same toys through it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from scipy.special import erf, erfinv

from sxmc_tpu_torch.generator import make_fake_dataset_batch
from sxmc_tpu_torch.stats.asimov import asimov_dataset
from sxmc_tpu_torch.stats.feldman_cousins import toy_dnll_batch
from sxmc_tpu_torch.stats.mle import MLE, FitResult

# (rates by signal name, ntoys) -> (ntoys, nev, ncols) toy batch
ToySource = Callable[[Dict[str, float], int], np.ndarray]


def _norm_cdf(x):
    return 0.5 * (1.0 + erf(np.asarray(x, np.float64) / np.sqrt(2.0)))


def _norm_sf(x):
    return 0.5 * (1.0 - erf(x / np.sqrt(2.0)))


def _norm_isf(p):
    return np.sqrt(2.0) * erfinv(1.0 - 2.0 * p)


@contextlib.contextmanager
def _preserved_fit_state(mle: MLE):
    """Run a side fit (an Asimov dataset) without clobbering the
    fit's dataset: restores the stack's read bins, its exact-KDE
    snapshot and the MLE's last-fit cache on exit (JAX hypotest.py:
    43-60)."""
    stack = mle.stack
    saved = (stack._read_bins, stack._kde_exact_state,
             getattr(mle, "_last", None))
    try:
        yield
    finally:
        stack._read_bins, stack._kde_exact_state, last = saved
        if last is not None:
            mle._last = last
        elif hasattr(mle, "_last"):
            del mle._last


def _cross_alpha(r_grid, vals, alpha):
    """First downward crossing of vals through alpha, linearly
    interpolated; r_grid[0] (with a warning) when the curve starts below
    alpha, the last grid point when it never drops below it."""
    if len(r_grid) and vals[0] < alpha:
        warnings.warn(
            f"CLs/q curve already below alpha={alpha:g} at the first "
            f"grid point r={r_grid[0]:g}; the limit lies at or below "
            "the scan minimum — extend the grid downward.")
        return float(r_grid[0])
    for i in range(len(r_grid) - 1):
        if vals[i] >= alpha >= vals[i + 1]:
            f = (vals[i] - alpha) / max(vals[i] - vals[i + 1], 1e-12)
            return float(r_grid[i] + f * (r_grid[i + 1] - r_grid[i]))
    return float(r_grid[-1])


@dataclasses.dataclass
class DiscoveryResult:
    q0: float                 # observed test statistic
    z_asymptotic: float       # sqrt(q0)
    p_asymptotic: float
    z_toys: Optional[float] = None   # from the b-only toy ensemble
    p_toys: Optional[float] = None
    ntoys: int = 0

    def __str__(self):
        s = (f"q0 = {self.q0:.3f}, Z = {self.z_asymptotic:.2f} sigma "
             f"(p = {self.p_asymptotic:.2e}, asymptotic)")
        if self.z_toys is not None:
            s += (f"; Z = {self.z_toys:.2f} sigma "
                  f"(p = {self.p_toys:.2e}, {self.ntoys} toys)")
        return s


@dataclasses.dataclass
class AsymptoticLimit:
    """Observed + expected CLs limits from the Asimov construction."""

    limit: float                       # observed upper limit
    expected: Dict[int, float]         # N sigma -> expected limit
    r_grid: np.ndarray
    cls_obs: np.ndarray
    cl: float

    def __str__(self):
        bands = ", ".join(
            f"{n:+d}s: {v:.4g}" for n, v in sorted(self.expected.items()))
        return (f"r < {self.limit:.4g} ({100 * self.cl:g}% CL, "
                f"asymptotic CLs); expected median "
                f"{self.expected.get(0, float('nan')):.4g} [{bands}]")


class HypoTest:
    """Discovery / CLs tests for one signal rate around a gradient MLE.

    ``fluctuate_systematics=True`` draws each toy's constrained
    systematic coefficients from their priors at generation (the per-toy
    fits keep the plug-in theta)."""

    def __init__(self, mle: MLE, signal_name: str,
                 fluctuate_systematics: bool = False):
        self.mle = mle
        self.signal_name = signal_name
        self.fluctuate_systematics = fluctuate_systematics
        self.k = mle.parameter_names.index(signal_name)
        if self.k >= mle.nsources:
            raise ValueError("Hypothesis tests apply to rate parameters")
        if float(mle.parameter_sigma[self.k]) > 0:
            warnings.warn(
                f"signal rate '{signal_name}' carries a Gaussian "
                "constraint; q0/CLs constructions assume an "
                "UNCONSTRAINED parameter of interest — the constraint "
                "term will pull every test statistic (and collapse "
                "expected bands).  Set the source's sigma to 0 for "
                "standard discovery/limit semantics.")

    # ------------------------------------------------------------------

    def discovery(self, data, ntoys: int = 0,
                  gen: Optional[torch.Generator] = None,
                  toys: Optional[ToySource] = None) -> DiscoveryResult:
        """Discovery significance of the signal (background-only null);
        with ``ntoys``, also the toy p-value from b-only toys."""
        mle = self.mle
        result = mle.fit(data)
        pnll0 = float(mle.profile(self.signal_name, [0.0], result)[0])
        rhat = result.value(self.signal_name)
        q0 = max(2.0 * (pnll0 - result.nll), 0.0) if rhat > 0 else 0.0
        z = float(np.sqrt(q0))
        out = DiscoveryResult(q0=q0, z_asymptotic=z,
                              p_asymptotic=float(_norm_sf(z)))
        if ntoys > 0:
            if gen is None and toys is None:
                gen = torch.Generator(mle.device).manual_seed(0)
            q_toys, _ = self._toy_stats(gen, 0.0, 0.0, ntoys, result, toys)
            # Half of the b-only toys have r-hat = 0 exactly (q0 = 0); the
            # p-value counts q >= q0_obs among all toys.
            p = float(np.mean(q_toys >= max(q0, 1e-12)))
            p = max(p, 1.0 / (ntoys + 1))
            out.p_toys = p
            out.z_toys = float(_norm_isf(p))
            out.ntoys = ntoys
        return out

    def _cls_at(self, gen, r_grid, q_obs, ntoys, result, verbose, toys):
        """CLs(r) at each grid point from per-point toy ensembles."""
        cls_vals = np.empty(len(r_grid))
        for i, r in enumerate(r_grid):
            q_sb, q_b = self._toy_qs(gen, float(r), ntoys, result, toys)
            p_sb = np.mean(q_sb >= q_obs[i] - 1e-9)
            p_b = np.mean(q_b >= q_obs[i] - 1e-9)
            cls_vals[i] = p_sb / max(p_b, 1.0 / ntoys)
            if verbose:
                print(f"CLs: r={r:g} q_obs={q_obs[i]:.3f} "
                      f"p_sb={p_sb:.3f} p_b={p_b:.3f} "
                      f"CLs={cls_vals[i]:.3f}")
        return cls_vals

    def cls_upper_limit(self, gen: Optional[torch.Generator], data,
                        r_grid: Sequence[float], ntoys: int = 200,
                        cl: float = 0.95, verbose: bool = False,
                        refine: int = 4, toys: Optional[ToySource] = None):
        """CLs upper limit on the signal rate: at each grid point the
        observed one-sided q_r and its s+b and b-only toy ensembles;
        with ``refine > 0``, that many extra points inside the bracket of
        the coarse CLs = 1 - cl crossing.  Returns ``(limit, r_grid,
        cls_values)`` with the refined points merged in."""
        mle = self.mle
        result = mle.fit(data)
        rhat = max(result.value(self.signal_name), 0.0)
        r_grid = np.asarray(r_grid, np.float64)
        alpha = 1.0 - cl

        def observed_q(grid):
            pnll = mle.profile(self.signal_name, grid.astype(np.float32),
                               result)
            q = np.maximum(2.0 * (pnll - result.nll), 0.0)
            return np.where(grid < rhat, 0.0, q)  # one-sided (q~_r)

        q_obs = observed_q(r_grid)
        cls_vals = self._cls_at(gen, r_grid, q_obs, ntoys, result, verbose,
                                toys)
        bracket = None
        for i in range(len(r_grid) - 1):
            if cls_vals[i] >= alpha >= cls_vals[i + 1]:
                bracket = i
                break
        if refine > 0 and bracket is not None:
            sub = np.linspace(r_grid[bracket], r_grid[bracket + 1],
                              refine + 2)[1:-1]
            q_sub = observed_q(sub)
            cls_sub = self._cls_at(gen, sub, q_sub, ntoys, result, verbose,
                                   toys)
            r_all = np.concatenate([r_grid, sub])
            order = np.argsort(r_all)
            r_grid = r_all[order]
            cls_vals = np.concatenate([cls_vals, cls_sub])[order]
        return (_cross_alpha(r_grid, cls_vals, 1.0 - cl), r_grid, cls_vals)

    # ------------------------------------------------------------------

    def cls_expected_band(self, gen: Optional[torch.Generator],
                          r_grid: Sequence[float], ntoys: int = 200,
                          cl: float = 0.95,
                          background_fit: Optional[FitResult] = None,
                          quantiles=(0.025, 0.16, 0.5, 0.84, 0.975),
                          toys: Optional[ToySource] = None):
        """Expected CLs limits (the "Brazil band") from b-only toys: a
        kappa-quantile limit crosses CLs_exp(r) = P(q_sb >=
        q_b^(1-kappa)) / kappa at 1 - cl.  Without ``background_fit`` the
        nominal (pre-data) background rates generate the toys.  Returns
        ``{kappa: expected_limit}``."""
        r_grid = np.asarray(r_grid, np.float64)
        cls_exp = {q: np.empty(len(r_grid)) for q in quantiles}
        for i, r in enumerate(r_grid):
            q_sb, q_b = self._toy_qs(gen, float(r), ntoys, background_fit,
                                     toys)
            for kq in quantiles:
                qcut = np.quantile(q_b, 1.0 - kq)
                p_sb = np.mean(q_sb >= qcut - 1e-9)
                cls_exp[kq][i] = p_sb / max(kq, 1e-6)
        return {kq: _cross_alpha(r_grid, cls_exp[kq], 1.0 - cl)
                for kq in quantiles}

    # ------------------------------------------------------------------
    # Asymptotic (Asimov) variants: deterministic, no toys.

    def asymptotic_significance(self, rate: float,
                                params: Optional[np.ndarray] = None
                                ) -> DiscoveryResult:
        """Median expected discovery significance for a true signal
        rate, from the Asimov dataset: Z_med = sqrt(q0_A)."""
        mle = self.mle
        with _preserved_fit_state(mle):
            a_data, a_w = asimov_dataset(
                mle, params=params, overrides={self.signal_name: float(rate)})
            a_res = mle.fit(a_data, weights=a_w)
            pnll0 = float(mle.profile(self.signal_name, [0.0], a_res)[0])
            q0 = max(2.0 * (pnll0 - a_res.nll), 0.0)
        z = float(np.sqrt(q0))
        return DiscoveryResult(q0=q0, z_asymptotic=z,
                               p_asymptotic=float(_norm_sf(z)))

    def asymptotic_upper_limit(self, data, r_grid: Sequence[float],
                               cl: float = 0.95) -> AsymptoticLimit:
        """Observed CLs upper limit + expected band, asymptotic: the q~_r
        distributions take their asymptotic forms with sigma^2 = r^2 /
        q_r,A from a background-only Asimov fit (arXiv:1007.1727 eqs.
        62-66, arXiv:1307.1427 eq. 38)."""
        mle = self.mle
        result = mle.fit(data)
        rhat = max(result.value(self.signal_name), 0.0)
        r_grid = np.asarray(r_grid, np.float64)
        pnll = mle.profile(self.signal_name, r_grid.astype(np.float32),
                           result)
        q_obs = np.maximum(2.0 * (np.asarray(pnll, np.float64)
                                  - result.nll), 0.0)
        q_obs = np.where(r_grid < rhat, 0.0, q_obs)
        cond = mle.conditional_fit(self.signal_name, 0.0, result)
        q_a = self._asimov_q(cond, r_grid)

        sqrt_q = np.sqrt(q_obs)
        sqrt_qa = np.sqrt(q_a)
        cls_obs = np.ones(len(r_grid))
        for i in range(len(r_grid)):
            if sqrt_qa[i] <= 0.0:
                continue
            if sqrt_q[i] <= sqrt_qa[i]:
                clsb = _norm_sf(sqrt_q[i])
                clb = _norm_sf(sqrt_q[i] - sqrt_qa[i])
            else:
                clsb = _norm_sf((q_obs[i] + q_a[i]) / (2.0 * sqrt_qa[i]))
                clb = _norm_sf((q_obs[i] - q_a[i]) / (2.0 * sqrt_qa[i]))
            cls_obs[i] = clsb / max(clb, 1e-12)
        limit = _cross_alpha(r_grid, cls_obs, 1.0 - cl)
        expected = {}
        for n in (-2, -1, 0, 1, 2):
            cls_exp = _norm_sf(sqrt_qa - n) / max(_norm_cdf(n), 1e-12)
            expected[n] = _cross_alpha(r_grid, cls_exp, 1.0 - cl)
        return AsymptoticLimit(limit=limit, expected=expected,
                               r_grid=r_grid, cls_obs=cls_obs, cl=cl)

    def _asimov_q(self, params_bkg: np.ndarray,
                  r_grid: np.ndarray) -> np.ndarray:
        """q_r,A over the grid from one background-only Asimov fit."""
        mle = self.mle
        with _preserved_fit_state(mle):
            a_data, a_w = asimov_dataset(
                mle, params=params_bkg, overrides={self.signal_name: 0.0})
            a_res = mle.fit(a_data, weights=a_w)
            grid0 = np.concatenate([[0.0], r_grid]).astype(np.float32)
            a_pnll = np.asarray(mle.profile(self.signal_name, grid0, a_res),
                                np.float64)
        # r-hat of the b-only Asimov is exactly 0, so its profile at 0 is
        # the unconditional minimum.
        return np.maximum(2.0 * (a_pnll[1:] - a_pnll[0]), 0.0)

    # ------------------------------------------------------------------

    def _toy_qs(self, gen, r: float, ntoys: int,
                background_fit: Optional[FitResult] = None, toys=None):
        """One-sided q~_r toy ensembles at rate r: (s+b toys, b-only
        toys), upward fluctuations (r_hat > r) zeroed."""
        q_sb, rhat_sb = self._toy_stats(gen, r, r, ntoys, background_fit,
                                        toys)
        q_b, rhat_b = self._toy_stats(gen, 0.0, r, ntoys, background_fit,
                                      toys)
        return (np.where(rhat_sb > r, 0.0, q_sb),
                np.where(rhat_b > r, 0.0, q_b))

    def _toy_stats(self, gen, gen_rate: float, test_rate: float, ntoys: int,
                   background_fit: Optional[FitResult] = None, toys=None):
        """Toys at gen_rate -> (q = 2 dNLL at test_rate, r_hat) per toy.
        With a ``background_fit`` the other rates come from the
        conditional fit with the signal pinned at gen_rate; without one
        (a pre-data band) the nominal means."""
        mle = self.mle
        if background_fit is not None:
            if hasattr(mle, "_last"):
                cond = mle.conditional_fit(self.signal_name, gen_rate,
                                           background_fit)
            else:
                cond = np.asarray(background_fit.params)
        else:
            cond = None
        rates = {}
        for sig in mle.signals:
            base = (cond[sig.source.index] if cond is not None
                    else mle.parameter_means[sig.source.index])
            rates[sig.name] = max(float(base), 0.0)
            if sig.source.index == self.k:
                rates[sig.name] = gen_rate
        if toys is not None:
            batch = np.asarray(toys(rates, ntoys), np.float32)
        else:
            batch = make_fake_dataset_batch(
                gen, mle.signals, mle.systematics, mle.observables, ntoys,
                mle.stack, poisson=True, rates=rates,
                fluctuate_systematics=self.fluctuate_systematics)
        rb = mle.stack.compute_read_bins(batch)
        dnll, rhat = toy_dnll_batch(mle, np.full(ntoys, test_rate),
                                    rb, self.k, tuple(mle._free_rates))
        return 2.0 * dnll, rhat
