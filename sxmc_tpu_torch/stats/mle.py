"""Gradient-based maximum-likelihood estimation (port of
``sxmc_tpu/stats/mle.py``).

The extended-ML NLL (ops.nll) is differentiable in the parameters, so
the best fit comes from a BFGS solve instead of a random walk, with

  * Hessian (inverse-curvature) covariance and symmetric errors,
  * profile-likelihood scans, every point an independent solve, the
    whole scan one batched solve (stats.bfgs),
  * MINOS-style asymmetric intervals from the profile crossings, and
  * one-sided profile-likelihood upper limits.

Source rates are optimised in log space (r = exp(q)), which enforces the
physical boundary r >= 0.  Systematic coefficients enter the NLL through
the re-histogrammed PDFs, which are piecewise constant in theta (the bin
assignment is a floor), so their event-term gradient is zero almost
everywhere; floating systematics are profiled by a coordinate-grid
descent, each grid one batched solve whose PDFs come from one
``PdfStack.evaluate_batch`` (kernel B1-batched, then B2).

The NLL is only ever differentiated in the parameters, never through a
histogram: the LUT (or the binned histograms) and the norms of a solve
are fixed inputs built by the kernels, and autograd takes the gradients
and Hessians of the plain NLL ops (stats.bfgs.Objective).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.special import erfinv

from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.ops import kernels
from sxmc_tpu_torch.ops.nll import binned_nll, nll as nll_fn
from sxmc_tpu_torch.stats.bfgs import Objective, minimize
from sxmc_tpu_torch.stats.intervals import Interval, chi2_quantile_1dof
from sxmc_tpu_torch.utils import as_f32

_LOG_CLAMP = 30.0


@dataclasses.dataclass
class FitResult:
    """Point estimate + curvature errors from a gradient MLE fit."""

    names: List[str]
    params: np.ndarray          # full parameter vector at the optimum
    nll: float                  # NLL at the optimum
    free: np.ndarray            # bool mask of optimized parameters
    covariance: np.ndarray      # (nfree, nfree) inverse Hessian
    converged: bool

    @property
    def free_names(self) -> List[str]:
        return [n for n, f in zip(self.names, self.free) if f]

    def value(self, name: str) -> float:
        return float(self.params[self.names.index(name)])

    def error(self, name: str) -> float:
        """Symmetric (Hessian) error; NaN for fixed parameters."""
        i = self.names.index(name)
        if not self.free[i]:
            return float("nan")
        j = int(np.sum(self.free[:i]))
        return float(np.sqrt(max(self.covariance[j, j], 0.0)))

    def to_intervals(self, cl: float = 0.683) -> Dict[str, Interval]:
        """Symmetric intervals, drop-in for LikelihoodSpace.get_best_fit."""
        z = np.sqrt(chi2_quantile_1dof(cl))
        out = {}
        for name in self.names:
            v = self.value(name)
            e = self.error(name)
            e = 0.0 if not np.isfinite(e) else e * z
            out[name] = Interval(one_sided=False, point_estimate=v,
                                 lower=v - e, upper=v + e, cl=cl)
        return out

    def __str__(self) -> str:
        lines = ["-- MLE best fit --"]
        for name in self.names:
            v = self.value(name)
            e = self.error(name)
            tag = "" if np.isfinite(e) else " (fixed)"
            etxt = f" +- {e:g}" if np.isfinite(e) else ""
            lines.append(f" {name}: {v:g}{etxt}{tag}")
        lines.append(f" NLL: {self.nll}")
        if not self.converged:
            lines.append(" WARNING: optimizer did not report convergence")
        return "\n".join(lines)


class MLE(MCMC):
    """The maximum-likelihood fit, with the MCMC's model contract: the
    parameter flattening, PDF stack and NLL constants of
    :class:`sxmc_tpu_torch.mcmc.metropolis.MCMC`, on its device (the card
    unless the caller asks for the CPU), with deterministic optimisation
    in place of the random walk."""

    def __init__(self, *args, maxiter: int = 400, **kwargs):
        super().__init__(*args, **kwargs)
        self.maxiter = maxiter
        rate_idx = np.arange(self.nsources)
        self._free_rates = tuple(
            int(i) for i in rate_idx[~self.parameter_fixed[:self.nsources]])
        self._float_systs = tuple(
            int(i) for i in range(self.nsources, self.nparameters)
            if not self.parameter_fixed[i])

    # ------------------------------------------------------------------

    def fit(self, data, weights=None) -> FitResult:
        """Rates by BFGS; floating systematics by a coordinate-grid
        descent (:meth:`_fit_systematics`).  ``weights`` are optional
        per-event weights on the log term (a weight of k is exactly k
        identical events): the mechanism that makes Asimov datasets
        (stats.asimov) fittable."""
        self.stack.set_data(data)
        read_bins = self.stack.read_bins
        w = None if weights is None else as_f32(weights, self.device)
        theta = np.asarray(self.parameter_means[self.nsources:], np.float32)
        q0 = self._initial_q()
        if self._float_systs:
            theta = self._fit_systematics(theta, q0, read_bins, w)
        qhat, fmin, ok = self._solve(theta, q0, read_bins, w)
        params = self._assemble(qhat, theta)
        cov = self._hessian_covariance(params, read_bins, w)
        result = FitResult(
            names=list(self.parameter_names), params=params,
            nll=float(fmin), free=~self.parameter_fixed.copy(),
            covariance=cov, converged=bool(ok))
        self._last = (result, read_bins, w)
        return result

    # ------------------------------------------------------------------

    def _fit_systematics(self, theta: np.ndarray, q0: np.ndarray,
                         read_bins, weights=None, npasses: int = 4,
                         ngrid: int = 9) -> np.ndarray:
        """Coordinate-grid descent over the floating systematics: per
        pass and coefficient, ``ngrid`` candidates around the current
        value (range 2 sigma, shrinking 3x per pass), each profiled over
        the rates; a grid is one batched solve on the PDFs of one
        ``evaluate_batch``.  The Gaussian constraint on the coefficient
        is inside the NLL, so the search finds the profile optimum."""
        theta = theta.copy()
        fidx = np.asarray(self._float_systs) - self.nsources
        widths = np.asarray([
            self.parameter_sigma[i] if self.parameter_sigma[i] > 0
            else 0.1 * max(abs(self.parameter_means[i]), 1.0)
            for i in self._float_systs], np.float32)
        for p in range(npasses):
            scale = 2.0 / (3.0 ** p)
            for jj, j in enumerate(fidx):
                grid = (theta[j] + np.linspace(-scale, scale, ngrid,
                                               dtype=np.float32)
                        * widths[jj])
                pnll = self._profile_syst_grid(grid, int(j), q0, theta,
                                               read_bins, weights)
                theta[j] = grid[int(np.argmin(pnll))]
        return theta

    def profile(self, name: str, values: Sequence[float],
                result: Optional[FitResult] = None) -> np.ndarray:
        """Profiled NLL over a grid: rates re-optimised per point, the
        whole scan one batched solve.  Floating systematics other than
        ``name`` are held at their global-fit optimum."""
        result, read_bins, weights = self._ensure_fit(result)
        values = np.asarray(values, np.float32)
        k = self.parameter_names.index(name)
        theta_hat = np.asarray(result.params[self.nsources:], np.float32)
        q_init = self._q_from_params(result.params)
        if k < self.nsources:
            free = tuple(i for i in self._free_rates if i != k)
            state = mle_state(self, theta_hat, read_bins, weights)
            base = self._base(theta_hat, len(values))
            base[:, k] = torch.as_tensor(values, device=self.device)
            _, f, _ = solve_rates(self, free, q_init, base, state)
            return f.cpu().numpy()
        return self._profile_syst_grid(values, k - self.nsources, q_init,
                                       theta_hat, read_bins, weights)

    def profile2d(self, name1: str, name2: str,
                  values1: Sequence[float], values2: Sequence[float],
                  result: Optional[FitResult] = None) -> np.ndarray:
        """Profiled NLL over a 2-D grid of two rates, or of a rate and a
        systematic coefficient (the PDFs rebuilt once per value of it):
        the whole ``(n1, n2)`` map is one batched solve.  dNLL cut at
        -ln(1 - cl) gives joint contours
        (:func:`profile2d_contour_levels`)."""
        result, read_bins, weights = self._ensure_fit(result)
        k1 = self.parameter_names.index(name1)
        k2 = self.parameter_names.index(name2)
        if k1 == k2:
            raise ValueError("profile2d needs two distinct parameters")
        if k1 >= self.nsources and k2 >= self.nsources:
            raise ValueError("profile2d supports two rates or one rate "
                             "+ one systematic coefficient; profile "
                             "two systematics one at a time")
        values1 = np.asarray(values1, np.float32)
        values2 = np.asarray(values2, np.float32)
        theta_hat = np.asarray(result.params[self.nsources:], np.float32)
        q_init = self._q_from_params(result.params)
        dev = self.device

        if k1 >= self.nsources or k2 >= self.nsources:
            transpose = k1 >= self.nsources
            k_rate, k_syst = (k2, k1) if transpose else (k1, k2)
            v_rate, v_syst = ((values2, values1) if transpose
                              else (values1, values2))
            j = k_syst - self.nsources
            free = tuple(i for i in self._free_rates if i != k_rate)
            thetas = np.repeat(theta_hat[None], len(v_syst), axis=0)
            thetas[:, j] = v_syst
            table, norms, extra = mle_state_batch(self, thetas, read_bins,
                                                  weights)
            ns, nr = len(v_syst), len(v_rate)
            rows = torch.arange(ns, device=dev).repeat_interleave(nr)
            base = self._base(theta_hat, ns * nr)
            base[:, k_rate] = torch.as_tensor(v_rate, device=dev).repeat(ns)
            base[:, k_syst] = torch.as_tensor(v_syst, device=dev)[rows]
            _, f, _ = solve_rates(self, free, q_init, base,
                                  (table[rows], norms[rows], extra))
            pnll = f.cpu().numpy().reshape(ns, nr)
            return pnll if transpose else pnll.T

        g1, g2 = np.meshgrid(values1, values2, indexing="ij")
        free = tuple(i for i in self._free_rates if i not in (k1, k2))
        state = mle_state(self, theta_hat, read_bins, weights)
        base = self._base(theta_hat, g1.size)
        base[:, k1] = torch.as_tensor(g1.ravel(), device=dev)
        base[:, k2] = torch.as_tensor(g2.ravel(), device=dev)
        _, f, _ = solve_rates(self, free, q_init, base, state)
        return f.cpu().numpy().reshape(len(values1), len(values2))

    def conditional_fit(self, name: str, value: float,
                        result: Optional[FitResult] = None) -> np.ndarray:
        """Conditional ("hat-hat") fit: the other free rates re-optimised
        with ``name`` pinned at ``value``; returns the full parameter
        vector (floating systematics held at the global-fit optimum)."""
        result, read_bins, weights = self._ensure_fit(result)
        k = self.parameter_names.index(name)
        free = tuple(i for i in self._free_rates if i != k)
        theta_hat = np.asarray(result.params[self.nsources:], np.float32)
        q_init = self._q_from_params(result.params)
        state = mle_state(self, theta_hat, read_bins, weights)
        base = self._base(theta_hat, 1)
        base[:, k] = float(np.float32(value))
        x, _, _ = solve_rates(self, free, q_init, base, state)
        qhat = q_init.copy()
        qhat[list(free)] = x[0].cpu().numpy()
        params = self._assemble(qhat, theta_hat)
        params[k] = value
        return params

    def profile_interval(self, name: str, cl: float = 0.683,
                         result: Optional[FitResult] = None,
                         ngrid: int = 41) -> Interval:
        """MINOS-style asymmetric interval from profile crossings of
        dNLL = chi2_quantile(cl, 1) / 2."""
        result, _, _ = self._ensure_fit(result)
        k = self.parameter_names.index(name)
        vhat = result.value(name)
        sig = result.error(name)
        if not np.isfinite(sig) or sig <= 0:
            sig = max(abs(vhat), 1.0) * 0.1
        lo = vhat - 6.0 * sig
        if k < self.nsources:
            lo = max(lo, 0.0)
        grid = np.linspace(lo, vhat + 6.0 * sig, ngrid, dtype=np.float32)
        pnll = self.profile(name, grid, result)
        target = 0.5 * chi2_quantile_1dof(cl)
        return _interval_from_profile(grid, pnll, vhat, target, cl)

    def upper_limit(self, name: str, cl: float = 0.9,
                    result: Optional[FitResult] = None,
                    ngrid: int = 61) -> float:
        """One-sided profile-likelihood upper limit: the dNLL crossing at
        z(cl)^2 / 2, z the one-sided normal quantile."""
        result, _, _ = self._ensure_fit(result)
        vhat = max(result.value(name), 0.0)
        sig = result.error(name)
        if not np.isfinite(sig) or sig <= 0:
            sig = max(abs(vhat), 1.0) * 0.1
        grid = np.linspace(0.0, vhat + 8.0 * sig, ngrid, dtype=np.float32)
        pnll = self.profile(name, grid, result)
        z = np.sqrt(2.0) * erfinv(2.0 * cl - 1.0)
        target = 0.5 * z * z
        dn = pnll - pnll.min()
        imin = int(np.argmin(pnll))
        for i in range(imin, len(grid) - 1):
            if dn[i] <= target <= dn[i + 1]:
                f = (target - dn[i]) / max(dn[i + 1] - dn[i], 1e-12)
                return float(grid[i] + f * (grid[i + 1] - grid[i]))
        return float(grid[-1])

    # ------------------------------------------------------------------
    # internals

    def _initial_q(self) -> np.ndarray:
        r0 = np.maximum(self.parameter_means[:self.nsources], 1e-4)
        return np.log(r0).astype(np.float32)

    def _q_from_params(self, params: np.ndarray) -> np.ndarray:
        r = np.maximum(np.asarray(params[:self.nsources]), 1e-8)
        return np.log(r).astype(np.float32)

    def _assemble(self, qhat: np.ndarray, theta: np.ndarray) -> np.ndarray:
        params = np.concatenate([
            np.asarray(self.parameter_means[:self.nsources], np.float32),
            np.asarray(theta, np.float32)])
        for i in self._free_rates:
            params[i] = np.exp(np.clip(qhat[i], -_LOG_CLAMP, _LOG_CLAMP))
        return params

    def _base(self, theta: np.ndarray, n: int) -> torch.Tensor:
        """``(n, npar)`` rows of the rates' means then ``theta``."""
        row = np.concatenate([self.parameter_means[:self.nsources],
                              np.asarray(theta, np.float32)])
        return torch.as_tensor(row.astype(np.float32),
                               device=self.device).repeat(n, 1)

    def _solve(self, theta, q0, read_bins, weights=None):
        """The free rates at fixed systematics: ``(qhat, nll, ok)``."""
        state = mle_state(self, theta, read_bins, weights)
        x, f, ok = solve_rates(self, self._free_rates, q0,
                               self._base(theta, 1), state)
        qhat = np.asarray(q0, np.float32).copy()
        qhat[list(self._free_rates)] = x[0].cpu().numpy()
        return qhat, float(f[0]), bool(ok[0])

    def _profile_syst_grid(self, values, j: int, q_init, theta, read_bins,
                           weights=None) -> np.ndarray:
        """Profiled NLL over a systematic-coefficient grid: the PDFs of
        every grid point from one ``evaluate_batch`` (B1-batched, then
        B2), the rate solves as one batch."""
        values = np.asarray(values, np.float32)
        thetas = np.repeat(np.asarray(theta, np.float32)[None], len(values),
                           axis=0)
        thetas[:, j] = values
        table, norms, extra = mle_state_batch(self, thetas, read_bins,
                                              weights)
        base = torch.as_tensor(np.concatenate(
            [np.repeat(self.parameter_means[None, :self.nsources],
                       len(values), axis=0), thetas], axis=1),
            device=self.device)
        _, f, _ = solve_rates(self, self._free_rates, q_init, base,
                              (table, norms, extra))
        return f.cpu().numpy()

    def _hessian_covariance(self, params, read_bins, weights=None):
        free_idx = np.where(~self.parameter_fixed)[0]
        h = free_hessian(self, params, tuple(int(i) for i in free_idx),
                         read_bins, weights)
        h = np.asarray(h, np.float64)
        # A floating systematic with no Gaussian constraint (sigma = 0)
        # has zero curvature everywhere (its event term is piecewise
        # constant by design), leaving a zero row and column.  pinv would
        # silently report zero variance; surface NaN instead.
        degenerate = np.all(h == 0.0, axis=1)
        if degenerate.any():
            names = [self.parameter_names[free_idx[i]]
                     for i in np.where(degenerate)[0]]
            warnings.warn(
                "Hessian is singular: parameter(s) "
                f"{names} have no curvature (unconstrained floating "
                "systematic?); their errors are NaN.")
            keep = ~degenerate
            cov = np.full_like(h, np.nan)
            sub = h[np.ix_(keep, keep)]
            try:
                cov_sub = np.linalg.inv(sub)
            except np.linalg.LinAlgError:
                cov_sub = np.linalg.pinv(sub)
            cov[np.ix_(keep, keep)] = cov_sub
            return cov
        try:
            return np.linalg.inv(h)
        except np.linalg.LinAlgError:
            return np.linalg.pinv(h)

    def _ensure_fit(self, result: Optional[FitResult]):
        if not hasattr(self, "_last"):
            raise RuntimeError("call fit() first")
        if result is None:
            return self._last
        return (result,) + self._last[1:]


def _interval_from_profile(grid: np.ndarray, pnll: np.ndarray,
                           vhat: float, target: float,
                           cl: float) -> Interval:
    """Linear-interpolated dNLL crossings around the profile minimum."""
    dn = np.asarray(pnll, np.float64)
    dn = dn - dn.min()
    imin = int(np.argmin(dn))
    point = float(vhat)
    lower = float(grid[0])
    found_lower = False
    for i in range(imin, 0, -1):
        if dn[i] <= target <= dn[i - 1]:
            f = (target - dn[i]) / max(dn[i - 1] - dn[i], 1e-12)
            lower = float(grid[i] + f * (grid[i - 1] - grid[i]))
            found_lower = True
            break
    upper = float(grid[-1])
    for i in range(imin, len(grid) - 1):
        if dn[i] <= target <= dn[i + 1]:
            f = (target - dn[i]) / max(dn[i + 1] - dn[i], 1e-12)
            upper = float(grid[i] + f * (grid[i + 1] - grid[i]))
            break
    one_sided = not found_lower and grid[0] <= 0.0 <= grid[-1]
    return Interval(one_sided=one_sided, point_estimate=point,
                    lower=lower, upper=upper, cl=cl)


def profile2d_contour_levels(cl_list=(0.683, 0.95)) -> list:
    """dNLL contour levels for joint 2-dof confidence regions:
    dNLL = -ln(1 - cl) (chi2 quantile with 2 dof, halved)."""
    return [-np.log(1.0 - cl) for cl in cl_list]


# ----------------------------------------------------------------------
# The NLL of a solve, and its fixed inputs


def nll_function(mle: MCMC):
    """``(params, table, norms, extra) -> scalar NLL`` in the active mode
    (JAX ``_mle_nllf``): unbinned, ``table`` is the LUT and ``extra``
    the per-event weights (or None); binned, ``table`` the histograms
    and ``extra`` the data counts per dataset bin (weights already
    folded in, the identical regrouping of the weighted log term)."""
    consts = mle.nll_spec.consts
    if not mle.binned:
        def f(params, lut, norms, weights):
            return nll_fn(params, lut, norms, consts, weights)

        return f
    mask = torch.as_tensor(mle.stack.dataset_mask, device=mle.device)
    bv = mle.stack.bin_volume

    def fb(params, hists, norms, counts):
        return binned_nll(params, hists, norms, consts, counts, mask, bv)

    return fb


def mle_state(mle: MCMC, theta, read_bins, weights=None):
    """``(table, norms, extra)`` at systematics ``theta`` (JAX
    ``_mle_eval`` + ``_mle_nllf``): unbinned the LUT (B1, then B2) and
    the weights; binned the histograms (B1) and the data counts."""
    stack = mle.stack
    if not mle.binned:
        lut, norms = stack.evaluate(as_f32(theta, mle.device), read_bins)
        return lut, norms, weights
    hists, norms = stack.histograms(as_f32(theta, mle.device))
    return hists, norms, stack.counts_from_read_bins(read_bins, weights)


def mle_state_batch(mle: MCMC, thetas, read_bins, weights=None):
    """:func:`mle_state` at ``(B, nsyst)`` thetas: ``(table (B, ...),
    norms (B, nsignals), extra)`` from one B1-batched launch per 32
    thetas (and one B2 launch, unbinned); ``extra`` is shared."""
    stack = mle.stack
    thetas = as_f32(thetas, mle.device)
    if not mle.binned:
        lut, norms = stack.evaluate_batch(thetas, read_bins)
        return lut, norms, weights
    hists, norms = stack.histograms_batch(thetas)
    return hists, norms, stack.counts_from_read_bins(read_bins, weights)


def toy_state(mle: MCMC, theta, read_bins_batch: torch.Tensor):
    """The fixed inputs of a batch of toy fits at systematics ``theta``:
    ``(table, norms, extra)``, per toy or shared.  The histograms are
    built once
    (B1); unbinned, the LUT of every toy comes from one B2 launch over
    the toys' events laid end to end (``(ntoys, nsignals, nev)`` read
    bins -> ``(nsignals, ntoys * nev)``); binned, each toy's data counts
    from one offset bincount."""
    stack = mle.stack
    hists, norms = stack.histograms(as_f32(theta, mle.device))
    if mle.binned:
        return hists, norms, stack.counts_from_read_bins(read_bins_batch)
    return toy_lut(stack, hists, norms, read_bins_batch), norms, None


def toy_lut(stack, hists: torch.Tensor, norms: torch.Tensor,
            read_bins_batch: torch.Tensor) -> torch.Tensor:
    """Every toy's ``(ntoys, nsignals, nev)`` LUT from one B2 launch: the
    toys' read bins ``(ntoys, nsignals, nev)`` laid end to end as
    ``(nsignals, ntoys * nev)``."""
    ntoys, nsig, nev = read_bins_batch.shape
    flat = read_bins_batch.transpose(0, 1).reshape(nsig, ntoys * nev)
    lut = kernels.lut_eval(hists, norms, flat.contiguous(), stack.bin_volume)
    return lut.reshape(nsig, ntoys, nev).transpose(0, 1)


def _scatter_spec(npar: int, idx: Sequence[int], device):
    """``(slot, mask)``: ``where(mask, x[slot], base)`` puts ``x`` at
    ``idx`` of a parameter vector (an exact gather, no matmul)."""
    slot = np.zeros(npar, np.int64)
    mask = np.zeros(npar, bool)
    for s, i in enumerate(idx):
        slot[i], mask[i] = s, True
    return (torch.as_tensor(slot, device=device),
            torch.as_tensor(mask, device=device))


def solve_rates(mle: MCMC, free_idx: Sequence[int], q0, base: torch.Tensor,
                state):
    """One batched solve of ``mle``'s NLL (:func:`solve`)."""
    return solve(nll_function(mle), mle.maxiter, free_idx, q0, base, state)


def solve(nllf, maxiter: int, free_idx: Sequence[int], q0,
          base: torch.Tensor, state):
    """One batched solve: row b minimises ``nllf(params, *state_b)`` over
    the log-rates ``free_idx`` (r = exp(clip(q, +-30)) scattered into
    ``base[b]``), from ``q0[free_idx]``; ``state`` = ``(table, norms,
    extra)``, each with a leading axis of one per row or shared by all
    rows (broadcasting).  Returns ``(x (B, nfree), f (B,), ok (B,))``:
    the BFGS + Newton polish of :func:`sxmc_tpu_torch.stats.bfgs.minimize`."""
    nrows = base.shape[0]
    dev = base.device
    if not free_idx:
        f = nllf(base, *state)
        return (torch.zeros((nrows, 0), dtype=torch.float32, device=dev), f,
                torch.ones(nrows, dtype=torch.bool, device=dev))
    slot, mask = _scatter_spec(base.shape[1], free_idx, dev)

    def objective(qf, base_row, table, norms, extra):
        r = torch.exp(torch.clamp(qf, -_LOG_CLAMP, _LOG_CLAMP))
        return nllf(torch.where(mask, r[..., slot], base_row), table, norms,
                    extra)

    q0 = torch.as_tensor(np.asarray(q0, np.float32), device=dev)
    x0 = q0[list(free_idx)].repeat(nrows, 1)
    obj = Objective(objective, (base,) + tuple(state))
    return minimize(obj, x0, maxiter)


def free_hessian(mle: MCMC, params, free_idx: Tuple[int, ...], read_bins,
                 weights=None) -> np.ndarray:
    """Hessian of the NLL over the free parameters, in natural units, with
    the PDFs fixed at ``params``' systematics (JAX ``_free_hessian``):
    rates contribute their event-term curvature, floating systematics
    only their constraint's 1/sigma^2."""
    params_t = as_f32(params, mle.device)
    state = mle_state(mle, params_t[mle.nsources:], read_bins, weights)
    nllf = nll_function(mle)
    slot, mask = _scatter_spec(params_t.shape[0], free_idx, mle.device)

    def fun(x, table, norms, extra):
        return nllf(torch.where(mask, x[..., slot], params_t), table, norms,
                    extra)

    obj = Objective(fun, state)
    x = params_t[list(free_idx)].unsqueeze(0)
    return obj.hessian(x)[0].cpu().numpy()
