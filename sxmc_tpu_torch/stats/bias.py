"""Ensemble bias / pull studies (port of ``sxmc_tpu/stats/bias.py``).

Generate toy datasets at known true rates, fit each, and histogram the
pulls g_j = (r_hat_j - r_true_j) / sigma_hat_j: an unbiased fit with
correct errors gives pull mean 0 and width 1 per parameter.  All toys
are one padded batch drawn on the device (generator.
make_fake_dataset_batch) and fitted as one batched solve; the per-toy
errors come from the batched rate-space Hessian.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from sxmc_tpu_torch.generator import make_fake_dataset_batch
from sxmc_tpu_torch.stats.bfgs import Objective
from sxmc_tpu_torch.stats.intervals import chi2_quantile_1dof
from sxmc_tpu_torch.stats.mle import (_LOG_CLAMP, MLE, _scatter_spec,
                                      nll_function, solve_rates, toy_state)


@dataclasses.dataclass
class PullStudy:
    """Pull distributions of the free rate parameters over a toy
    ensemble."""

    names: List[str]          # free rate parameters, in order
    true_rates: np.ndarray    # (nfree,) generation values
    estimates: np.ndarray     # (ntoys, nfree) per-toy MLEs
    errors: np.ndarray        # (ntoys, nfree) per-toy Hessian errors
    cl: float                 # confidence level for the coverage column
    ntoys: int

    @property
    def pulls(self) -> np.ndarray:
        """(ntoys, nfree); NaN where a toy's error was unusable."""
        err = np.where(self.errors > 0, self.errors, np.nan)
        return (self.estimates - self.true_rates[None, :]) / err

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per parameter: pull mean/width, mean error, coverage of the
        +-z(cl) interval, and the count of usable toys."""
        z = float(np.sqrt(chi2_quantile_1dof(self.cl)))
        pulls = self.pulls
        out = {}
        for j, name in enumerate(self.names):
            p = pulls[:, j]
            ok = np.isfinite(p)
            n = int(ok.sum())
            pj = p[ok]
            out[name] = {
                "true": float(self.true_rates[j]),
                "pull_mean": float(pj.mean()) if n else float("nan"),
                "pull_std": float(pj.std(ddof=1)) if n > 1
                else float("nan"),
                "mean_error": float(self.errors[ok, j].mean()) if n
                else float("nan"),
                "coverage": float((np.abs(pj) <= z).mean()) if n
                else float("nan"),
                "n_used": n,
            }
        return out

    def __str__(self) -> str:
        lines = [f"-- Pull study ({self.ntoys} toys) --",
                 f" {'parameter':<12} {'true':>8} {'pull mean':>10} "
                 f"{'pull width':>10} {'coverage':>9}  (target "
                 f"{self.cl:.0%})"]
        for name, s in self.summary().items():
            lines.append(
                f" {name:<12} {s['true']:>8.4g} {s['pull_mean']:>10.3f} "
                f"{s['pull_std']:>10.3f} {s['coverage']:>9.3f}  "
                f"[{s['n_used']} toys]")
        return "\n".join(lines)


def pull_study(mle: MLE, ntoys: int, gen: Optional[torch.Generator],
               rates: Optional[Dict[str, float]] = None, cl: float = 0.683,
               fluctuate_systematics: bool = False, mesh=None,
               toys=None) -> PullStudy:
    """A pull/bias study around a gradient MLE: ``ntoys`` toys generated
    at ``rates`` (by parameter name; default the nominal means) from
    ``gen`` (a ``torch.Generator`` on the fit's device), or taken from
    ``toys(gen_rates, ntoys)`` when given, and fitted as one batch (or
    split over ``mesh``'s shards, ``parallel.toys_sharded``, with the same
    results).  Returns the PullStudy over the free rate parameters."""
    truth = np.asarray(mle.parameter_means, np.float64).copy()
    if rates:
        for name, value in rates.items():
            truth[mle.parameter_names.index(name)] = value
    gen_rates = {sig.name: max(float(truth[sig.source.index]), 0.0)
                 for sig in mle.signals}
    if toys is not None:
        batch = np.asarray(toys(gen_rates, ntoys), np.float32)
    else:
        batch = make_fake_dataset_batch(
            gen, mle.signals, mle.systematics, mle.observables, ntoys,
            mle.stack, poisson=True, rates=gen_rates,
            fluctuate_systematics=fluctuate_systematics)
    rb = mle.stack.compute_read_bins(batch)
    if mesh is not None:
        from sxmc_tpu_torch.parallel.toys_sharded import sharded_pull_batch

        rhat, err = sharded_pull_batch(mesh, mle, rb, tuple(mle._free_rates))
    else:
        rhat, err = toy_fit_batch(mle, rb, tuple(mle._free_rates))
    free = list(mle._free_rates)
    return PullStudy(names=[mle.parameter_names[i] for i in free],
                     true_rates=truth[np.asarray(free, int)],
                     estimates=rhat, errors=err, cl=cl, ntoys=ntoys)


def toy_fit_batch(mle: MLE, read_bins_batch: torch.Tensor, free_idx):
    """Per toy: the global fit of the free rates -> ``(r_hat, sigma_hat)``
    host arrays ``(ntoys, nfree)`` (JAX ``_toy_fit_batch``).  The fit runs
    in log-rates; the errors are the rate-space Hessian's inverse
    square-root diagonal, -1 where the curvature is unusable.
    Systematics are held at nominal (plug-in)."""
    ntoys = read_bins_batch.shape[0]
    ns = mle.nsources
    theta = np.asarray(mle.parameter_means[ns:], np.float32)
    q0 = np.log(np.maximum(mle.parameter_means[:ns], 1e-4)).astype(
        np.float32)
    state = toy_state(mle, theta, read_bins_batch)
    base = mle._base(theta, ntoys)
    x, _, _ = solve_rates(mle, tuple(free_idx), q0, base, state)
    rhat = torch.exp(torch.clamp(x, -_LOG_CLAMP, _LOG_CLAMP))
    nllf = nll_function(mle)
    slot, mask = _scatter_spec(base.shape[1], free_idx, mle.device)

    def fun_r(rf, base_row, table, norms, extra):
        return nllf(torch.where(mask, rf[..., slot], base_row), table, norms,
                    extra)

    h = Objective(fun_r, (base,) + tuple(state)).hessian(rhat)
    var = torch.diagonal(torch.linalg.inv_ex(h)[0], dim1=-2, dim2=-1)
    ok = torch.isfinite(var) & (var > 0)
    err = torch.where(ok, torch.sqrt(torch.where(ok, var, 1.0)), -1.0)
    return rhat.cpu().numpy(), err.cpu().numpy()
