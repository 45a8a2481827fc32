"""Feldman-Cousins confidence intervals via batched toy fits (port of
``sxmc_tpu/stats/feldman_cousins.py``).

Construction (profile-likelihood variant, nuisances plugged in at their
nominal values for toy generation):

  for each r_true on a grid:
      generate N toy datasets with the signal injected at r_true
      for each toy: d(r_true) = NLL(r_true, rates-hat-hat) - NLL(r-hat)
      critical value c(r_true) = cl-quantile of d
  interval for the observed data = { r : d_obs(r) <= c(r) }

Every toy of the belt is generated on the device (generator.
make_fake_dataset_batch), padded to one length, and fitted twice
(global and pinned) as two batched solves over the whole (grid x toys)
batch; the toys' LUT is one B2 launch (stats.mle.toy_state).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from sxmc_tpu_torch.generator import make_fake_dataset_batch
from sxmc_tpu_torch.stats.intervals import Interval
from sxmc_tpu_torch.stats.mle import MLE, solve_rates, toy_state


@dataclasses.dataclass
class Belt:
    """A Feldman-Cousins confidence belt for one parameter."""

    name: str
    cl: float
    r_grid: np.ndarray        # (G,) true-value grid
    crit: np.ndarray          # (G,) critical dNLL per grid point
    dnll_toys: np.ndarray     # (G, ntoys) the full toy dNLL distributions


def pad_toys(batches: Sequence[torch.Tensor]) -> torch.Tensor:
    """Toy batches ``(ntoys_i, nev_i, ncols)`` stacked along the toys,
    padded to the longest with tag -1 rows (observables 0)."""
    nev = max(max(b.shape[1] for b in batches), 1)
    ncols = batches[0].shape[2]
    out = []
    for b in batches:
        pad = torch.zeros((b.shape[0], nev - b.shape[1], ncols),
                          dtype=b.dtype, device=b.device)
        pad[..., -1] = -1.0
        out.append(torch.cat([b, pad], dim=1))
    return torch.cat(out, dim=0)


class FeldmanCousins:
    """FC interval construction around a gradient MLE fit."""

    def __init__(self, mle: MLE, signal_name: str):
        self.mle = mle
        self.signal_name = signal_name
        self.k = mle.parameter_names.index(signal_name)
        if self.k >= mle.nsources:
            raise ValueError("Feldman-Cousins applies to rate parameters")

    def build_belt(self, gen: torch.Generator, r_grid: Sequence[float],
                   ntoys: int = 200, cl: float = 0.9, verbose: bool = False,
                   fluctuate_systematics: bool = False, mesh=None,
                   toys=None) -> Belt:
        """Toy-MC the belt: ``(G * ntoys)`` datasets, two batched solves.

        ``gen`` is a ``torch.Generator`` on the fit's device; ``toys``,
        when given, replaces the generator: ``toys(rates, ntoys)`` returns
        the ``(ntoys, nev, ncols)`` batch of one grid point (rates keyed
        by signal name), which is how the tests feed both packages the
        same toys.  ``fluctuate_systematics`` draws each toy's
        constrained coefficients from their priors at generation.
        ``mesh`` (``parallel.mesh.Mesh``) splits the (grid x toys) fit
        batch over its shards, each on its device, with the same results
        (``parallel.toys_sharded``)."""
        mle = self.mle
        r_grid = np.asarray(r_grid, np.float32)
        per_point = []
        for r in r_grid:
            rates = self._toy_rates(float(r))
            if toys is not None:
                batch = torch.as_tensor(np.asarray(toys(rates, ntoys),
                                                   np.float32),
                                        device=mle.device)
            else:
                batch = make_fake_dataset_batch(
                    gen, mle.signals, mle.systematics, mle.observables,
                    ntoys, mle.stack, poisson=True, rates=rates,
                    fluctuate_systematics=fluctuate_systematics)
            per_point.append(batch)
        rb = mle.stack.compute_read_bins(pad_toys(per_point))
        r_values = np.repeat(r_grid, ntoys)
        if mesh is not None:
            from sxmc_tpu_torch.parallel.toys_sharded import sharded_toy_dnll

            dnll, _ = sharded_toy_dnll(mesh, mle, r_values, rb, self.k,
                                       tuple(mle._free_rates))
        else:
            dnll, _ = toy_dnll_batch(mle, r_values, rb, self.k,
                                     tuple(mle._free_rates))
        dnll = dnll.reshape(len(r_grid), ntoys)
        crit = np.quantile(dnll, cl, axis=1)
        if verbose:
            for r, c in zip(r_grid, crit):
                print(f"FC belt: r_true={r:g} crit dNLL={c:.3f}")
        return Belt(name=self.signal_name, cl=cl, r_grid=r_grid, crit=crit,
                    dnll_toys=dnll)

    def interval(self, data, belt: Belt, result=None) -> Interval:
        """Observed FC interval: profile dNLL against the belt's
        criticals."""
        mle = self.mle
        if result is None:
            result = mle.fit(data)
        pnll = mle.profile(self.signal_name, belt.r_grid, result)
        dnll_obs = pnll - result.nll
        accepted = dnll_obs <= belt.crit
        if not accepted.any():
            # Pathological (undersampled belt): accept the closest point.
            accepted[int(np.argmin(dnll_obs - belt.crit))] = True
        idx = np.where(accepted)[0]
        lo = _refine(belt.r_grid, dnll_obs - belt.crit, idx[0], -1)
        hi = _refine(belt.r_grid, dnll_obs - belt.crit, idx[-1], +1)
        one_sided = idx[0] == 0 and belt.r_grid[0] <= 0.0
        return Interval(one_sided=bool(one_sided),
                        point_estimate=result.value(self.signal_name),
                        lower=float(lo), upper=float(hi), cl=belt.cl)

    def run(self, gen: torch.Generator, data, r_grid: Sequence[float],
            ntoys: int = 200, cl: float = 0.9, verbose: bool = False,
            toys=None, mesh=None) -> Interval:
        """Belt + observed interval in one call (``mesh`` as in
        :meth:`build_belt`)."""
        belt = self.build_belt(gen, r_grid, ntoys, cl, verbose, mesh=mesh,
                               toys=toys)
        self.last_belt = belt
        return self.interval(data, belt)

    def _toy_rates(self, r: float) -> Dict[str, float]:
        """Injection rates by signal name: every signal fed by the
        parameter's source at ``r``, the others at their sources' nominal
        means (HypoTest._toy_stats' mapping)."""
        rates = {}
        for sig in self.mle.signals:
            if sig.source.index == self.k:
                rates[sig.name] = r
            else:
                base = self.mle.parameter_means[sig.source.index]
                rates[sig.name] = max(float(base), 0.0)
        return rates


def _refine(grid, excess, i, direction):
    """Linear crossing of excess = 0 between grid[i] and its neighbour."""
    j = i + direction
    if j < 0 or j >= len(grid) or excess[i] == excess[j]:
        return grid[i]
    f = excess[i] / (excess[i] - excess[j])
    f = min(max(f, 0.0), 1.0)
    return grid[i] + f * (grid[j] - grid[i])


def toy_dnll_batch(mle: MLE, r_values, read_bins_batch: torch.Tensor,
                   k: int, free_idx):
    """Per toy ``(dNLL, r_hat)`` (JAX ``_toy_dnll_batch``): dNLL =
    NLL(rate k pinned at the toy's r, the others profiled) - NLL(global
    minimum), floored at 0, and r_hat the toy's unconstrained rate k.
    Systematics are held at nominal (the plug-in construction); the
    global and the pinned fits are each one batched solve over every
    toy, on PDFs built once (B1) and one LUT launch (B2).  Returns host
    arrays."""
    ntoys = read_bins_batch.shape[0]
    ns = mle.nsources
    theta = np.asarray(mle.parameter_means[ns:], np.float32)
    means = np.asarray(mle.parameter_means[:ns], np.float32)
    q0 = np.log(np.maximum(means, 1e-4)).astype(np.float32)
    free_no_k = tuple(i for i in free_idx if i != k)
    state = toy_state(mle, theta, read_bins_batch)
    base = mle._base(theta, ntoys)
    x_hat, f_hat, _ = solve_rates(mle, tuple(free_idx), q0, base, state)
    pinned = base.clone()
    pinned[:, k] = torch.as_tensor(np.asarray(r_values, np.float32),
                                   device=mle.device)
    _, f_pin, _ = solve_rates(mle, free_no_k, q0, pinned, state)
    if k in free_idx:
        rhat = torch.exp(x_hat[:, list(free_idx).index(k)])
    else:
        rhat = base[:, k]
    dnll = torch.clamp_min(f_pin - f_hat, 0.0)
    return dnll.cpu().numpy(), rhat.cpu().numpy()
