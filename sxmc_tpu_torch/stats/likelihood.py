"""LikelihoodSpace: the sampled likelihood function.

Re-implements reference src/likelihood.{h,cpp} over plain arrays: the
MCMC chain history replaces the ROOT TNtuple, projections are numpy
histograms instead of ``TNtuple::Draw``, and the contour subset is a
boolean mask instead of ``CopyTree``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sxmc_tpu_torch.stats.intervals import Interval, make_error_estimator
from sxmc_tpu_torch.utils import FitError


class LikelihoodSpace:
    """Samples of the likelihood function (likelihood.h:25-100)."""

    def __init__(self, samples: np.ndarray, nll_values: np.ndarray,
                 names: List[str], cl: float = 0.683,
                 error_type: str = "contour"):
        if samples.ndim != 2 or samples.shape[0] != nll_values.shape[0]:
            raise FitError(
                "LikelihoodSpace needs (nsamples, nparams) samples "
                "with one NLL value per sample; got shapes "
                f"{samples.shape} and {nll_values.shape}")
        self.samples = np.asarray(samples)
        self.nll_values = np.asarray(nll_values)
        self.names = list(names)
        self.cl = cl
        self.error_type = error_type
        self._ml_params: Optional[Dict[str, Interval]] = None

    @classmethod
    def from_arrays(cls, samples, nll_values, names, **kw):
        return cls(np.asarray(samples), np.asarray(nll_values), names, **kw)

    # ------------------------------------------------------------------

    def column(self, name: str) -> np.ndarray:
        if name == "likelihood":
            return self.nll_values
        return self.samples[:, self.names.index(name)]

    @property
    def nll_min(self) -> float:
        return float(self.nll_values.min())

    def get_best_fit(self) -> Dict[str, Interval]:
        """Extract ML params + intervals (likelihood.cpp:104-137)."""
        if self._ml_params is None:
            est = make_error_estimator(self.error_type, self, self.cl)
            self._ml_params = {name: est.get_interval(name)
                               for name in self.names}
        return self._ml_params

    def get_contour(self, delta: float) -> "LikelihoodSpace":
        """Samples with NLL within delta of the minimum
        (likelihood.cpp:89-101)."""
        mask = (self.nll_values - self.nll_min) < delta
        if mask.sum() == 0:
            raise FitError(
                f"no likelihood samples within dNLL < {delta} of the "
                "minimum — the chain has not explored the mode "
                "(raise nsteps or check the model)")
        return LikelihoodSpace(self.samples[mask], self.nll_values[mask],
                               self.names, self.cl, self.error_type)

    def get_projection(self, name: str, bins: int = 100
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """1-D histogram of a parameter (likelihood.cpp:75-86)."""
        col = self.column(name)
        return np.histogram(col, bins=bins)

    def correlation_matrix(self) -> Tuple[np.ndarray, List[str]]:
        """Pearson correlations between parameters (utils.cpp:29-78)."""
        cols = [self.column(n) for n in self.names]
        stds = np.array([c.std() for c in cols])
        ok = stds > 0
        mat = np.eye(len(cols))
        data = np.stack(cols)
        if ok.any():
            # One varying column gives corrcoef a 0-d result.
            sub = np.atleast_2d(np.corrcoef(data[ok]))
            idx = np.where(ok)[0]
            for a, ia in enumerate(idx):
                for b, ib in enumerate(idx):
                    mat[ia, ib] = sub[a, b]
        return mat, self.names

    # ------------------------------------------------------------------

    def print_best_fit(self) -> str:
        lines = ["-- Best fit --"]
        for name, interval in self.get_best_fit().items():
            lines.append(f" {name}: {interval}")
        lines.append(f" NLL: {self.nll_min}")
        return "\n".join(lines)

    def print_correlations(self) -> str:
        mat, names = self.correlation_matrix()
        maxlen = max(len(n) for n in names)
        lines = ["-- Correlation matrix --"]
        for i, n in enumerate(names):
            row = "".join(f"{mat[i, j]:8.3f}" for j in range(len(names)))
            lines.append(f"{n:>{maxlen}} {row}")
        return "\n".join(lines)

    # ------------------------------------------------------------------

    def save(self, filename: str) -> None:
        """Persist the likelihood space (the reference writes a TNtuple
        per experiment, sxmc.cpp:130-141)."""
        from sxmc_tpu_torch.io import loaders

        data = np.concatenate(
            [self.samples, self.nll_values[:, None]], axis=1)
        loaders.write_float_table(filename, data,
                                  self.names + ["likelihood"])

    @classmethod
    def load(cls, filename: str, cl: float = 0.683,
             error_type: str = "contour") -> "LikelihoodSpace":
        """Resume from a saved sample file (the ``fit.samples`` mechanism,
        sxmc.cpp:84-94)."""
        from sxmc_tpu_torch.io import loaders

        data, fields = loaders.read_float_table(filename)
        if not fields or fields[-1] != "likelihood":
            raise FitError(
                f"{filename!r} is not a saved likelihood space (last "
                f"column must be 'likelihood', got {fields[-1:]!r})")
        return cls(data[:, :-1], data[:, -1], fields[:-1], cl, error_type)
