"""MCMC convergence diagnostics: split-R-hat and effective sample size.

The reference has no convergence diagnostics at all (chains are trusted
blind); these are the standard tools (Gelman et al., BDA3) computed on
device-resident chain arrays.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def split_rhat(chains: np.ndarray) -> float:
    """Split-R-hat for one parameter.

    Args:
        chains: ``(nchains, nsteps)`` samples (a single chain is split
            in half, per the "split" variant).

    Returns:
        The potential scale reduction factor; ~1.0 at convergence.
    """
    chains = np.asarray(chains, np.float64)
    if chains.ndim == 1:
        chains = chains[None, :]
    n = chains.shape[1] // 2
    if n < 2:
        return float("nan")
    halves = np.concatenate([chains[:, :n], chains[:, n:2 * n]], axis=0)
    m = halves.shape[0]
    means = halves.mean(axis=1)
    vars_ = halves.var(axis=1, ddof=1)
    w = vars_.mean()
    b = n * means.var(ddof=1)
    if w <= 0:
        return float("nan")
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def ess(chain: np.ndarray, max_lag: int = 1000) -> float:
    """Effective sample size via the initial-positive-sequence
    autocorrelation estimator (Geyer 1992)."""
    x = np.asarray(chain, np.float64).reshape(-1)
    n = x.size
    if n < 4:
        return float(n)
    x = x - x.mean()
    var = (x * x).mean()
    if var <= 0:
        return float(n)
    max_lag = min(max_lag, n - 1)
    # FFT autocorrelation.
    f = np.fft.rfft(x, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:max_lag + 1]
    acf = acf / acf[0]
    # Sum pairs of consecutive lags while positive.
    tau = 1.0
    for k in range(1, max_lag, 2):
        pair = acf[k] + (acf[k + 1] if k + 1 <= max_lag else 0.0)
        if pair <= 0:
            break
        tau += 2 * pair
    return float(n / tau)


def summarize(samples: np.ndarray, names: Sequence[str],
              nchains: int = 1) -> Dict[str, Dict[str, float]]:
    """Per-parameter diagnostics for a pooled (nchains*nsteps, npar)
    sample array."""
    samples = np.asarray(samples)
    total, npar = samples.shape
    nsteps = total // max(nchains, 1)
    out: Dict[str, Dict[str, float]] = {}
    for j, name in enumerate(names):
        col = samples[:nchains * nsteps, j]
        chains = col.reshape(nchains, nsteps)
        out[name] = {
            "mean": float(col.mean()),
            "std": float(col.std()),
            "ess": ess(col),
            "rhat": split_rhat(chains),
        }
    return out
