"""Asimov datasets: the expectation-valued dataset as weighted events
(port of ``sxmc_tpu/stats/asimov.py``).

An Asimov dataset replaces every statistical fluctuation with its
expectation (Cowan, Cranmer, Gross & Vitells, arXiv:1007.1727 sec.
3.2): its maximum-likelihood estimators equal the generating parameters,
and fitting it gives the asymptotic test-statistic scale that turns
expected significances, limits and bands into a few deterministic fits
(stats.hypotest).  The PDFs are histograms, so the Asimov dataset is
exact: one event per (dataset, bin) at the bin centre, weighted by the
expected count

    nu_b = sum_j rate_j * nexpected_j * counts_jb / n_mc_j

which the weighted-event NLL (ops.nll with ``weights``) scores as
``sum_b nu_b log s_b``.  The histograms come from one
``PdfStack.histograms`` call (kernel B1 on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from sxmc_tpu_torch.ops import histogram as hist_ops


def bin_centers(stack) -> np.ndarray:
    """``(total_nbins, nobservables)`` bin-centre coordinates of a
    PdfStack's grid, in flat row-major bin order (pdfz.cpp:207-215)."""
    nbins = stack.nbins
    strides = hist_ops.bin_strides(nbins)
    flat = np.arange(stack.total_nbins, dtype=np.int64)
    centers = np.empty((stack.total_nbins, len(nbins)), np.float32)
    for i, (lo, up, n) in enumerate(
            zip(stack.lower_host, stack.upper_host, nbins)):
        axis = (flat // strides[i]) % n
        centers[:, i] = lo + (axis + 0.5) * (up - lo) / n
    return centers


def asimov_dataset(model, params: Optional[np.ndarray] = None,
                   overrides: Optional[Dict[str, float]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The Asimov dataset of a fit model (an MCMC or MLE: ``stack``,
    ``static``, ``parameter_means``, ``parameter_names``, ``nsources``)
    at ``params`` (default the nominal means), with ``overrides`` by
    parameter name on top (e.g. ``{"signal": 0.0}``).

    Returns ``(data, weights)``: ``(n, nobservables + 1)`` float32 events
    (dataset tag last, one per nonempty bin per dataset) and their
    ``(n,)`` float32 expected counts, for ``MLE.fit(data, weights=...)``.
    """
    if params is None:
        params = np.asarray(model.parameter_means, np.float64).copy()
    else:
        params = np.asarray(params, np.float64).copy()
    if overrides:
        for name, value in overrides.items():
            params[model.parameter_names.index(name)] = value

    stack = model.stack
    hists, _ = stack.histograms(
        np.asarray(params[model.nsources:], np.float32))
    hists = hists.cpu().numpy().astype(np.float64)

    st = model.static
    rates = params[np.asarray(st.source_id)]
    scale = rates * np.asarray(st.nexpected, np.float64) \
        / np.asarray(st.n_mc, np.float64)
    nu = hists * scale[:, None]                 # (nsignals, total_nbins)

    centers = bin_centers(stack)
    events, weights = [], []
    for ds in sorted({int(d) for d in stack.datasets}):
        rows = [j for j, d in enumerate(stack.datasets) if int(d) == ds]
        nu_d = nu[rows].sum(axis=0)
        keep = nu_d > 0
        n_keep = int(keep.sum())
        if n_keep == 0:
            continue
        events.append(np.concatenate(
            [centers[keep], np.full((n_keep, 1), float(ds), np.float32)],
            axis=1))
        weights.append(nu_d[keep])
    if not events:
        return (np.empty((0, stack.nobservables + 1), np.float32),
                np.empty((0,), np.float32))
    return (np.concatenate(events).astype(np.float32),
            np.concatenate(weights).astype(np.float32))
