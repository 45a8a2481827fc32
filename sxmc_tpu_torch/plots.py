"""Spectral fit plots.

Port of ``sxmc_tpu/plots.py::plot_fit`` (reference src/plots.{h,cpp})
with matplotlib: per dataset and per observable, a stacked spectrum of
each signal's PDF projection scaled to ``rate * nexpected *
efficiency`` at the best-fit parameters, overlaid with the total and
the (fake or real) data.  The signals' PDFs are their host-side
``EvalHist`` tables, so plotting runs on the CPU whatever device the
fit ran on.  The statistics tier's figures follow
(``sxmc_tpu/plots.py:116-284``): the CLs scan with its expected band, 2-D
profile-likelihood contours, pull histograms, and 2-D posterior credible
regions.  Every function imports matplotlib at its first call.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from sxmc_tpu_torch.signal import nominal_params

# Default color sequence (the reference uses a fixed 6-color palette,
# plots.cpp:23-29).
_COLORS = ["#4477AA", "#EE6677", "#228833", "#CCBB44", "#66CCEE",
           "#AA3377", "#BBBBBB", "#000000"]


def _pyplot():
    import matplotlib  # at first use: importing the package stays cheap

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_fit(
    best_fit: Dict[str, "object"],
    fc,
    data: np.ndarray,
    output_path: str,
    suffix: str = "",
    formats: tuple = ("png",),
) -> None:
    """Make stacked spectral plots for every (dataset, observable), to
    ``<output_path>/fit_ds<dataset>_<observable><suffix>.<format>``.

    Args:
        best_fit: parameter name -> Interval (point_estimate used).
        fc: the FitConfig.
        data: ``(nevents, nobs + 1)`` dataset with tags.
        output_path: directory for output images.
        formats: output file formats (matplotlib's png/pdf/svg/eps).
    """
    plt = _pyplot()
    os.makedirs(output_path, exist_ok=True)
    data = np.asarray(data)
    nobs = len(fc.observables)

    # Best-fit systematic parameter vector.
    theta = nominal_params(fc.systematics).copy()
    for syst in fc.systematics:
        for j, pidx in enumerate(syst.pidx):
            name = f"{syst.name}_{j}"
            if name in best_fit:
                theta[pidx] = best_fit[name].point_estimate

    for dataset in fc.datasets:
        ds_data = data[data[:, nobs] == dataset]
        for obs in fc.observables:
            fig, ax = plt.subplots(figsize=(7, 5))
            edges = np.linspace(obs.lower, obs.upper, obs.bins + 1)
            centers = 0.5 * (edges[:-1] + edges[1:])
            width = edges[1] - edges[0]

            total = np.zeros(obs.bins)
            for i, sig in enumerate(fc.signals):
                if sig.dataset != dataset:
                    continue
                rate = 1.0
                if sig.source.name in best_fit:
                    rate = best_fit[sig.source.name].point_estimate
                eff = sig.get_efficiency(fc.systematics)
                dens = sig.histogram.density_histogram(theta)
                # Project the N-D density onto this observable
                # (plots.cpp's projection loop).
                axes = tuple(a for a in range(nobs) if a != obs.field_index)
                marg = dens.sum(axis=axes) if axes else dens
                if nobs > 1:
                    marg = marg * np.prod(
                        [(o.upper - o.lower) / o.bins for o in fc.observables
                         if o.field_index != obs.field_index])
                counts = marg * width * rate * sig.nexpected * eff
                ax.plot(centers, total + counts, drawstyle="steps-mid",
                        color=_COLORS[i % len(_COLORS)], label=sig.title)
                total += counts

            ax.plot(centers, total, drawstyle="steps-mid", color="black",
                    lw=2, label="Fit")
            if ds_data.size:
                counts, _ = np.histogram(ds_data[:, obs.field_index],
                                         bins=edges)
                ax.errorbar(centers, counts, yerr=np.sqrt(counts), fmt="ko",
                            ms=4, label="Data")

            ax.set_xlabel(obs.title or obs.name)
            ax.set_ylabel(f"Events / {width:g} {obs.units}")
            if obs.logscale:
                ax.set_yscale("log")
            if obs.yrange and obs.yrange[0] >= 0:
                ax.set_ylim(obs.yrange)
            ax.legend(fontsize=8)
            fig.tight_layout()
            stem = os.path.join(output_path,
                                f"fit_ds{dataset}_{obs.name}{suffix}")
            for fmt in formats:
                fig.savefig(f"{stem}.{fmt}", dpi=120)
            plt.close(fig)


def plot_cls_scan(r_grid, cls_values, limit: float, cl: float, outpath: str,
                  signal_name: str = "signal",
                  expected: Dict[float, float] = None) -> None:
    """CLs exclusion scan: observed CLs(r) with the alpha crossing, plus
    the expected-limit band when given (``{kappa: limit}``, 0.5 the
    median, 0.16/0.84 the +-1 sigma band)."""
    plt = _pyplot()
    r_grid = np.asarray(r_grid, float)
    cls_values = np.asarray(cls_values, float)
    alpha = 1.0 - cl
    fig, ax = plt.subplots(figsize=(7, 5))
    if expected:
        lo, hi = expected.get(0.16), expected.get(0.84)
        if lo is not None and hi is not None:
            ax.axvspan(min(lo, hi), max(lo, hi), color="#228833",
                       alpha=0.2, lw=0, label="Expected limit ±1σ")
        med = expected.get(0.5)
        if med is not None:
            ax.axvline(med, color="#228833", ls="--", lw=1.5,
                       label="Expected limit (median)")
    ax.plot(r_grid, cls_values, color="#4477AA", lw=2, marker="o", ms=5,
            label="Observed CLs")
    ax.axhline(alpha, color="#888888", ls=":", lw=1.5)
    ax.annotate(f"α = {alpha:g}", (r_grid[-1], alpha), xytext=(-4, 4),
                textcoords="offset points", ha="right", fontsize=9,
                color="#555555")
    ax.axvline(limit, color="#4477AA", ls="--", lw=1.5,
               label=f"Observed limit ({cl:.0%} CL)")
    ax.set_xlabel(f"{signal_name} rate")
    ax.set_ylabel("CLs")
    ax.set_ylim(0.0, min(1.05, max(1.02 * cls_values.max(), 3 * alpha)))
    ax.grid(alpha=0.25, lw=0.5)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(outpath, dpi=120)
    plt.close(fig)


def plot_profile2d(values1, values2, pnll, outpath: str,
                   name1: str = "param 1", name2: str = "param 2",
                   cl_list=(0.683, 0.95), best=None) -> None:
    """Joint 2-dof confidence contours (dNLL = -ln(1 - cl)) from a
    ``(n1, n2)`` profile-NLL map of ``MLE.profile2d``; ``best`` an
    optional (v1, v2) marker."""
    from sxmc_tpu_torch.stats.mle import profile2d_contour_levels

    plt = _pyplot()
    pnll = np.asarray(pnll, float)
    dnll = pnll - np.nanmin(pnll)
    levels = sorted(profile2d_contour_levels(cl_list))
    fig, ax = plt.subplots(figsize=(6.5, 5.5))
    g1, g2 = np.meshgrid(np.asarray(values1, float),
                         np.asarray(values2, float), indexing="ij")
    pc = ax.pcolormesh(g1, g2, dnll, shading="auto", cmap="viridis",
                       vmax=max(levels) * 2.0)
    fig.colorbar(pc, ax=ax, label=r"$\Delta$NLL")
    cs = ax.contour(g1, g2, dnll, levels=levels, colors="white",
                    linewidths=1.5)
    ax.clabel(cs, fmt={lv: f"{cl:.0%}" for lv, cl in
                       zip(levels, sorted(cl_list))}, fontsize=8)
    if best is not None:
        ax.plot([best[0]], [best[1]], marker="*", ms=12, color="#EE6677",
                mec="white", mew=0.5)
    ax.set_xlabel(name1)
    ax.set_ylabel(name2)
    fig.tight_layout()
    fig.savefig(outpath, dpi=120)
    plt.close(fig)


def plot_pulls(study, outpath: str, bins: int = 25) -> None:
    """Pull histograms per free rate of a stats.bias.PullStudy, over the
    unit Gaussian an unbiased fit must follow."""
    plt = _pyplot()
    pulls = study.pulls
    n = len(study.names)
    fig, axes = plt.subplots(1, n, figsize=(4.2 * n, 3.6), squeeze=False)
    x = np.linspace(-4, 4, 200)
    summary = study.summary()
    for j, (ax, name) in enumerate(zip(axes[0], study.names)):
        p = pulls[:, j]
        p = p[np.isfinite(p)]
        ax.hist(p, bins=bins, range=(-4, 4), density=True,
                color=_COLORS[j % len(_COLORS)], alpha=0.65)
        ax.plot(x, np.exp(-0.5 * x * x) / np.sqrt(2 * np.pi),
                color="#000000", lw=1.2, ls="--")
        s = summary[name]
        ax.set_title(f"{name}: mean {s['pull_mean']:+.2f}, "
                     f"width {s['pull_std']:.2f}", fontsize=9)
        ax.set_xlabel(f"({name} fit − true) / σ")
    axes[0][0].set_ylabel("toy density")
    fig.tight_layout()
    fig.savefig(outpath, dpi=120)
    plt.close(fig)


def plot_posterior2d(lspace, name1: str, name2: str, outpath: str,
                     bins: int = 60, cl_list=(0.683, 0.95)) -> None:
    """Joint credible regions of two parameters from MCMC samples: a 2-D
    histogram of the posterior samples with highest-density contours
    enclosing ``cl_list``, and the lowest-NLL sample marked."""
    plt = _pyplot()
    x = np.asarray(lspace.column(name1), float)
    y = np.asarray(lspace.column(name2), float)
    h, xe, ye = np.histogram2d(x, y, bins=bins)
    flat = np.sort(h.ravel())[::-1]
    csum = np.cumsum(flat)
    total = csum[-1]
    levels = sorted({float(flat[np.searchsorted(csum, cl * total)])
                     for cl in cl_list if total > 0})
    xc = 0.5 * (xe[:-1] + xe[1:])
    yc = 0.5 * (ye[:-1] + ye[1:])
    fig, ax = plt.subplots(figsize=(6.5, 5.5))
    pc = ax.pcolormesh(xe, ye, h.T, shading="auto", cmap="viridis")
    fig.colorbar(pc, ax=ax, label="posterior samples")
    if levels and levels[0] > 0:
        ax.contour(xc, yc, h.T, levels=levels, colors="white",
                   linewidths=1.5)
    i, j = lspace.names.index(name1), lspace.names.index(name2)
    k = int(np.argmin(lspace.nll_values))
    ax.plot([lspace.samples[k, i]], [lspace.samples[k, j]], marker="*",
            ms=12, color="#EE6677", mec="white", mew=0.5)
    ax.set_xlabel(name1)
    ax.set_ylabel(name2)
    fig.tight_layout()
    fig.savefig(outpath, dpi=120)
    plt.close(fig)
