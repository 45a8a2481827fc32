"""Spectral fit plots.

Port of ``sxmc_tpu/plots.py::plot_fit`` (reference src/plots.{h,cpp})
with matplotlib: per dataset and per observable, a stacked spectrum of
each signal's PDF projection scaled to ``rate * nexpected *
efficiency`` at the best-fit parameters, overlaid with the total and
the (fake or real) data.  The signals' PDFs are their host-side
``EvalHist`` tables, so plotting runs on the CPU whatever device the
fit ran on.  The statistics tier's figures (CLs scans, profiles,
pulls, posteriors) are not ported yet (ROADMAP queue A, item 10).
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
    import matplotlib  # at first use: importing the package stays cheap

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
