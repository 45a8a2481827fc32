"""Plain reference of the fit that the benchmark's cells time.

Written from the semantics of upstream sxmc (mastbaum/sxmc: ``config.cpp``,
``pdfz.cpp``, ``nll_kernels.cpp``, ``mcmc.cpp``,
``contour.cpp``), in plain PyTorch and NumPy.  It imports nothing of the
program under test and takes nothing that the program made: it reads the
sxmc configuration, the raw Monte-Carlo tables and the data events that the
benchmark generated, and the proposal streams that the benchmark handed to
the program, and works everything else out again.

What it computes, for a parameter vector ``theta`` (source rates, then each
systematic's coefficients, in the configuration's first-seen order):

* each signal's MC rows after its cuts, with its systematics applied in
  order (``shift``: x + p, ``scale``: x (1 + p), ``ctscale``: 1 + (x - 1)
  (1 + p), ``resolution_scale``: x + p (x - x_true), with p the power
  series sum_i theta_i x^i), in float32 operation by operation so that a
  row on a bin edge lands where the upstream code puts it;
* the histogram of the rows inside ``lower <= x < upper``, the bin
  ``floor((x - lower) * (nbins / (upper - lower)))``, and the in-domain
  count ``norm``;
* the extended negative log-likelihood
  ``-sum_i log(sum_j w_j f_j(x_i)) + sum_j w_j + sum_k z_k^2 / 2`` with
  ``w_j = rate_j nexpected_j norm_j / n_mc_j`` and ``f_j`` the histogram
  density, in float64, and 1e18 where a rate is negative.

``dtype`` runs all of it in a lower precision: the control that the
comparison has to reject (bfloat16 for this float32 configuration).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

BARRIER = float(np.float32(1e18))
HAARIO = 2.4 * 2.4
TYPES = ("shift", "scale", "ctscale", "resolution_scale")


class Layout:
    """The parameters, observables and signals of an sxmc configuration
    (config.cpp:75-258): sources first, then each systematic's
    coefficients, systematics and sources in first-seen order over every
    signal of the ``signals`` section."""

    def __init__(self, sxmc: dict):
        fit = sxmc["fit"]
        pdfs = sxmc.get("pdfs", {})
        obs = pdfs.get("observables", {})
        systs = pdfs.get("systematics", {})
        if sxmc.get("sources") or sxmc.get("data"):
            raise NotImplementedError("sources/data sections are not used "
                                      "by the benchmark's configurations")
        self.observables = [(obs[n]["field"], float(obs[n]["min"]),
                             float(obs[n]["max"]), int(obs[n]["bins"]))
                            for n in fit["observables"]]
        self.cuts = [(obs[n]["field"], float(obs[n]["min"]),
                      float(obs[n]["max"])) for n in fit.get("cuts", [])]
        self.systematics: List[dict] = []
        names, means, sigmas, fixed = [], [], [], []
        sources = []
        for sname, sconf in sxmc["signals"].items():
            for y in sconf.get("systematics", []):
                if any(s["name"] == y for s in self.systematics):
                    continue
                c = systs[y]
                if c["type"] not in TYPES:
                    raise ValueError(f"unknown systematic type {c['type']}")
                self.systematics.append(dict(
                    name=y, type=c["type"], field=c["observable_field"],
                    truth=c.get("true_field", c.get("truth_field")),
                    mean=[float(v) for v in c["mean"]],
                    sigma=[float(v) for v in c["sigma"]],
                    fixed=bool(c.get("fixed", False))))
            sources.append(dict(name=sname,
                                mean=float(sconf.get("mean", 1.0)),
                                sigma=float(sconf.get("sigma", 0.0)),
                                fixed=bool(sconf.get("fixed", False))))
        for s in sources:
            names.append(s["name"])
            means.append(s["mean"])
            sigmas.append(s["sigma"])
            fixed.append(s["fixed"])
        self.nsources = len(sources)
        k = self.nsources
        for y in self.systematics:
            y["pidx"] = list(range(k, k + len(y["mean"])))
            k += len(y["mean"])
            for j in range(len(y["mean"])):
                names.append(f"{y['name']}_{j}")
                means.append(y["mean"][j])
                sigmas.append(y["sigma"][j])
                fixed.append(y["fixed"])
        self.names = names
        self.means = np.asarray(means, np.float32)
        self.sigmas = np.asarray(sigmas, np.float32)
        self.fixed = np.asarray(fixed, bool)
        self.signals = []
        for sname in fit["signals"]:
            c = sxmc["signals"][sname]
            if ("rate" in c) == ("scale" in c):
                raise ValueError(f"signal {sname}: one of rate or scale")
            self.signals.append(dict(
                name=sname, dataset=int(c["dataset"]),
                source=[s["name"] for s in sources].index(sname),
                rate=c.get("rate"), scale=c.get("scale"),
                systematics=[y for y in self.systematics
                             if y["name"] in c.get("systematics", [])]))
        self.nsteps = int(fit["nsteps"])
        self.burnin_fraction = float(fit.get("burnin_fraction", 0.1))
        self.signal_name = fit.get("signal_name", "")
        self.confidence = float(fit.get("confidence", 0.683))

    @property
    def nfloat(self) -> int:
        return int((~self.fixed).sum())

    def initial_widths(self) -> np.ndarray:
        """Initial jump widths (mcmc.cpp:197-228): 0.1 width 2.4^2 / nfloat,
        the width sigma, or sqrt(m)/m (m = max(mean, 10)) for a free rate,
        sqrt(max(mean, 1)) otherwise; -1 where fixed."""
        sf = HAARIO / max(self.nfloat, 1)
        w = np.empty(len(self.names), np.float64)
        for i, (m, s) in enumerate(zip(self.means, self.sigmas)):
            if self.fixed[i]:
                w[i] = -1.0
            elif s > 0:
                w[i] = 0.1 * float(s) * sf
            elif i < self.nsources:
                mm = max(float(m), 10.0)
                w[i] = 0.1 * math.sqrt(mm) / mm * sf
            else:
                w[i] = 0.1 * math.sqrt(max(float(m), 1.0)) * sf
        return w

    def phases(self, nsteps: Optional[int] = None) -> List[int]:
        """Steps of the burn-in phases and the main phase (mcmc.cpp:
        273-311)."""
        n = self.nsteps if nsteps is None else nsteps
        b = int(n * self.burnin_fraction)
        return ([b, b] if b > 0 else []) + [n - 2 * b]


def chi2_quantile_1dof(cl: float) -> float:
    """x with P(chi^2_1 < x) = cl: the square of the normal quantile."""
    from statistics import NormalDist
    return NormalDist().inv_cdf(0.5 + cl / 2.0) ** 2


def contour_upper(column: np.ndarray, nll: np.ndarray, cl: float) -> float:
    """Upper end of the likelihood-contour interval (contour.cpp): the
    largest value among samples within 0.5 chi2_1(cl) of the minimum."""
    nll = np.asarray(nll)
    keep = (nll - nll.min()) < 0.5 * chi2_quantile_1dof(cl)
    return float(np.asarray(column)[keep].max())


class Model:
    """The configuration's likelihood over the given tables, on ``device``.

    ``tables`` maps each signal to ``(rows (n, nfields) float32 tensor,
    field names)``; ``dtype`` is the precision of the whole computation
    (float32 transforms and binning with float64 sums, unless lower)."""

    def __init__(self, layout: Layout, tables: Dict[str, Tuple], device,
                 dtype=torch.float32):
        self.layout = layout
        self.device = torch.device(device)
        self.dtype = dtype
        self.acc = torch.float64 if dtype == torch.float32 else dtype
        lo = layout.observables
        self.nbins = [o[3] for o in lo]
        self.total = int(np.prod(self.nbins))
        self.bin_volume = float(np.prod([(o[2] - o[1]) / o[3] for o in lo]))
        self.sigs = []
        for s in layout.signals:
            rows, fields = tables[s["name"]]
            rows = rows.to(self.device)
            n_mc = rows.shape[0]
            keep = torch.ones(n_mc, dtype=torch.bool, device=self.device)
            for f, a, b in layout.cuts:
                col = rows[:, fields.index(f)]
                keep &= (col >= a) & (col <= b)
            need = {o[0] for o in lo}
            for y in s["systematics"]:
                need.add(y["field"])
                if y["truth"]:
                    need.add(y["truth"])
            cols = {f: rows[keep, fields.index(f)].to(dtype).contiguous()
                    for f in sorted(need)}
            # A scale S means n_mc / S expected events, stored as -1 / S
            # and multiplied out (signal.cpp:32-35): the same float.
            nexpected = (float(s["rate"]) if s["rate"] is not None
                         else (1.0 / float(s["scale"])) * n_mc)
            self.sigs.append(dict(cols=cols, n_mc=n_mc, nexpected=nexpected,
                                  dataset=s["dataset"], source=s["source"],
                                  systs=s["systematics"],
                                  nrows=int(keep.sum())))
        # What the configuration states, on the device.
        self.means = torch.tensor(layout.means, dtype=torch.float64,
                                  device=self.device)
        self.sigmas = torch.tensor(layout.sigmas, dtype=torch.float64,
                                   device=self.device)

    # ----------------------------------------------------------- binning

    def _bins(self, cols: Sequence[torch.Tensor]):
        """Flat bin ids and the in-domain mask of points given one column
        per observable (pdfz.cpp:388-398)."""
        ids = valid = None
        stride = 1
        for i in reversed(range(len(self.nbins))):
            field, lo, hi, nb = self.layout.observables[i]
            x = cols[i].to(self.dtype)
            lo_t = torch.tensor(lo, dtype=torch.float32).to(self.dtype)
            hi_t = torch.tensor(hi, dtype=torch.float32).to(self.dtype)
            scale = (torch.tensor(float(nb), dtype=torch.float32)
                     / (torch.tensor(hi, dtype=torch.float32)
                        - torch.tensor(lo, dtype=torch.float32))
                     ).to(self.dtype)
            ok = (x >= lo_t.to(x.device)) & (x < hi_t.to(x.device))
            axis = torch.floor((x - lo_t.to(x.device)) * scale.to(x.device))
            axis = axis.to(torch.int64).clamp(0, nb - 1) * stride
            stride *= nb
            ids = axis if ids is None else ids + axis
            valid = ok if valid is None else valid & ok
        return ids, valid

    def _transformed(self, sig: dict, theta: torch.Tensor) -> List:
        cols = dict(sig["cols"])
        th = theta.to(self.dtype)
        for y in sig["systs"]:
            x = cols[y["field"]]
            p = 0.0 + th[y["pidx"][0]]
            xi = x
            for i, k in enumerate(y["pidx"][1:]):
                if i > 0:
                    xi = xi * x
                p = p + th[k] * xi
            if y["type"] == "shift":
                x = x + p
            elif y["type"] == "scale":
                x = x * (1.0 + p)
            elif y["type"] == "ctscale":
                x = 1.0 + (x - 1.0) * (1.0 + p)
            else:
                x = x + p * (x - cols[y["truth"]])
            cols[y["field"]] = x
        return [cols[o[0]] for o in self.layout.observables]

    def histogram(self, j: int, theta) -> Tuple[torch.Tensor, float]:
        """Signal j's bin counts at ``theta`` and its in-domain count."""
        theta = torch.as_tensor(np.asarray(theta, np.float32),
                                device=self.device)
        ids, valid = self._bins(self._transformed(self.sigs[j], theta))
        counts = torch.bincount(ids[valid], minlength=self.total)
        return counts.to(self.acc), float(valid.sum())

    # ------------------------------------------------------------- data

    def events(self, data) -> dict:
        """Per-signal read bins of the events ``(nevents, nobs + 1)`` (the
        last column the dataset tag): the bin, -1 out of domain, -2 where
        the tag is another dataset's."""
        data = torch.as_tensor(data, device=self.device)
        pts = data[:, :-1].to(torch.float32)
        ids, valid = self._bins([pts[:, i] for i in range(pts.shape[1])])
        tags = data[:, -1]
        rows = []
        for s in self.sigs:
            r = torch.where(tags == float(s["dataset"]), ids,
                            torch.full_like(ids, -2))
            rows.append(torch.where(valid, r, torch.full_like(ids, -1)))
        return dict(read_bins=torch.stack(rows), n=int(data.shape[0]))

    # -------------------------------------------------------------- NLL

    def nll(self, theta, ev: dict) -> float:
        """The extended NLL of the events ``ev`` (:meth:`events`) at
        ``theta``."""
        theta = np.asarray(theta, np.float32)
        ns = self.layout.nsources
        if (theta[:ns] < 0).any():
            return BARRIER
        th = torch.as_tensor(theta, device=self.device).to(self.acc)
        s = torch.zeros(ev["n"], dtype=self.acc, device=self.device)
        wsum = torch.zeros((), dtype=self.acc, device=self.device)
        vol = torch.tensor(self.bin_volume, dtype=self.acc,
                           device=self.device)
        for j, sig in enumerate(self.sigs):
            counts, norm = self.histogram(j, theta)
            norm_t = torch.tensor(norm, dtype=self.acc, device=self.device)
            w = ((th[sig["source"]] * sig["nexpected"]) * norm_t
                 / sig["n_mc"])
            wsum = wsum + w
            rb = ev["read_bins"][j]
            dens = counts[rb.clamp(min=0)] / (norm_t * vol)
            # Out of domain, another dataset's event, or a signal with no
            # row left in the domain (0 / 0): the density counts 0
            # (nll_kernels.cpp skips NaN PDF values).
            dens = torch.where((rb >= 0) & torch.isfinite(dens), dens,
                               torch.zeros_like(dens))
            s = s + w * dens
        pos = s > 0
        logs = torch.where(pos, torch.log(torch.where(pos, s,
                                                      torch.ones_like(s))),
                           torch.zeros_like(s))
        z = (th - self.means.to(self.acc)) / torch.where(
            self.sigmas > 0, self.sigmas, torch.ones_like(self.sigmas)
        ).to(self.acc)
        cons = 0.5 * torch.where(self.sigmas > 0, z * z,
                                 torch.zeros_like(z)).sum()
        total = -logs.sum() + wsum + cons
        return float(total)


# -------------------------------------------------------- chain checks


def retune(widths: np.ndarray, phase_states: np.ndarray, fixed: np.ndarray,
           nfloat: int, dtype=torch.float32) -> np.ndarray:
    """Jump widths after a burn-in phase (mcmc.cpp:279-305): 2.4^2 / nfloat
    times the population RMS of the phase's states, kept where the RMS is
    0; -1 where fixed."""
    x = torch.as_tensor(phase_states)
    if dtype == torch.float32:
        rms = x.double().std(dim=0, correction=0).numpy()
    else:
        rms = x.to(dtype).float().std(dim=0, correction=0).to(dtype)
        rms = rms.double().numpy()
    new = np.where(rms > 0, HAARIO / max(nfloat, 1) * rms, widths)
    return np.where(fixed, -1.0, new)


def move_errors(prev: np.ndarray, cur: np.ndarray, noise: np.ndarray,
                widths: np.ndarray, fixed: np.ndarray) -> np.ndarray:
    """Per step, the largest distance of a floating parameter's move from
    ``widths * noise``, in units of its width (0 for a perfect move)."""
    free = ~fixed
    step = cur.astype(np.float64) - prev.astype(np.float64)
    want = widths[None, :] * noise.astype(np.float64)
    err = np.abs(step - want)[:, free] / np.abs(widths[free])[None, :]
    return err.max(axis=1) if err.size else np.zeros(len(step))


def inferred_widths(prev, cur, noise, fixed) -> Optional[np.ndarray]:
    """The one width per floating parameter that the chain's moved steps
    imply (the median of move / noise over the moves whose noise is not
    near 0); None when no step moved."""
    prev = prev.astype(np.float64)
    cur = cur.astype(np.float64)
    moved = (cur != prev).any(axis=1)
    if not moved.any():
        return None
    z = noise[moved].astype(np.float64)
    # Moves whose noise is near 0 say little of the width: left out.
    ratio = np.where(np.abs(z) > 0.05, (cur[moved] - prev[moved]) /
                     np.where(z == 0, 1.0, z), np.nan)
    w = np.nanmedian(np.where(np.isfinite(ratio), ratio, np.nan), axis=0)
    return np.where(fixed, -1.0, w)
