"""PdfStack: all of a fit's PDFs as one batched evaluation (PyTorch).

Port of ``sxmc_tpu/pdf/stack.py`` for histogram signals.  Every
signal's MC samples are concatenated; systematics carry per-signal
application masks.

Static/dynamic split (stack.py:216-252): a signal no systematic acts on
has a theta-invariant histogram, built once on the host here and never
again; only the *dynamic* signals' samples go to the device, field-major
``(nfields, n)`` and back to back, each signal a segment addressed by
its offset (the TPU padded every segment to a chunk multiple instead).

Entry points: :meth:`histograms` (kernel B1) and
:meth:`histograms_batch` (B1's batched form); :meth:`evaluate` and
:meth:`evaluate_batch` (B1, then the LUT gather B2), the split path of
fits whose systematics are fixed or absent; :meth:`fused_nll_pair`
(B3) and :meth:`fused_segment` (B4), with :meth:`fused_nll_pair_batch`
and :meth:`fused_segment_batch` for lock-step chains, and
:meth:`fused_segment_tril` / :meth:`fused_segment_tril_batch` for
full-covariance proposals, :meth:`fused_segment_tempered` for a
tempering ladder; :meth:`blocked_segment` and
:meth:`blocked_segment_batch` (B5); the experiment-grouped forms of the
sharded ensemble (:meth:`fused_segment_grouped`,
:meth:`fused_segment_tril_grouped`, :meth:`blocked_segment_grouped`),
whose read bins come from :meth:`compute_read_bins` of a padded
``(nexp, nevents, ncols)`` batch; and the binned likelihood's data counts
(:meth:`data_bin_counts`, :meth:`counts_from_read_bins`).  KDE signals
are not ported yet and raise.

Weighted MC (a signal whose ``histogram.weights`` is set; stack.py:
183-194, 238-290): a static weighted row is a float64 host sum of its
weights per bin, rounded once to float32, and its norm the float64 sum
of those float32 bins (stack.py:246-247).  When any dynamic signal is
weighted, the dynamic samples carry a weight row (1 for the dynamic
signals without weights) and every kernel takes its weighted form:
float64 weight sums, rounded once.  The blocked kernel B5 takes
unweighted stacks only (``has_weights``), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.ops import histogram as hist_ops
from sxmc_tpu_torch.ops import kernels
from sxmc_tpu_torch.ops.nll import NLLStatic, device_consts
from sxmc_tpu_torch.ops.transforms import SystematicDesc
from sxmc_tpu_torch.pdf.evalhist import EvalHist, read_bins_for
from sxmc_tpu_torch.signal import Observable, Signal, Systematic
from sxmc_tpu_torch.utils import as_f32, resolve_device


def _host_histogram(samples, lower, upper, nbins,
                    weights=None) -> np.ndarray:
    """Host (numpy) counts with the device bin-id math (the f32 scale
    of ``compute_bin_ids``, stack.py:62-101 with pallas_scale=False);
    with ``weights``, their float64 sums per bin, rounded to float32."""
    samples = np.asarray(samples, np.float32)
    strides = hist_ops.bin_strides(nbins)
    scales = hist_ops.bin_scales(lower, upper, nbins)
    n = samples.shape[0]
    valid = np.ones(n, bool)
    ids = np.zeros(n, np.int64)
    for i in range(len(nbins)):
        lo = np.float32(lower[i])
        up = np.float32(upper[i])
        col = samples[:, i]
        valid &= (col >= lo) & (col < up)
        axis = np.floor((col - lo) * scales[i]).astype(np.int32)
        np.clip(axis, 0, nbins[i] - 1, out=axis)
        ids += axis.astype(np.int64) * strides[i]
    total = hist_ops.total_bins(nbins)
    if weights is None:
        h = np.bincount(ids[valid], minlength=total)
    else:
        h = np.bincount(ids[valid],
                        weights=np.asarray(weights, np.float64)[valid],
                        minlength=total)
    return h.astype(np.float32)


class PdfStack:
    """Batched evaluator for all PDFs in a fit, on one device (the card
    unless ``device`` says otherwise; without CUDA that raises)."""

    def __init__(self, signals: Sequence[Signal],
                 observables: Sequence[Observable],
                 systematics: Sequence[Systematic], device="cuda"):
        self.device = resolve_device(device)
        self.nsignals = len(signals)
        self.nobservables = len(observables)
        for s in signals:
            if not isinstance(s.histogram, EvalHist):
                raise NotImplementedError(
                    f"signal {s.name}: only histogram PDFs are ported to "
                    "sxmc_tpu_torch (KDE: ROADMAP queue A, item 12)")
        weights = [s.histogram.weights for s in signals]
        self.has_weights = any(w is not None for w in weights)

        nobs = self.nobservables
        lower, upper, nbins = [0.0] * nobs, [1.0] * nobs, [1] * nobs
        for obs in observables:
            lower[obs.field_index] = obs.lower
            upper[obs.field_index] = obs.upper
            nbins[obs.field_index] = obs.bins
        self.lower_host = tuple(float(x) for x in lower)
        self.upper_host = tuple(float(x) for x in upper)
        self.nbins = tuple(int(b) for b in nbins)
        self.total_nbins = hist_ops.total_bins(self.nbins)
        self.bin_volume = hist_ops.bin_volume(lower, upper, self.nbins)
        self.n_mc = np.asarray([s.n_mc for s in signals], np.float32)
        self.datasets = [s.dataset for s in signals]
        # Unique dataset tags + (ndatasets, nsignals) membership mask:
        # the binned likelihood's analog of the -2 dataset sentinel.
        self.unique_datasets = tuple(sorted(set(self.datasets)))
        self.dataset_mask = np.asarray(
            [[1.0 if s == d else 0.0 for s in self.datasets]
             for d in self.unique_datasets], np.float32)

        arrays = [s.histogram.samples_host for s in signals]
        self.nfields = max(a.shape[1] for a in arrays)
        descs = [(_desc(s),
                  tuple(s.name in sig.systematic_names for sig in signals))
                 for s in systematics]

        touched = np.zeros(self.nsignals, bool)
        for _, mask in descs:
            touched |= np.asarray(mask, bool)
        self._dyn_idx = tuple(int(i) for i in np.flatnonzero(touched))
        self._static_idx = tuple(int(i) for i in np.flatnonzero(~touched))
        self._ndyn = len(self._dyn_idx)

        # Static rows: built once on the host.
        hist_init = np.zeros((self.nsignals, self.total_nbins), np.float32)
        norm_init = np.zeros(self.nsignals, np.float32)
        for i in self._static_idx:
            h = _host_histogram(arrays[i][:, :nobs], lower, upper,
                                self.nbins, weights[i])
            hist_init[i] = h
            norm_init[i] = h.sum(dtype=np.float64)
        self.hist_init = torch.as_tensor(hist_init, device=self.device)
        self.norm_init = tuple(float(x) for x in norm_init)
        self._norm_init_t = torch.as_tensor(norm_init, device=self.device)
        self._dyn_idx_t = torch.as_tensor(self._dyn_idx, dtype=torch.int64,
                                          device=self.device)
        self.sig_slot = tuple(
            self._dyn_idx.index(i) if touched[i] else -1
            for i in range(self.nsignals))

        # Dynamic rows: field-major samples + segment offsets, and a
        # weight row when a dynamic signal is weighted.
        self.hist_spec = None
        self.samples = None
        dyn_weighted = any(weights[i] is not None for i in self._dyn_idx)
        if self._ndyn:
            dyn = [arrays[i] for i in self._dyn_idx]
            seg_off = np.concatenate([[0], np.cumsum([a.shape[0]
                                                      for a in dyn])])
            dyn_systs = []
            for desc, mask in descs:
                m = tuple(mask[i] for i in self._dyn_idx)
                if any(m):
                    dyn_systs.append((desc, m))
            self.hist_spec = kernels.HistSpec.build(
                self.nfields, lower, upper, self.nbins, dyn_systs, seg_off,
                weighted=dyn_weighted)
            rows = np.concatenate(dyn, axis=0).T
            if dyn_weighted:
                w = np.concatenate([
                    np.ones(a.shape[0], np.float32) if weights[i] is None
                    else weights[i] for i, a in zip(self._dyn_idx, dyn)])
                rows = np.concatenate([rows, w[None]])
            self.samples = torch.as_tensor(np.ascontiguousarray(rows),
                                           device=self.device)
        self._read_bins = None

    # ------------------------------------------------------------------

    def nll_spec(self, st: NLLStatic) -> kernels.NLLSpec:
        """The fused kernels' NLL spec for the fit constants ``st``
        (copies them to the device: make it once per fit)."""
        return kernels.NLLSpec(st=st, consts=device_consts(st, self.device),
                               sig_slot=self.sig_slot,
                               norm_init=self.norm_init,
                               bin_volume=self.bin_volume)

    def set_data(self, data) -> None:
        """Precompute per-signal read bins for a dataset
        ``(nevents, nobservables + 1)`` (tag last): data points never
        move under systematics (pdfz.cpp:245-302)."""
        self._read_bins = self.compute_read_bins(data)

    @property
    def read_bins(self) -> torch.Tensor:
        if self._read_bins is None:
            raise RuntimeError("set_data() must be called first")
        return self._read_bins

    def compute_read_bins(self, data) -> torch.Tensor:
        """``(nsignals, nevents)`` int32 read bins with the -1/-2
        sentinels; an unknown dataset tag gets -2 in every row where the
        point is in the domain (the pad rows of
        ``parallel.ensemble.pad_datasets`` get one or the other).  A
        batch of experiments ``(nexp, nevents, ncols)`` gives ``(nexp,
        nsignals, nevents)``, the grouped forms' layout."""
        pts = as_f32(data, self.device)
        if pts.dim() == 3:
            nexp, nev = pts.shape[:2]
            rb = read_bins_for(pts.reshape(nexp * nev, -1),
                               self.nobservables, self.lower_host,
                               self.upper_host, self.nbins, self.datasets)
            return rb.reshape(self.nsignals, nexp, nev).transpose(
                0, 1).contiguous()
        return read_bins_for(pts, self.nobservables, self.lower_host,
                             self.upper_host, self.nbins, self.datasets)

    @property
    def supports_fused(self) -> bool:
        """True when the fused kernels (B3/B4, weighted or not) apply: at
        least one dynamic segment (KDE stacks do not reach here)."""
        return self._ndyn >= 1

    def histograms(self, theta_syst) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(nsignals, total_nbins)`` counts + ``(nsignals,)`` norms at
        theta (the dynamic rows through kernel B1; with no dynamic
        signal, the static table alone)."""
        hists = self.hist_init.clone()
        norms = self._norm_init_t.clone()
        if self._ndyn:
            theta = as_f32(theta_syst, self.device).reshape(-1)
            dyn, dyn_norms = kernels.segmented_histogram(
                self.hist_spec, self.samples, theta)
            hists[self._dyn_idx_t] = dyn
            norms[self._dyn_idx_t] = dyn_norms
        return hists, norms

    def histograms_batch(self, thetas) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(nchains, nsignals, total_nbins)`` counts + ``(nchains,
        nsignals)`` norms at ``(nchains, nsyst)`` thetas: the dynamic
        rows of every chain from one B1-batched launch per MAXCHAINS
        thetas."""
        thetas = as_f32(thetas, self.device)
        nch = thetas.shape[0]
        hists = self.hist_init.expand(nch, -1, -1).clone()
        norms = self._norm_init_t.expand(nch, -1).clone()
        if self._ndyn:
            # One launch takes up to MAXCHAINS thetas: a larger batch (a
            # systematics grid, fluctuated toys) goes out in launches of
            # at most that many, each binning its own thetas exactly.
            flat = thetas.reshape(nch, -1)
            for a in range(0, nch, kernels.MAXCHAINS):
                b = min(a + kernels.MAXCHAINS, nch)
                dyn, dyn_norms = kernels.segmented_histogram_batched(
                    self.hist_spec, self.samples, flat[a:b].contiguous())
                hists[a:b, self._dyn_idx_t] = dyn
                norms[a:b, self._dyn_idx_t] = dyn_norms
        return hists, norms

    def evaluate(self, theta_syst, read_bins=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """theta -> ``(lut (nsignals, nevents), norms (nsignals,))``:
        B1 for the dynamic rows on top of the static ones, then the LUT
        gather B2 over the read bins (JAX stack.py:960-1001)."""
        rb = self.read_bins if read_bins is None else read_bins
        hists, norms = self.histograms(theta_syst)
        return kernels.lut_eval(hists, norms, rb, self.bin_volume), norms

    def evaluate_batch(self, thetas, read_bins=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched ``(lut, norms)``: thetas ``(nchains, nsyst)`` ->
        ``((nchains, nsignals, nevents), (nchains, nsignals))``; B2 runs
        over the ``nchains * nsignals`` rows, every chain reading the
        same read bins."""
        rb = self.read_bins if read_bins is None else read_bins
        hists, norms = self.histograms_batch(thetas)
        nch = hists.shape[0]
        lut = kernels.lut_eval(
            hists.reshape(nch * self.nsignals, self.total_nbins),
            norms.reshape(-1), rb, self.bin_volume)
        return lut.reshape(nch, self.nsignals, rb.shape[1]), norms

    def data_bin_counts(self, data) -> torch.Tensor:
        """The binned likelihood's sufficient statistic: ``(ndatasets,
        total_nbins)`` float32 counts of the data events ``(nevents,
        nobservables + 1)`` per dataset, with :meth:`compute_read_bins`'
        bin-id math (out-of-domain events and tags of no signal fall in
        no row)."""
        pts = as_f32(data, self.device)
        ids, valid = hist_ops.compute_bin_ids(
            pts[:, :self.nobservables], self.lower_host, self.upper_host,
            self.nbins)
        tags = pts[:, self.nobservables]
        rows = [torch.bincount(ids[valid & (tags == float(ds))],
                               minlength=self.total_nbins)
                for ds in self.unique_datasets]
        return torch.stack(rows).to(torch.float32)

    def counts_from_read_bins(self, read_bins: torch.Tensor,
                              weights: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """Per-dataset data bin counts from per-signal read bins
        ``([ntoys,] nsignals, nevents)`` -> ``([ntoys,] ndatasets,
        total_nbins)``: row j of the read bins is >= 0 exactly for
        in-domain events carrying signal j's dataset tag, so one
        representative row per dataset gives :meth:`data_bin_counts`
        without the raw events (JAX stack.py:765-791).  ``weights``
        ``([ntoys,] nevents)`` (an Asimov dataset's expected counts) are
        summed per bin in float64 and rounded once; a batch of toys is
        counted by one offset ``bincount``."""
        lead = tuple(read_bins.shape[:-2])
        ntoys = int(np.prod(lead)) if lead else 1
        nev = read_bins.shape[-1]
        total = self.total_nbins
        rows = []
        for d in self.unique_datasets:
            rb = read_bins[..., self.datasets.index(d), :].reshape(ntoys,
                                                                   nev)
            sel = rb >= 0
            # Each toy's bins are offset by toy * (total + 1); the
            # events of no bin go to a spare slot that is cut off below.
            off = torch.arange(ntoys, device=rb.device,
                               dtype=torch.int64)[:, None] * (total + 1)
            flat = (torch.where(sel, rb.to(torch.int64), total)
                    + off).reshape(-1)
            if weights is None:
                c = torch.bincount(flat, minlength=ntoys * (total + 1))
            else:
                w = torch.as_tensor(weights, device=rb.device).to(
                    torch.float64).reshape(-1, nev).expand(ntoys, nev)
                c = torch.zeros(ntoys * (total + 1), dtype=torch.float64,
                                device=rb.device)
                c.index_add_(0, flat, w.reshape(-1))
            rows.append(c.reshape(ntoys, total + 1)[:, :total])
        out = torch.stack(rows, dim=1).to(torch.float32)
        return out.reshape(lead + out.shape[1:]) if lead else out[0]

    def _require_fused(self) -> None:
        if not self.supports_fused:
            raise NotImplementedError(
                "the fused kernels need a dynamic signal (a floating "
                "systematic acting on it); take the split path "
                "(PdfStack.evaluate) instead")

    def fused_nll_pair(self, params: torch.Tensor, read_bins: torch.Tensor,
                       ns: kernels.NLLSpec):
        """Compensated NLL ``(hi, lo)`` at ``params`` ``(npar,)``
        (kernel B3); ``ns`` from :meth:`nll_spec`."""
        self._require_fused()
        return kernels.fused_nll(self.hist_spec, ns, self.samples,
                                 self.hist_init, read_bins, params)

    def fused_nll_pair_batch(self, params: torch.Tensor,
                             read_bins: torch.Tensor, ns: kernels.NLLSpec):
        """``(nchains, npar)`` params -> ``(nchains,)`` pairs (B3's
        batched form)."""
        self._require_fused()
        return kernels.fused_nll_batched(self.hist_spec, ns, self.samples,
                                         self.hist_init, read_bins, params)

    def fused_segment(self, params0, nll0, width, read_bins, noise, log_u,
                      ns: kernels.NLLSpec, debug_mode: bool = False):
        """A whole fixed-width Metropolis segment of one chain (kernel
        B4); returns ``(samples (n, npar), nlls (n, 2), accepts (n,))``."""
        self._require_fused()
        return kernels.fused_segment(
            self.hist_spec, ns, self.samples, self.hist_init, read_bins,
            params0, nll0, width, noise, log_u, debug_mode)

    def fused_segment_batch(self, params0, nll0, width, read_bins, noise,
                            log_u, ns: kernels.NLLSpec,
                            debug_mode: bool = False):
        """:meth:`fused_segment` for ``(nchains, npar)`` params: the
        lock-step histories ``(n, nchains, ...)`` (B4's batched form)."""
        self._require_fused()
        return kernels.fused_segment_batched(
            self.hist_spec, ns, self.samples, self.hist_init, read_bins,
            params0, nll0, width, noise, log_u, debug_mode)

    def fused_segment_tril(self, params0, nll0, tril, read_bins, noise,
                           log_u, ns: kernels.NLLSpec,
                           debug_mode: bool = False):
        """:meth:`fused_segment` with full-covariance proposals ``cur +
        L @ z``, ``tril`` ``(npar, npar)`` (B4's tril form)."""
        self._require_fused()
        return kernels.fused_segment_tril(
            self.hist_spec, ns, self.samples, self.hist_init, read_bins,
            params0, nll0, tril, noise, log_u, debug_mode)

    def fused_segment_tril_batch(self, params0, nll0, tril, read_bins,
                                 noise, log_u, ns: kernels.NLLSpec,
                                 debug_mode: bool = False):
        """:meth:`fused_segment_tril` for lock-step chains, ``tril``
        ``(nchains, npar, npar)`` (B4's batched tril form)."""
        self._require_fused()
        return kernels.fused_segment_tril_batched(
            self.hist_spec, ns, self.samples, self.hist_init, read_bins,
            params0, nll0, tril, noise, log_u, debug_mode)

    def fused_segment_tempered(self, params0, nll0, width, beta, read_bins,
                               noise, log_u, ns: kernels.NLLSpec,
                               debug_mode: bool = False):
        """One swap interval of a parallel-tempering ladder: the
        ``(ntemps, npar)`` replicas of :meth:`fused_segment_batch`, each
        with its inverse temperature ``beta`` ``(ntemps,)`` in the accept
        (B4's tempered form)."""
        self._require_fused()
        return kernels.fused_segment_tempered(
            self.hist_spec, ns, self.samples, self.hist_init, read_bins,
            params0, nll0, width, beta, noise, log_u, debug_mode)

    def blocked_segment(self, params0, nll0, width, read_bins, noise, log_u,
                        ns: kernels.NLLSpec, debug_mode: bool = False):
        """A whole blocked Metropolis-within-Gibbs segment of one chain
        (kernel B5): ``noise`` ``(n, M + 1, npar)``, ``log_u`` ``(n, M +
        1)``; returns per-cycle ``(samples (n, npar), nlls (n, 2),
        accepted fractions (n,))``.  Unweighted stacks only."""
        self._require_fused()
        return kernels.blocked_segment(
            self.hist_spec, ns, self.samples, self.hist_init, read_bins,
            params0, nll0, width, noise, log_u, debug_mode)

    def blocked_segment_batch(self, params0, nll0, width, read_bins, noise,
                              log_u, ns: kernels.NLLSpec,
                              debug_mode: bool = False):
        """:meth:`blocked_segment` for ``(nchains, npar)`` params:
        ``noise`` ``(n, M + 1, nchains, npar)``, histories ``(n, nchains,
        ...)`` (B5's batched form)."""
        self._require_fused()
        return kernels.blocked_segment_batched(
            self.hist_spec, ns, self.samples, self.hist_init, read_bins,
            params0, nll0, width, noise, log_u, debug_mode)

    def _grouped(self, kernel, params0, nll0, width, read_bins, noise,
                 log_u, ns, debug_mode):
        """The grouped layout (JAX stack.py:471-545): ``params0 (nexp,
        cpe, npar)``, ``nll0 (nexp, cpe, 2)``, ``width`` with the same
        two leading axes, ``noise`` / ``log_u`` with them after the step
        (and, blocked, the M + 1) axes -> histories ``(n, nexp, cpe,
        ...)``.  The kernels take the chains flat, chain-major by
        experiment."""
        self._require_fused()
        nexp, cpe, npar = params0.shape
        nch = nexp * cpe
        lead = noise.shape[:noise.dim() - 3]  # (n,) or (n, M + 1)
        samples, nlls, accs = kernel(
            self.hist_spec, ns, self.samples, self.hist_init, read_bins,
            params0.reshape(nch, npar), nll0.reshape(nch, 2),
            width.reshape((nch,) + tuple(width.shape[2:])),
            noise.reshape(lead + (nch, npar)),
            log_u.reshape(lead + (nch,)), debug_mode)
        n = samples.shape[0]
        return (samples.reshape(n, nexp, cpe, npar),
                nlls.reshape(n, nexp, cpe, 2), accs.reshape(n, nexp, cpe))

    def fused_segment_grouped(self, params0, nll0, width, read_bins, noise,
                              log_u, ns: kernels.NLLSpec,
                              debug_mode: bool = False):
        """A whole fixed-width segment of every experiment's chains in
        one launch (B4's experiment-grouped form; more launches only
        past the chain caps): ``read_bins`` ``(nexp, nsignals,
        nevents)``, the rest in the grouped layout of :meth:`_grouped`.
        Each chain walks as :meth:`fused_segment_batch` would on its
        experiment's read bins."""
        return self._grouped(kernels.fused_segment_grouped, params0, nll0,
                             width, read_bins, noise, log_u, ns, debug_mode)

    def fused_segment_tril_grouped(self, params0, nll0, tril, read_bins,
                                   noise, log_u, ns: kernels.NLLSpec,
                                   debug_mode: bool = False):
        """:meth:`fused_segment_grouped` with full-covariance proposals,
        ``tril`` ``(nexp, cpe, npar, npar)``."""
        return self._grouped(kernels.fused_segment_tril_grouped, params0,
                             nll0, tril, read_bins, noise, log_u, ns,
                             debug_mode)

    def blocked_segment_grouped(self, params0, nll0, width, read_bins, noise,
                                log_u, ns: kernels.NLLSpec,
                                debug_mode: bool = False):
        """B5's experiment-grouped form: ``noise`` ``(n, M + 1, nexp, cpe,
        npar)``, ``log_u`` ``(n, M + 1, nexp, cpe)``; unweighted stacks
        only."""
        return self._grouped(kernels.blocked_segment_grouped, params0, nll0,
                             width, read_bins, noise, log_u, ns, debug_mode)


def _desc(s: Systematic) -> SystematicDesc:
    """The SystematicDesc of a fit-level systematic (signal.cpp:144-165)."""
    return SystematicDesc(type=s.type, obs=s.observable_field_index,
                          par_indices=tuple(s.pidx),
                          extra_field=max(s.truth_field_index, 0))
