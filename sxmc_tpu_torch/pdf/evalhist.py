"""Binned PDF evaluator (PyTorch port of ``sxmc_tpu/pdf/evalhist.py``).

Semantics (reference src/pdfz.{h,cpp}):
  * systematics transform the samples at every evaluation
    (pdfz.cpp:372-385);
  * events outside ``[lower, upper)`` in any observable are dropped from
    both histogram and normalization (pdfz.cpp:388-404);
  * eval points never move, so their bin ids are precomputed once per
    dataset: id >= 0 in-domain, -1 out-of-domain -> NaN, -2 dataset
    mismatch -> 0.0, out-of-domain winning over a mismatch
    (pdfz.cpp:245-302, 411-436; evalhist.py:140-155);
  * PDF value = bins[id] / (norm * bin_volume).

:meth:`EvalHist.histogram` is the segmented-histogram kernel B1
(``ops.kernels.segmented_histogram``) with one segment, and
:meth:`EvalHist.eval` B1 then the LUT gather B2
(``ops.kernels.lut_eval``): on a CUDA device the hand-written kernels,
on the CPU their plain versions (the JAX package's ``pallas_histogram``
+ ``pallas_eval_lut``).  Per-sample ``weights`` (an extension over the
reference, evalhist.py:20-22) take B1's weighted form: bins and norm
are float64 sums of the in-domain weights, rounded once to float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.ops import histogram as hist_ops
from sxmc_tpu_torch.ops import transforms
from sxmc_tpu_torch.utils import resolve_device


class PdfError(ValueError):
    """Generic PDF-related error (reference: pdfz.h:93-102)."""


class EvalHist:
    """N-dimensional histogram PDF with on-the-fly systematics.

    The samples stay on the host until the first evaluation, which
    copies them to ``device`` once: the card unless the caller says
    otherwise (without CUDA that raises).
    """

    def __init__(
        self,
        samples,
        nfields: int,
        nobservables: int,
        lower: Sequence[float],
        upper: Sequence[float],
        nbins: Sequence[int],
        dataset: int = 0,
        weights=None,
        device="cuda",
    ):
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim == 1:
            if nfields <= 0 or samples.size % nfields != 0:
                raise PdfError(
                    "Length of samples array is not divisible by number of "
                    "fields.")
            samples = samples.reshape(-1, nfields)
        if samples.shape[1] != nfields:
            raise PdfError("Sample array width does not match nfields.")
        if nobservables == 0:
            raise PdfError("Number of observables in PDF is zero.")
        if nobservables > nfields:
            raise PdfError(
                "Number of observables cannot be greater than number of "
                "fields.")
        if len(upper) != nobservables:
            raise PdfError(
                "Number of upper bounds must be same as number of "
                "observables.")
        if len(lower) != nobservables:
            raise PdfError(
                "Number of lower bounds must be same as number of "
                "observables.")
        if len(nbins) != nobservables:
            raise PdfError(
                "Size of nbins array must be same as number of observables.")
        if hist_ops.total_bins(nbins) == 0:
            raise PdfError("Cannot make histogram with zero bins.")

        self.samples_host = samples
        self._samples_t = None  # field-major device copy, made lazily
        self.weights = weights
        self.nfields = nfields
        self.nobservables = nobservables
        self.lower_host = tuple(float(x) for x in lower)
        self.upper_host = tuple(float(x) for x in upper)
        self.nbins = tuple(int(b) for b in nbins)
        self.dataset = int(dataset)
        self.total_nbins = hist_ops.total_bins(self.nbins)
        self.bin_volume = hist_ops.bin_volume(lower, upper, self.nbins)
        self.systematics: Tuple[transforms.SystematicDesc, ...] = ()
        self.device = resolve_device(device)

    @property
    def n_mc(self) -> int:
        return self.samples_host.shape[0]

    @property
    def weights(self) -> Optional[np.ndarray]:
        """Per-sample float32 weights on the host, or None (unweighted).
        May be set after construction, as on the JAX package's EvalHist
        (tests/test_static_segments.py:34-41)."""
        return self._weights

    @weights.setter
    def weights(self, weights) -> None:
        if weights is not None:
            weights = np.asarray(weights, np.float32).reshape(-1)
            if weights.shape[0] != self.samples_host.shape[0]:
                raise PdfError(
                    f"{weights.shape[0]} weights for "
                    f"{self.samples_host.shape[0]} samples")
        self._weights = weights
        self._samples_t = None
        self._hist_spec = None

    def add_systematic(self, desc: transforms.SystematicDesc) -> None:
        """Attach a systematic (reference: Eval::AddSystematic)."""
        self.systematics = self.systematics + (desc,)
        self._hist_spec = None

    def compute_read_bins(self, points) -> torch.Tensor:
        """Eval-point bin ids with the -1/-2 sentinels.

        ``points`` is ``(npoints, nobservables + 1)``; the final column
        is the dataset tag.
        """
        points = np.asarray(points, dtype=np.float32)
        if points.ndim == 1:
            width = self.nobservables + 1
            if points.size % width != 0:
                raise PdfError(
                    "Number of entries in evaluation points array not "
                    "divisible by number of observables.")
            points = points.reshape(-1, width)
        pts = torch.as_tensor(points, device=self.device)
        return read_bins_for(pts, self.nobservables, self.lower_host,
                             self.upper_host, self.nbins, [self.dataset])[0]

    def hist_spec(self):
        """The kernels' view of this PDF: one segment, every systematic
        acting on it (made once, until a systematic or the weights
        change)."""
        from sxmc_tpu_torch.ops import kernels

        if self._hist_spec is None:
            self._hist_spec = kernels.HistSpec.build(
                nfields=self.nfields, lower=self.lower_host,
                upper=self.upper_host, nbins=self.nbins,
                systematics=[(d, (True,)) for d in self.systematics],
                seg_off=(0, self.n_mc), weighted=self.weights is not None)
        return self._hist_spec

    def device_samples(self) -> torch.Tensor:
        """The field-major ``(nfields, n)`` samples on ``device``, with
        the weights as one more row when weighted."""
        if self._samples_t is None:
            rows = self.samples_host.T
            if self.weights is not None:
                rows = np.concatenate([rows, self.weights[None]])
            self._samples_t = torch.as_tensor(np.ascontiguousarray(rows),
                                              device=self.device)
        return self._samples_t

    def histogram(self, params=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Build ``(bins, norm)`` at the given systematic parameters."""
        from sxmc_tpu_torch.ops import kernels

        hs = self.hist_spec()
        theta = (np.zeros(hs.npar, np.float32) if params is None
                 else np.atleast_1d(np.asarray(params, np.float32)))
        bins, norms = kernels.segmented_histogram(
            hs, self.device_samples(),
            torch.as_tensor(theta, device=self.device))
        return bins[0], norms[0]

    def eval(self, read_bins: torch.Tensor, params=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Histogram + evaluate at precomputed read_bins.

        Returns ``(pdf_values, norm)``: ``(npoints,)`` float32 densities
        (NaN/0 sentinels applied) and the scalar in-domain norm.
        """
        from sxmc_tpu_torch.ops import kernels

        bins, norm = self.histogram(params)
        lut = kernels.lut_eval(bins[None], norm[None],
                               read_bins.to(torch.int32)[None],
                               self.bin_volume)
        return lut[0], norm

    def eval_points(self, points, params=None):
        """Convenience: compute read_bins then evaluate."""
        return self.eval(self.compute_read_bins(points), params)

    def density_histogram(self, params=None) -> np.ndarray:
        """Normalized density per bin, shaped ``self.nbins``: bins /
        (max(norm, 1) * bin_volume) in float32 (reference:
        EvalHist::CreateHistogram, pdfz.cpp:498-594)."""
        bins, norm = self.histogram(params)
        bv = float(np.float32(self.bin_volume))
        dens = bins / (torch.clamp_min(norm, 1.0) * bv)
        return dens.cpu().numpy().reshape(self.nbins)

    def density_projection(self, observable_index: int,
                           params=None) -> np.ndarray:
        """Normalized 1-D density of one observable, the others summed
        out (the reference declares CreateHistogramProjection but leaves
        it unimplemented, pdfz.cpp:597-619; evalhist.py:231-253)."""
        if not 0 <= observable_index < self.nobservables:
            raise PdfError(
                "CreateHistogramProjection: Invalid observable index!")
        dens = self.density_histogram(params)
        axes = tuple(a for a in range(self.nobservables)
                     if a != observable_index)
        marg = dens.sum(axis=axes) if axes else dens
        lo = float(np.float32(self.lower_host[observable_index]))
        up = float(np.float32(self.upper_host[observable_index]))
        width = (up - lo) / self.nbins[observable_index]
        total = marg.sum() * width
        return marg / total if total > 0 else marg

    def random_sample(self, gen: torch.Generator, nexpected: float,
                      syst_vals=None, uppers=None, lowers=None,
                      poisson: bool = False,
                      dataset: Optional[int] = None) -> np.ndarray:
        """Draw ``(n, nobs + 1)`` events from the binned PDF at
        ``syst_vals`` (reference: pdfz.cpp:817-922): categorical over
        the bins, uniform within a bin, bins outside the optional
        per-observable bounds excluded; all draws from the CPU generator
        ``gen`` (:func:`sxmc_tpu_torch.generator.sample_from_counts`)."""
        from sxmc_tpu_torch.generator import sample_from_counts

        if dataset is None:
            dataset = self.dataset
        bins, _ = self.histogram(syst_vals)
        return sample_from_counts(
            gen, bins.cpu().numpy(), self.nbins, self.lower_host,
            self.upper_host, nexpected, uppers=uppers, lowers=lowers,
            poisson=poisson, dataset=dataset)

    def get_samples(self) -> np.ndarray:
        """Observable columns + dataset tag (reference: pdfz.h:542-556)."""
        obs = self.samples_host[:, :self.nobservables]
        tag = np.full((obs.shape[0], 1), float(self.dataset), np.float32)
        return np.concatenate([obs, tag], axis=1)


def read_bins_for(points: torch.Tensor, nobs: int, lower, upper, nbins,
                  datasets: Sequence[int]) -> torch.Tensor:
    """``(len(datasets), npoints)`` int32 read bins of float32 points.

    Row j holds the bin id where the point's tag equals ``datasets[j]``,
    -2 where it does not, and -1 where the point is out of domain
    (out-of-domain wins, pdfz.cpp:295-301).
    """
    ids, valid = hist_ops.compute_bin_ids(points[:, :nobs], lower, upper,
                                          nbins)
    ids = ids.to(torch.int32)
    tags = points[:, nobs]
    minus1 = torch.full_like(ids, -1)
    minus2 = torch.full_like(ids, -2)
    rows = [torch.where(valid, torch.where(tags == float(ds), ids, minus2),
                        minus1) for ds in datasets]
    return torch.stack(rows)


def eval_from_bins(bins: torch.Tensor, norm: torch.Tensor,
                   bin_volume: float, read_bins: torch.Tensor
                   ) -> torch.Tensor:
    """LUT gather with sentinel semantics (reference: pdfz.cpp:411-436).

    ``bins`` is ``(..., total_nbins)`` and ``read_bins`` ``(...,
    npoints)`` with matching leading axes; ``norm`` broadcasts over
    the leading axes.
    """
    safe = read_bins.to(torch.int64).clamp(0, bins.shape[-1] - 1)
    denom = (norm * float(np.float32(bin_volume))).unsqueeze(-1)
    vals = torch.gather(bins, -1, safe) / denom
    vals = torch.where(read_bins == -2, torch.zeros_like(vals), vals)
    return torch.where(read_bins == -1, torch.full_like(vals, float("nan")),
                       vals)
